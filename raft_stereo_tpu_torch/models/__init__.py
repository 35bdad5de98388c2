"""Model modules of the port (NCHW inside, reference torch module names)."""
