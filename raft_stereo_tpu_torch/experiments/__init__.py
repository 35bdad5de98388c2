"""The phase-packed encoder stage of the port (off by default; see
``models/extractor.py``'s ``_ENABLE_PACKED``) and its CUDA conv kernel."""
