"""Serving runtime of the port: the batched inference engine."""
