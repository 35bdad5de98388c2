"""Serving runtime of the port: the batched inference engine.

``AOTStore`` (``runtime/aot_store.py``, the persistent graph store) is
exported here, as the JAX package's runtime exports it, and loaded on first
access."""

__all__ = ["AOTStore"]


def __getattr__(name):
    if name == "AOTStore":
        from raft_stereo_tpu_torch.runtime.aot_store import AOTStore

        return AOTStore
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
