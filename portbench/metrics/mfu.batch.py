"""mfu.batch: ``readers.forward_mfu``."""

from portbench.readers import forward_mfu as read  # noqa: F401
