"""fusion_mfu.batch: ``mad_readers.fusion_mfu``."""

from portbench.mad_readers import fusion_mfu as read  # noqa: F401
