"""xattn_ms_per_pair.batch: ``mad_readers.xattn_ms_per_pair``."""

from portbench.mad_readers import xattn_ms_per_pair as read  # noqa: F401
