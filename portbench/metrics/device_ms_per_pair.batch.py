"""device_ms_per_pair.batch: ``readers.device_ms_per_pair``."""

from portbench.readers import device_ms_per_pair as read  # noqa: F401
