"""stage_ms_per_pair.batch: ``readers.stage_ms_per_pair``."""

from portbench.readers import stage_ms_per_pair as read  # noqa: F401
