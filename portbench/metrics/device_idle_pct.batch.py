"""device_idle_pct.batch: ``readers.device_idle_pct``."""

from portbench.readers import device_idle_pct as read  # noqa: F401
