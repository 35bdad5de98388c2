"""xattn_roofline.batch: ``mad_readers.xattn_roofline``."""

from portbench.mad_readers import xattn_roofline as read  # noqa: F401
