"""k1_roofline.batch: ``readers.k1_roofline``."""

from portbench.readers import k1_roofline as read  # noqa: F401
