"""lk_roofline.replay: see metrics/_readers.py, lk_roofline."""

from vio_bench.metrics._readers import lk_roofline as read  # noqa: F401
