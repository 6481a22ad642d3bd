"""launches_per_frame.replay: see metrics/_readers.py, launches_per_frame."""

from vio_bench.metrics._readers import launches_per_frame as read  # noqa: F401
