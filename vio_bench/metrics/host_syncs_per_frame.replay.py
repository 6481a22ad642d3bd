"""host_syncs_per_frame.replay: see metrics/_readers.py, syncs_per_frame."""

from vio_bench.metrics._readers import syncs_per_frame as read  # noqa: F401
