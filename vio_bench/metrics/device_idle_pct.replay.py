"""device_idle_pct.replay: see metrics/_readers.py, device_idle_pct."""

from vio_bench.metrics._readers import device_idle_pct as read  # noqa: F401
