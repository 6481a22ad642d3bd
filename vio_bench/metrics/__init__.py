"""Per-layer metrics, one file each, named as in ``BENCHMARK.json``: each
has ``read(records) -> float | None``, where ``records`` is what the traced
run recorded (``trace.Trace.records`` and the entry module's own counts). A
reader that finds nothing to read returns None, and the harness leaves the
metric out of the line; none returns 0 for a share."""
