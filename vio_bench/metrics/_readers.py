"""The readers that several per-layer metrics share (one metric per
end-to-end metric it moves, ``.replay`` for ``replay_fps``)."""

from __future__ import annotations


def _per_frame(records: dict, key: str):
    n, frames = records.get(key), records.get("frames")
    return n / frames if n is not None and frames else None


def syncs_per_frame(records: dict):
    """Host synchronizations (torch's sync debug mode) per frame of the
    window."""
    return _per_frame(records, "syncs")


def launches_per_frame(records: dict):
    """Kernels the profiler saw on the device per frame of the window."""
    if not records.get("launches"):
        return None
    return _per_frame(records, "launches")


def device_idle_pct(records: dict):
    """100 x (1 - the union of the device's kernel, copy and set intervals
    over the traced window)."""
    busy, window = records.get("busy_s"), records.get("window_s")
    if not busy or not window:
        return None
    return 100.0 * (1.0 - busy / window)


def lk_roofline(records: dict):
    """K1-K3's share of their roofline: the least time their launches'
    shapes need (``roofline.least_s``) over their device time."""
    least, dev = records.get("lk_least_s"), records.get("lk_device_s")
    if not least or not dev:
        return None
    return 100.0 * least / dev
