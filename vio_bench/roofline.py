"""The least time the card could take for a K1-K3 launch, from the launch's
shapes.

``bound``, ``footprint_bytes``, ``origin``, ``k1_read_bytes`` and the
``*_flops`` counts are frozen copies of ``chip_smoke.py``'s bound
arithmetic (published peaks of one H100 SXM: 3.35 TB/s of HBM, 67 TFLOP/s
float32 outside the tensor cores); the harness's tests hold them equal to
the smoke's. ``least_s`` applies them to what the benchmark can see of a
launch inside a frame: its slots (B x K), window, levels and image sizes.
The points' positions, which slots are live and how many steps each ran are
data the harness does not read, so a launch is counted as every slot live
for one step at every level, each slot's pixel blocks read once and the
blocks of one level never more than the level's pixels: the fewest that
launch's shapes need.
"""

from __future__ import annotations

import torch

PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
F32 = 4


def bound(nbytes: float, flops: float) -> dict:
    """The least time on the card: the larger of bytes over the memory rate
    and float32 operations over the float32 peak."""
    t_bytes = 1e3 * nbytes / PEAK_BYTES_S
    t_ops = 1e3 * flops / PEAK_F32_FLOP_S
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=float(nbytes), bound_flops=float(flops))


def origin(c, back, pad, n, side):
    """block_origin of csrc/lk_common.cuh for a tensor of coordinates."""
    f = torch.floor(torch.nan_to_num(c, nan=0.0)).clamp(-2 ** 24, 2 ** 24).long()
    return (f - back + pad).clamp(0, n + 2 * pad - side) - pad


def footprint_bytes(img, oy, ox, side):
    """Bytes of the distinct pixels of ``img`` that side x side blocks at
    origins (oy, ox) read, each row and column clamped into the image."""
    h, w = img.shape
    span = torch.arange(side, device=oy.device)
    rows = (oy[:, None] + span).clamp(0, h - 1)
    cols = (ox[:, None] + span).clamp(0, w - 1)
    seen = torch.zeros((h, w), dtype=torch.bool, device=img.device)
    seen[rows[:, :, None], cols[:, None, :]] = True
    return int(seen.sum()) * img.element_size()


def k1_read_bytes(pyr0, pyr1, pts, windows, win):
    """Bytes of the level pixels K1 must read, once each: the (win+3)^2
    template block of every active slot at every level of the first
    pyramid, and the (win+1)^2 windows its steps sample in the second."""
    half = (win - 1) // 2
    total = 0
    for lvl, (a, b) in enumerate(zip(pyr0, pyr1)):
        h, w = a.shape
        tx, ty = pts[:, 0] / float(2 ** lvl), pts[:, 1] / float(2 ** lvl)
        total += footprint_bytes(a, origin(ty, half + 1, half + 2, h, win + 3),
                                 origin(tx, half + 1, half + 2, w, win + 3), win + 3)
        xs = [x for lv, x, _ in windows if lv == lvl]
        ys = [y for lv, _, y in windows if lv == lvl]
        if xs:
            xs, ys = torch.cat(xs), torch.cat(ys)
            total += footprint_bytes(b, origin(ys, half, half + 2, h, win + 1),
                                     origin(xs, half, half + 2, w, win + 1), win + 1)
    return total


def template_flops(win):      # block Scharr + 3 bilinear patches
    return 24 * (win + 1) ** 2 + 21 * win * win


def sums_flops(win):          # the three structure-tensor sums
    return 6 * win * win


def track_iter_flops(win):    # K1: bilinear window + diff + two dot sums
    return 12 * win * win + 10


def refine_iter_flops(win):   # K2: bilinear window + mean + zero-mean diff + sums
    return 14 * win * win + 20


def refine_fixed_flops(win):  # K2 per point: template sums, zero-mean, end residual
    return 20 * win * win


def _blocks(n_slots, side, h, w):
    return min(n_slots * side * side, h * w) * F32


def least_s(kernel: str, slots: int, win: int, levels: int, height: int, width: int) -> float:
    """Seconds one launch of ``kernel`` ("track", "refine", "extract") over
    ``slots`` slots needs at least (see the module's docstring)."""
    sizes = [(height // 2 ** lv, width // 2 ** lv) for lv in range(levels + 1)]
    point_io = slots * (2 * F32 + 1)            # a point in, a point and a flag out
    if kernel == "track":
        nbytes = sum(_blocks(slots, win + 3, h, w) + _blocks(slots, win + 1, h, w)
                     for h, w in sizes) + point_io
        flops = slots * len(sizes) * (template_flops(win) + sums_flops(win)
                                      + track_iter_flops(win))
    elif kernel == "refine":
        h, w = sizes[0]
        nbytes = (_blocks(slots, win + 1, h, w) + 3 * slots * win * win * F32
                  + point_io + slots * F32)
        flops = slots * (refine_fixed_flops(win) + refine_iter_flops(win))
    elif kernel == "extract":
        h, w = sizes[0]
        nbytes = _blocks(slots, win + 3, h, w) + slots * 2 * F32 + 3 * slots * win * win * F32
        flops = slots * template_flops(win)
    else:
        raise ValueError(f"unknown kernel {kernel!r}")
    return bound(nbytes, flops)["bound_ms"] / 1e3
