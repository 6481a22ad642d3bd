"""The traced run's records: ``torch.profiler`` (CUPTI) over the measured
window, and the host syncs counted beside it (``syncs.SyncSites``).

``Trace`` is a context manager around the window; ``records()`` reduces
what it saw to the numbers the per-layer metrics (``metrics/*.py``) and the
result line read: the device's busy seconds (the union of every kernel,
copy and set interval), kernel launches, device seconds by kernel name,
the launches and device seconds of K1-K3, the longest idle gaps labelled by
what the host was calling meanwhile, and the syncs. Off (``--trace 0``) it
does nothing.
"""

from __future__ import annotations

import bisect
import collections
import time

import torch

from vio_bench.syncs import SyncSites

LK_KERNELS = {"track": "lk_track_kernel", "refine": "lk_refine_kernel",
              "extract": "lk_extract_kernel"}
TOP = 10


class Trace:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = self.syncs = None
        self.window_s = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.syncs = SyncSites().__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        if self.enabled:
            self.syncs.__exit__(*exc)
            self.prof.__exit__(*exc)

    def records(self) -> dict:
        """Empty when off."""
        if not self.enabled:
            return {}
        gpu, host = [], []
        cuda = torch.autograd.DeviceType.CUDA
        for e in self.prof.profiler.kineto_results.events():
            start = e.start_ns()
            item = (start, start + e.duration_ns(), e.name())
            (gpu if e.device_type() == cuda else host).append(item)
        gpu.sort()
        host.sort()
        kernels = [g for g in gpu if not g[2].startswith(("Memcpy", "Memset"))]
        by_name = collections.Counter()
        for a, b, name in gpu:
            by_name[name] += (b - a) * 1e-9
        lk = {}
        for kind, stem in LK_KERNELS.items():
            mine = [b - a for a, b, name in kernels if stem in name]
            lk[kind] = dict(launches=len(mine), device_s=sum(mine) * 1e-9)
        busy, gaps, end = 0, [], None
        for a, b, name in gpu:
            if end is None or a > end:
                if end is not None:
                    gaps.append((a - end, end, a, name))
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        gaps.sort(reverse=True)
        return dict(
            window_s=self.window_s, busy_s=busy * 1e-9, launches=len(kernels),
            syncs=self.syncs.total, sync_sites=dict(self.syncs.sites.most_common(TOP)),
            lk=lk, device_ops=[[n, s] for n, s in by_name.most_common(TOP)],
            idle_gaps=[[_gap_label(host, g0, g1, nxt), (g1 - g0) * 1e-9]
                       for _, g0, g1, nxt in gaps[:TOP]])


def _gap_label(host, g0, g1, next_op) -> str:
    """What the host called longest while the device idled from g0 to g1,
    and the device operation that ended the gap."""
    i = bisect.bisect_left(host, (g0 - 10 ** 9,))
    spent = collections.Counter()
    for a, b, name in host[i:]:
        if a >= g1:
            break
        spent[name] += max(0, min(b, g1) - max(a, g0))
    call = spent.most_common(1)[0][0] if spent and spent.most_common(1)[0][1] > 0 \
        else "no CUDA call"
    return f"host in {call}; then {next_op[:80]}"
