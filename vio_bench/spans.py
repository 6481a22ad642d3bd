"""The program's spans joined with a traced window's profiler events.

The port records spans at the boundaries of a frame's stages (its
``utils/logging.py``: ``tracing()`` on, ``drain()`` after); each has a
``name``, ``start_ns`` / ``end_ns`` on the profiler's clock (epoch
nanoseconds, as kineto's events' ``start_ns()``), an ``id`` and its
parent's id, ``parent``. ``join`` puts the window's host CUDA calls and
device idle time down to the span the host was in:

- ``span_s``: seconds inside each span name; ``span_n``: spans of each name;
- ``span_children``: each name's child span names (a stage's subtree);
- ``launches_by_span``: kernel-launch calls (``LAUNCH_CALLS``) by the
  innermost span their start lies in, ``OUTSIDE`` for the rest;
- ``idle_by_span``: seconds of the window the device was idle, by the
  innermost span the host was in meanwhile, ``OUTSIDE`` for the rest.

The readers below turn these records into per-frame and per-chunk numbers;
each returns None where the run recorded no spans.
"""

from __future__ import annotations

import bisect
import collections
import heapq

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")
OUTSIDE = "(outside spans)"


def innermost(spans) -> list:
    """[(start_ns, end_ns, name)]: the time the spans cover, cut where the
    innermost span (the open one that started last; of two that started
    together, the shorter) changes; sorted, disjoint, neighbours of one
    name merged."""
    order = sorted(spans, key=lambda s: s.start_ns)
    bounds = sorted({t for s in spans for t in (s.start_ns, s.end_ns)})
    heap, out, i = [], [], 0
    for a, b in zip(bounds, bounds[1:]):
        while i < len(order) and order[i].start_ns <= a:
            s = order[i]
            heapq.heappush(heap, (-s.start_ns, s.end_ns - s.start_ns, i, s))
            i += 1
        while heap and heap[0][3].end_ns <= a:
            heapq.heappop(heap)
        if not heap:
            continue
        name = heap[0][3].name
        if out and out[-1][1] == a and out[-1][2] == name:
            out[-1] = (out[-1][0], b, name)
        else:
            out.append((a, b, name))
    return out


def _idle(gpu, t0: int, t1: int) -> list:
    """[(a, b)]: the stretches of [t0, t1] no device interval covers."""
    out, end = [], t0
    for a, b, _ in sorted(gpu):
        a, b = max(a, t0), min(b, t1)
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if end < t1:
        out.append((end, t1))
    return out


def join(spans, host, gpu, t0_ns: int, t1_ns: int) -> dict:
    """The records above, from the window's spans, its host events and its
    device intervals ([(start_ns, end_ns, name)] each) and its bounds."""
    span_s, span_n = collections.Counter(), collections.Counter()
    names = {s.id: s.name for s in spans}
    children = collections.defaultdict(set)
    for s in spans:
        span_s[s.name] += (s.end_ns - s.start_ns) * 1e-9
        span_n[s.name] += 1
        if s.parent in names:
            children[names[s.parent]].add(s.name)
    segs = innermost(spans)
    starts = [a for a, _, _ in segs]

    def where(t: int) -> str:
        k = bisect.bisect_right(starts, t) - 1
        return segs[k][2] if k >= 0 and t < segs[k][1] else OUTSIDE

    launches = collections.Counter(where(a) for a, _, name in host
                                   if name.startswith(LAUNCH_CALLS))
    idle = collections.Counter()
    total, k = 0, 0
    for a, b in _idle(gpu, t0_ns, t1_ns):
        total += b - a
        while k < len(segs) and segs[k][1] <= a:
            k += 1
        j = k
        while j < len(segs) and segs[j][0] < b:
            idle[segs[j][2]] += min(b, segs[j][1]) - max(a, segs[j][0])
            j += 1
    idle[OUTSIDE] = total - sum(idle.values())
    return dict(span_s=dict(span_s), span_n=dict(span_n),
                span_children={n: sorted(c) for n, c in children.items()},
                launches_by_span=dict(launches),
                idle_by_span={n: ns * 1e-9 for n, ns in idle.most_common()})


def idle_line(records: dict) -> str:
    """``idle_by_span`` for the run's standard error."""
    idle = records.get("idle_by_span") or {}
    return "device idle by span: " + ", ".join(f"{n} {s:.3f} s" for n, s in idle.items())


def _subtree(records: dict, name: str) -> set:
    out, todo = set(), [name]
    while todo:
        n = todo.pop()
        if n not in out:
            out.add(n)
            todo += records["span_children"].get(n, [])
    return out


def ms_per_frame(records: dict, name: str):
    """Milliseconds inside the spans ``name`` per frame of the window."""
    if name not in records.get("span_s", {}) or not records.get("frames"):
        return None
    return 1e3 * records["span_s"][name] / records["frames"]


def ms_per_span(records: dict, name: str, per: str):
    """Milliseconds inside the spans ``name`` per span ``per`` (a chunk)."""
    n = records.get("span_n", {}).get(per)
    if name not in records.get("span_s", {}) or not n:
        return None
    return 1e3 * records["span_s"][name] / n


def launches_per_frame(records: dict, name: str):
    """Kernel-launch calls made inside the spans ``name`` or their
    descendants, per frame of the window."""
    if name not in records.get("span_s", {}) or not records.get("frames"):
        return None
    tree = _subtree(records, name)
    return sum(n for s, n in records["launches_by_span"].items() if s in tree) / records["frames"]
