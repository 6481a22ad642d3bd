"""CPU tests of the joins of the program's spans with a traced window's
events (``vio_bench/spans.py``), on synthetic spans and events (run from the
root of the repo: ``python -m pytest vio_bench/tests/test_vio_bench_spans.py``)."""

from __future__ import annotations

import types

import pytest

from vio_bench import spans as sj

MS = 1_000_000


def _span(i, name, a, b, parent=None):
    return types.SimpleNamespace(id=i, name=name, start_ns=a * MS, end_ns=b * MS, parent=parent)


# Two frames of 10 ms, each a track (1-4) and a solve (4-9) holding an
# optimize (5-8); the host outside any span from 20 to 25 ms.
SPANS = [s for f in range(2) for s in (
    _span(10 * f + 1, "frame", 10 * f, 10 * f + 10),
    _span(10 * f + 2, "track", 10 * f + 1, 10 * f + 4, 10 * f + 1),
    _span(10 * f + 3, "solve", 10 * f + 4, 10 * f + 9, 10 * f + 1),
    _span(10 * f + 4, "optimize", 10 * f + 5, 10 * f + 8, 10 * f + 3))]
HOST = ([(t * MS, t * MS + 10_000, "cudaLaunchKernel") for t in (2, 3, 5, 6, 7, 12, 16, 22)]
        + [(8 * MS, 8 * MS + 10_000, "cuLaunchKernel"),
           (4 * MS + 500_000, 4 * MS + 600_000, "cudaMemcpyAsync")])
GPU = [(int(t * MS), int((t + 0.5) * MS), "k") for t in (2, 5.5, 6, 7, 13)]   # 2.5 ms busy
WINDOW = (0, 25 * MS)


@pytest.fixture
def joined():
    return sj.join(SPANS, HOST, GPU, *WINDOW)


def test_innermost_cuts_where_the_inner_span_changes():
    segs = [(a / MS, b / MS, n) for a, b, n in sj.innermost(SPANS[:4])]
    assert segs == [(0, 1, "frame"), (1, 4, "track"), (4, 5, "solve"), (5, 8, "optimize"),
                    (8, 9, "solve"), (9, 10, "frame")]
    same_start = [_span(1, "outer", 0, 4), _span(2, "inner", 0, 2, 1)]
    assert [n for _, _, n in sj.innermost(same_start)] == ["inner", "outer"]


def test_launches_by_span_count_each_launch_call_once(joined):
    launches = joined["launches_by_span"]
    # the call at 8 ms, where optimize ends, is the solve's
    assert launches == {"track": 3, "optimize": 4, "solve": 1, sj.OUTSIDE: 1}
    calls = sum(name.startswith(sj.LAUNCH_CALLS) for _, _, name in HOST)
    assert sum(launches.values()) <= calls


def test_idle_by_span_sums_to_the_windows_idle(joined):
    idle = joined["idle_by_span"]
    window_idle = (WINDOW[1] - WINDOW[0]) * 1e-9 - 2.5e-3
    assert sum(idle.values()) == pytest.approx(window_idle, rel=0.01)
    assert idle == pytest.approx({"track": 5e-3, "optimize": 4.5e-3, "solve": 4e-3,
                                  "frame": 4e-3, sj.OUTSIDE: 5e-3})


def test_span_seconds_counts_and_children(joined):
    assert joined["span_s"] == pytest.approx({"frame": 0.02, "track": 0.006, "solve": 0.01,
                                              "optimize": 0.006})
    assert joined["span_n"] == {"frame": 2, "track": 2, "solve": 2, "optimize": 2}
    assert joined["span_children"] == {"frame": ["solve", "track"], "solve": ["optimize"]}


def test_readers_per_frame_and_per_chunk(joined):
    records = dict(joined, frames=2)
    assert sj.ms_per_frame(records, "track") == pytest.approx(3.0)
    assert sj.ms_per_frame(records, "solve") == pytest.approx(5.0)
    assert sj.launches_per_frame(records, "solve") == pytest.approx(2.5)    # with optimize
    assert sj.launches_per_frame(records, "track") == pytest.approx(1.5)
    assert sj.ms_per_span(records, "optimize", "frame") == pytest.approx(3.0)
    assert "optimize" in sj.idle_line(records)


@pytest.mark.parametrize("records", [{}, {"frames": 50, "launches": 10}],
                         ids=["nothing", "no spans"])
def test_readers_read_nothing_without_spans(records):
    assert sj.ms_per_frame(records, "track") is None
    assert sj.launches_per_frame(records, "solve") is None
    assert sj.ms_per_span(records, "chunk.readback", "chunk") is None
