"""``lm.optimize`` replayed as a captured CUDA graph (solver/lm.py).

On the CPU: which calls stay eager (``lm.why_eager``: off the card, batched
by ``torch.func.vmap``, a host read of ``GREEDY_GN`` / ``EARLY_EXIT_FTOL``,
``BATCH_CANDIDATES``' batched Cholesky solve), the counters, and the
``optimize`` span's ``graph`` attribute.

On the card (the ``cuda`` marker; skips without one): a short recording
rendered by ``vio_bench/sim/`` and served through the chunked server with
eager ``optimize``, each call's inputs and outputs kept, then every call
replayed through the graph with every output field compared; two engines
alternating frames in one thread, and two threads each with an engine at
once, against each engine alone; a new graph for a new iteration count or
option; ``lm.counts`` as eager calls leave it; the fleet's ``vmap`` and
``BATCH_CANDIDATES`` eager.

No JAX here. On the card's machine, from the root of the repo:
``python -m pytest --noconftest -m cuda tests/test_torch_lm_graph.py``."""

from __future__ import annotations

import contextlib
import threading

import pytest
import torch
from torch.utils._pytree import tree_flatten, tree_map

from mobile_slam_tpu_torch.engine import estimator as est
from mobile_slam_tpu_torch.engine import example
from mobile_slam_tpu_torch.solver import lm
from mobile_slam_tpu_torch.utils import logging as slog

SEED = 2 ** 31 + 1717       # the card's recordings (vio_bench's generator)
RECORDING_S = 2.0           # 41 frames at 20 Hz: chunked mode near frame 15
CHUNK = 5
DEVICE = "cuda"


@contextlib.contextmanager
def _options(**kv):
    old = {k: getattr(lm, k) for k in kv}
    for k, v in kv.items():
        setattr(lm, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(lm, k, v)


def _cpu_example():
    cfg = example.tiny_config()
    ps = est.make_params(cfg, device="cpu")
    st, inp = example.make_example_state(cfg, ps, device="cpu")
    return cfg, ps, st, inp


def _optimize_args(st, ps):
    return (st.window, st.table, st.prior, ps.ex_t, ps.ex_q, est.solver_params(ps))


# --- CPU ---------------------------------------------------------------------

@pytest.mark.parametrize("case", ["cpu", "vmap", "greedy_host", "ftol_host",
                                  "batch_candidates"])
def test_why_eager(case):
    _, ps, st, _ = _cpu_example()
    leaves, _ = tree_flatten(_optimize_args(st, ps) + (st.td,))
    if case == "cpu":
        assert lm.why_eager(leaves, True, False, False, None) == "not on CUDA"
        # The device forms of the options read nothing on the host.
        assert lm.why_eager(leaves, False, True, False, 1e-3) == "not on CUDA"
    elif case == "vmap":
        seen = []
        torch.func.vmap(lambda p: seen.append(
            lm.why_eager([p] + leaves, True, False, False, None)) or p)(torch.zeros((2, 3)))
        assert seen == ["batched or differentiated"]
    elif case == "greedy_host":
        assert lm.why_eager(leaves, True, True, False, None) == "host read"
    elif case == "ftol_host":
        assert lm.why_eager(leaves, True, False, False, 1e-6) == "host read"
        assert lm.why_eager(leaves, True, False, False, 0.0) == "host read"
    else:
        assert lm.why_eager(leaves, True, False, True, None) == "batched Cholesky solve"
        # Under GREEDY_GN the candidates are solved one by one.
        assert lm.why_eager(leaves, False, True, True, None) == "not on CUDA"


def test_cpu_solve_is_eager_and_its_span_says_so():
    cfg, ps, st, inp = _cpu_example()
    st, is_kf = est.bookkeeping_step(st, inp, ps)
    lm.reset_counts()
    slog.drain()
    with slog.tracing():
        est.solve_and_slide(st, bool(is_kf), ps, cfg.estimator.num_iterations)
    spans = [s for s in slog.drain() if s.name == "optimize"]
    assert [s.attrs for s in spans] == [{"graph": "eager"}]
    assert lm.graph_counts == {"captures": 0, "replays": 0, "eager": 1}
    assert lm.last_form() == "eager"


def test_reset_counts_clears_graph_counts_and_counts_keeps_its_keys():
    for k in lm.graph_counts:
        lm.graph_counts[k] = 7
    lm.counts["iterations"] = 5
    lm.reset_counts()
    assert lm.graph_counts == {"captures": 0, "replays": 0, "eager": 0}
    assert lm.counts == {"iterations": 0, "host_reads": 0}
    assert set(lm.counts) == {"iterations", "host_reads"}


# --- card --------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs replay only on an NVIDIA GPU")


def _leaves(tree):
    return tree_flatten(tree)[0]


def _clone(tree):
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


class _Feed:
    """One recording served frame by frame through its own chunked server."""

    def __init__(self, cfg, traffic, rec):
        from mobile_slam_tpu_torch.engine.serving import ChunkedImageServer
        from vio_bench.entries import common

        self.common, self.rec, self.fi, self.imu_i = common, rec, 0, 0
        self.server = ChunkedImageServer(common.vio_config(cfg), chunk_size=CHUNK,
                                         stable_frames=traffic["stable_frames"], device=DEVICE)
        self.poses = []

    @property
    def done(self) -> bool:
        return self.fi >= len(self.rec.cam_ts)

    def step(self) -> None:
        ts = float(self.rec.cam_ts[self.fi])
        self.imu_i = self.common.feed_imu(self.server, self.rec, self.imu_i, ts)
        self.poses += [(r.ts, r.ok, r.p, r.q) for r in
                       self.server.process_frame(self.rec.frames[self.fi], ts)]
        self.fi += 1

    def finish(self) -> list:
        self.poses += [(r.ts, r.ok, r.p, r.q) for r in self.server.flush()]
        return self.poses


def _serve_alone(cfg, traffic, rec) -> list:
    feed = _Feed(cfg, traffic, rec)
    while not feed.done:
        feed.step()
    return feed.finish()


def _same_poses(a, b) -> bool:
    return len(a) == len(b) and all(
        x[0] == y[0] and x[1] == y[1] and (x[2] == y[2]).all() and (x[3] == y[3]).all()
        for x, y in zip(a, b))


@pytest.fixture(scope="module")
def card():
    """The recordings, eager ``optimize``'s calls over the first (inputs,
    iteration count, ``host_branch``, outputs), and each recording's poses
    served alone through the graph."""
    _need_card()
    from vio_bench import harness
    from vio_bench.entries import common

    cfg = harness.load_json("configs", "tumvi_room_512.json")
    traffic = harness.load_json("traffic", "replay_chunk25.json")
    recs = common.recordings(cfg, traffic, SEED, 2, RECORDING_S, DEVICE)
    calls = []

    def recording(window, table, prior, ex_t, ex_q, params, num_iterations, td0=0.0,
                  host_branch=True):
        args = _clone((window, table, prior, ex_t, ex_q, params, td0))
        out = lm._optimize(window, table, prior, ex_t, ex_q, params, num_iterations, td0,
                           host_branch)
        calls.append((args, num_iterations, host_branch, _clone(out)))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lm, "optimize", recording)
        eager_poses = _serve_alone(cfg, traffic, recs[0])
    torch.cuda.synchronize()
    alone = [_serve_alone(cfg, traffic, r) for r in recs]
    return dict(cfg=cfg, traffic=traffic, recs=recs, calls=calls, eager_poses=eager_poses,
                alone=alone)


def _compare(out, ref):
    """(bit-equal leaves, all leaves, the largest relative difference)."""
    a, b = _leaves(out), _leaves(ref)
    assert len(a) == len(b)
    equal, worst = 0, 0.0
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        if torch.equal(x, y):
            equal += 1
            continue
        assert x.is_floating_point(), (x, y)
        both_nan = torch.isnan(x) & torch.isnan(y)
        d = torch.where(both_nan, 0.0, (x - y).abs() / y.abs().clamp_min(1e-30))
        worst = max(worst, float(d.max()))
    return equal, len(a), worst


@pytest.mark.cuda
def test_graph_replays_eager_calls_exactly(card):
    """(a) every recorded call replayed through the graph: every field of
    window, table, SolveResult and culled_ids bit-equal, or within 1e-6
    relative where a kernel differs."""
    calls = card["calls"]
    assert len(calls) >= 10, len(calls)
    lm.reset_counts()
    equal = total = 0
    worst = 0.0
    for args, n_it, host_branch, ref in calls:
        window, table, prior, ex_t, ex_q, params, td0 = _clone(args)
        out = lm.optimize(window, table, prior, ex_t, ex_q, params, n_it, td0=td0,
                          host_branch=host_branch)
        assert lm.last_form() in ("capture", "replay")
        e, n, w = _compare(out, ref)
        equal, total, worst = equal + e, total + n, max(worst, w)
    same = _same_poses(card["eager_poses"], card["alone"][0])
    print(f"graph against eager over {len(calls)} calls: {equal} of {total} leaves "
          f"bit-equal, largest relative difference {worst:.3e}; the recording's poses "
          f"served eagerly and through the graph {'equal' if same else 'differ'}")
    assert worst <= 1e-6
    # Bit-equal solves serve bit-equal poses.
    assert same or worst > 0
    assert lm.graph_counts["eager"] == 0
    assert lm.graph_counts["captures"] + lm.graph_counts["replays"] == len(calls)


@pytest.mark.cuda
def test_graph_outputs_are_not_overwritten_by_the_next_replay(card):
    args, n_it, host_branch, ref = card["calls"][-1]
    first = lm.optimize(*_clone(args)[:6], n_it, td0=args[6], host_branch=host_branch)
    other = card["calls"][0][0]
    lm.optimize(*_clone(other)[:6], n_it, td0=other[6], host_branch=host_branch)
    assert _compare(first, ref)[2] <= 1e-6


@pytest.mark.cuda
def test_two_engines_alternating_in_one_thread(card):
    """(b) two servers alternate frames in one thread (one graph between
    them) and serve the poses each serves alone."""
    feeds = [_Feed(card["cfg"], card["traffic"], r) for r in card["recs"]]
    while not all(f.done for f in feeds):
        for f in feeds:
            if not f.done:
                f.step()
    for f, alone in zip(feeds, card["alone"]):
        assert _same_poses(f.finish(), alone)
    assert sum(ok for _, ok, _, _ in card["alone"][0]) > 10


@pytest.mark.cuda
def test_two_threads_each_with_an_engine(card):
    """(c) two threads serve at once, as the gateway's sessions do: each
    captures its own graph and serves the poses its engine serves alone."""
    lm.reset_counts()
    out, errors = [None, None], []

    def body(k):
        try:
            out[k] = _serve_alone(card["cfg"], card["traffic"], card["recs"][k])
        except Exception as e:   # noqa: BLE001  (re-raised in the main thread)
            errors.append(e)

    threads = [threading.Thread(target=body, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive()
    if errors:
        raise errors[0]
    assert lm.graph_counts["captures"] == 2
    for got, alone in zip(out, card["alone"]):
        assert _same_poses(got, alone)


@pytest.mark.cuda
@pytest.mark.parametrize("change", ["num_iterations", "GREEDY_GN", "EARLY_EXIT_FTOL"])
def test_a_new_key_captures_a_new_graph(card, change):
    """(d) another iteration count or option captures its own graph, whose
    output is the eager call's under the same setting, and the old key
    still replays its own."""
    args, n_it, host_branch, ref = card["calls"][-1]
    lm.optimize(*_clone(args)[:6], n_it, td0=args[6], host_branch=host_branch)
    opts, n_new, hb = {}, n_it, host_branch
    if change == "num_iterations":
        n_new = n_it + 3
    else:
        # The options' host forms read the device: their device forms are captured.
        opts, hb = {change: True if change == "GREEDY_GN" else 1e-6}, False
    with _options(**opts):
        lm.reset_counts()
        got = lm.optimize(*_clone(args)[:6], n_new, td0=args[6], host_branch=hb)
        assert lm.graph_counts["captures"] == 1 and lm.last_form() == "capture"
        want = lm._optimize(*_clone(args)[:6], n_new, args[6], hb)
        assert _compare(got, want)[2] <= 1e-6
        again = lm.optimize(*_clone(args)[:6], n_new, td0=args[6], host_branch=hb)
        assert lm.last_form() == "replay" and _compare(again, want)[2] <= 1e-6
    lm.reset_counts()
    old = lm.optimize(*_clone(args)[:6], n_it, td0=args[6], host_branch=host_branch)
    assert lm.last_form() == "replay" and lm.graph_counts["captures"] == 0
    assert _compare(old, ref)[2] <= 1e-6


@pytest.mark.cuda
def test_counts_after_replays_as_after_eager_calls(card):
    """(e) ``lm.counts`` rises by the iteration count on every call, the
    capturing one included (its warm-up runs do not count)."""
    args, n_it, host_branch, _ = card["calls"][0]
    n_new = n_it + 5          # a key no other test uses: the first call captures
    lm.reset_counts()
    for _ in range(3):
        lm._optimize(*_clone(args)[:6], n_new, args[6], host_branch)
    eager = dict(lm.counts)
    lm.reset_counts()
    for _ in range(3):
        lm.optimize(*_clone(args)[:6], n_new, td0=args[6], host_branch=host_branch)
    assert lm.graph_counts == {"captures": 1, "replays": 2, "eager": 0}
    assert lm.counts == eager == {"iterations": 3 * n_new, "host_reads": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["vmap", "BATCH_CANDIDATES"])
def test_eager_forms_capture_nothing(card, form):
    """Under the fleet's ``vmap``, and with ``BATCH_CANDIDATES``, nothing is
    captured or replayed, and the result is the eager body's."""
    (a, n_it, hb, _), (b, _, _, _) = card["calls"][-2], card["calls"][-1]

    if form == "vmap":
        stacked = tree_map(lambda x, y: torch.stack([x, y]), _clone(a), _clone(b))

        def run(fn):
            return torch.func.vmap(lambda w, t, p, ex_t, ex_q, ps, td: fn(
                w, t, p, ex_t, ex_q, ps, n_it, td, False))(*stacked)
    else:
        def run(fn):
            with _options(BATCH_CANDIDATES=True):
                return fn(*_clone(a)[:6], n_it, a[6], hb)

    lm.reset_counts()
    got = run(lambda *xs: lm.optimize(*xs[:7], td0=xs[7], host_branch=xs[8]))
    assert lm.graph_counts == {"captures": 0, "replays": 0, "eager": 1}
    want = run(lm._optimize)
    assert all(torch.equal(x, y) for x, y in zip(_leaves(got), _leaves(want)))
