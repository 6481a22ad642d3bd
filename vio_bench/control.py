"""The control of ``correct``, and the faults it must catch.

    python -m vio_bench.control --workload <cell> --seeds 11,12,13 --seconds 30 [--arm <arm>]

runs whole runs of a cell (set-up, window, checks; no result line) for each
seed in one process, with the program changed underneath as ``--arm``
says (by default the control its configuration names), and prints one JSON
line per seed: the numbers compared, their limits and whether the run came
out correct.

The configurations state no number format; they state guarantees
(``guarantees`` in each file), and the control (``control``) breaks one:
``solve_skipped`` serves each frame the IMU's prediction, with
``solve_and_slide``'s optimisation skipped (the step that is most of a
frame, and the one a change for speed would be tempted to thin out).
``sound`` runs the program as it is. The faults ``correct`` must catch:
- ``state_unchanged``: from the first tracking frame on, the per-frame
  step does nothing: ``bookkeeping_step`` and ``solve_and_slide`` hand
  back the state they were given, and the answer is that state's newest
  pose.
- ``pose_altered``: one pose moved by ``ALTER_M`` where it is produced (the
  ``ALTER_AT``-th ``solve_and_slide``).

Not a part of the benchmark's own runs; ``tests/`` drives it.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import time

ALTER_M = 1.0
ALTER_AT = 40       # past the set-up's calls in every cell at the full size


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _solve_patch(alter):
    from mobile_slam_tpu_torch.engine import estimator as est

    solve, calls = est.solve_and_slide, [0]

    def patched(state, *args, **kw):
        new_state, p, q, diag = solve(state, *args, **kw)
        calls[0] += 1
        return alter(state, new_state, p, q, diag, calls[0])

    return _patched(est, "solve_and_slide", patched)


@contextlib.contextmanager
def _state_unchanged():
    from mobile_slam_tpu_torch.config import NUM_SLOTS
    from mobile_slam_tpu_torch.engine import estimator as est

    book, tracking = est.bookkeeping_step, []

    def unchanged_book(state, *args, **kw):
        new_state, is_kf = book(state, *args, **kw)
        return (state if tracking else new_state), is_kf

    def unchanged_solve(state, new, p, q, diag, n):
        tracking.append(n)
        return state, state.window.p[NUM_SLOTS - 1], state.window.q[NUM_SLOTS - 1], diag

    with _patched(est, "bookkeeping_step", unchanged_book), _solve_patch(unchanged_solve):
        yield


def _pose_altered(at: int = ALTER_AT):
    return _solve_patch(lambda state, new, p, q, diag, n:
                        (new, p + ALTER_M if n == at else p, q, diag))


def _solve_skipped():
    from mobile_slam_tpu_torch.config import NUM_SLOTS

    return _solve_patch(lambda state, new, p, q, diag, n: (
        state, state.window.p[NUM_SLOTS - 1], state.window.q[NUM_SLOTS - 1], diag))


ARMS = {"sound": contextlib.nullcontext, "solve_skipped": _solve_skipped,
        "state_unchanged": _state_unchanged, "pose_altered": _pose_altered}


def run_arm(workload: str, seed: int, seconds: float, arm: str, device="cuda",
            traffic_update=None, alter_at: int = ALTER_AT) -> dict:
    """One run of ``workload`` under ``arm``: {"checks", "correct", ...}."""
    from vio_bench import harness

    t_start = time.perf_counter()
    cell = harness.find_cell(harness.benchmark(), workload)
    cfg = harness.load_json("configs", f"{cell['config']}.json")
    traffic = harness.load_json("traffic", f"{cell['traffic']}.json")
    traffic.update(traffic_update or {})
    limits = harness.load_json("limits", f"{cell['name']}.json")["checks"]
    entry = importlib.import_module(f"vio_bench.entries.{traffic['entry']}")
    with (_pose_altered(alter_at) if arm == "pose_altered" else ARMS[arm]()):
        run = entry.run(cfg, traffic, seed=seed, seconds=seconds, trace=False,
                         t_start=t_start, device=device)
    correct, out = harness.judge(run.checks, limits)
    return dict(workload=workload, arm=arm, seed=seed, correct=correct,
                checks={k: v["value"] for k, v in out.items()},
                limits={k: v["limit"] for k, v in out.items()}, e2e=run.e2e,
                attempted=run.attempted, failed=run.failed, notes=run.notes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vio_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--arm", choices=sorted(ARMS),
                    help="default: the control the cell's configuration names")
    args = ap.parse_args(argv)
    from vio_bench import harness

    harness.set_cache_dirs()
    if args.arm is None:
        cell = harness.find_cell(harness.benchmark(), args.workload)
        args.arm = harness.load_json("configs", f"{cell['config']}.json")["control"]
    for seed in [int(s) for s in args.seeds.split(",")]:
        try:
            out = run_arm(args.workload, seed, args.seconds, args.arm)
        except Exception as e:          # a run that crashes has failed: say so, go on
            out = dict(workload=args.workload, arm=args.arm, seed=seed, correct=False,
                       error=f"{type(e).__name__}: {e}"[:500])
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
