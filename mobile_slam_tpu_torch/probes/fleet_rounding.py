"""How far a fleet step parts from the single-sequence step on IDENTICAL
inputs: the same state and frame replicated B times through
``torch.func.vmap``, against one unbatched call, stage by stage.

    python -m mobile_slam_tpu_torch.probes.fleet_rounding [--batch 4] [--dtype float32]

On the bench configuration and sequence: the tracker over three frames from
a fresh state (the same RANSAC draws on both sides), then on the feature
path after initialization bookkeeping, triangulation, the LM solve with 1
and 2 iterations, and the whole ``solve_and_slide`` (keyframe branch
selected on the device in the fleet). Any difference is rounding: batched
and single products and factorizations run different kernels. Prints one
JSON object: per stage the largest absolute difference of any floating
output of any sequence (integer and bool outputs: the count of entries that
differ).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mobile_slam_tpu_torch.engine import estimator as est
from mobile_slam_tpu_torch.engine import example
from mobile_slam_tpu_torch.engine.vio_engine import Status, VIOEngine, set_full_precision
from mobile_slam_tpu_torch.eval import simulation as sim
from mobile_slam_tpu_torch.frontend import feature_table as ft
from mobile_slam_tpu_torch.frontend import tracker as trk
from mobile_slam_tpu_torch.models.cameras.base import make_camera
from mobile_slam_tpu_torch.parallel import batch
from mobile_slam_tpu_torch.solver import lm

_leaves = torch.utils._pytree.tree_leaves


def _diff(batched, single) -> float:
    """Largest difference between any sequence of ``batched`` and ``single``."""
    worst = 0.0
    for x, y in zip(_leaves(batched), _leaves(single)):
        y = y.expand_as(x[0])
        if x.is_floating_point():
            worst = max(worst, float((x.double() - y.double()[None]).abs().max()))
        else:
            worst = max(worst, float((x != y[None]).sum()))
    return worst


def _feature_input(cfg, data, fi, t0, device, dtype):
    """Frame ``fi``'s FrameInput as the feature path builds it."""
    k, m = cfg.tracker.max_points, cfg.estimator.max_imu_per_interval
    f = data.frames[fi]
    n = min(len(f["ids"]), k)

    def pad(a, sh, size):
        out = np.zeros((size,) + sh)
        out[:min(len(a), size)] = np.asarray(a)[:size]
        return torch.as_tensor(out, dtype=dtype, device=device)

    dt, acc, gyr = sim.imu_between(data, data.cam_ts[fi - 1], data.cam_ts[fi])
    ids = np.full(k, -1, np.int32)
    ids[:n] = f["ids"][:n]
    return est.FrameInput(
        ts=torch.tensor(data.cam_ts[fi] - t0, dtype=dtype, device=device),
        ids=torch.as_tensor(ids, device=device), obs=pad(f["rays"], (3,), k),
        uv=pad(f["uv"], (2,), k), vel=pad(f["vel"], (2,), k),
        valid=torch.as_tensor(np.arange(k) < n, device=device), imu_dt=pad(dt, (), m),
        imu_acc=pad(acc, (3,), m), imu_gyr=pad(gyr, (3,), m),
        imu_cnt=torch.tensor(min(len(dt), m), dtype=torch.int32, device=device))


def run(device="cuda", b: int = 4, dtype=torch.float32, seconds: float = 3.0) -> dict:
    set_full_precision()
    cfg = example.bench_config()
    tcfg = cfg.tracker
    cam = make_camera(cfg.camera, dtype=torch.float64, device="cpu")
    data = sim.simulate(example.bench_sim_config(seconds), cam, cfg.camera.r_ic_mat,
                        cfg.camera.t_ic_vec)
    rep = lambda x: batch.batch_states([x] * b)     # noqa: E731
    out = {}

    # The tracker over three frames from a fresh state.
    tcam = make_camera(cfg.camera, dtype=dtype, device=device)
    focal = cfg.camera.focal_length
    gen = torch.Generator(device=device).manual_seed(0)
    single = trk.init_tracker_state(tcfg, cfg.camera.height, cfg.camera.width, dtype=dtype,
                                    device=device)
    fleet = rep(single)
    step = torch.func.vmap(lambda s, im, d: trk.detect_and_track(
        s, im, torch.zeros((), dtype=dtype, device=device), tcam, tcfg, focal,
        ransac_draws=d))
    for fi in range(3):
        img = torch.as_tensor(sim.render_frame(data, fi, cam, example.R_IC,
                                               cfg.camera.t_ic_vec), dtype=dtype,
                              device=device)
        draws = torch.randint(0, 1 << 30, (tcfg.ransac_iters, 8), generator=gen,
                              device=device)
        single, s_out = trk.detect_and_track(
            single, img, torch.zeros((), dtype=dtype, device=device), tcam, tcfg, focal,
            ransac_draws=draws)
        fleet, f_out = step(fleet, rep(img), rep(draws))
        out[f"tracker frame {fi}"] = _diff((fleet, f_out), (single, s_out))

    # The estimator on the feature path, from the state after initialization.
    engine = VIOEngine(cfg, device=device, dtype=dtype)
    imu_i, fi = 0, 0
    for fi in range(len(data.frames)):
        while imu_i < len(data.imu_ts) and data.imu_ts[imu_i] <= data.cam_ts[fi] + 1e-9:
            engine.push_imu(data.imu_ts[imu_i], data.imu_acc[imu_i], data.imu_gyr[imu_i])
            imu_i += 1
        f = data.frames[fi]
        res = engine.process_features(data.cam_ts[fi], f["ids"], f["rays"], uv=f["uv"],
                                      vel=f["vel"])
        if res.status == Status.TRACKING:
            break
    if engine.status != Status.TRACKING:
        raise RuntimeError("the sequence ended before TRACKING")
    ps = engine.params
    inp = _feature_input(cfg, data, fi + 1, engine._t0, device, dtype)
    st, kf = est.bookkeeping_step(engine.state, inp, ps)
    st_b, kf_b = torch.func.vmap(lambda s, i: est.bookkeeping_step(s, i, ps))(
        rep(engine.state), rep(inp))
    out["bookkeeping"] = _diff((st_b, kf_b), (st, kf))
    w = st.window
    tab = ft.triangulate(st.table, w.p, w.q, ps.ex_t, ps.ex_q, ps.init_depth, td=st.td)
    tab_b = torch.func.vmap(lambda t, w_, td: ft.triangulate(
        t, w_.p, w_.q, ps.ex_t, ps.ex_q, ps.init_depth, td=td))(rep(st.table), rep(w),
                                                                 rep(st.td))
    out["triangulate"] = _diff(tab_b, tab)
    sp = est.solver_params(ps)
    for n_it in (1, 2):
        one = lm.optimize(w, tab, st.prior, ps.ex_t, ps.ex_q, sp, n_it, td0=st.td)
        many = torch.func.vmap(lambda w_, t, pr, td: lm.optimize(
            w_, t, pr, ps.ex_t, ps.ex_q, sp, n_it, td0=td, host_branch=False))(rep(w), rep(tab), rep(st.prior),
                                                            rep(st.td))
        out[f"LM {n_it} iteration(s), window"] = _diff(many[0], one[0])
    n_it = cfg.estimator.num_iterations
    _, p1, q1, _ = est.solve_and_slide(st, bool(kf), ps, n_it)
    _, pb, qb, _ = torch.func.vmap(lambda s, k: est.solve_and_slide(s, k, ps, n_it))(
        rep(st), rep(kf))
    out["solve_and_slide pose"] = _diff((pb, qb), (p1, q1))
    return dict(device=str(device), batch=b, dtype=str(dtype).replace("torch.", ""),
                keyframe=bool(kf), stages=out)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    print(json.dumps(run(args.device, args.batch, getattr(torch, args.dtype))))


if __name__ == "__main__":
    main()
