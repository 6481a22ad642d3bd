"""Multi-rank dry run of the fleet (torch twin of
``__graft_entry__.dryrun_multichip``).

``dryrun_multichip(n)`` starts n ranks (parallel/launch.py) and runs three
checks on every rank of the group, float32 as the reference runs them:

1. ``tiny_config``: B = n sequences (``make_example_state(seed=s)``), one
   ``make_batched_step`` over the ranks' mesh: the gathered poses are
   finite, of shape (n, 3).
2. The landmark-sharded ``tp_damped_step`` over the same group against
   ``lm._solve_damped`` on the unsharded equations of sequence 0, at the
   reference's damping 1e-2 and its bars (rtol 5e-4, atol 5e-6). It needs
   collectives on this rank's tensors: NCCL on distinct cards, or gloo on
   the CPU; ranks that share a card (gloo over CUDA tensors, which has no
   ``all_gather_into_tensor``) skip it and say so.
3. ``production_config``: B = n, one step over the mesh, then ``reps``
   steps timed, against the same B on one rank (rank 0, the others
   waiting). The ratio is the host-parallel speedup of the ranks: the step
   is bound by the host's dispatch, and each rank dispatches its own share.

Rank 0 prints the reference's lines and the call returns rank 0's figures,
with whether any rank had imported ``jax`` or the JAX package.
"""

from __future__ import annotations

import sys
import time

import torch
import torch.distributed as dist

from mobile_slam_tpu_torch.engine import estimator as est
from mobile_slam_tpu_torch.engine.example import make_example_state, production_config, tiny_config
from mobile_slam_tpu_torch.factors.imu_factor import sqrt_info_from_cov
from mobile_slam_tpu_torch.models.state import eligible_mask
from mobile_slam_tpu_torch.parallel import batch, launch, tp_solver
from mobile_slam_tpu_torch.solver import assembly, lm

DTYPE = torch.float32
TP_MU = 1e-2        # the reference's damping: the toy state's reduced system is PSD
TP_RTOL, TP_ATOL = 5e-4, 5e-6


def _fleet(cfg, params, n, device):
    states, inps = zip(*[make_example_state(cfg, params, DTYPE, seed=s, device=device)
                         for s in range(n)])
    return batch.batch_states(list(states)), batch.batch_states(list(inps))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tp_check(cfg, params, mesh):
    st, _ = make_example_state(cfg, params, DTYPE, seed=0, device=mesh.device)
    w = st.window
    lam_mask = eligible_mask(st.table)
    x = assembly.XState(p=w.p, q=w.q, v=w.v, ba=w.ba, bg=w.bg,
                        lam=torch.where(lam_mask, 1.0 / 5.0, 1.0).to(DTYPE),
                        td=torch.zeros((), dtype=DTYPE, device=mesh.device))
    sqrt_i = sqrt_info_from_cov(w.pre.cov[1:])
    valid_i = (w.pre.sum_dt[1:] < 10.0) & (w.imu_cnt[1:] > 0)
    proj_valid = assembly.proj_valid_mask(st.table)
    prior_H0 = st.prior.J0.T @ st.prior.J0
    sp = est.solver_params(params)
    mu = torch.tensor(TP_MU, dtype=DTYPE, device=mesh.device)
    eqs = assembly.build_normal_eqs(x, st.table, w.pre, sqrt_i, valid_i, st.prior, prior_H0,
                                    params.ex_t, params.ex_q, sp, proj_valid)
    dx_ref, dlam_ref = lm._solve_damped(eqs, mu, lam_mask)

    r, n = mesh.rank, mesh.world
    dx, dlam, _ = tp_solver.tp_damped_step(
        x._replace(lam=tp_solver.shard_landmarks(x.lam, r, n)),
        tp_solver.shard_landmarks(st.table, r, n), w.pre, sqrt_i, valid_i, st.prior,
        prior_H0, params.ex_t, params.ex_q, sp, tp_solver.shard_landmarks(proj_valid, r, n),
        tp_solver.shard_landmarks(lam_mask, r, n), mu, group=mesh.group)
    want = (dx_ref, tp_solver.shard_landmarks(dlam_ref, r, n))
    if not bool(torch.isfinite(dx).all()):
        raise AssertionError("the sharded solve produced non-finite values")
    for name, got, ref in (("dx", dx, want[0]), ("dlam", dlam, want[1])):
        if not torch.allclose(got, ref, rtol=TP_RTOL, atol=TP_ATOL):
            raise AssertionError(f"rank {r}: sharded {name} differs from the unsharded solve "
                                 f"by {float((got - ref).abs().max())}")
    return float(torch.linalg.vector_norm(dx))


def run_checks(rank: int, world: int, device: str = "cuda", reps: int = 3) -> dict:
    """The three checks on this rank of an initialized group of ``world``
    ranks; raises on a failed check."""
    mesh = batch.make_mesh(None if torch.device(device).type == "cuda" else [device] * world)
    if not isinstance(mesh, batch.RankMesh):    # a group of one rank: make_mesh gives its device
        mesh = batch.RankMesh(dist.group.WORLD, rank, world, mesh, "seq")
    lead = rank == 0
    out = {}

    cfg = tiny_config()
    params = est.make_params(cfg, dtype=DTYPE, device=mesh.device)
    state, inp = _fleet(cfg, params, world, mesh.device)
    step = batch.make_batched_step(params, cfg.estimator.num_iterations, mesh=mesh)
    _, (p, _, _) = step(batch.shard_batched(state, mesh), inp)
    if p.shape != (world, 3) or not bool(torch.isfinite(p).all()):
        raise AssertionError(f"rank {rank}: fleet poses {tuple(p.shape)}, "
                             f"finite {bool(torch.isfinite(p).all())}")
    out["poses"] = p.cpu()
    if lead:
        print(f"dryrun_multichip OK: {world} sequences over {world}-rank mesh, poses finite",
              flush=True)

    if dist.get_backend(mesh.group) == "nccl" or mesh.device.type == "cpu":
        out["tp_dx_norm"] = _tp_check(cfg, params, mesh)
        if lead:
            print(f"dryrun_multichip OK: landmark-sharded TP solve over {world}-rank group "
                  f"matches unsharded (|dx|={out['tp_dx_norm']:.3e})", flush=True)
    else:
        out["tp_dx_norm"] = None
        if lead:
            print(f"dryrun_multichip: landmark-sharded TP solve not run: the {world} ranks "
                  f"share {torch.cuda.device_count()} card(s) over gloo, which has no "
                  "all_gather_into_tensor on CUDA tensors (NCCL needs a card per rank)",
                  flush=True)

    pcfg = production_config()
    pparams = est.make_params(pcfg, dtype=DTYPE, device=mesh.device)
    n_it = pcfg.estimator.num_iterations
    state, inp = _fleet(pcfg, pparams, world, mesh.device)
    pstep = batch.make_batched_step(pparams, n_it, mesh=mesh)
    st, (p, _, _) = pstep(batch.shard_batched(state, mesh), inp)
    if p.shape != (world, 3) or not bool(torch.isfinite(p).all()):
        raise AssertionError(f"rank {rank}: production-shape poses not finite")
    st = batch.shard_batched(state, mesh)
    _sync(mesh.device)
    t0 = time.perf_counter()
    for _ in range(reps):
        st, (p, _, _) = pstep(st, inp)
    _sync(mesh.device)
    out["mesh_ms"] = 1e3 * (time.perf_counter() - t0) / reps
    dist.barrier(group=mesh.group)
    if lead:
        one = batch.make_batched_step(pparams, n_it)
        one(state, inp)
        s_t = state
        _sync(mesh.device)
        t0 = time.perf_counter()
        for _ in range(reps):
            s_t, (p1, _, _) = one(s_t, inp)
        _sync(mesh.device)
        out["single_ms"] = 1e3 * (time.perf_counter() - t0) / reps
        out["speedup"] = out["single_ms"] / out["mesh_ms"]
        print(f"dryrun_multichip OK: PRODUCTION-shape ({pcfg.estimator.max_features} feat, "
              f"{pcfg.tracker.max_points} pts, {pcfg.estimator.max_imu_per_interval} imu, "
              f"{n_it} iters) B={world} step over {world}-rank mesh {out['mesh_ms']:.1f} ms "
              f"vs one rank {out['single_ms']:.1f} ms -> host-parallel speedup "
              f"{out['speedup']:.2f}x ({reps} reps; {world}.0 = every rank's dispatch in "
              "parallel)", flush=True)
    dist.barrier(group=mesh.group)
    out["jax_imported"] = "jax" in sys.modules
    out["reference_imported"] = any(m == "mobile_slam_tpu" or m.startswith("mobile_slam_tpu.")
                                    for m in sys.modules)
    return out


def dryrun_multichip(n_devices: int, device: str = "cuda", reps: int = 3) -> dict:
    """The three checks on ``n_devices`` spawned ranks; rank 0's figures,
    the import flags over every rank."""
    ranks = launch.run_ranks(run_checks, n_devices, device, reps, device=device)
    out = ranks[0]
    for k in ("jax_imported", "reference_imported"):
        out[k] = any(r[k] for r in ranks)
    return out
