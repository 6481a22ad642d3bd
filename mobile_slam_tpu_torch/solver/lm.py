"""Sliding-window Levenberg-Marquardt with landmark Schur complement (torch
twin of mobile_slam_tpu.solver.lm): each iteration builds the normal
equations, solves a near-Gauss-Newton and a conservative Marquardt
candidate and keeps the one that lowers the robust cost more.

The reference's three step options are module globals with its names and
defaults, read at call time (the port is eager, so nothing retraces):

* ``GREEDY_GN``: the Marquardt candidate is evaluated only when the
  Gauss-Newton one did not lower the cost.
* ``BATCH_CANDIDATES``: both candidates in one ``torch.func.vmap`` of the
  damped solve and one of the cost.
* ``EARLY_EXIT_FTOL``: stop once an accepted step improves the cost by less
  than ftol (relative); None runs the fixed count.

The reference writes two of them as device control flow (``lax.cond``,
``while_loop``), which ``jax.vmap`` turns into a select and a masked loop.
``solve`` takes both forms, chosen by ``host_branch`` as ``solve_and_slide``
chooses its keyframe branch: True reads the decision on the host (one read
per iteration, counted in ``counts``) and skips the work; False computes
both sides and selects on the device, and runs the full count with a
per-sequence ``done`` flag that freezes the carry (the form ``vmap`` needs).

After the loop: NaN rollback, the 4-dof gauge fix of frame 0, the decoupled
td innovation (a scalar Gauss-Newton step on the projection cost at the
solved state, ``assembly.td_grad_hess``), depth write-back and
reprojection-error outlier culling.

``optimize`` is a few thousand small kernels whose launches, not their
work, set its time on the card. Where nothing in a call reads the device
from the host or needs eager dispatch (``why_eager``), it runs as a CUDA
graph: captured once per key (device, each input's shape and type, the
iteration count, ``host_branch``, the three options, the calling thread)
into a process-wide cache, then replayed, the caller's tensors copied into
the graph's static inputs and its outputs cloned out. The kernels are those
of the eager call; the IMU factors' batched Cholesky solve (MAGMA, which a
capture refuses) runs eagerly just before the replay. ``graph_counts``
counts captures, replays and eager calls; ``last_form()`` says which the
calling thread's last call was.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from mobile_slam_tpu_torch.config import NUM_SLOTS
from mobile_slam_tpu_torch.solver import layout
from mobile_slam_tpu_torch.factors.imu_factor import sqrt_info_from_cov
from mobile_slam_tpu_torch.models.state import FeatureTable, WindowState, eligible_mask
from mobile_slam_tpu_torch.solver import assembly
from mobile_slam_tpu_torch.solver.assembly import Prior, SolverParams, XState
from mobile_slam_tpu_torch.utils import rotations as rot
from mobile_slam_tpu_torch.utils.linalg import cholesky_or_nan, median, tree_where

W = NUM_SLOTS
S = layout.S
NSOLVE = layout.EX_COL
OUTLIER_REPROJ_WHITENED = 2.0

GREEDY_GN = False
BATCH_CANDIDATES = False
EARLY_EXIT_FTOL: float | None = None

# LM iterations run and host reads made by the host forms of GREEDY_GN and
# EARLY_EXIT_FTOL since the last reset_counts() (python counters, no sync).
counts = {"iterations": 0, "host_reads": 0}
# optimize calls that captured a CUDA graph, replayed one, or ran eagerly,
# since the last reset_counts().
graph_counts = {"captures": 0, "replays": 0, "eager": 0}
# Eager runs of optimize on the capture stream before its capture, so that
# cuBLAS and cuSOLVER make their handles and workspaces outside it.
GRAPH_WARMUP = 3


def reset_counts() -> None:
    for d in (counts, graph_counts):
        for k in d:
            d[k] = 0


class SolveResult(NamedTuple):
    x: XState
    cost0: torch.Tensor
    cost: torch.Tensor
    accepted: torch.Tensor
    # td observability: Gauss-Newton curvature of the projection cost in td
    # at the solved state, the scalar step -g/h (0 with td off) and the
    # total robust weight behind the curvature.
    td_info: torch.Tensor
    td_innov: torch.Tensor
    td_wsum: torch.Tensor


def _retract(x: XState, dx, dlam, lam_mask) -> XState:
    dpose = dx[0:layout.POSE_COLS].reshape(W, 6)
    dsb = dx[layout.POSE_COLS:layout.TD_COL].reshape(W, 9)
    return XState(p=x.p + dpose[:, 0:3], q=rot.quat_boxplus(x.q, dpose[:, 3:6]),
                  v=x.v + dsb[:, 0:3], ba=x.ba + dsb[:, 3:6], bg=x.bg + dsb[:, 6:9],
                  lam=x.lam + torch.where(lam_mask, dlam, torch.zeros_like(dlam)),
                  td=x.td + dx[layout.TD_COL])


def _solve_damped(eqs: assembly.NormalEqs, mu, lam_mask):
    """One damped Schur-complement solve: (dx (166,), dlam (F,))."""
    H = eqs.H_ss[:NSOLVE, :NSOLVE]
    g = eqs.g_s[:NSOLVE]
    H_sl = eqs.H_sl[:NSOLVE]
    diag = torch.diagonal(H)
    floor = 1e-7 * median(diag) + 1e-10
    H_d = H + torch.diag(mu * diag + floor)
    hll = eqs.H_ll * (1.0 + mu) + 1e-6 * median(eqs.H_ll) + 1e-12
    hll = torch.where(lam_mask, hll, torch.ones_like(hll))
    inv_hll = 1.0 / hll
    lm = lam_mask.to(H.dtype)
    H_red = H_d - (H_sl * (inv_hll * lm)[None, :]) @ H_sl.T
    g_red = g - H_sl @ (inv_hll * eqs.g_l * lm)
    d = torch.sqrt(torch.clamp(torch.diagonal(H_red), min=1e-12))
    Hn = H_red / (d[:, None] * d[None, :])
    L = cholesky_or_nan(Hn)
    dx = -torch.cholesky_solve((g_red / d)[:, None], L)[:, 0] / d
    dlam = -(eqs.g_l + H_sl.T @ dx) * inv_hll
    return dx, dlam


def solve(x0: XState, table: FeatureTable, window: WindowState, prior: Prior,
          ex_t, ex_q, params: SolverParams, num_iterations: int,
          mu_init: float = 1e-8, host_branch: bool = True, *,
          imu_sqrt_info=None) -> SolveResult:
    """The LM loop; ``host_branch`` picks the form of the step options
    (module docstring). ``imu_sqrt_info``: the IMU factors' square-root
    information, computed here from the window when None."""
    greedy, batched, ftol = GREEDY_GN, BATCH_CANDIDATES, EARLY_EXIT_FTOL
    dtype = x0.p.dtype
    if imu_sqrt_info is None:
        imu_sqrt_info = sqrt_info_from_cov(window.pre.cov[1:])
    imu_valid = (window.pre.sum_dt[1:] < 10.0) & (window.imu_cnt[1:] > 0)
    proj_valid = assembly.proj_valid_mask(table)
    lam_mask = eligible_mask(table)
    prior_H0 = prior.J0.T @ prior.J0

    def cost_fn(x):
        return assembly.total_cost(x, table, window.pre, imu_sqrt_info,
                                   imu_valid, prior, ex_t, ex_q, params, proj_valid)

    mu_b = torch.full((), 1e-4, dtype=dtype, device=x0.p.device)

    def candidate(x, eqs, mu):
        dx, dlam = _solve_damped(eqs, mu, lam_mask)
        x_c = _retract(x, dx, dlam, lam_mask)
        return x_c, cost_fn(x_c)

    def step(x, cost, mu):
        eqs = assembly.build_normal_eqs(x, table, window.pre, imu_sqrt_info,
                                        imu_valid, prior, prior_H0, ex_t, ex_q,
                                        params, proj_valid)
        if batched and not greedy:
            xs, costs = torch.func.vmap(lambda m: candidate(x, eqs, m))(
                torch.stack([mu, mu_b]))
            x_a, x_b = XState(*[t[0] for t in xs]), XState(*[t[1] for t in xs])
            cost_a, cost_b = costs[0], costs[1]
        else:
            x_a, cost_a = candidate(x, eqs, mu)
            good_a = (torch.isfinite(cost_a) & (cost_a < cost)) if greedy else None
            if greedy and host_branch:
                counts["host_reads"] += 1
                x_b, cost_b = ((x_a, cost_a) if bool(good_a)
                               else candidate(x, eqs, mu_b))
            else:
                x_b, cost_b = candidate(x, eqs, mu_b)
                if greedy:
                    x_b = tree_where(good_a, x_a, x_b)
                    cost_b = torch.where(good_a, cost_a, cost_b)
        use_a = torch.isfinite(cost_a) & (
            cost_a <= torch.where(torch.isfinite(cost_b), cost_b, inf))
        x_new = tree_where(use_a, x_a, x_b)
        cost_new = torch.where(use_a, cost_a, cost_b)
        ok = torch.isfinite(cost_new) & (cost_new < cost)
        mu = torch.where(ok & use_a, torch.clamp(mu * 0.25, min=1e-12),
                         torch.where(ok, mu, torch.clamp(mu * 10.0, max=1e4)))
        return (tree_where(ok, x_new, x), torch.where(ok, cost_new, cost), mu,
                ok)

    cost0 = cost_fn(x0)
    inf = torch.full_like(cost0, float("inf"))
    x, cost = x0, cost0
    mu = torch.full((), mu_init, dtype=dtype, device=x0.p.device)
    n_acc = torch.zeros((), dtype=torch.int32, device=x0.p.device)
    done = torch.zeros((), dtype=torch.bool, device=x0.p.device)
    for _ in range(num_iterations):
        counts["iterations"] += 1
        x_n, cost_n, mu_n, ok = step(x, cost, mu)
        n_acc_n = n_acc + ok.to(torch.int32)
        if ftol is None:
            x, cost, mu, n_acc = x_n, cost_n, mu_n, n_acc_n
            continue
        # Converged: an accepted step whose relative improvement fell below
        # ftol (Ceres function_tolerance); a rejected step keeps iterating.
        stop = ok & ((cost - cost_n) / torch.clamp(cost, min=1e-30) < ftol)
        if host_branch:
            x, cost, mu, n_acc = x_n, cost_n, mu_n, n_acc_n
            counts["host_reads"] += 1
            if bool(stop):
                break
        else:
            x = tree_where(done, x, x_n)
            cost = torch.where(done, cost, cost_n)
            mu = torch.where(done, mu, mu_n)
            n_acc = torch.where(done, n_acc, n_acc_n)
            done = done | stop
    zero = torch.zeros((), dtype=dtype, device=x0.p.device)
    return SolveResult(x=x, cost0=cost0, cost=cost, accepted=n_acc,
                       td_info=zero, td_innov=zero, td_wsum=zero)


def apply_gauge_fix(x: XState, p0_old, q0_old) -> XState:
    """Rotate the solution so frame-0 yaw and position keep their pre-solve
    values (applyOptimizationResults, with the euler-singularity case)."""
    r0_old = rot.quat_to_rot(q0_old)
    r0_new = rot.quat_to_rot(x.q[0])
    ypr_old = rot.r2ypr(r0_old)
    ypr_new = rot.r2ypr(r0_new)
    y_diff = ypr_old[0] - ypr_new[0]
    zero = torch.zeros_like(y_diff)
    rot_diff = rot.ypr2r(torch.stack([y_diff, zero, zero]))
    singular = ((torch.abs(torch.abs(ypr_old[1]) - 90.0) < 1.0)
                | (torch.abs(torch.abs(ypr_new[1]) - 90.0) < 1.0))
    rot_diff = torch.where(singular, r0_old @ r0_new.T, rot_diff)
    q_diff = rot.rot_to_quat(rot_diff)
    return XState(p=(x.p - x.p[0:1]) @ rot_diff.T + p0_old,
                  q=rot.quat_normalize(rot.quat_mul(q_diff[None, :], x.q)),
                  v=x.v @ rot_diff.T, ba=x.ba, bg=x.bg, lam=x.lam, td=x.td)


def why_eager(leaves, host_branch: bool, greedy: bool, batched: bool,
              ftol) -> str | None:
    """Why ``optimize`` on these inputs (the leaves of its tensor arguments)
    under these step options must run eagerly, or None when a captured CUDA
    graph can run it: a host read, ``BATCH_CANDIDATES``' batched Cholesky
    solve (MAGMA on the card, which a capture refuses), an input batched or
    differentiated by ``torch.func`` or autograd, or an input off the card."""
    if host_branch and (greedy or ftol is not None):
        return "host read"
    if batched and not greedy:
        return "batched Cholesky solve"
    tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
    if any(torch._C._functorch.is_functorch_wrapped_tensor(t) or t.requires_grad
           for t in tensors):
        return "batched or differentiated"
    if not all(t.is_cuda for t in tensors):
        return "not on CUDA"
    return None


class _Graph:
    """``optimize`` captured for one key: static inputs (the leaves of its
    arguments, then the IMU square-root information), the graph, and for
    each output leaf either the input it passes through unchanged or the
    static output it is cloned from."""

    def __init__(self, leaves, spec, num_iterations: int, host_branch: bool):
        self.thread = threading.current_thread()
        self.device = leaves[0].device
        self.inputs = [t.clone() for t in leaves]

        def run():
            window, table, prior, ex_t, ex_q, params, td0 = tree_unflatten(self.inputs[:-1],
                                                                           spec)
            return _optimize(window, table, prior, ex_t, ex_q, params, num_iterations,
                             td0, host_branch, imu_sqrt_info=self.inputs[-1])

        with torch.cuda.device(self.device):
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                for _ in range(GRAPH_WARMUP):
                    run()
            torch.cuda.current_stream().wait_stream(stream)
            self.graph = torch.cuda.CUDAGraph()
            # thread_local: other threads' engines run on while this one captures.
            with torch.cuda.graph(self.graph, stream=stream, capture_error_mode="thread_local"):
                out = run()
        counts["iterations"] -= (GRAPH_WARMUP + 1) * num_iterations
        out_leaves, self.out_spec = tree_flatten(out)
        passed = {id(t): i for i, t in enumerate(self.inputs)}
        index: dict = {}
        # (True, i): the caller's input leaf i, passed through as the eager
        # call passes it; (False, j): a clone of static output j.
        self.plan, self.outputs = [], []
        for t in out_leaves:
            if id(t) in passed:
                self.plan.append((True, passed[id(t)]))
                continue
            if id(t) not in index:
                index[id(t)] = len(self.outputs)
                self.outputs.append(t)
            self.plan.append((False, index[id(t)]))

    def __call__(self, leaves):
        with torch.cuda.device(self.device):
            for s, t in zip(self.inputs, leaves):
                s.copy_(t)
            self.graph.replay()
            fresh = [t.clone() for t in self.outputs]
        return tree_unflatten([leaves[i] if from_input else fresh[i]
                               for from_input, i in self.plan], self.out_spec)


_graphs: dict = {}
_capture_lock = threading.Lock()   # one capture at a time in the process
_local = threading.local()


def last_form() -> str:
    """How the calling thread's last ``optimize`` ran: "capture", "replay"
    or "eager"."""
    return getattr(_local, "form", "eager")


def optimize(window: WindowState, table: FeatureTable, prior: Prior, ex_t,
             ex_q, params: SolverParams, num_iterations: int, td0=0.0,
             host_branch: bool = True):
    """Solve, NaN rollback, gauge fix, depth write-back and outlier culling.
    Returns (window, table, SolveResult, culled_ids (F,)). ``host_branch``
    as in ``solve``. Replays a captured CUDA graph unless ``why_eager``
    gives a reason (module docstring)."""
    if not isinstance(td0, torch.Tensor):
        td0 = torch.as_tensor(td0, dtype=window.p.dtype, device=window.p.device)
    leaves, spec = tree_flatten((window, table, prior, ex_t, ex_q, params, td0))
    if why_eager(leaves, host_branch, GREEDY_GN, BATCH_CANDIDATES, EARLY_EXIT_FTOL):
        _local.form = "eager"
        graph_counts["eager"] += 1
        return _optimize(window, table, prior, ex_t, ex_q, params, num_iterations,
                         td0, host_branch)
    key = (threading.get_ident(), leaves[0].device, num_iterations, host_branch, GREEDY_GN,
           BATCH_CANDIDATES, EARLY_EXIT_FTOL, tuple((t.shape, t.dtype) for t in leaves))
    # The ten IMU factors' batched Cholesky solve runs through MAGMA, which a
    # capture refuses: it runs eagerly, before the graph, as it would inside.
    leaves.append(sqrt_info_from_cov(window.pre.cov[1:]))
    graph = _graphs.get(key)
    if graph is None:
        with _capture_lock:
            for k in [k for k, g in _graphs.items() if not g.thread.is_alive()]:
                del _graphs[k]
            graph = _graphs[key] = _Graph(leaves, spec, num_iterations, host_branch)
        _local.form = "capture"
        graph_counts["captures"] += 1
    else:
        _local.form = "replay"
        graph_counts["replays"] += 1
    counts["iterations"] += num_iterations
    return graph(leaves)


def _optimize(window: WindowState, table: FeatureTable, prior: Prior, ex_t,
              ex_q, params: SolverParams, num_iterations: int, td0, host_branch: bool,
              imu_sqrt_info=None):
    """``optimize``'s eager body (``imu_sqrt_info`` as in ``solve``)."""
    dtype, dev = window.p.dtype, window.p.device
    elig = eligible_mask(table)
    safe_depth = torch.where(table.depth > 0, table.depth, params.init_depth)
    lam0 = torch.where(elig, 1.0 / safe_depth, torch.ones_like(safe_depth))
    x0 = XState(p=window.p, q=window.q, v=window.v, ba=window.ba, bg=window.bg,
                lam=lam0, td=torch.as_tensor(td0, dtype=dtype, device=dev))
    res = solve(x0, table, window, prior, ex_t, ex_q, params, num_iterations,
                host_branch=host_branch, imu_sqrt_info=imu_sqrt_info)

    finite = torch.stack([torch.all(torch.isfinite(t)) for t in res.x]).all()
    x = tree_where(finite, res.x, x0)
    td = torch.where(params.td_enable > 0,
                     torch.clamp(x.td, -params.td_max, params.td_max), x0.td)
    x = apply_gauge_fix(x._replace(td=td), window.p[0], window.q[0])

    proj_valid = assembly.proj_valid_mask(table)
    g_td, h_td, wsum_td = assembly.td_grad_hess(x, table, ex_t, ex_q, params,
                                                proj_valid)
    innov = torch.where(h_td > 0, -g_td / torch.clamp(h_td, min=1e-6),
                        torch.zeros_like(g_td))
    innov = torch.where(torch.isfinite(innov), innov, torch.zeros_like(innov))
    res = res._replace(td_info=h_td, td_innov=innov * params.td_enable,
                       td_wsum=wsum_td)
    window = window._replace(p=x.p, q=x.q, v=x.v, ba=x.ba, bg=x.bg)

    new_depth = 1.0 / x.lam
    neg = new_depth < 0
    depth = torch.where(elig & ~neg, new_depth, table.depth)

    r_p = assembly._all_residuals(x, table, ex_t, ex_q, params)
    err = torch.linalg.vector_norm(r_p, dim=-1) * proj_valid
    n_obs = torch.clamp(torch.sum(proj_valid, dim=1), min=1)
    mean_err = torch.sum(err, dim=1) / n_obs
    outlier = elig & (mean_err > OUTLIER_REPROJ_WHITENED)
    solve_flag = torch.where(
        elig, torch.where(neg | outlier, 2, 1).to(torch.int32), table.solve_flag)
    culled_ids = torch.where(elig & outlier, table.fid, torch.full_like(table.fid, -1))
    table = table._replace(depth=depth, solve_flag=solve_flag)
    return window, table, res._replace(x=x), culled_ids
