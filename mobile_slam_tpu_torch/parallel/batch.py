"""Multi-sequence fleet on one card (torch twin of
mobile_slam_tpu.parallel.batch).

B independent VIO sequences advance together, one frame per step: the
estimator state is a tuple of fixed-shape tensors, so a fleet is a leading
batch axis and one step is ``torch.func.vmap`` of the single-sequence step.
Every operation on the per-frame path then runs once for the whole fleet:

* the keyframe branch of ``solve_and_slide`` is taken on the device (both
  branches computed, one selected per sequence), as ``lax.cond`` is under
  ``jax.vmap``;
* the LK kernels K1-K3 (ops/lk.py) are custom ops whose vmap rule makes ONE
  launch over all B x K point slots on the card (a plain-version loop over
  the sequences on the CPU);
* the chunk loops (``make_batched_chunked_step``, ``make_batched_image_step``)
  are Python loops over the T frames of the vmapped step, as
  engine/chunked.py is for one sequence.

The reference shards the batch axis over a TPU mesh. On one card the mesh
reduces to a single ``torch.device``: ``make_mesh`` returns it and
``shard_batched`` moves every tensor leaf there. A fleet spread over
several cards is not built here; parallel/tp_solver.py spreads one
sequence's solve over the ranks of a process group instead.

What ``vmap`` requires of code on the per-frame path: no host branch on a
tensor (``bool(t)``, ``int(t)``, ``if t``) and no in-place write of a
batched value into a buffer made inside the step (``torch.zeros(...)[i] =
v``): write out of place (``index_put``, ``scatter``, ``torch.cat``).

The entry points run on the device of the tensors they are given.
"""

from __future__ import annotations

import torch

from mobile_slam_tpu_torch.engine import chunked
from mobile_slam_tpu_torch.engine import estimator as est
from mobile_slam_tpu_torch.frontend import tracker as trk


def make_mesh(devices=None, axis: str = "seq") -> torch.device:
    """The fleet's device. ``devices`` is None (the current CUDA device) or
    a sequence of one device: on one card the reference's mesh over the
    sequence axis is that card. ``axis`` is accepted for the reference's
    signature."""
    del axis
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: give devices=['cpu'] for a fleet on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    devices = list(devices)
    if len(devices) != 1:
        raise NotImplementedError(
            f"a fleet runs on one device here, got {len(devices)}")
    return torch.device(devices[0])


def batch_states(states: list):
    """Stack per-sequence states (or inputs) along a leading batch axis:
    every tensor leaf is stacked; the ``torch.Generator`` of an
    ``ImageChunkCarry`` becomes a tuple of B generators (a generator does
    not stack, and ``vmap`` cannot carry it)."""
    first = states[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(states)
    if isinstance(first, torch.Generator):
        return tuple(states)
    if isinstance(first, tuple):
        fields = [batch_states([s[i] for s in states]) for i in range(len(first))]
        return type(first)(*fields) if hasattr(first, "_fields") else tuple(fields)
    raise TypeError(f"cannot batch a leaf of type {type(first).__name__}")


def shard_batched(tree, mesh: torch.device, axis: str = "seq"):
    """Place a batched tree on the fleet's device: every tensor leaf
    ``.to(mesh)``; generators stay where they were made."""
    del axis
    if isinstance(tree, torch.Tensor):
        return tree.to(mesh)
    if isinstance(tree, tuple) and not isinstance(tree, torch.Size):
        fields = [shard_batched(x, mesh) for x in tree]
        return type(tree)(*fields) if hasattr(tree, "_fields") else tuple(fields)
    return tree


def _on(mesh, *trees):
    return trees if mesh is None else tuple(shard_batched(t, mesh) for t in trees)


def _feature_step(params: est.StaticParams, num_iterations: int):
    """bookkeeping + solve + slide of one sequence, the keyframe branch
    selected on the device."""

    def one(state, inp):
        state, is_kf = est.bookkeeping_step(state, inp, params)
        state, p, q, diag = est.solve_and_slide(state, is_kf, params, num_iterations)
        return state, (p, q, chunked._frame_ok(diag), diag.is_keyframe)

    return torch.func.vmap(one)


def make_batched_step(params: est.StaticParams, num_iterations: int,
                      mesh: torch.device | None = None, axis: str = "seq"):
    """Fleet step: vmapped (bookkeeping + solve + slide) over the sequence
    axis. Returns fn(batched_state, batched FrameInput) -> (batched_state,
    (p (B, 3), q (B, 4), ok (B,)))."""
    vone = _feature_step(params, num_iterations)

    def step(state, inp):
        state, (p, q, ok, _) = vone(*_on(mesh, state, inp))
        return state, (p, q, ok)

    return step


def make_batched_chunked_step(params: est.StaticParams, num_iterations: int,
                              mesh: torch.device | None = None, axis: str = "seq"):
    """Fleet feature-path serving: a loop over a T-frame chunk of the
    vmapped step. Returns fn(batched_state, FrameInput with leading (T, B))
    -> (batched_state, (p (T, B, 3), q (T, B, 4), ok (T, B), is_kf (T, B)))."""
    vone = _feature_step(params, num_iterations)

    def chunk(state, inputs):
        state, inputs = _on(mesh, state, inputs)
        outs = []
        for t in range(inputs.ts.shape[0]):
            state, out = vone(state, chunked._unstack(inputs, t))
            outs.append(out)
        return state, tuple(torch.stack(x) for x in zip(*outs))

    return chunk


def make_batched_image_step(params: est.StaticParams, num_iterations: int,
                            tracker_cfg, camera, focal: float,
                            mesh: torch.device | None = None, axis: str = "seq"):
    """Fleet full-image-path step: B sequences' complete per-frame pipelines
    (CLAHE -> pyramid -> LK -> F-RANSAC -> refill -> solve,
    engine/chunked.make_image_frame_step) vmapped, over a T-frame chunk.

    Returns fn(carry_B, inputs_TB, ransac_draws=None) -> (carry_B, (p (T,
    B, 3), q (T, B, 4), ok (T, B), is_kf (T, B))), where carry_B is
    ``batch_states`` of B ``ImageChunkCarry`` (its ``gen`` a tuple of B
    generators) and inputs_TB an ``ImageFrameInput`` with leading (T, B).
    Before the loop: ``preprocess_frame`` of all T x B frames, and the RANSAC
    draws (T, B, iters, 8), sequence b's (T, iters, 8) from its own
    generator in one call, as its single-stream chunk would draw them
    (engine/chunked.py). ``ransac_draws`` replaces them."""
    one_frame = chunked.make_image_frame_step(params, num_iterations, tracker_cfg,
                                              camera, focal, host_branch=False)

    gen_at = chunked.ImageChunkCarry._fields.index("gen")

    def frame(core, inp, pre, draws):       # core: the carry less its generator
        carry, out = one_frame(chunked.ImageChunkCarry(*core[:gen_at], None,
                                                       *core[gen_at:]), inp, pre, draws)
        return carry[:gen_at] + carry[gen_at + 1:], out

    vone = torch.func.vmap(frame)
    vpre = torch.func.vmap(lambda img: trk.preprocess_frame(img, tracker_cfg))

    def chunk(carry, inputs, ransac_draws=None):
        carry, inputs = _on(mesh, carry, inputs)
        n, b = inputs.img.shape[:2]
        pre = vpre(inputs.img.flatten(0, 1))
        pre = (pre[0].unflatten(0, (n, b)), tuple(lv.unflatten(0, (n, b)) for lv in pre[1]),
               pre[2].unflatten(0, (n, b)))
        if ransac_draws is None:
            ransac_draws = torch.stack([
                torch.randint(0, 1 << 30, (n, tracker_cfg.ransac_iters, 8), generator=g,
                              device=inputs.img.device) for g in carry.gen], dim=1)
        core, outs = carry[:gen_at] + carry[gen_at + 1:], []
        for t in range(n):
            core, out = vone(core, chunked._unstack(inputs, t),
                             (pre[0][t], tuple(lv[t] for lv in pre[1]), pre[2][t]),
                             ransac_draws[t])
            outs.append(out)
        carry = chunked.ImageChunkCarry(*core[:gen_at], carry.gen, *core[gen_at:])
        return carry, tuple(torch.stack(x) for x in zip(*outs))

    return chunk


def fleet_metrics(batched_p: torch.Tensor, gt_p: torch.Tensor) -> torch.Tensor:
    """Mean position error across the fleet."""
    return torch.mean(torch.linalg.vector_norm(batched_p - gt_p, dim=-1))
