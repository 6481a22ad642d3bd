"""Multi-sequence fleet (torch twin of mobile_slam_tpu.parallel.batch).

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

The mesh. The reference shards the sequence axis over a device mesh that
one process drives. This path is bound by the host's dispatch, not by the
card, so one process queueing work for n devices would pay that dispatch n
times per fleet frame. Here the mesh is SPMD over the ranks of a
``torch.distributed`` process group instead, one process per rank (started
by parallel/launch.py): ``make_mesh`` returns a ``RankMesh`` (the group,
this rank, the world size W and this rank's device) when the group has more
than one rank, and a single ``torch.device`` otherwise, whose behaviour is
the one-card fleet's. Under a ``RankMesh``:

* ``shard_batched`` keeps this rank's contiguous slice ``[r B/W, (r+1)
  B/W)`` of every leading axis (``NamedSharding(P(axis))``'s map), its
  generators moved to this rank's device;
* the steps take the state as this rank's shard (``shard_batched``'s, or the
  one a step returned) and the fleet's global inputs, slice the inputs the
  same way, run the vmapped step on the shard and gather the per-frame
  outputs along B, so every rank returns the global (T, B) results while
  the carry stays sharded (JAX's ``out_shardings``). The gather is one
  ``all_gather`` per call: on the device over NCCL, or on a host copy over
  gloo (ranks that share a card, or the CPU);
* ``fleet_metrics(..., mesh=)`` reduces this rank's shard to the global mean.

What ``vmap`` requires of code on the per-frame path: no host branch on a
tensor (``bool(t)``, ``int(t)``, ``if t``) and no in-place write of a
batched value into a buffer made inside the step (``torch.zeros(...)[i] =
v``): write out of place (``index_put``, ``scatter``, ``torch.cat``).

The entry points run on the device of the tensors they are given.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from mobile_slam_tpu_torch.engine import chunked
from mobile_slam_tpu_torch.engine import estimator as est
from mobile_slam_tpu_torch.frontend import tracker as trk


class RankMesh(NamedTuple):
    """The fleet's mesh over a process group of more than one rank: this
    rank holds sequences ``[rank B/world, (rank+1) B/world)`` on ``device``."""

    group: dist.ProcessGroup
    rank: int
    world: int
    device: torch.device
    axis: str = "seq"


def _card() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: give devices=['cpu'] (one per rank) for a fleet "
                           "on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def make_mesh(devices=None, axis: str = "seq"):
    """The fleet's mesh. Under an initialized ``torch.distributed`` group of
    W > 1 ranks: a ``RankMesh`` on this rank's device (``devices[rank]``
    when ``devices``, of length W, is given; else the current CUDA device).
    Otherwise one device: ``devices`` is None (the current CUDA device) or
    a sequence of one device. Several devices without such a group raise:
    each rank is its own process (parallel/launch.py)."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if devices is not None:
        devices = list(devices)
        if world > 1 and len(devices) != world:
            raise ValueError(f"{len(devices)} devices for a group of {world} ranks")
        if world == 1 and len(devices) != 1:
            raise RuntimeError(
                f"a mesh over {len(devices)} devices needs an initialized torch.distributed "
                f"group of {len(devices)} ranks, one process each: run the fleet as "
                f"parallel.launch.run_ranks(fn, {len(devices)}), where fn(rank, world) calls "
                "make_mesh")
    if world > 1:
        rank = dist.get_rank()
        device = _card() if devices is None else torch.device(devices[rank])
        return RankMesh(dist.group.WORLD, rank, world, device, axis)
    return _card() if devices is None else torch.device(devices[0])


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


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, tuple):
        for x in tree:
            yield from _leaves(x)


def _move_generator(g: torch.Generator, device: torch.device) -> torch.Generator:
    """``g`` on ``device``, its state carried over (between devices of one
    type: a CPU and a CUDA generator draw different streams)."""
    if g.device == device:
        return g
    if g.device.type != device.type:
        raise ValueError(f"a generator on {g.device} cannot move to {device}: its draws "
                         "would differ; make it on the rank's device")
    moved = torch.Generator(device=device)
    moved.set_state(g.get_state())
    return moved


def _slice(tree, mesh: RankMesh, dim: int):
    """This rank's contiguous share of axis ``dim`` of every tensor (and of
    every tuple of per-sequence generators), on its device."""
    if isinstance(tree, torch.Tensor):
        n = tree.shape[dim]
        if n % mesh.world:
            raise ValueError(f"a fleet of {n} sequences does not split over {mesh.world} ranks")
        k = n // mesh.world
        return tree.narrow(dim, mesh.rank * k, k).to(mesh.device)
    if isinstance(tree, tuple) and tree and all(isinstance(g, torch.Generator) for g in tree):
        if len(tree) % mesh.world:
            raise ValueError(f"{len(tree)} generators do not split over {mesh.world} ranks")
        k = len(tree) // mesh.world
        mine = tree[mesh.rank * k:(mesh.rank + 1) * k]
        return tuple(_move_generator(g, mesh.device) for g in mine)
    if isinstance(tree, tuple):
        fields = [_slice(x, mesh, dim) for x in tree]
        return type(tree)(*fields) if hasattr(tree, "_fields") else tuple(fields)
    return tree


def shard_batched(tree, mesh, axis: str = "seq"):
    """Place a batched tree on the fleet's mesh. On one device: every tensor
    leaf ``.to(mesh)``, generators stay where they were made. Under a
    ``RankMesh``: this rank's slice of every leading axis and of every
    tuple of generators, on its device; raises when B is not a multiple of
    the world size."""
    del axis
    if isinstance(mesh, RankMesh):
        return _slice(tree, mesh, 0)
    if isinstance(tree, torch.Tensor):
        return tree.to(mesh)
    if isinstance(tree, tuple) and not isinstance(tree, torch.Size):
        fields = [shard_batched(x, mesh) for x in tree]
        return type(tree)(*fields) if hasattr(tree, "_fields") else tuple(fields)
    return tree


def _on(mesh, state, inputs, dim: int):
    """A step's (state, inputs) on this rank: under a ``RankMesh`` the state
    is this rank's shard already and the inputs are the fleet's, sliced
    along their sequence axis ``dim``."""
    if mesh is None:
        return state, inputs
    if not isinstance(mesh, RankMesh):
        return shard_batched(state, mesh), shard_batched(inputs, mesh)
    b, n = next(_leaves(state)).shape[0], next(_leaves(inputs)).shape[dim]
    if n != b * mesh.world:
        raise ValueError(
            f"the state holds {b} sequences and the inputs {n} over {mesh.world} ranks: pass "
            "this rank's shard of the state (shard_batched, or the state a step returned) "
            "and the fleet's inputs")
    return shard_batched(state, mesh.device), _slice(inputs, mesh, dim)


def _host_collectives(mesh: RankMesh) -> bool:
    return dist.get_backend(mesh.group) != "nccl"


def _gather(mesh, outs: tuple, dim: int) -> tuple:
    """The fleet's outputs on every rank: each rank's (.., B/W, ..) outputs
    gathered along the sequence axis ``dim`` in rank order, in one
    ``all_gather`` (every output packed as float64 columns, which holds
    float32 and bool values exactly)."""
    if not isinstance(mesh, RankMesh):
        return outs
    rows = [x.movedim(dim, 0) for x in outs]
    b = rows[0].shape[0]
    packed = torch.cat([r.reshape(b, -1).to(torch.float64) for r in rows], dim=1)
    if _host_collectives(mesh):
        packed = packed.cpu()
    parts = [torch.empty_like(packed) for _ in range(mesh.world)]
    dist.all_gather(parts, packed, group=mesh.group)
    full = torch.cat(parts).to(mesh.device)
    out, col = [], 0
    for r, x in zip(rows, outs):
        n = r[0].numel()
        out.append(full[:, col:col + n].reshape(-1, *r.shape[1:]).movedim(0, dim).to(x.dtype))
        col += n
    return tuple(out)


def _feature_step(params: est.StaticParams, num_iterations: int):
    """bookkeeping + solve + slide of one sequence, the keyframe branch
    selected on the device."""

    def one(state, inp):
        state, is_kf = est.bookkeeping_step(state, inp, params)
        state, p, q, diag = est.solve_and_slide(state, is_kf, params, num_iterations)
        return state, (p, q, chunked._frame_ok(diag), diag.is_keyframe)

    return torch.func.vmap(one)


def make_batched_step(params: est.StaticParams, num_iterations: int,
                      mesh: torch.device | RankMesh | None = None, axis: str = "seq"):
    """Fleet step: vmapped (bookkeeping + solve + slide) over the sequence
    axis. Returns fn(batched_state, batched FrameInput) -> (batched_state,
    (p (B, 3), q (B, 4), ok (B,))). With a ``RankMesh`` (here and in the
    chunk steps) the state in and out is this rank's shard, the inputs and
    the outputs are the fleet's."""
    vone = _feature_step(params, num_iterations)

    def step(state, inp):
        state, (p, q, ok, _) = vone(*_on(mesh, state, inp, 0))
        return state, _gather(mesh, (p, q, ok), 0)

    return step


def make_batched_chunked_step(params: est.StaticParams, num_iterations: int,
                              mesh: torch.device | RankMesh | None = None, axis: str = "seq"):
    """Fleet feature-path serving: a loop over a T-frame chunk of the
    vmapped step. Returns fn(batched_state, FrameInput with leading (T, B))
    -> (batched_state, (p (T, B, 3), q (T, B, 4), ok (T, B), is_kf (T, B)))."""
    vone = _feature_step(params, num_iterations)

    def chunk(state, inputs):
        state, inputs = _on(mesh, state, inputs, 1)
        outs = []
        for t in range(inputs.ts.shape[0]):
            state, out = vone(state, chunked._unstack(inputs, t))
            outs.append(out)
        return state, _gather(mesh, tuple(torch.stack(x) for x in zip(*outs)), 1)

    return chunk


def make_batched_image_step(params: est.StaticParams, num_iterations: int,
                            tracker_cfg, camera, focal: float,
                            mesh: torch.device | RankMesh | None = None, axis: str = "seq"):
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
    (engine/chunked.py). ``ransac_draws`` replaces them (the fleet's, sliced
    like the inputs under a ``RankMesh``)."""
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
        carry, inputs = _on(mesh, carry, inputs, 1)
        if ransac_draws is not None and isinstance(mesh, RankMesh):
            ransac_draws = _slice(ransac_draws, mesh, 1)
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
        return carry, _gather(mesh, tuple(torch.stack(x) for x in zip(*outs)), 1)

    return chunk


def fleet_metrics(batched_p: torch.Tensor, gt_p: torch.Tensor, mesh=None) -> torch.Tensor:
    """Mean position error across the fleet. Under a ``RankMesh`` the
    poses are this rank's shard and the mean is the fleet's: one
    ``all_reduce`` of the sum and the count."""
    err = torch.linalg.vector_norm(batched_p - gt_p, dim=-1)
    if not isinstance(mesh, RankMesh):
        return torch.mean(err)
    red = torch.stack([err.sum(), err.new_tensor(err.numel())])
    if _host_collectives(mesh):
        red = red.cpu()
    dist.all_reduce(red, group=mesh.group)
    return (red[0] / red[1]).to(mesh.device)
