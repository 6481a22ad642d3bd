"""The fleet over the ranks of a process group (parallel/batch.py's
``RankMesh``, parallel/launch.py, parallel/dryrun.py), world 2 over gloo on
the CPU, float64 at ``tiny_config``.

One spawn of two ranks serves the whole file (tests/_torch_ranks.py,
which imports neither JAX nor the JAX package); while it runs, this process
computes the world-1 fleet and the reference. Checked on every rank:

1. The feature fleet at B = 4 (sequence 1 on the keyframe branch, as in
   tests/test_torch_batch.py), a T = 2 chunk through
   ``make_batched_chunked_step`` over the mesh: the gathered (T, B) poses
   within 1e-10 m of the port's world-1 fleet, the ok and keyframe flags
   equal, and within 1e-5 (tests/test_torch_batch.py's bar) of the JAX
   package's ``make_batched_chunked_step`` (mesh None: the same program,
   unsharded). The carry stays sharded: this rank's two sequences, equal
   to theirs in the world-1 carry.
2. A 3-frame image fleet at B = 2 (one sequence per rank) through
   ``make_batched_image_step``, no injected draws: within 1e-10 m of the
   world-1 fleet, each sequence drawing from its own generator (a rank
   keeps its sequence's generator).
3. ``make_mesh`` under the group (and its refusal of a device list of
   another length), ``shard_batched``'s contiguous slices of a tree,
   generators included, and its refusal of a fleet that does not split; a
   step refusing the global state.
4. ``fleet_metrics`` over the group against the global mean at 1e-12.
5. ``dryrun.run_checks`` (``dryrun_multichip``'s three checks).

And: a rank that raises fails the launcher's call.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_ranks import fail_on_rank_one, rank_checks
from tests._torch_parity import F64, example_state, reference_compile_cache, t64, tonp  # noqa: F401
from tests.test_torch_tracker import tracker_sequence

from mobile_slam_tpu.engine.example import tiny_config
from mobile_slam_tpu.engine import estimator as jest
from mobile_slam_tpu.parallel import batch as jbatch
from mobile_slam_tpu_torch import convert
from mobile_slam_tpu_torch.engine import chunked
from mobile_slam_tpu_torch.engine import example as texample
from mobile_slam_tpu_torch.frontend import tracker as trk
from mobile_slam_tpu_torch.models.cameras.base import make_camera
from mobile_slam_tpu_torch.parallel import batch, launch

WORLD = 2
B, T = 4, 2             # feature fleet
B_IMG, T_IMG = 2, 3     # image fleet
POSE_TOL = 1e-5         # port against the reference (tests/test_torch_batch.py)
SELF_TOL = 1e-10        # over the ranks against world 1, float64
L = chunked.GROWTH_WINDOW


def _stack_jax(trees):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


def _later(inp, t):
    return inp._replace(ts=inp.ts + 0.05 * t)


def _image_carry(cfg, t_state, s):
    """Sequence s of the image fleet: a texture translating its own way,
    the tracker warmed on 3 frames, its own generator (seed s); the carry
    and its T_IMG frames' inputs."""
    frames = tracker_sequence(3 + T_IMG, step=((0.9, -0.6), (-0.7, 0.8))[s])
    cam = make_camera(cfg.camera, dtype=F64, device="cpu")
    tst = trk.init_tracker_state(cfg.tracker, cfg.camera.height, cfg.camera.width,
                                 dtype=F64, device="cpu")
    for k in range(3):
        tst, _ = trk.detect_and_track(tst, t64(frames[k]), 0.05 * k, cam, cfg.tracker,
                                      cfg.camera.focal_length,
                                      generator=torch.Generator().manual_seed(k))
    carry = chunked.ImageChunkCarry(
        est_state=t_state, tracker_state=tst,
        banned_ids=torch.full((cfg.estimator.max_features,), -1, dtype=torch.int32),
        gen=torch.Generator().manual_seed(s), depth_ema=t64(0.0), vel_ema=t64(0.05),
        lag_depth=torch.zeros(L, dtype=F64), lag_vel=torch.zeros(L, dtype=F64),
        lag_i=torch.tensor(0, dtype=torch.int32))
    return carry, [t64(f) for f in frames[3:]]


def _time_major(trees):
    stacked = batch.batch_states(trees)                  # (B, T, ...)
    return type(stacked)(*[x.transpose(0, 1) for x in stacked])


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    cfg = tiny_config()
    jp = jest.make_params(cfg, jnp.float64)
    n_it = cfg.estimator.num_iterations
    states, inps = [], []
    for s in range(B):
        st, inp = example_state(cfg, jp, jnp.float64, seed=s)
        if s == 1:
            inp = inp._replace(valid=inp.valid & (jnp.arange(inp.valid.shape[0]) < 12))
        states.append(st)
        inps.append(inp)
    params = convert.static_params(tonp(jp), dtype=F64, device="cpu")
    t_states = [convert.estimator_state(tonp(s), dtype=F64, device="cpu") for s in states]
    t_inps = [convert.frame_input(tonp(i), dtype=F64, device="cpu") for i in inps]
    f_state = batch.batch_states(t_states)
    f_inputs = _time_major([chunked.stack_frame_inputs([_later(i, t) for t in range(T)])
                            for i in t_inps])

    # The port's copy of the configuration: what the ranks unpickle must not
    # import the JAX package.
    tcfg = texample.tiny_config()
    cam = make_camera(tcfg.camera, dtype=F64, device="cpu")
    image_args = (params, n_it, tcfg.tracker, cam, tcfg.camera.focal_length)
    seqs = [_image_carry(tcfg, t_states[s], s) for s in range(B_IMG)]
    i_carry = batch.batch_states([c for c, _ in seqs])
    i_inputs = _time_major([chunked.stack_image_inputs([
        chunked.ImageFrameInput(img=img, ts=t64(0.05 * (3 + t)), imu_dt=t_inps[s].imu_dt,
                                imu_acc=t_inps[s].imu_acc, imu_gyr=t_inps[s].imu_gyr,
                                imu_cnt=t_inps[s].imu_cnt)
        for t, img in enumerate(frames)], "cpu") for s, (_, frames) in enumerate(seqs)])

    rng = np.random.default_rng(5)
    metric = (torch.as_tensor(rng.normal(size=(B, 3))), torch.as_tensor(rng.normal(size=(B, 3))))
    shard_tree = (torch.arange(B * 3.0).reshape(B, 3),
                  (torch.arange(B), tuple(torch.Generator().manual_seed(20 + s)
                                          for s in range(B))))
    path = str(tmp_path_factory.mktemp("fleet_mesh") / "inputs.pt")
    torch.save(dict(params=params, n_it=n_it, feature_state=f_state, feature_inputs=f_inputs,
                    image_args=image_args, image_carry=i_carry, image_inputs=i_inputs,
                    metric=metric, shard_tree=shard_tree), path)

    ranks = []
    spawn = threading.Thread(target=lambda: ranks.extend(
        launch.run_ranks(rank_checks, WORLD, path, device="cpu")))
    spawn.start()
    try:
        # World 1 and the reference while the ranks run (the generators of
        # i_carry advance here; the ranks loaded theirs from the file).
        one = batch.make_batched_chunked_step(params, n_it)(f_state, f_inputs)
        one_img = batch.make_batched_image_step(*image_args)(i_carry, i_inputs)
        jstep = jbatch.make_batched_chunked_step(jp, n_it)
        _, ref = jstep(_stack_jax(states),
                       _stack_jax([_stack_jax([_later(i, t) for i in inps]) for t in range(T)]))
    finally:
        spawn.join()
    assert len(ranks) == WORLD, "the ranks did not return"
    return dict(ranks=ranks, one=one, one_img=one_img, ref=[np.asarray(x) for x in ref],
                metric=metric, shard_tree=shard_tree)


def _assert_same_fleet(got, want):
    for x, y in zip(got[:2], want[:2]):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0, atol=SELF_TOL)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])


def test_feature_fleet_over_two_ranks_matches_world_one_and_reference(fleet):
    state1, out1 = fleet["one"]
    p_ref, q_ref, ok_ref, kf_ref = fleet["ref"]
    assert kf_ref[0].tolist() == [False, True, False, False]     # one branch per sequence
    for r, got in enumerate(fleet["ranks"]):
        p, q, ok, kf = got["feature"]
        assert p.shape == (T, B, 3) and kf.shape == (T, B) and kf.dtype == torch.bool
        _assert_same_fleet(got["feature"], out1)
        np.testing.assert_allclose(p.numpy(), p_ref, rtol=0, atol=POSE_TOL)
        np.testing.assert_allclose(q.numpy(), q_ref, rtol=0, atol=POSE_TOL)
        np.testing.assert_array_equal(ok.numpy(), ok_ref)
        np.testing.assert_array_equal(kf.numpy(), kf_ref)
        k = B // WORLD
        np.testing.assert_allclose(got["feature_state_p"].numpy(),
                                   state1.window.p[r * k:(r + 1) * k].numpy(),
                                   rtol=0, atol=SELF_TOL)


def test_image_fleet_over_two_ranks_matches_world_one(fleet):
    carry1, out1 = fleet["one_img"]
    assert out1[0].shape == (T_IMG, B_IMG, 3)
    for r, got in enumerate(fleet["ranks"]):
        _assert_same_fleet(got["image"], out1)
        assert got["image_gens"] == [r]                          # its own generator
        np.testing.assert_allclose(got["image_carry_p"].numpy(),
                                   carry1.est_state.window.p[r:r + 1].numpy(),
                                   rtol=0, atol=SELF_TOL)


def test_shard_batched_slices_and_refuses_uneven(fleet):
    x, (ids, gens) = fleet["shard_tree"]
    k = B // WORLD
    for r, got in enumerate(fleet["ranks"]):
        assert got["mesh"] == ("RankMesh", r, WORLD, "cpu", "seq")
        assert got["mesh_size"] == "3 devices for a group of 2 ranks"
        sx, (sids, sgens) = got["shard"]
        assert torch.equal(sx, x[r * k:(r + 1) * k]) and torch.equal(sids, ids[r * k:(r + 1) * k])
        assert [g.initial_seed() for g in sgens] == [g.initial_seed()
                                                      for g in gens[r * k:(r + 1) * k]]
        assert "does not split over 2 ranks" in got["uneven"]
        assert "this rank's shard" in got["global_state"]


def test_fleet_metrics_over_the_group(fleet):
    p, gt = fleet["metric"]
    want = float(batch.fleet_metrics(p, gt))
    for got in fleet["ranks"]:
        np.testing.assert_allclose(got["metric"], want, rtol=1e-12)


def test_dryrun_checks_on_every_rank(fleet):
    for got in fleet["ranks"]:
        d = got["dryrun"]
        assert d["poses"].shape == (WORLD, 3) and bool(torch.isfinite(d["poses"]).all())
        assert d["tp_dx_norm"] is not None and np.isfinite(d["tp_dx_norm"])
        assert d["mesh_ms"] > 0
        assert not d["jax_imported"] and not d["reference_imported"]
    assert fleet["ranks"][0]["dryrun"]["single_ms"] > 0


def test_launcher_fails_when_a_rank_raises():
    with pytest.raises(Exception, match="rank one fails on purpose"):
        launch.run_ranks(fail_on_rank_one, WORLD, device="cpu")


def test_rank_mesh_keeps_generators_on_their_device_type():
    """A rank's generators move to its device only between devices of one
    type (a CPU and a CUDA generator draw different streams); on the same
    device they stay the objects they were."""
    gens = (torch.Generator(), torch.Generator())
    assert batch.shard_batched(gens, batch.RankMesh(None, 1, 2, torch.device("cpu"))) == gens[1:]
    with pytest.raises(ValueError, match="cannot move"):
        batch.shard_batched(gens, batch.RankMesh(None, 1, 2, torch.device("cuda", 0)))
