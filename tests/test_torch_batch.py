"""The port's fleet (parallel/batch.py) against the JAX package's, float64 on
the CPU at tiny sizes.

1. ``make_batched_step`` at B = 2 against the reference's
   ``make_batched_step`` (one jitted program, shared by 2): sequence 0 takes
   the general-frame branch and sequence 1 the keyframe branch in the same
   step (it sees too few tracked features), so the device-side select is
   shown per sequence. Poses within 1e-5 (the bar of
   tests/test_torch_chunked.py), ok flags equal, keyframe flags equal and
   different, the prior as J0ᵀJ0 / J0ᵀr0 (tests/test_torch_estimator.py).
2. ``make_batched_chunked_step`` at B = 2, T = 2 against the same
   reference program stepped twice (its ``make_batched_chunked_step`` is a
   scan of that step), and each sequence against the port's own
   single-stream ``make_chunked_step`` within 1e-10.
3. ``make_batched_image_step`` at B = 2, T = 2 (two textures moving apart,
   warm tracker states) against the reference's per-sequence image frame
   step (its Pallas kernels in interpret mode, the reference's RANSAC draws
   injected), and each sequence against the port's single-stream
   ``make_chunked_image_step`` within 1e-10.
4. ``torch.func.vmap`` of each LK operation against B single calls:
   bit-equal (the CPU rule runs the plain version per sequence).
5. ``fleet_metrics``, ``batch_states`` and the one-device mesh (a mesh over
   several devices needs a process group: tests/test_torch_fleet_mesh.py).
6. The vmap rules' CUDA route with the kernels' entry points recorded:
   one launch per op for the whole fleet, with its batch strides.

The reference reads a keyframe flag nowhere outside its step, so its flags
come from the window: with a full window a keyframe step slides the oldest
frame out (``ts[0]`` changes) and a general step keeps it.
"""

import contextlib
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_parity import (  # noqa: F401
    F64, example_state, ransac_draws, reference_compile_cache, t64, tonp)
from tests.test_torch_tracker import tracker_sequence

from mobile_slam_tpu.engine import chunked as jchunked
from mobile_slam_tpu.engine import estimator as jest
from mobile_slam_tpu.engine.example import tiny_config
from mobile_slam_tpu.frontend import tracker as jtrk
from mobile_slam_tpu.models.cameras.base import make_camera as jax_camera
from mobile_slam_tpu.ops import lk_pallas
from mobile_slam_tpu.parallel import batch as jbatch
from mobile_slam_tpu_torch import convert
from mobile_slam_tpu_torch.engine import chunked
from mobile_slam_tpu_torch.frontend import tracker as trk
from mobile_slam_tpu_torch.models.cameras.base import make_camera
from mobile_slam_tpu_torch.ops import image as im
from mobile_slam_tpu_torch.ops import lk
from mobile_slam_tpu_torch.parallel import batch

POSE_TOL = 1e-5     # port against the reference
SELF_TOL = 1e-10    # a fleet sequence against its own single run, float64
PRIOR_TOL = 1e-6    # relative, J0ᵀJ0 and J0ᵀr0 (tests/test_torch_estimator.py)
B, T = 2, 2
L = chunked.GROWTH_WINDOW


@pytest.fixture(autouse=True)
def interpret_mode():
    lk_pallas._INTERPRET = True
    yield
    lk_pallas._INTERPRET = False


def _stack_jax(trees, axis=0):
    return jax.tree.map(lambda *xs: jnp.stack(xs, axis=axis), *trees)


@pytest.fixture(scope="module")
def fleet():
    """B example states and inputs in both packages, float64. Sequence 1
    keeps 12 of its tracked features (fewer than 20: a keyframe)."""
    cfg = tiny_config()
    jp = jest.make_params(cfg, jnp.float64)
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
    n_it = cfg.estimator.num_iterations
    return dict(cfg=cfg, jp=jp, params=params, n_it=n_it, states=states, inps=inps,
                t_states=t_states, t_inps=t_inps,
                jstep=jbatch.make_batched_step(jp, n_it))


def _later(inp, t):
    return inp._replace(ts=inp.ts + 0.05 * t)


def _prior_close(pj, pt):
    J, r = np.asarray(pj.J0), np.asarray(pj.r0)
    Jt, rt = pt.J0.numpy(), pt.r0.numpy()
    H, Ht = J.T @ J, Jt.T @ Jt
    scale = max(np.abs(H).max(), 1e-30)
    assert np.abs(H - Ht).max() <= PRIOR_TOL * scale
    assert np.abs(J.T @ r - Jt.T @ rt).max() <= PRIOR_TOL * scale ** 0.5 * max(np.abs(r).max(), 1.0)


def _reference_frames(f, steps):
    """The reference fleet over ``steps`` frames: per frame (p, q, ok,
    is_kf) as numpy (B, ...), and the last state."""
    state, out = _stack_jax(f["states"]), []
    for t in range(steps):
        before = np.asarray(state.window.ts[:, 0])
        state, (p, q, ok) = f["jstep"](state, _stack_jax([_later(i, t) for i in f["inps"]]))
        kf = np.asarray(state.window.ts[:, 0]) != before
        out.append(tuple(np.asarray(x) for x in (p, q, ok)) + (kf,))
    return out, state


def test_batched_step_matches_reference(fleet):
    (ref,), jstate = _reference_frames(fleet, 1)
    step = batch.make_batched_step(fleet["params"], fleet["n_it"])
    tstate, (p, q, ok) = step(batch.batch_states(fleet["t_states"]),
                              batch.batch_states(fleet["t_inps"]))
    assert p.shape == (B, 3) and q.shape == (B, 4) and ok.shape == (B,)
    np.testing.assert_allclose(p.numpy(), ref[0], atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(q.numpy(), ref[1], atol=POSE_TOL, rtol=0)
    np.testing.assert_array_equal(ok.numpy(), ref[2])
    assert ref[3].tolist() == [False, True]       # one branch per sequence
    kf = tstate.window.ts[:, 0] != batch.batch_states(fleet["t_states"]).window.ts[:, 0]
    assert kf.tolist() == ref[3].tolist()
    np.testing.assert_allclose(tstate.window.p.numpy(), np.asarray(jstate.window.p),
                               atol=POSE_TOL, rtol=0)
    for s in range(B):
        _prior_close(jax.tree.map(lambda x: x[s], jstate.prior),
                     type(tstate.prior)(*[x[s] for x in tstate.prior]))


def test_batched_chunked_step_matches_reference_and_single_runs(fleet):
    ref, jstate = _reference_frames(fleet, T)
    inputs = batch.batch_states([chunked.stack_frame_inputs([_later(i, t) for t in range(T)])
                                 for i in fleet["t_inps"]])
    inputs = type(inputs)(*[x.transpose(0, 1) for x in inputs])     # (T, B, ...)
    step = batch.make_batched_chunked_step(fleet["params"], fleet["n_it"])
    tstate, (p, q, ok, kf) = step(batch.batch_states(fleet["t_states"]), inputs)
    assert p.shape == (T, B, 3) and kf.shape == (T, B) and kf.dtype == torch.bool
    for t in range(T):
        np.testing.assert_allclose(p[t].numpy(), ref[t][0], atol=POSE_TOL, rtol=0)
        np.testing.assert_allclose(q[t].numpy(), ref[t][1], atol=POSE_TOL, rtol=0)
        np.testing.assert_array_equal(ok[t].numpy(), ref[t][2])
        np.testing.assert_array_equal(kf[t].numpy(), ref[t][3])
    assert kf[0].tolist() == [False, True]
    for s in range(B):
        _prior_close(jax.tree.map(lambda x: x[s], jstate.prior),
                     type(tstate.prior)(*[x[s] for x in tstate.prior]))

    single = chunked.make_chunked_step(fleet["params"], fleet["n_it"])
    for s in range(B):
        st_s, (p_s, q_s, ok_s, kf_s) = single(
            fleet["t_states"][s], chunked.stack_frame_inputs(
                [_later(fleet["t_inps"][s], t) for t in range(T)]))
        np.testing.assert_allclose(p[:, s].numpy(), p_s.numpy(), atol=SELF_TOL, rtol=0)
        np.testing.assert_allclose(q[:, s].numpy(), q_s.numpy(), atol=SELF_TOL, rtol=0)
        assert torch.equal(ok[:, s], ok_s) and torch.equal(kf[:, s], kf_s)
        # The prior's factor has no unique signs: compare J0ᵀJ0.
        H_b, H_s = (J.T @ J for J in (tstate.prior.J0[s].numpy(), st_s.prior.J0.numpy()))
        assert np.abs(H_b - H_s).max() <= SELF_TOL * np.abs(H_s).max()


def _image_sequence(f, s):
    """Sequence s of the image fleet: a texture translating its own way,
    the port's tracker warmed on its first 3 frames, the example estimator
    state of seed s; (reference carry, port carry, port frame inputs 3..)."""
    cfg = f["cfg"]
    frames = tracker_sequence(3 + T, step=((0.9, -0.6), (-0.7, 0.8))[s])
    cam = make_camera(cfg.camera, dtype=F64, device="cpu")
    tst = trk.init_tracker_state(cfg.tracker, cfg.camera.height, cfg.camera.width,
                                 dtype=F64, device="cpu")
    for k in range(3):
        tst, _ = trk.detect_and_track(tst, t64(frames[k]), 0.05 * k, cam, cfg.tracker,
                                      cfg.camera.focal_length,
                                      generator=torch.Generator().manual_seed(k))
    tst_np = convert.to_numpy(tst)
    F = cfg.estimator.max_features
    jcarry = jchunked.ImageChunkCarry(
        est_state=f["states"][s],
        tracker_state=jtrk.TrackerState(tuple(map(jnp.asarray, tst_np.pyr)),
                                        *map(jnp.asarray, tst_np[1:])),
        banned_ids=jnp.full((F,), -1, jnp.int32), key=jax.random.PRNGKey(3 + s),
        # Typed as the step returns them, so that its second call does not
        # compile again.
        depth_ema=jnp.asarray(0.0, jnp.float64), vel_ema=jnp.asarray(0.05, jnp.float64),
        lag_depth=jnp.zeros(L), lag_vel=jnp.zeros(L), lag_i=jnp.asarray(0, jnp.int32))
    tcarry = chunked.ImageChunkCarry(
        est_state=f["t_states"][s], tracker_state=tst,
        banned_ids=torch.full((F,), -1, dtype=torch.int32),
        gen=torch.Generator().manual_seed(s), depth_ema=t64(0.0), vel_ema=t64(0.05),
        lag_depth=torch.zeros(L, dtype=F64), lag_vel=torch.zeros(L, dtype=F64),
        lag_i=torch.tensor(0, dtype=torch.int32))
    inp = f["t_inps"][s]
    inputs = [chunked.ImageFrameInput(
        img=t64(frames[3 + t]), ts=t64(0.05 * (3 + t)), imu_dt=inp.imu_dt,
        imu_acc=inp.imu_acc, imu_gyr=inp.imu_gyr, imu_cnt=inp.imu_cnt) for t in range(T)]
    return jcarry, tcarry, inputs


def test_batched_image_step_matches_reference_and_single_runs(fleet):
    cfg, n_it = fleet["cfg"], fleet["n_it"]
    tcfg = dataclasses.replace(cfg.tracker, use_pallas=True)
    jstep = jax.jit(jchunked.make_image_frame_step(
        fleet["jp"], n_it, tcfg, jax_camera(cfg.camera, dtype=jnp.float64),
        cfg.camera.focal_length))
    seqs = [_image_sequence(fleet, s) for s in range(B)]

    # The reference, sequence by sequence; the draws its keys give.
    ref, draws = [], torch.zeros((T, B, cfg.tracker.ransac_iters, 8), dtype=torch.int64)
    for s, (jcarry, _, inputs) in enumerate(seqs):
        rows = []
        for t, inp in enumerate(inputs):
            draws[t, s] = torch.as_tensor(ransac_draws(jax.random.split(jcarry.key)[1],
                                                       cfg.tracker.ransac_iters))
            jinp = jchunked.ImageFrameInput(*[jnp.asarray(x.numpy()) for x in inp])
            jcarry, out = jstep(jcarry, (jinp, jtrk.preprocess_frame(jinp.img, tcfg)))
            rows.append(tuple(np.asarray(x) for x in out))
        ref.append(rows)

    cam = make_camera(cfg.camera, dtype=F64, device="cpu")
    args = (fleet["params"], n_it, cfg.tracker, cam, cfg.camera.focal_length)
    carry = batch.batch_states([c for _, c, _ in seqs])
    assert isinstance(carry.gen, tuple) and len(carry.gen) == B
    inputs = batch.batch_states([chunked.stack_image_inputs(i, "cpu") for _, _, i in seqs])
    inputs = type(inputs)(*[x.transpose(0, 1) for x in inputs])     # (T, B, ...)
    before = dict(lk.launch_counts)
    carry2, (p, q, ok, kf) = batch.make_batched_image_step(*args)(carry, inputs,
                                                               ransac_draws=draws)
    assert lk.launch_counts == before       # the CPU runs the plain versions
    assert carry2.gen is carry.gen and p.shape == (T, B, 3) and kf.shape == (T, B)
    for s in range(B):
        for t in range(T):
            p_j, q_j, ok_j, kf_j = ref[s][t]
            np.testing.assert_allclose(p[t, s].numpy(), p_j, atol=POSE_TOL, rtol=0)
            np.testing.assert_allclose(q[t, s].numpy(), q_j, atol=POSE_TOL, rtol=0)
            assert bool(ok[t, s]) == bool(ok_j) and bool(kf[t, s]) == bool(kf_j)

    single = chunked.make_chunked_image_step(*args)
    for s, (_, c, i) in enumerate(seqs):
        c_s, (p_s, q_s, ok_s, kf_s) = single(c, chunked.stack_image_inputs(i, "cpu"),
                                             ransac_draws=draws[:, s])
        np.testing.assert_allclose(p[:, s].numpy(), p_s.numpy(), atol=SELF_TOL, rtol=0)
        np.testing.assert_allclose(q[:, s].numpy(), q_s.numpy(), atol=SELF_TOL, rtol=0)
        assert torch.equal(ok[:, s], ok_s) and torch.equal(kf[:, s], kf_s)
        assert torch.equal(carry2.tracker_state.ids[s], c_s.tracker_state.ids)
        np.testing.assert_allclose(carry2.tracker_state.pts[s].numpy(),
                                   c_s.tracker_state.pts.numpy(), atol=SELF_TOL, rtol=0)


def test_image_step_draws_each_sequence_from_its_own_generator(fleet, monkeypatch):
    """Without injected draws, sequence b draws (T, iters, 8) from its own
    generator in one call: what its single-stream chunk would draw."""
    cfg = fleet["cfg"]
    gens = [torch.Generator().manual_seed(10 + s) for s in range(B)]
    want = [torch.randint(0, 1 << 30, (T, cfg.tracker.ransac_iters, 8),
                          generator=torch.Generator().manual_seed(10 + s)) for s in range(B)]

    def one_frame(carry, inp, pre, draws):      # hands the draws out as its pose
        return carry, (draws, inp.ts.new_zeros(4), inp.ts > 0, inp.ts > 0)

    monkeypatch.setattr(chunked, "make_image_frame_step", lambda *a, **k: one_frame)
    step = batch.make_batched_image_step(fleet["params"], 2, cfg.tracker, None, 1.0)
    img = torch.zeros((T, B, cfg.camera.height, cfg.camera.width), dtype=F64)
    inputs = chunked.ImageFrameInput(img=img, ts=torch.ones((T, B), dtype=F64),
                                     imu_dt=img[..., 0, :4], imu_acc=img[..., :4, :3],
                                     imu_gyr=img[..., :4, :3],
                                     imu_cnt=torch.zeros((T, B), dtype=torch.int32))
    carry = chunked.ImageChunkCarry(*([torch.zeros(B)] * 3), tuple(gens),
                                    *([torch.zeros(B)] * 5))
    _, (seen, *_) = step(carry, inputs)
    assert seen.shape == (T, B, cfg.tracker.ransac_iters, 8)
    for s in range(B):
        assert torch.equal(seen[:, s], want[s])


def test_lk_ops_under_vmap_equal_single_calls():
    rs = np.random.RandomState(0)
    n, h, w, k, win = 3, 64, 96, 20, 9
    imgs0 = torch.as_tensor(rs.rand(n, h, w).astype(np.float32) * 255)
    imgs1 = torch.roll(imgs0, 1, dims=2)
    pyr0 = [torch.stack(x) for x in zip(*[im.build_pyramid(a, 2) for a in imgs0])]
    pyr1 = [torch.stack(x) for x in zip(*[im.build_pyramid(a, 2) for a in imgs1])]
    pts = torch.as_tensor(rs.uniform(10, 50, (n, k, 2)).astype(np.float32))
    act = torch.as_tensor(rs.rand(n, k) > 0.2)
    prm = lk.LKParams(window=win, levels=2, iters=10, eps=0.01)
    before = dict(lk.launch_counts)

    def same(batched, singles):
        for s, single in enumerate(singles):
            assert all(torch.equal(x[s], y) for x, y in zip(batched, single))

    same(torch.func.vmap(lambda a, b, p, q: lk.track_pyramidal(a, b, p, q, prm))(
        pyr0, pyr1, pts, act),
        [lk.track_pyramidal([p[s] for p in pyr0], [p[s] for p in pyr1], pts[s], act[s], prm)
         for s in range(n)])
    # An image shared by the fleet (not vmapped) beside vmapped centers.
    same(torch.func.vmap(lambda c: lk.extract_patches(imgs0[0], c, win))(pts),
         [lk.extract_patches(imgs0[0], pts[s], win) for s in range(n)])
    tm = torch.func.vmap(lambda a, c: lk.extract_patches(a, c, win))(imgs0, pts)
    same(tm, [lk.extract_patches(imgs0[s], pts[s], win) for s in range(n)])
    same(torch.func.vmap(lambda a, t, gx, gy, p, q: lk.refine_template(
        a, t, gx, gy, p, q, win, 8, 0.01, 2.0))(imgs1, *tm, pts, act),
        [lk.refine_template(imgs1[s], tm[0][s], tm[1][s], tm[2][s], pts[s], act[s], win, 8,
                            0.01, 2.0) for s in range(n)])
    assert lk.launch_counts == before


def test_fleet_metrics_batch_states_and_mesh():
    p = np.random.default_rng(0).normal(size=(4, 3))
    gt = p + 0.1
    want = float(jbatch.fleet_metrics(jnp.asarray(p), jnp.asarray(gt)))
    got = batch.fleet_metrics(torch.as_tensor(p), torch.as_tensor(gt))
    np.testing.assert_allclose(float(got), want, rtol=1e-12)
    np.testing.assert_allclose(float(got), np.sqrt(3) * 0.1, rtol=1e-12)

    pairs = [(torch.full((2,), float(s)), (torch.tensor(s), torch.Generator())) for s in range(3)]
    stacked = batch.batch_states(pairs)
    assert stacked[0].shape == (3, 2) and stacked[1][0].tolist() == [0, 1, 2]
    assert stacked[1][1] == tuple(g for _, (_, g) in pairs)
    mesh = batch.make_mesh(["cpu"])
    assert mesh == torch.device("cpu")
    moved = batch.shard_batched(stacked, mesh)
    assert moved[0].device == mesh and moved[1][1] == stacked[1][1]
    with pytest.raises(RuntimeError, match="initialized torch.distributed group of 2 ranks"):
        batch.make_mesh(["cpu", "cpu"])         # several devices need one rank each
    if not torch.cuda.is_available():       # the default is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            batch.make_mesh()


def test_cuda_vmap_rule_makes_one_launch_over_the_fleet(monkeypatch):
    """On CUDA tensors the vmap rule of each LK op calls its kernel's entry
    point ONCE for all B x K slots, with B, K and the batch strides (0 for
    an image every sequence shares), and never the plain version; a call
    outside vmap is the single-stream launch (B = 1, strides 0). Checked
    here with the CUDA route forced and the entry points recorded."""
    calls = []

    def strides(addr, n):
        return list((ctypes.c_longlong * n).from_address(addr))

    class Lib:
        def lk_track_launch(self, prev, nxt, bsp, bsn, h, w, n_lvl, pts, act, b, k, *rest):
            calls.append(("track", b, k, strides(bsp, n_lvl), strides(bsn, n_lvl)))
            return 0

        def lk_refine_launch(self, img, img_bs, h, w, tp, gx, gy, p0, act, b, k, *rest):
            calls.append(("refine", b, k, img_bs))
            return 0

        def lk_extract_launch(self, img, img_bs, h, w, c, b, k, *rest):
            calls.append(("extract", b, k, img_bs))
            return 0

    def plain(*a, **kw):
        raise AssertionError("the CUDA route took a plain version")

    monkeypatch.setattr(lk, "build_kernels", Lib)
    monkeypatch.setattr(lk, "_configure", lambda lib: None)
    monkeypatch.setattr(lk, "_route", lambda t: "cuda")
    monkeypatch.setattr(lk.cuda_build, "stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    for name in ("track_pyramidal_ref", "refine_template_ref", "extract_patches_ref"):
        monkeypatch.setattr(lk, name, plain)
    n, k, win = 3, 7, 9
    imgs = torch.rand(n, 64, 96) * 255
    pyr = [torch.stack(x) for x in zip(*[im.build_pyramid(a, 2) for a in imgs])]
    shared = im.build_pyramid(imgs[0], 2)
    pts, act = torch.rand(n, k, 2) * 40, torch.ones(n, k, dtype=torch.bool)
    tmpl = [torch.rand(n, k, win * win) for _ in range(3)]
    prm = lk.LKParams(window=win, levels=2, iters=5, eps=0.01)
    before = dict(lk.launch_counts)

    pos, ok = torch.func.vmap(lambda a, p, q: lk.track_pyramidal(a, shared, p, q, prm))(
        pyr, pts, act)
    tp = torch.func.vmap(lambda a, c: lk.extract_patches(a, c, win))(imgs, pts)
    rp = torch.func.vmap(lambda t, gx, gy, p, q: lk.refine_template(
        imgs[0], t, gx, gy, p, q, win, 5, 0.01, 2.0))(*tmpl, pts, act)
    assert pos.shape == (n, k, 2) and ok.shape == (n, k)
    assert [t.shape for t in tp] == [(n, k, win * win)] * 3
    assert [t.shape for t in rp] == [(n, k, 2), (n, k), (n, k)]
    level_sizes = [lv.shape[0] * lv.shape[1] for lv in shared]
    assert calls == [("track", n, k, level_sizes, [0, 0, 0]),
                     ("extract", n, k, 64 * 96), ("refine", n, k, 0)]
    assert {key: lk.launch_counts[key] - before[key] for key in before} == {
        "track_pyramidal": 1, "refine_template": 1, "extract_patches": 1}

    calls.clear()
    lk.track_pyramidal(shared, shared, pts[0], act[0], prm)
    lk.extract_patches(imgs[0], pts[0], win)
    lk.refine_template(imgs[0], *(t[0] for t in tmpl), pts[0], act[0], win, 5, 0.01, 2.0)
    assert calls == [("track", 1, k, [0, 0, 0], [0, 0, 0]), ("extract", 1, k, 0),
                     ("refine", 1, k, 0)]

    prep = lk._track_prep_batched(pyr, [lv.expand(n, *lv.shape) for lv in shared], pts,
                                  act, prm)
    assert [a.data_ptr() for a in prep[0]] == [a.data_ptr() for a in pyr]
    assert [a.stride(0) for a in prep[1]] == [0, 0, 0]
    with pytest.raises(ValueError, match="B=3"):
        lk._track_prep_batched([lv[:2] for lv in pyr], pyr, pts, act, prm)
