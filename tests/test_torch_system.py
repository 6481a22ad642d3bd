"""The port's system loop (engine/vio_system.py) against the JAX package's,
float64 on the CPU.

Both ``VIOSystem``s read one 1.25 s sequence that the port's writer produced
(configs/tum_vi_room1.yaml with ``max_cnt`` 60), with their engines built at
float64. The reference runs it once, synchronously. The port runs it three
times:

1. synchronously to a checkpoint at frame ``CKPT`` (the final snapshot of a
   run cut there, as ``--frames=CKPT --checkpoint=PATH`` writes it): held
   against the reference's poses up to that frame;
2. resumed from that snapshot to the end of the sequence: held against the
   reference's poses after it;
3. pipelined over the whole sequence: held against all of the reference's
   poses and its evaluation.json.

Bars: the same TUM timestamps; positions and quaternions within 1e-5 (the
bar of tests/test_torch_feature_path.py); evaluation.json within 1e-5 (ATE
and RPE after the camera->body transform), the same pose and frame counts.
The runs cover the windowing, the IMU push up to each frame, the skip of
consumed frames and IMU samples on resume, the pose tags by ``res.ts``
under pipelining and the body transform before the evaluation.

The frames go through the reference's tracker on both sides: the port's
``detect_and_track`` is replaced by a shim that hands the port's
``TrackerState`` to the reference's jitted tracker and returns its state and
output as tensors (the state is still the port's to save and restore; the
RANSAC key chain is the reference engine's, PRNGKey(0) split once per
frame, continued on resume from the reference engine's key at the
snapshot's frame).
Without it the tracks part within the first frames of motion: RANSAC's
inlier votes flip on rounding-level differences (the reference's jitted
tracker and the same functions run one by one already disagree), and the
poses then differ far beyond the bar. The port's tracker is held against
the reference in tests/test_torch_tracker.py and tests/test_torch_slice.py.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_parity import reference_compile_cache  # noqa: F401

from mobile_slam_tpu import config as jconfig
from mobile_slam_tpu.engine import vio_engine as jvio
from mobile_slam_tpu.engine import vio_system as jvs
from mobile_slam_tpu.frontend import tracker as jtrk
from mobile_slam_tpu_torch import config as tconfig
from mobile_slam_tpu_torch.engine import vio_system as tvs
from mobile_slam_tpu_torch.engine.vio_engine import VIOEngine
from mobile_slam_tpu_torch.frontend import tracker as trk
from mobile_slam_tpu_torch.io import synthetic
from mobile_slam_tpu_torch.io.trajectory import read_tum

torch.set_num_threads(1)      # one thread per test worker, as tests/_torch_parity.py

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSE_TOL = 1e-5
CKPT = 22       # frames before the snapshot: TRACKING from frame 11, 11 poses


class ReferenceFrontend:
    """Stands in for the port's ``trk.detect_and_track``: the reference
    engine's jitted tracker on the port's state, one RANSAC key per frame."""

    def __init__(self, step):
        self.step = step
        self.generator = None
        self.key = None

    def continue_from(self, generator, key) -> None:
        self.generator, self.key = generator, key

    def __call__(self, state, img, ts, camera, cfg, focal, *, generator=None,
                 banned_ids=None, **_):
        if generator is not self.generator:     # a new engine, or a reset one
            self.continue_from(generator, jax.random.PRNGKey(0))
        self.key, sub = jax.random.split(self.key)

        def to_jax(s):
            return jtrk.TrackerState(*[
                tuple(jnp.asarray(lv.numpy()) for lv in v) if f == "pyr"
                else jnp.asarray(v.numpy()) for f, v in zip(s._fields, s)])

        def to_torch(v):
            return torch.from_numpy(np.array(v))

        js, out = self.step(to_jax(state), jnp.asarray(img.numpy()),
                            jnp.asarray(float(ts), jnp.float64), key=sub,
                            banned_ids=jnp.asarray(banned_ids.numpy()))
        state = trk.TrackerState(*[
            tuple(to_torch(lv) for lv in v) if f == "pyr" else to_torch(v)
            for f, v in zip(js._fields, js)])
        return state, trk.TrackerOutput(*[to_torch(v) for v in out])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("system")
    seq = str(root / "seq")
    synthetic.write_sequence(seq, synthetic.sim_config(1.25, seed=7, noise=True))
    text = open(os.path.join(REPO, "configs", "tum_vi_room1.yaml")).read()
    lines = [f"dataset_path: {seq}" if ln.startswith("dataset_path:")
             else "max_cnt: 60" if ln.startswith("max_cnt:") else ln
             for ln in text.splitlines()]
    cfg_path = root / "cfg.yaml"
    cfg_path.write_text("\n".join(lines) + "\n")
    out = {}

    jcfg = jconfig.load_config(str(cfg_path))
    system = jvs.VIOSystem(jcfg, log_root=str(root / "jax"))
    engine = system.engine = jvio.VIOEngine(jcfg, dtype=jnp.float64)
    step, keys = engine._tracker_step, []

    def keyed_step(*a, **kw):
        keys.append(engine._key)            # the chain after this frame's split
        return step(*a, **kw)

    engine._tracker_step = keyed_step

    tcfg = tconfig.load_config(str(cfg_path))
    frontend = ReferenceFrontend(step)
    snapshot = str(root / "torch.npz")

    def run(name, end_frame=-1, **kw):
        cfg = tcfg.replace(end_frame=end_frame)
        system = tvs.VIOSystem(cfg, log_root=str(root / name), device="cpu", **kw)
        system.engine = VIOEngine(cfg, device="cpu", dtype=torch.float64)
        if "resume_path" in kw:
            frontend.continue_from(system.engine._gen, keys[CKPT - 1])
        return system.process_sequence()

    def port_runs():
        try:
            out["ckpt"] = run("ckpt", end_frame=CKPT, checkpoint_path=snapshot)
            out["pipelined"] = run("pipelined", pipelined=True)
        except BaseException as e:     # re-raised in the test's thread below
            failed.append(e)

    failed = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trk, "detect_and_track", frontend)
        # The port's synchronous and pipelined runs need only the reference's
        # jitted tracker, so they run beside the reference's own run (which
        # spends most of its time compiling, off the interpreter lock); the
        # resumed run needs the reference's key chain, so it runs after.
        port = threading.Thread(target=port_runs)
        port.start()
        try:
            out["jax"] = system.process_sequence()
        finally:
            port.join()
        if failed:
            raise failed[0]
        out["resume"] = run("resume", resume_path=snapshot)
    return out


def trajectory(summary):
    return read_tum(os.path.join(summary.log_dir, "trajectory_pose.txt"))


def assert_same_trajectory(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_allclose(a[1], b[1], rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(a[2], b[2], rtol=0, atol=POSE_TOL)


def test_synchronous_run_to_a_checkpoint_matches_reference(runs):
    ref, ck = trajectory(runs["jax"]), trajectory(runs["ckpt"])
    assert (runs["ckpt"].frames_processed, runs["ckpt"].poses_recovered) == (CKPT, 11)
    n = len(ck[0])
    assert_same_trajectory(tuple(a[:n] for a in ref), ck)
    assert ref[0][n] > ck[0][-1]


def test_resumed_run_matches_reference(runs):
    ref, ck, res = (trajectory(runs[k]) for k in ("jax", "ckpt", "resume"))
    n = len(ck[0])
    assert runs["resume"].frames_processed == runs["jax"].frames_processed - CKPT > 0
    assert res[0][0] > ck[0][-1]        # no frame before the snapshot again
    assert_same_trajectory(tuple(a[n:] for a in ref), res)


def test_pipelined_run_matches_reference(runs):
    ref, pipe = runs["jax"], runs["pipelined"]
    assert (pipe.frames_processed, pipe.poses_recovered) == (
        ref.frames_processed, ref.poses_recovered)
    assert_same_trajectory(trajectory(ref), trajectory(pipe))
    ej = json.load(open(os.path.join(ref.log_dir, "evaluation.json")))
    et = json.load(open(os.path.join(pipe.log_dir, "evaluation.json")))
    assert set(ej) == set(et)
    for k in sorted(set(ej) - {"fps"}):
        np.testing.assert_allclose(et[k], ej[k], rtol=0, atol=POSE_TOL, err_msg=k)
    assert np.isfinite(et["ate_rmse_m"])
