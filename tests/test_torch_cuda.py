"""GPU tier of the PyTorch port: ``pytest -m cuda tests/test_torch_cuda.py``
(``--noconftest`` on a machine without JAX: tests/conftest.py imports it).

Runs chip_smoke.py in a subprocess: it builds the CUDA kernels, holds
each against its plain PyTorch version at main-path shapes and drives the
port's engine and chunked server over the bench sequence. The subprocess
exits with 42 when no CUDA device is present, and the test then skips; the
probe-kernel, fleet-kernel, calibration, adversarial-frame and dry-run tests decide
inside themselves and skip without a card too.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.cuda
def test_chip_smoke_on_gpu():
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          capture_output=True, text=True, timeout=1200, cwd=REPO)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr)
    if proc.returncode == 42:
        pytest.skip("no CUDA device")
    assert proc.returncode == 0, "chip_smoke.py failed (see output above)"
    assert proc.stdout.strip().splitlines()[-1].startswith('{"ok": true')


@pytest.mark.cuda
def test_probe_kernels_match_plain_versions():
    """P1 and P2 build, launch and agree with their plain versions on the
    card: P1 exact on inputs where its block sum shows; P2 full within
    0.02 px, the other modes' displacement within 1e-6 px (constant or zero
    steps), every mode's witness within 1e-4 relative."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from mobile_slam_tpu_torch.probes import call_overhead as p1
    from mobile_slam_tpu_torch.probes import lk_pack_probe as p2

    pts, img = p1.check_inputs("cuda")
    out = p1._touch_points_cuda(pts, img)
    assert torch.equal(out, p1.touch_points_ref(pts, img))
    assert bool((out != pts).all())
    q, prev_p, next_p = p2.inputs("cuda")
    for mode in p2.MODES:
        a, wa = p2._lk_probe_cuda(q, prev_p, next_p, p2.PAD, mode)
        b, wb = p2.lk_probe_ref(q, prev_p, next_p, p2.PAD, mode)
        tol = 0.02 if mode == "full" else 1e-6
        assert float((a - b).abs().max()) <= tol, mode
        assert float(((wa - wb).abs() / wb.abs().clamp(min=1.0)).max()) <= 1e-4, mode
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_lk_kernels_take_a_fleet_in_one_launch():
    """Under torch.func.vmap on CUDA tensors, K1, K2 and K3 each launch once
    for the whole fleet, bit-equal to one launch per sequence."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from mobile_slam_tpu_torch.ops import image as im
    from mobile_slam_tpu_torch.ops import lk

    gen = torch.Generator(device="cuda").manual_seed(0)
    n, k, win = 3, 40, 21
    imgs = torch.rand((n, 128, 160), generator=gen, device="cuda") * 255
    nxt = torch.roll(imgs, (1, 2), dims=(1, 2))
    pyr0 = [torch.stack(x) for x in zip(*[im.build_pyramid(a, 2) for a in imgs])]
    pyr1 = [torch.stack(x) for x in zip(*[im.build_pyramid(a, 2) for a in nxt])]
    pts = torch.rand((n, k, 2), generator=gen, device="cuda") * 100 + 14
    act = torch.rand((n, k), generator=gen, device="cuda") > 0.1
    prm = lk.LKParams(window=win, levels=2)

    def one_launch(fn, *args):
        before = dict(lk.launch_counts)
        out = torch.func.vmap(fn)(*args)
        assert sum(lk.launch_counts[x] - before[x] for x in before) == 1
        return out

    def same(batched, singles):
        for s, single in enumerate(singles):
            for x, y in zip(batched, single):
                assert bool(((x[s] == y) | (x[s].isnan() & y.isnan())).all())

    pos = one_launch(lambda a, b, p, q: lk.track_pyramidal(a, b, p, q, prm), pyr0, pyr1,
                     pts, act)
    same(pos, [lk.track_pyramidal([p[s] for p in pyr0], [p[s] for p in pyr1], pts[s],
                                  act[s], prm) for s in range(n)])
    tm = one_launch(lambda a, c: lk.extract_patches(a, c, win), nxt, pos[0])
    same(tm, [lk.extract_patches(nxt[s], pos[0][s], win) for s in range(n)])
    ref = one_launch(lambda t, gx, gy, p, q: lk.refine_template(
        pyr0[0][0], t, gx, gy, p, q, win, 30, 0.01, 2.5), *tm, pts, pos[1])
    same(ref, [lk.refine_template(pyr0[0][0], *(t[s] for t in tm), pts[s], pos[1][s], win,
                                  30, 0.01, 2.5) for s in range(n)])
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_lk_kernels_at_the_gateway_shapes():
    """K1-K3 at the gateway's mobile profile: window 15 (the run-time-window
    body) over 3 pyramid images of a 640x480 frame, 160 slots, against
    their plain versions at the bars of chip_smoke.py phase 2 (K1/K2 0.02
    px, K2 residual 0.05, K3 1e-3)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from mobile_slam_tpu_torch.ops import image as im
    from mobile_slam_tpu_torch.ops import lk

    gen = torch.Generator(device="cuda").manual_seed(3)
    base = torch.rand((1, 1, 122, 162), generator=gen, device="cuda") * 255
    big = torch.nn.functional.interpolate(base, size=(488, 648), mode="bicubic",
                                          align_corners=False)[0, 0]
    img0, img1 = big[4:484, 4:644].contiguous(), big[2:482, 7:647].contiguous()
    pyr0, pyr1 = im.build_pyramid(img0, 2), im.build_pyramid(img1, 2)
    pts = torch.rand((160, 2), generator=gen, device="cuda") * torch.tensor(
        [600.0, 440.0], device="cuda") + 20
    act = torch.rand((160,), generator=gen, device="cuda") > 0.1
    prm = lk.LKParams(window=15, levels=2, iters=20)
    pos_k, ok_k = lk.track_pyramidal(pyr0, pyr1, pts, act, prm)
    pos_p, ok_p = lk.track_pyramidal_ref(pyr0, pyr1, pts, act, prm)
    both = ok_k & ok_p
    assert int(both.sum()) > 80 and bool((ok_k == ok_p).all())
    assert float((pos_k - pos_p)[both].norm(dim=-1).max()) < 0.02
    tk = lk.extract_patches(img1, pos_p, 15)
    tp = lk.extract_patches_ref(img1, pos_p, 15)
    assert max(float((a - b).abs().max()) for a, b in zip(tk, tp)) < 1e-3
    args = (img0, *tp, pos_p, both, 15, 20, 0.01, 2.5)
    pk, okk, rk = lk.refine_template(*args)
    pp, okp, rp = lk.refine_template_ref(*args)
    m = okk & okp
    assert int(m.sum()) > 80 and bool((okk == okp).all())
    assert float((pk - pp)[m].norm(dim=-1).max()) < 0.02
    assert float((rk - rp)[m].abs().max()) < 0.05
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_calibration_on_the_card_matches_the_cpu():
    """calibrate_from_board for the Kannala-Brandt camera of
    configs/tum_vi_room1.yaml from 10 board views (0.1 px noise) on the card
    at float64, against the same call on the CPU: every corner's
    projection within chip_smoke.CALIB_CPU_PX, the RMS within
    CALIB_RMS_RTOL, and the reference test's bar (RMS < 0.5 px, focal within
    5%)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from mobile_slam_tpu_torch.models.cameras import calibration as cal

    true, w, h, opts, bar = cs.calibration_cameras()["KANNALA_BRANDT"]
    objs, imgs, pcs = cs.board_views(cal._PROJECT["KANNALA_BRANDT"], true, w, h, 10, **opts)
    args = ("KANNALA_BRANDT", cs.BOARD, objs, imgs, w, h)
    p, rms = cal.calibrate_from_board(*args, device="cuda")
    p_cpu, rms_cpu = cal.calibrate_from_board(*args, device="cpu")
    pts = torch.as_tensor(pcs)
    px = float((cal._PROJECT["KANNALA_BRANDT"](torch.as_tensor(p), pts)
                - cal._PROJECT["KANNALA_BRANDT"](torch.as_tensor(p_cpu), pts)).abs().max())
    assert px <= cs.CALIB_CPU_PX and abs(rms - rms_cpu) <= cs.CALIB_RMS_RTOL * rms_cpu
    assert bar(true.numpy(), p, rms)


@pytest.mark.cuda
def test_adversarial_frame_feeds_the_server_on_the_card():
    """One level-0 adversarial frame (the oracle renderer, bench.py's
    sequence, seed 11) through the port's ChunkedImageServer on the card:
    the frame streams through the engine, K1 launches once and K2 / K3
    twice."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from mobile_slam_tpu_torch.engine.example import bench_config
    from mobile_slam_tpu_torch.engine.serving import ChunkedImageServer
    from mobile_slam_tpu_torch.eval import adversarial as adv
    from mobile_slam_tpu_torch.eval import simulation as sim
    from mobile_slam_tpu_torch.ops import lk

    cfg = bench_config()
    cam, nuis = cfg.camera, adv.LEVELS[0]
    data = adv.make_adversarial_data(sim.SimConfig(duration=0.2, num_landmarks=900, seed=11),
                                     cam, cam.r_ic_mat, np.asarray(cam.t_ic_vec), nuis)
    img = adv.render_frame_adversarial(data, 0, cam, cam.r_ic_mat, np.asarray(cam.t_ic_vec),
                                       nuis)
    server = ChunkedImageServer(cfg, chunk_size=25)
    for i in np.flatnonzero(data.imu_ts <= data.cam_ts[0] + 1e-9):
        server.push_imu(data.imu_ts[i], data.imu_acc[i], data.imu_gyr[i])
    lk.reset_launch_counts()
    server.process_frame(img, data.cam_ts[0])
    torch.cuda.synchronize()
    assert server.frames_streamed == 1 and server.mode == "stream"
    assert lk.launch_counts == {"track_pyramidal": 1, "refine_template": 2,
                                "extract_patches": 2}


@pytest.mark.cuda
def test_dryrun_over_two_ranks_on_the_card():
    """parallel/dryrun.dryrun_multichip(2): two spawned ranks (on distinct
    cards over NCCL where the machine has two, else sharing one over gloo)
    run the reference's three dry-run checks; the sharded solve runs only
    with a card per rank."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from mobile_slam_tpu_torch.parallel import dryrun

    out = dryrun.dryrun_multichip(2)
    assert out["poses"].shape == (2, 3) and bool(torch.isfinite(out["poses"]).all())
    assert (out["tp_dx_norm"] is not None) == (torch.cuda.device_count() >= 2)
    assert out["mesh_ms"] > 0 and out["single_ms"] > 0
    assert not out["jax_imported"] and not out["reference_imported"]
