"""The plain versions of the two probe kernels (P1, P2) against a numpy
transcription of the reference kernels' arithmetic (scripts/
dev_call_overhead.py ``_tiny_kernel``, scripts/dev_lk_pack_probe.py
``_kernel``; the scripts themselves need a TPU), and the probes' dispatch.

Bars: P1 exact, on inputs where its block sum shows (an integer-valued
image, so the float32 sum is exact in any order, and points near 0, so
1e-12 x the sum is ~1e6 ulps of them); P2's ``full`` mode within 1e-3 px
after 8 iterations (float32 window sums taken in another order; the known
(-3, +3) shift is recovered to 0.02 px), the other modes' displacement
within 1e-6 px (their steps are constants or exactly 0, as measured), and
every mode's witness, the sum of every window it compared, within 1e-5
relative (float32 sums of 8 x 441 terms in another order).
"""

import numpy as np
import pytest
import torch

from mobile_slam_tpu_torch.probes import call_overhead as p1
from mobile_slam_tpu_torch.probes import lk_pack_probe as p2

F32 = np.float32
P2_TOL = 1e-3
P2_DISP_TOL = 1e-6
P2_WIT_RTOL = 1e-5


def _np_touch(pts, img):
    s = F32(np.sum(img[:8, :128], dtype=F32) * F32(1e-12))
    return (pts + s).astype(F32), s


def test_p1_plain_matches_reference_arithmetic():
    pts, img = p1.check_inputs("cpu")
    out = p1.touch_points_ref(pts, img)
    ref, s = _np_touch(pts.numpy(), img.numpy())
    np.testing.assert_array_equal(out.numpy(), ref)
    assert out.dtype == torch.float32
    # The block sum shows in every output, and a neighbouring block's would
    # give another result.
    assert (out.numpy() != pts.numpy()).all()
    np.testing.assert_allclose(out.numpy() - pts.numpy(), s, rtol=1e-5)
    assert not np.array_equal(ref, _np_touch(pts.numpy(), img.numpy()[1:])[0])


# numpy transcription of dev_lk_pack_probe._kernel for one point.
def _bilinear(block, fx, fy, win):
    w00 = (F32(1.0) - fx) * (F32(1.0) - fy)
    w01 = fx * (F32(1.0) - fy)
    w10 = (F32(1.0) - fx) * fy
    w11 = fx * fy
    return (w00 * block[0:win, 0:win] + w01 * block[0:win, 1:win + 1]
            + w10 * block[1:win + 1, 0:win] + w11 * block[1:win + 1, 1:win + 1])


def _scharr(tb, n):
    right = F32(3) * tb[0:n, 2:n + 2] + F32(10) * tb[1:n + 1, 2:n + 2] + F32(3) * tb[2:n + 2, 2:n + 2]
    left = F32(3) * tb[0:n, 0:n] + F32(10) * tb[1:n + 1, 0:n] + F32(3) * tb[2:n + 2, 0:n]
    bot = F32(3) * tb[2:n + 2, 0:n] + F32(10) * tb[2:n + 2, 1:n + 1] + F32(3) * tb[2:n + 2, 2:n + 2]
    top = F32(3) * tb[0:n, 0:n] + F32(10) * tb[0:n, 1:n + 1] + F32(3) * tb[0:n, 2:n + 2]
    return (right - left) / F32(32), (bot - top) / F32(32)


def _np_probe_point(tx, ty, prev_p, next_p, pad, mode, iters, win):
    hp, wp = prev_p.shape
    half = (win - 1) // 2
    if mode == "notmpl":
        t = np.full((win, win), 0.5, F32)
        gx = np.full((win, win), 0.25, F32)
        gy = np.full((win, win), 0.25, F32)
    else:
        tbx = int(np.clip(int(np.floor(tx)) - half - 1 + pad, 0, wp - (win + 3)))
        tby = int(np.clip(int(np.floor(ty)) - half - 1 + pad, 0, hp - (win + 3)))
        ftx, fty = F32(tx - np.floor(tx)), F32(ty - np.floor(ty))
        tb = prev_p[tby:tby + win + 3, tbx:tbx + win + 3]
        gxb, gyb = _scharr(tb, win + 1)
        t = _bilinear(tb[1:win + 2, 1:win + 2], ftx, fty, win)
        gx = _bilinear(gxb, ftx, fty, win)
        gy = _bilinear(gyb, ftx, fty, win)
    gxx, gxy, gyy = np.sum(gx * gx), np.sum(gx * gy), np.sum(gy * gy)
    det = gxx * gyy - gxy * gxy
    inv_det = F32(1.0) / det if abs(det) > 1e-12 else F32(0.0)
    ix, iy = F32(tx), F32(ty)
    witness = 0.0
    for _ in range(iters):
        if mode == "empty":
            ix, iy = F32(ix + F32(1e-4)), F32(iy + F32(1e-4))
            continue
        fx, fy = F32(ix - np.floor(ix)), F32(iy - np.floor(iy))
        if mode == "noload":
            c = _bilinear(tb[1:win + 2, 1:win + 2], fx, fy, win)
        else:
            nbx = int(np.clip(int(np.floor(ix)) - half + pad, 0, wp - (win + 1)))
            nby = int(np.clip(int(np.floor(iy)) - half + pad, 0, hp - (win + 1)))
            c = _bilinear(next_p[nby:nby + win + 1, nbx:nbx + win + 1], fx, fy, win)
        witness += np.sum(c, dtype=np.float64)
        if mode == "noarith":
            ix, iy = F32(ix + c[0, 0] * F32(1e-9)), F32(iy + F32(1e-4))
            continue
        diff = c - t
        b1, b2 = np.sum(diff * gx), np.sum(diff * gy)
        ix = F32(ix - (gyy * b1 - gxy * b2) * inv_det)
        iy = F32(iy - (gxx * b2 - gxy * b1) * inv_det)
    if mode == "empty":
        witness = np.sum(t, dtype=np.float64)
    return ix, iy, witness


@pytest.fixture(scope="module")
def p2_world():
    return p2.inputs("cpu", k=12, size=96, seed=3)


@pytest.mark.parametrize("mode", p2.MODES)
def test_p2_plain_matches_reference_arithmetic(p2_world, mode):
    pts, prev_p, next_p = p2_world
    out, wit = p2.lk_probe_ref(pts, prev_p, next_p, p2.PAD, mode)
    out, wit, q = out.numpy(), wit.numpy(), pts.numpy()
    ref = np.array([_np_probe_point(float(x), float(y), prev_p.numpy(), next_p.numpy(),
                                    p2.PAD, mode, p2.ITERS, p2.WIN) for x, y in q])
    if mode == "full":      # the probe really tracks the (-3, +3) shift
        np.testing.assert_allclose(out, ref[:, :2], atol=P2_TOL, rtol=0)
        np.testing.assert_allclose(np.median(out - q, axis=0), [-3.0, 3.0], atol=0.02)
    else:
        np.testing.assert_allclose(out - q, ref[:, :2] - q, atol=P2_DISP_TOL, rtol=0)
    np.testing.assert_allclose(wit, ref[:, 2], rtol=P2_WIT_RTOL)
    assert np.abs(wit).min() > 100.0        # every point summed a real window


def test_probe_dispatch_on_cpu():
    """CPU tensors take the plain versions and count no launch; the CUDA
    entry points need a device and raise without one."""
    pts, imgs = p1.inputs("cpu", k=8, size=128, steps=1)
    q, prev_p, next_p = p2.inputs("cpu", k=4, size=64)
    b1, b2 = dict(p1.launch_counts), dict(p2.launch_counts)
    assert torch.equal(p1.touch_points(pts, imgs[0]), p1.touch_points_ref(pts, imgs[0]))
    for a, b in zip(p2.lk_probe(q, prev_p, next_p, p2.PAD, "full"),
                    p2.lk_probe_ref(q, prev_p, next_p, p2.PAD, "full")):
        assert torch.equal(a, b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            p1._touch_points_cuda(pts, imgs[0])
        with pytest.raises(RuntimeError, match="CUDA"):
            p2._lk_probe_cuda(q, prev_p, next_p, p2.PAD, "full")
        with pytest.raises(ValueError, match="CUDA"):
            p2.run(device="cpu")
    with pytest.raises(ValueError, match="mode"):
        p2.lk_probe(q, prev_p, next_p, p2.PAD, "bogus")
    with pytest.raises(ValueError, match="window 21"):   # the kernel's only window
        p2._lk_probe_cuda(q, prev_p, next_p, p2.PAD, "full", window=15)
    assert p1.launch_counts == b1 and p2.launch_counts == b2


def test_call_overhead_driver_on_cpu():
    """The P1 driver's loop and slope on the CPU (eager only; the CUDA
    graph needs a card)."""
    res = p1.run(device="cpu", calls=(0, 1, 2), reps=1, passes=1, k=8, size=128,
                 steps=3)
    assert sorted(res["eager"]) == [0, 1, 2] and res["graph"] is None
    assert all(v > 0 for v in res["eager"].values())
    assert np.isfinite(res["slope_eager_us"]) and res["slope_graph_us"] is None


def test_forward_ad_cost_probe_on_cpu():
    """The forward-AD probe runs on the CPU and shows its finding there: a
    constant times a differentiated input goes through PyTorch's Python
    reference ops, the plain product and a product of two differentiated
    inputs do not; on a machine without a card it refuses the card."""
    from mobile_slam_tpu_torch.probes import forward_ad_cost

    out = forward_ad_cost.run("cpu", n=20)
    cases = out["cases"]
    assert cases["constant * dual"]["ref_calls"] > 0
    assert cases["plain"]["ref_calls"] == 0 and cases["dual * dual"]["ref_calls"] == 0
    assert all(c["us_per_call"] > 0 for c in cases.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            forward_ad_cost.run("cuda", n=1)
