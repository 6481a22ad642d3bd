"""What the K1-K3 kernels and their wrappers rest on, held on the CPU.

* Borders: a gather that clamps each row and column into the unpadded image
  equals the gather from the replicate-padded copy, bit for bit.
* K2's one-round right-hand side (the faster form its kernel could take)
  against the two-round form it takes, and the plain K2 run with it against
  the Pallas kernel in interpret mode.
* The per-point step counts of the plain versions (the kernels' chains).
* The wrappers' layout step: no copy of a contiguous float32 image or
  level, one copy of anything else, no padding, and the errors it raises.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests._torch_parity import reference_compile_cache, shifted, texture  # noqa: F401

from mobile_slam_tpu.ops import lk_pallas
from mobile_slam_tpu_torch.ops import image as im, lk

H, W = 64, 96
WIN = 21


@pytest.fixture(autouse=True)
def interpret_mode():
    lk_pallas._INTERPRET = True
    yield
    lk_pallas._INTERPRET = False


@pytest.fixture(scope="module")
def world():
    img0 = texture(np.random.RandomState(3), H, W)
    img1 = shifted(img0, 1.7, -1.2).astype(np.float32)
    return img0.astype(np.float32), img1


def _points():
    pts = np.array([[30.0, 30.0], [45.3, 22.7], [60.1, 40.6], [25.8, 44.2],
                    [70.0, 25.5], [40.0, 15.0], [12.5, 12.5], [83.0, 50.0],
                    [5.0, 30.0], [0.0, 0.0]], np.float32)
    act = np.ones(len(pts), bool)
    act[-1] = False
    return pts, act


# --- (a) the identity the in-kernel border rests on -----------------------

@pytest.mark.parametrize("h,w", [(37, 53), (64, 96), (25, 24)])
@pytest.mark.parametrize("rows", [WIN + 3, WIN + 1])
def test_clamped_gather_equals_gather_from_padded_copy(h, w, rows):
    """Exact: both sides only select pixels. Origins cover the four corners,
    the four edges and the interior of the padded image."""
    pad = (WIN - 1) // 2 + 2
    img = torch.from_numpy(np.random.RandomState(h * w).rand(h, w).astype(np.float32))
    hp, wp = h + 2 * pad, w + 2 * pad
    ys = [0, 1, pad - 1, pad, (hp - rows) // 2, hp - rows - 1, hp - rows]
    xs = [0, 1, pad - 1, pad, (wp - rows) // 2, wp - rows - 1, wp - rows]
    by, bx = (t.reshape(-1) for t in torch.meshgrid(torch.tensor(ys), torch.tensor(xs),
                                                    indexing="ij"))
    want = lk._gather_block(lk._pad(img, pad), by, bx, rows, rows)
    got = lk._gather_clamped(img, by, bx, rows, rows, pad)
    assert got.shape == (len(ys) * len(xs), rows, rows)
    assert torch.equal(got, want)


# --- (b) K2's one-round right-hand side -----------------------------------

def _rel(a, b, ref):
    return float((a - b).abs().max() / ref.abs().max())


def test_one_round_rhs_matches_two_round_on_the_test_world(world):
    """float32 sums of 441 terms in two orders: relative 1e-4 of the largest
    right-hand side, each also against the float64 value."""
    img0, img1 = world
    pts, _ = _points()
    p = torch.from_numpy(pts)
    t, gx, gy = (a.reshape(-1, WIN, WIN) for a in
                 lk.extract_patches_ref(torch.from_numpy(img0), p, WIN))
    pad = (WIN - 1) // 2 + 2
    c = lk._sample(lk._pad(torch.from_numpy(img1), pad), p[:, 0] + 0.9, p[:, 1] - 0.6,
                   WIN, pad)
    one = lk.refine_rhs_one_round(c, t, gx, gy)
    two = lk.refine_rhs_two_round(c, t, gx, gy)
    exact = lk.refine_rhs_two_round(*(a.double() for a in (c, t, gx, gy)))
    for a, b, e in zip(one, two, exact):
        assert float(e.abs().max()) > 1.0     # a real step, not a converged one
        assert _rel(a, b, e) < 1e-4
        assert _rel(a.double(), e, e) < 1e-4
        assert _rel(b.double(), e, e) < 1e-4


def test_one_round_rhs_on_a_bright_weakly_textured_patch():
    """0..255 values near 200 with gradients under 1 per pixel: c - t stays a
    small residual, so the one-round form loses nothing to cancellation: it
    is held within 1e-5 relative of the float64 value. The two-round form is
    the less exact one here (the float32 mean of 441 values near 200 is off
    by ~1e-5, and sum(gx) ~ 100 carries that into b), so it is held, and the
    two are held together, at 1e-3."""
    rs = np.random.RandomState(8)
    yy, xx = np.mgrid[0:WIN, 0:WIN].astype(np.float64)
    k = 6
    ax, ay = rs.uniform(-0.3, 0.3, (2, k, 1, 1))
    ph = rs.uniform(0, 6.0, (k, 1, 1))

    def patch(sx, sy):
        x, y = xx + sx, yy + sy
        return 200.0 + ax * x + ay * y + 1.5 * np.sin(0.31 * x + ph) * np.cos(0.23 * y)

    t = torch.from_numpy(patch(0.0, 0.0).astype(np.float32))
    c = torch.from_numpy((patch(0.6, -0.4) + 1.5).astype(np.float32))  # shifted, brighter
    gx = torch.from_numpy(np.gradient(patch(0.0, 0.0), axis=2).astype(np.float32))
    gy = torch.from_numpy(np.gradient(patch(0.0, 0.0), axis=1).astype(np.float32))
    assert float(gx.abs().max()) < 1.0 and float(gy.abs().max()) < 1.0
    one = lk.refine_rhs_one_round(c, t, gx, gy)
    two = lk.refine_rhs_two_round(c, t, gx, gy)
    exact = lk.refine_rhs_two_round(*(a.double() for a in (c, t, gx, gy)))
    for a, b, e in zip(one, two, exact):
        assert float(e.abs().min()) > 1.0     # a real step at every patch
        assert _rel(a.double(), e, e) < 1e-5
        assert _rel(b.double(), e, e) < 1e-3
        assert _rel(a, b, e) < 1e-3


@pytest.mark.parametrize("iters,max_shift", [(8, 2.0), (30, 2.5), (4, 2.0)])
def test_refine_with_one_round_rhs_matches_pallas(world, iters, max_shift):
    """The plain K2 taking its right-hand side in one round, against
    the Pallas kernel in interpret mode on the inputs of
    test_torch_lk.test_refine_matches_pallas_and_xla: ok identical, positions
    within 1e-3 px, residuals within 0.05."""
    img0, img1 = world
    pts, act = _points()
    tmpl = lk_pallas.extract_patches(jnp.asarray(img0), jnp.asarray(pts), WIN)
    start = pts + np.array([0.9, -0.6], np.float32)
    pos_j, ok_j, res_j = lk_pallas.refine_template(
        jnp.asarray(img1), *tmpl, jnp.asarray(start), jnp.asarray(act), WIN, iters,
        0.005, max_shift)
    pos_t, ok_t, res_t = lk.refine_template_ref(
        torch.from_numpy(img1), *[torch.from_numpy(np.asarray(t)) for t in tmpl],
        torch.from_numpy(start), torch.from_numpy(act), WIN, iters, 0.005, max_shift,
        one_round=True)
    ok_j = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    assert ok_j.sum() >= 7
    assert np.linalg.norm(pos_t.numpy()[ok_j] - np.asarray(pos_j)[ok_j], axis=-1).max() < 1e-3
    assert np.abs(res_t.numpy()[ok_j] - np.asarray(res_j)[ok_j]).max() < 0.05


# --- (c) the steps each point runs ----------------------------------------

@pytest.mark.parametrize("levels", [1, 3])
def test_track_steps_per_point(world, levels):
    img0, img1 = world
    pts, act = _points()
    p0 = im.build_pyramid(torch.from_numpy(img0), levels - 1)
    p1 = im.build_pyramid(torch.from_numpy(img1), levels - 1)
    prm = lk.LKParams(window=WIN, levels=levels - 1, iters=6, eps=0.005)
    its, steps = [], []
    out = lk.track_pyramidal_ref(p0, p1, torch.from_numpy(pts), torch.from_numpy(act),
                                 prm, iterations=its, steps=steps)
    plain = lk.track_pyramidal_ref(p0, p1, torch.from_numpy(pts), torch.from_numpy(act), prm)
    assert all(torch.equal(a, b) for a, b in zip(out, plain))   # counting changes nothing
    (n,) = steps
    assert n.shape == (len(pts),) and n.dtype == torch.int64
    assert len(its) == levels and int(n.sum()) == sum(its)
    assert int(n[-1]) == 0                              # the dead slot
    assert int(n.max()) <= prm.iters * levels
    assert int(n[:6].min()) >= levels                   # a live point steps at every level
    # With no early exit every live, invertible point runs into the cap.
    capped = []
    lk.track_pyramidal_ref(p0, p1, torch.from_numpy(pts), torch.from_numpy(act),
                           prm._replace(eps=0.0), steps=capped)
    assert int(capped[0][:6].max()) == prm.iters * levels


def test_refine_steps_per_point(world):
    img0, img1 = world
    pts, act = _points()
    tmpl = lk.extract_patches_ref(torch.from_numpy(img0), torch.from_numpy(pts), WIN)
    start = torch.from_numpy(pts + np.array([0.9, -0.6], np.float32))
    args = (torch.from_numpy(img1), *tmpl, start, torch.from_numpy(act), WIN)
    its, steps = [], []
    lk.refine_template_ref(*args, 8, 0.005, 2.0, iterations=its, steps=steps)
    (n,) = steps
    assert int(n.sum()) == its[0] and int(n[-1]) == 0 and int(n.max()) <= 8
    assert int(n[:6].min()) >= 1
    capped = []
    lk.refine_template_ref(*args, 5, 0.0, 2.0, steps=capped)
    assert int(capped[0][:6].max()) == 5 and int(capped[0][-1]) == 0


@pytest.mark.parametrize("levels", [1, 3])
def test_track_windows_follow_the_steps(world, levels):
    """``windows`` records one position per step of each moving point, at
    the level it steps on, and changes nothing."""
    img0, img1 = world
    pts, act = _points()
    p0 = im.build_pyramid(torch.from_numpy(img0), levels - 1)
    p1 = im.build_pyramid(torch.from_numpy(img1), levels - 1)
    prm = lk.LKParams(window=WIN, levels=levels - 1, iters=6, eps=0.005)
    its, wins = [], []
    out = lk.track_pyramidal_ref(p0, p1, torch.from_numpy(pts), torch.from_numpy(act),
                                 prm, iterations=its, windows=wins)
    plain = lk.track_pyramidal_ref(p0, p1, torch.from_numpy(pts), torch.from_numpy(act), prm)
    assert all(torch.equal(a, b) for a, b in zip(out, plain))
    for lvl, n in zip(range(levels - 1, -1, -1), its):
        at = [(x, y) for lv, x, y in wins if lv == lvl]
        assert sum(x.numel() for x, _ in at) == n
        assert all(x.shape == y.shape for x, y in at)
    # The first step of the finest level starts where the coarser levels ended.
    x0 = [x for lv, x, _ in wins if lv == 0][0]
    assert x0.numel() >= 6 and bool(torch.isfinite(x0).all())


def test_refine_windows_follow_the_steps(world):
    img0, img1 = world
    pts, act = _points()
    tmpl = lk.extract_patches_ref(torch.from_numpy(img0), torch.from_numpy(pts), WIN)
    start = torch.from_numpy(pts + np.array([0.9, -0.6], np.float32))
    args = (torch.from_numpy(img1), *tmpl, start, torch.from_numpy(act), WIN, 8, 0.005, 2.0)
    its, wins = [], []
    pos, _, _ = lk.refine_template_ref(*args, iterations=its, windows=wins)
    *steps, (xe, ye) = wins
    assert sum(x.numel() for x, _ in steps) == its[0]
    assert torch.equal(steps[0][0], start[:, 0][torch.from_numpy(act)])
    a = torch.from_numpy(act)
    assert torch.equal(xe, pos[a, 0]) and torch.equal(ye, pos[a, 1])   # the residual's window


# --- (d) the wrappers' layout step ----------------------------------------

def _no_padding(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the kernel wrappers must not pad or concatenate")
    monkeypatch.setattr(lk, "_pad", boom)
    monkeypatch.setattr(lk.F, "pad", boom)
    monkeypatch.setattr(torch, "cat", boom)


def test_build_pyramid_levels_are_contiguous(world):
    pyr = im.build_pyramid(torch.from_numpy(world[0]), 3)
    assert [tuple(p.shape) for p in pyr] == [(64, 96), (32, 48), (16, 24), (8, 12)]
    assert all(p.is_contiguous() and p.dtype == torch.float32 for p in pyr)


def test_track_prep_hands_over_the_levels_without_a_copy(world, monkeypatch):
    pts, act = _points()
    p0 = im.build_pyramid(torch.from_numpy(world[0]), 2)
    p1 = im.build_pyramid(torch.from_numpy(world[1]), 2)
    _no_padding(monkeypatch)
    prm = lk.LKParams(window=WIN, levels=2, iters=5, eps=0.01)
    t_pts, t_act = torch.from_numpy(pts), torch.from_numpy(act)
    prev, nxt, pts_c, act_c, prm_out = lk._track_prep(p0, p1, t_pts, t_act, prm)
    assert [a.data_ptr() for a in prev + nxt] == [a.data_ptr() for a in p0 + p1]
    assert pts_c.data_ptr() == t_pts.data_ptr() and act_c.data_ptr() == t_act.data_ptr()
    assert prm_out == prm


def test_track_prep_copies_other_layouts_once(world):
    pts, act = _points()
    wide = torch.from_numpy(world[0]).double()
    strided = torch.from_numpy(np.ascontiguousarray(np.repeat(world[1], 2, axis=1)))[:, ::2]
    assert not strided.is_contiguous()
    prm = lk.LKParams(window=WIN, levels=0, iters=5, eps=0.01)
    prev, nxt, pts_c, act_c, _ = lk._track_prep(
        [wide], [strided], torch.from_numpy(pts).double(),
        torch.from_numpy(act.astype(np.int32)), prm)
    for got, src in ((prev[0], wide), (nxt[0], strided)):
        assert got.dtype == torch.float32 and got.is_contiguous()
        assert got.data_ptr() != src.data_ptr()
        assert torch.equal(got, src.float())
    assert pts_c.dtype == torch.float32 and act_c.dtype == torch.bool
    assert act_c.tolist() == act.tolist()


def test_refine_prep_hands_over_the_image_without_a_copy(world, monkeypatch):
    _no_padding(monkeypatch)
    pts, act = _points()
    img = torch.from_numpy(world[1])
    tmpl = [torch.zeros(len(pts), WIN * WIN) for _ in range(3)]
    t_pts, t_act = torch.from_numpy(pts), torch.from_numpy(act)
    out = lk._refine_prep(img, *tmpl, t_pts, t_act, WIN, 8, 0.01, 2.0)
    want = [img, *tmpl, t_pts, t_act]
    assert [a.data_ptr() for a in out[:6]] == [a.data_ptr() for a in want]
    assert out[6:] == (WIN, 8, 0.01, 2.0)
    strided = torch.from_numpy(np.ascontiguousarray(np.repeat(world[1], 2, axis=1)))[:, ::2]
    got = lk._refine_prep(strided, *tmpl, t_pts, t_act, WIN, 8, 0.01, 2.0)[0]
    assert got.is_contiguous() and got.data_ptr() != strided.data_ptr()
    assert torch.equal(got, strided)


def test_extract_prep_hands_over_the_image_without_a_copy(world, monkeypatch):
    _no_padding(monkeypatch)
    pts, _ = _points()
    img, t_pts = torch.from_numpy(world[1]), torch.from_numpy(pts)
    out = lk._extract_prep(img, t_pts, WIN)
    assert [a.data_ptr() for a in out[:2]] == [img.data_ptr(), t_pts.data_ptr()]
    assert out[2] == WIN
    strided = torch.from_numpy(np.ascontiguousarray(np.repeat(world[1], 2, axis=1)))[:, ::2]
    got = lk._extract_prep(strided, t_pts.double(), WIN)
    assert got[0].is_contiguous() and got[0].data_ptr() != strided.data_ptr()
    assert torch.equal(got[0], strided)
    assert got[1].dtype == torch.float32 and torch.equal(got[1], t_pts)


def test_prep_raises_on_what_the_kernels_do_not_take(world, monkeypatch):
    pts, act = (torch.from_numpy(a) for a in _points())
    img = torch.from_numpy(world[0])
    prm = lk.LKParams(window=WIN, levels=0, iters=5, eps=0.01)
    with pytest.raises(ValueError, match="window"):
        lk._track_prep([img], [img], pts, act, prm._replace(window=33))
    with pytest.raises(ValueError, match="depth"):
        lk._track_prep([img] * 9, [img] * 9, pts, act, prm)
    with pytest.raises(ValueError, match="depth"):
        lk._track_prep([img], [img, img], pts, act, prm)
    with pytest.raises(ValueError, match="2-D"):
        lk._track_prep([img[None]], [img[None]], pts, act, prm)
    with pytest.raises(ValueError, match="differ"):
        lk._track_prep([img], [img[:, :-1]], pts, act, prm)
    with pytest.raises(ValueError, match="points"):
        lk._track_prep([img], [img], pts[:, :1], act, prm)
    with pytest.raises(ValueError, match="active"):
        lk._track_prep([img], [img], pts, act[:-1], prm)
    tmpl = [torch.zeros(len(pts), WIN * WIN) for _ in range(3)]
    with pytest.raises(ValueError, match="templates"):
        lk._refine_prep(img, tmpl[0][:, :-1], *tmpl[1:], pts, act, WIN, 8, 0.01, 2.0)
    with pytest.raises(ValueError, match="2-D"):
        lk._refine_prep(img[None], *tmpl, pts, act, WIN, 8, 0.01, 2.0)
    with pytest.raises(ValueError, match="window"):
        lk._refine_prep(img, *tmpl, pts, act, 2, 8, 0.01, 2.0)
    with pytest.raises(ValueError, match="2-D"):
        lk._extract_prep(img[None], pts, WIN)
    with pytest.raises(ValueError, match="2-D"):
        lk._extract_prep(img[:0], pts, WIN)
    for window in (2, 33):
        with pytest.raises(ValueError, match="window"):
            lk._extract_prep(img, pts, window)
    for centers in (pts[:, :1], pts[:0], pts[None]):
        with pytest.raises(ValueError, match="points"):
            lk._extract_prep(img, centers, WIN)
    # Every window and depth the kernels take fits the card's shared memory;
    # one that would not is refused before the launch, with both sizes.
    assert lk.track_smem_bytes(WIN, 4) == 45872
    assert lk.track_smem_bytes(lk.MAX_WINDOW, lk.MAX_LEVELS) <= lk.SMEM_LIMIT
    monkeypatch.setattr(lk, "SMEM_LIMIT", 40000)
    with pytest.raises(ValueError, match="45872 bytes.*40000"):
        lk._track_prep([img] * 4, [img] * 4, pts, act, prm)


def test_cuda_entry_points_raise_without_a_card_and_count_nothing(world):
    """K1's, K2's and K3's CUDA entry points build first, so without a card
    they raise; they never fall back to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    pts, act = (torch.from_numpy(a) for a in _points())
    img = torch.from_numpy(world[0])
    before = dict(lk.launch_counts)
    with pytest.raises(RuntimeError, match="CUDA"):
        lk._track_pyramidal_cuda([img], [img], pts, act, lk.LKParams(levels=0))
    tmpl = [torch.zeros(len(pts), WIN * WIN) for _ in range(3)]
    with pytest.raises(RuntimeError, match="CUDA"):
        lk._refine_template_cuda(img, *tmpl, pts, act, WIN, 8, 0.01, 2.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        lk._extract_patches_cuda(img, pts, WIN)
    assert lk.launch_counts == before


def test_k1_is_configured_once_per_device(monkeypatch):
    """The dynamic shared-memory attribute is per device: lk_configure runs
    at the first K1 launch on each card and never again on that card."""
    class Lib:
        calls = 0

        def lk_configure(self):
            Lib.calls += 1
            return 0

    current = {"index": 0}
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current["index"])
    monkeypatch.setattr(lk, "_configured", set())
    for index, want in ((0, 1), (0, 1), (1, 2), (0, 2), (1, 2)):
        current["index"] = index
        lk._configure(Lib())
        assert Lib.calls == want

    class Refused(Lib):
        def lk_configure(self):
            return 1

    current["index"] = 2
    with pytest.raises(RuntimeError, match="lk_configure"):
        lk._configure(Refused())
    assert 2 not in lk._configured


def test_ptxas_report_reads_registers_shared_memory_and_spills(tmp_path, monkeypatch):
    from mobile_slam_tpu_torch.ops import cuda_build

    (tmp_path / "libx.log").write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z15lk_track_kernelILi0EEv9LevelMetaPKf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z15lk_track_kernelILi0EEv9LevelMetaPKf\n"
        "    8 bytes stack frame, 10 bytes spill stores, 16 bytes spill loads\n"
        "ptxas info    : Used 72 registers, used 1 barriers, 8 bytes cumulative stack size, 160 bytes smem\n"
        "ptxas info    : Compile time = 130.382 ms\n"
        "ptxas info    : Compiling entry function '_Z18probe_touch_kernelPKfS0_Pf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z18probe_touch_kernelPKfS0_Pf\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 32 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_Z15lk_probe_kernelILi2ELi21EEvPKfS1_' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z15lk_probe_kernelILi2ELi21EEvPKfS1_\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 1 barriers, 6272 bytes smem\n")
    monkeypatch.setattr(cuda_build, "library_path", lambda name: tmp_path / "libx.so")
    assert cuda_build.ptxas_report("x") == [
        "lk_track_kernel<0>: 72 registers, 160 B static shared memory, spills 10 B stored / 16 B loaded",
        "probe_touch_kernel: 32 registers, 0 B static shared memory, spills 0 B stored / 0 B loaded",
        "lk_probe_kernel<2, 21>: 40 registers, 6272 B static shared memory, spills 0 B stored / 0 B loaded"]
    assert "-v" in cuda_build.NVCC_FLAGS


def test_count_loop_loads_finds_the_loads_inside_backward_branches():
    from mobile_slam_tpu_torch.ops import cuda_build

    sass = (
        "\n\tcode for sm_90a\n"
        "\t\tFunction : _Z15lk_probe_kernelILi3EEvPKfS1_iiiS1_iPfS2_\n"
        "\t.headerflags\t@\"EF_CUDA_SM90\"\n"
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;\n"
        "        /*0010*/                   LDG.E R2, desc[UR4][R4.64] ;\n"
        ".L_x_1:\n"
        "        /*0020*/                   LDG.E.CONSTANT R5, desc[UR4][R6.64] ;\n"
        "        /*0030*/                   FADD R7, R5, R7 ;\n"
        "        /*0040*/              @P0 BRA `(.L_x_1) ;\n"
        "        /*0050*/                   LDG.E R8, desc[UR4][R6.64] ;\n"
        "        /*0060*/                   BRA `(.L_x_2) ;\n"
        ".L_x_2:\n"
        "        /*0070*/                   EXIT ;\n"
        "\t\tFunction : _Z18probe_touch_kernelPKfS0_Pf\n"
        "        /*0000*/                   LDG.E R2, desc[UR4][R4.64] ;\n"
        "        /*0010*/                   LDG.E R3, desc[UR4][R4.64+0x4] ;\n"
        "        /*0020*/              @P1 BRA 0x10 ;\n"
        "        /*0030*/                   EXIT ;\n")
    assert cuda_build.count_loop_loads(sass) == {"lk_probe_kernel<3>": (1, 3),
                                                 "probe_touch_kernel": (1, 2)}
