"""The port's dataset I/O against OpenCV and the JAX package, on the CPU.

1. ``io/png.py``: the decoder equals ``cv2.imread(..., IMREAD_GRAYSCALE)``
   bit for bit on OpenCV-written 8- and 16-bit grayscale PNG and binary
   PGM, and decodes each of the five PNG row filters (built here) at both
   depths, through the C row unfilter and through the Python rows alike;
   RGB, gray + alpha and RGBA PNG at 8 and 16 bits read within GRAY_BAR
   grey levels of OpenCV, through io/png.py and through the native loader
   (8 bits), which agree with each other exactly; the encoder round-trips
   through OpenCV; palette, interlaced, JPEG and 16-bit PGM raise.
2. ``io/synthetic.py`` against ``scripts/make_synthetic_dataset.py`` for
   the same ``SimConfig`` (1.5 s, noise, seed 7): the IMU, mocap and image
   CSVs are byte-equal and the frames the same pixels.
3. The CSV loaders and ``EurocDataset`` (the pure reader and the native
   one) equal the JAX package's ``EurocDataset(use_native=False)`` on that
   sequence, images included, also through ``image_stream`` (the native
   prefetching stream and the sequential reads).
4. ``write_tum`` writes the reference's bytes; ``read_tum`` reads them back.
"""

import dataclasses
import filecmp
import importlib.util
import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest

from mobile_slam_tpu.io import dataset as jds
from mobile_slam_tpu.io import trajectory as jtraj
from mobile_slam_tpu_torch.io import dataset as tds
from mobile_slam_tpu_torch.io import native_loader, png, synthetic
from mobile_slam_tpu_torch.io import trajectory as ttraj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ_SECONDS = 1.5
# Grey levels between a colour PNG read here and by OpenCV: the port and
# native/loader.cpp truncate (299 R + 587 G + 114 B) / 1000, libpng rounds
# its own fixed-point luma. Measured: at most 1, on about 0.3% of the
# pixels at 8 bits and half of them at 16 (libpng converts before it drops
# the low byte); gray + alpha reads exactly.
GRAY_BAR = 1


# ---------------------------------------------------------------------------
# 1. PNG / PGM
# ---------------------------------------------------------------------------

def _image(depth: int, h=37, w=53, seed=0) -> np.ndarray:
    rs = np.random.RandomState(seed)
    smooth = np.cumsum(rs.randint(-3, 4, (h, w)), axis=1)    # runs that filters like
    if depth == 8:
        return (smooth + rs.randint(0, 256, (h, 1))).astype(np.uint8)
    return (smooth * 131 + rs.randint(0, 65536, (h, 1))).astype(np.uint16)


@pytest.mark.parametrize("kind", ["png8", "png16", "pgm"])
def test_decoder_matches_opencv(tmp_path, kind):
    img = _image(16 if kind == "png16" else 8)
    path = str(tmp_path / ("img.pgm" if kind == "pgm" else "img.png"))
    assert cv2.imwrite(path, img)
    ref = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    out = png.imread_gray(path)
    assert out.dtype == np.uint8 and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)
    hdr = png.read_header(path)
    assert (hdr.height, hdr.width, hdr.bit_depth) == (*img.shape, img.itemsize * 8)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _png_with_filter(img: np.ndarray, ftype: int, color: int = 0) -> bytes:
    """A PNG of colour type ``color`` of ``img`` ((H, W) or (H, W, samples))
    whose every row uses row filter ``ftype`` (the PNG specification's
    definitions, byte by byte)."""
    h, w = img.shape[:2]
    bpp = img.itemsize * png.CHANNELS[color]
    raw = img.astype(">u2").tobytes() if img.itemsize == 2 else img.tobytes()
    stride = w * bpp
    out, prev = bytearray(), bytes(stride)
    for y in range(h):
        row = raw[y * stride:(y + 1) * stride]
        out.append(ftype)
        for x in range(stride):
            a = row[x - bpp] if x >= bpp else 0
            b, c = prev[x], (prev[x - bpp] if x >= bpp else 0)
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][ftype]
            out.append((row[x] - pred) & 0xFF)
        prev = row

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (png.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8 * img.itemsize, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_decoder_reads_every_row_filter(ftype, depth):
    img = _image(depth, seed=ftype)
    data = _png_with_filter(img, ftype)
    want = img if depth == 8 else (img >> 8).astype(np.uint8)
    np.testing.assert_array_equal(png.decode_png(data), want)
    ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(png.decode_png(data), ref)


@pytest.mark.parametrize("route", ["c", "python"])
@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_both_unfilter_routes_read_every_row_filter(ftype, depth, route, monkeypatch):
    fn = png.native_unfilter()
    assert fn is not None, "csrc/png_unfilter.cpp did not build"
    monkeypatch.setattr(png, "_unfilter_fn", fn if route == "c" else False)
    img = _image(depth, h=29, w=41, seed=10 + ftype)
    data = _png_with_filter(img, ftype)
    ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(png.decode_png(data), ref)
    bad = bytearray(zlib.decompress(data[data.index(b"IDAT") + 4:]))
    bad[(img.shape[1] * img.itemsize + 1) * 3] = 7       # row 3's filter byte
    with pytest.raises(ValueError, match="PNG row filter 7"):
        png._unfilter(bytes(bad), img.shape[0], img.shape[1] * img.itemsize,
                      img.itemsize)


def test_encoder_round_trips_through_opencv(tmp_path):
    img = _image(8, h=64, w=80, seed=5)
    path = str(tmp_path / "w.png")
    png.write_png(path, img)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(png.imread_gray(path), img)


def _color_image(color: int, depth: int, h=37, w=53, seed=0) -> np.ndarray:
    """(H, W, samples) of colour type ``color``: each sample a smooth image
    of its own, so that the row filters see runs."""
    return np.stack([_image(depth, h, w, seed + 10 * c) for c in range(png.CHANNELS[color])], -1)


@pytest.mark.parametrize("depth,route", [(8, "pure"), (8, "native"), (16, "pure")])
@pytest.mark.parametrize("color", [2, 4, 6])
def test_color_png_matches_opencv(tmp_path, color, depth, route):
    """Colour PNG reads as OpenCV reads it, within GRAY_BAR grey levels, through
    io/png.py (8 and 16 bits) and the native loader (8 bits, the only depth
    it decodes: the same integer luma, so the two agree exactly)."""
    img = _color_image(color, depth, seed=color)
    path = str(tmp_path / "c.png")
    with open(path, "wb") as f:
        f.write(_png_with_filter(img, 4, color))          # Paeth: every byte lane
    ref = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    assert png.read_header(path) == png.ImageHeader(53, 37, depth, color)
    out = png.imread_gray(path)
    if route == "native":
        assert native_loader.ensure_built(), "g++ and zlib did not build native/loader.cpp"
        native = native_loader.decode_image(path, 53, 37)
        np.testing.assert_array_equal(native, out)
        out = native
    assert out.dtype == np.uint8 and out.shape == ref.shape
    assert np.abs(out.astype(int) - ref).max() <= GRAY_BAR


@pytest.mark.parametrize("what", ["palette", "interlaced", "pgm16", "jpeg"])
def test_decoder_raises_on_other_files(tmp_path, what):
    img = _image(8)
    if what == "palette":
        data = bytearray(_png_with_filter(img, 0))
        data[8 + 8 + 9] = 3             # IHDR colour type 3 (CRC left stale)
        path = str(tmp_path / "p.png")
        open(path, "wb").write(bytes(data))
    elif what == "interlaced":
        data = bytearray(_png_with_filter(img, 0))
        data[8 + 8 + 12] = 1            # IHDR interlace byte (CRC left stale)
        path = str(tmp_path / "i.png")
        open(path, "wb").write(bytes(data))
    elif what == "pgm16":
        path = str(tmp_path / "d.pgm")
        cv2.imwrite(path, _image(16))
    else:
        path = str(tmp_path / "j.jpg")
        cv2.imwrite(path, img)
    with pytest.raises(ValueError):
        png.imread_gray(path)


# ---------------------------------------------------------------------------
# 2-3. The sequence writer and the dataset readers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sequences(tmp_path_factory):
    """The same 1.5 s sequence written by the port and by the reference's
    script: (port root, reference root)."""
    root = tmp_path_factory.mktemp("seq")
    ours, ref = str(root / "port"), str(root / "ref")
    assert synthetic.main(["--out", ours, "--duration", str(SEQ_SECONDS), "--noise"]) == 0
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_dataset", os.path.join(REPO, "scripts", "make_synthetic_dataset.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    argv = sys.argv
    sys.argv = ["make_synthetic_dataset.py", "--out", ref, "--duration", str(SEQ_SECONDS),
                "--noise"]
    try:
        script.main()
    finally:
        sys.argv = argv
    return ours, ref


@pytest.mark.parametrize("csv", ["imu0", "mocap0", "cam0"])
def test_writer_csvs_equal_the_reference_script(sequences, csv):
    ours, ref = sequences
    a, b = (os.path.join(r, "mav0", csv, "data.csv") for r in (ours, ref))
    assert filecmp.cmp(a, b, shallow=False)


def test_writer_frames_equal_the_reference_script(sequences):
    ours, ref = sequences
    names = sorted(os.listdir(os.path.join(ref, "mav0", "cam0", "data")))
    assert len(names) == int(SEQ_SECONDS * 20) + 1
    for name in names:
        a, b = (cv2.imread(os.path.join(r, "mav0", "cam0", "data", name), cv2.IMREAD_GRAYSCALE)
                for r in (ours, ref))
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("use_native", [False, True])
def test_dataset_matches_reference(sequences, use_native):
    ours, _ = sequences
    if use_native:
        assert native_loader.ensure_built(), "g++ and zlib did not build native/loader.cpp"
    t = tds.EurocDataset(ours, use_native=use_native)
    j = jds.EurocDataset(ours, use_native=False)
    assert t._native == use_native
    for name in ("ts", "acc", "gyr"):
        np.testing.assert_array_equal(getattr(t.imu, name), getattr(j.imu, name))
    np.testing.assert_array_equal(t.images.ts, j.images.ts)
    assert t.images.filenames == j.images.filenames
    for name in ("ts", "p", "q"):
        np.testing.assert_array_equal(getattr(t.ground_truth, name),
                                      getattr(j.ground_truth, name))
    assert len(t) == len(j) == int(SEQ_SECONDS * 20) + 1
    for idx in range(len(t)):
        np.testing.assert_array_equal(t.read_image(idx), j.read_image(idx))
    for got, want in zip(t.imu_between(1.4e9 + 0.2, 1.4e9 + 0.3),
                         j.imu_between(1.4e9 + 0.2, 1.4e9 + 0.3)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("use_native", [False, True])
def test_image_stream_matches_reference(sequences, use_native):
    """``image_stream`` yields every (index, image) of the sequence in order,
    through the native prefetching stream or through ``read_image``, as the
    reference's pure reader reads them."""
    ours, _ = sequences
    t = tds.EurocDataset(ours, use_native=use_native)
    j = jds.EurocDataset(ours, use_native=False)
    stream = t.image_stream(512, 512, prefetch=3)
    assert isinstance(stream, native_loader.PrefetchingImageStream) == use_native
    got = list(stream)
    assert [i for i, _ in got] == list(range(len(j)))
    for (_, img), (_, want) in zip(got, j.image_stream(512, 512)):
        np.testing.assert_array_equal(img, want)
    if use_native:
        stream.close()


def test_csv_loaders_match_reference(tmp_path):
    """Malformed, short, non-finite and traversal lines are skipped alike."""
    imu = tmp_path / "imu.csv"
    imu.write_text("#ts,wx,wy,wz,ax,ay,az\n1000,0.1,0.2,0.3,9.8,0.0,0.1\n"
                   "bad,line\n2000,0.1,nan,0.3,9.8,0,0\n3000,1,2,3,4,5,6\n\n")
    cam = tmp_path / "cam.csv"
    cam.write_text("#ts,file\n1000,a.png\n2000,/etc/passwd\n3000,../x.png\n"
                   "4000,\"b.png\"\nzz,c.png\n")
    gt = tmp_path / "gt.csv"
    gt.write_text("#ts,p,q\n1000,1,2,3,1,0,0,0\n2000,1,2\n3000,4,5,6,0,1,0,0\n")
    for a, b in zip(dataclasses.astuple(tds.load_imu_csv(str(imu))),
                    dataclasses.astuple(jds.load_imu_csv(str(imu)))):
        np.testing.assert_array_equal(a, b)
    ti, ji = tds.load_image_csv(str(cam)), jds.load_image_csv(str(cam))
    np.testing.assert_array_equal(ti.ts, ji.ts)
    assert ti.filenames == ji.filenames == ["a.png", "b.png"]
    for a, b in zip(dataclasses.astuple(tds.load_ground_truth_csv(str(gt))),
                    dataclasses.astuple(jds.load_ground_truth_csv(str(gt)))):
        np.testing.assert_array_equal(a, b)


def test_sixteen_bit_sequence_reads_through_the_pure_decoder(tmp_path):
    """native/loader.cpp decodes only 8-bit PNG: a 16-bit sequence still
    reads, through io/png.py, as OpenCV reads it."""
    base = tmp_path / "mav0"
    (base / "cam0" / "data").mkdir(parents=True)
    (base / "imu0").mkdir()
    (base / "imu0" / "data.csv").write_text("1000,0,0,0,0,0,9.8\n")
    img = _image(16)
    cv2.imwrite(str(base / "cam0" / "data" / "1000.png"), img)
    (base / "cam0" / "data.csv").write_text("1000,1000.png\n")
    ds = tds.EurocDataset(str(tmp_path))
    np.testing.assert_array_equal(ds.read_image(0), cv2.imread(
        str(base / "cam0" / "data" / "1000.png"), cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("use_native", [False, True])
def test_color_sequence_matches_reference(tmp_path, use_native):
    """A 5-frame RGB / RGBA PNG sequence in EuRoC layout (as the KITTI-360
    converter links camera PNGs) reads through ``EurocDataset`` as through
    the reference's, which reads with ``cv2.imread(IMREAD_GRAYSCALE)``,
    within GRAY_BAR, by ``read_image`` and by ``image_stream``."""
    base = tmp_path / "mav0"
    (base / "cam0" / "data").mkdir(parents=True)
    (base / "imu0").mkdir()
    (base / "imu0" / "data.csv").write_text("1000,0,0,0,0,0,9.8\n")
    rows = []
    for i in range(5):
        name = f"{1000 + i}.png"
        color = (2, 6)[i % 2]
        (base / "cam0" / "data" / name).write_bytes(
            _png_with_filter(_color_image(color, 8, seed=20 + i), i % 5, color))
        rows.append(f"{1000 + i},{name}\n")
    (base / "cam0" / "data.csv").write_text("".join(rows))
    if use_native:
        assert native_loader.ensure_built(), "g++ and zlib did not build native/loader.cpp"
    t = tds.EurocDataset(str(tmp_path), use_native=use_native)
    j = jds.EurocDataset(str(tmp_path), use_native=False)
    assert t._native == use_native and len(t) == len(j) == 5
    want = [j.read_image(i) for i in range(5)]
    stream = t.image_stream(53, 37, prefetch=2)
    got = [img.copy() for _, img in stream]
    if use_native:
        stream.close()
    for i in range(5):
        for out in (t.read_image(i), got[i]):
            assert out.shape == want[i].shape
            assert np.abs(out.astype(int) - want[i]).max() <= GRAY_BAR


def test_native_loader_rebuilds_on_force():
    """``ensure_built(force=True)`` compiles native/loader.cpp again (the
    reference's parameter) and leaves it usable."""
    assert native_loader.ensure_built()
    before = os.stat(native_loader._LIB_PATH).st_mtime_ns
    assert native_loader.ensure_built(force=True)
    assert os.stat(native_loader._LIB_PATH).st_mtime_ns > before
    assert native_loader.available()


# ---------------------------------------------------------------------------
# 4. Trajectories
# ---------------------------------------------------------------------------

def test_write_tum_matches_reference(tmp_path):
    rs = np.random.RandomState(2)
    ts = 1.4e9 + np.cumsum(rs.uniform(0.04, 0.06, 20))
    p = rs.normal(size=(20, 3))
    q = rs.normal(size=(20, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    a, b = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    ttraj.write_tum(a, ts, p, q)
    jtraj.write_tum(b, ts, p, q)
    assert open(a, "rb").read() == open(b, "rb").read()
    for got, want in zip(ttraj.read_tum(a), jtraj.read_tum(b)):
        np.testing.assert_array_equal(got, want)
