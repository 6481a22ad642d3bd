"""EuRoC-layout dataset ingestion (torch port's copy of
mobile_slam_tpu.io.dataset; numpy only).

Mirror of src/utility/measurement_processor.cpp: IMU CSV parsing with
malformed-line skipping (:53-106), image-list CSV with filename sanitization
(path-traversal and absolute-path rejection, cleanFilename :157-176), ground
truth (mocap0) loading, and IMU slicing into per-frame measurement batches
((prev_ts, ts] windows, :251-292).

Layout:
    <root>/mav0/imu0/data.csv        timestamp_ns, wx, wy, wz, ax, ay, az
    <root>/mav0/cam0/data.csv        timestamp_ns, filename
    <root>/mav0/cam0/data/<file>     grayscale images
    <root>/mav0/mocap0/data.csv      ground truth (ts_ns, p, q)
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from mobile_slam_tpu_torch.io import png


@dataclasses.dataclass
class ImuData:
    ts: np.ndarray    # (N,) seconds
    gyr: np.ndarray   # (N, 3)
    acc: np.ndarray   # (N, 3)


@dataclasses.dataclass
class ImageIndex:
    ts: np.ndarray          # (M,) seconds
    filenames: list[str]    # sanitized, relative


@dataclasses.dataclass
class GroundTruth:
    ts: np.ndarray   # (K,)
    p: np.ndarray    # (K, 3)
    q: np.ndarray    # (K, 4) wxyz


def clean_filename(name: str) -> str | None:
    """Sanitize an image filename from the CSV: reject absolute paths and
    path traversal (measurement_processor.cpp:157-176)."""
    name = name.strip().strip('"')
    if not name:
        return None
    if name.startswith("/") or name.startswith("\\"):
        return None
    if ".." in name.replace("\\", "/").split("/"):
        return None
    if any(c in name for c in ("\x00",)):
        return None
    return name


def load_imu_csv(path: str) -> ImuData:
    """Parse an EuRoC imu0/data.csv; malformed lines are skipped
    (measurement_processor.cpp:53-106)."""
    ts, gyr, acc = [], [], []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(",")
            if len(parts) < 7:
                continue
            try:
                vals = [float(p) for p in parts[:7]]
            except ValueError:
                continue
            if not all(np.isfinite(vals)):
                continue
            ts.append(vals[0] * 1e-9)
            gyr.append(vals[1:4])
            acc.append(vals[4:7])
    return ImuData(np.asarray(ts), np.asarray(gyr).reshape(-1, 3),
                   np.asarray(acc).reshape(-1, 3))


def load_image_csv(path: str) -> ImageIndex:
    """Parse cam0/data.csv with filename sanitization."""
    ts, names = [], []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(",")
            if len(parts) < 2:
                continue
            try:
                t = float(parts[0]) * 1e-9
            except ValueError:
                continue
            name = clean_filename(parts[1])
            if name is None:
                continue
            ts.append(t)
            names.append(name)
    return ImageIndex(np.asarray(ts), names)


def load_ground_truth_csv(path: str) -> GroundTruth:
    """EuRoC mocap/state ground truth: ts_ns, px, py, pz, qw, qx, qy, qz."""
    ts, p, q = [], [], []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(",")
            if len(parts) < 8:
                continue
            try:
                vals = [float(x) for x in parts[:8]]
            except ValueError:
                continue
            ts.append(vals[0] * 1e-9)
            p.append(vals[1:4])
            q.append(vals[4:8])
    return GroundTruth(np.asarray(ts), np.asarray(p).reshape(-1, 3),
                       np.asarray(q).reshape(-1, 4))


class EurocDataset:
    """Random-access EuRoC sequence (the MeasurementProcessor's data side).

    Images are decoded on the host by the port's own PNG/PGM reader
    (io/png.py; no OpenCV). The native C++ loader (native/loader.cpp, built
    by io/native_loader.py) provides the same interface with its own CSV
    parsing, 8-bit PNG/PGM decoding (gray, RGB, gray + alpha and RGBA PNG,
    colour converted by the same integer luma as io/png.py) and a prefetch
    ring buffer; it is used when it builds, and 16-bit PNG goes through
    io/png.py either way. Palette or interlaced PNG raises ``ValueError``.
    """

    def __init__(self, root: str, cam: str = "cam0", imu: str = "imu0",
                 gt: str = "mocap0", use_native: bool = True):
        mav = os.path.join(root, "mav0")
        base = mav if os.path.isdir(mav) else root
        self.base = base
        self._native = False
        if use_native:
            try:
                from mobile_slam_tpu_torch.io import native_loader as nl

                self._native = nl.available()
                self._nl = nl
            except Exception:
                self._native = False
        if self._native:
            raw = self._nl.parse_csv(os.path.join(base, imu, "data.csv"), 7)
            self.imu = ImuData(raw[:, 0] * 1e-9, raw[:, 1:4], raw[:, 4:7])
            ts, names = self._nl.parse_image_csv(
                os.path.join(base, cam, "data.csv"))
            self.images = ImageIndex(ts, names)
        else:
            self.imu = load_imu_csv(os.path.join(base, imu, "data.csv"))
            self.images = load_image_csv(os.path.join(base, cam, "data.csv"))
        self.image_dir = os.path.join(base, cam, "data")
        gt_csv = os.path.join(base, gt, "data.csv")
        self.ground_truth = (load_ground_truth_csv(gt_csv)
                             if os.path.exists(gt_csv) else None)
        self._size = None
        self._depth = None

    def __len__(self):
        return len(self.images.ts)

    def read_image(self, idx: int) -> np.ndarray:
        path = os.path.join(self.image_dir, self.images.filenames[idx])
        if self._native and self._native_decodes():
            h, w = self._size
            return self._nl.decode_image(path, w, h)
        return png.imread_gray(path)

    def _native_decodes(self) -> bool:
        """Whether the native loader decodes this sequence (8-bit images of
        any colour type io/png.py reads): the size and depth are probed
        once, from the first image's header, which raises ``ValueError``
        for a file neither reader decodes."""
        if self._size is None:
            hdr = png.read_header(os.path.join(self.image_dir, self.images.filenames[0]))
            self._size = (hdr.height, hdr.width)
            self._depth = hdr.bit_depth
        return self._depth == 8

    def image_stream(self, width: int, height: int, prefetch: int = 6):
        """Sequential image stream, yields (index, image): decoded ahead by
        the native loader's worker thread where it decodes this sequence
        (8-bit images), by ``read_image`` one after another otherwise."""
        if self._native and self._native_decodes():
            return self._nl.PrefetchingImageStream(
                self.image_dir, self.images.filenames, width, height, prefetch)
        return ((i, self.read_image(i)) for i in range(len(self)))

    def imu_between(self, t0: float, t1: float):
        """IMU samples with ts in (t0, t1] (measurement_processor.cpp:272-286).
        Returns (ts, acc, gyr)."""
        i0 = np.searchsorted(self.imu.ts, t0, side="right")
        i1 = np.searchsorted(self.imu.ts, t1, side="right")
        return (self.imu.ts[i0:i1], self.imu.acc[i0:i1], self.imu.gyr[i0:i1])
