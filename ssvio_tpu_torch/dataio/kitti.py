"""KITTI odometry dataset reader and writer (host side; port of
`ssvio_tpu/dataio/kitti.py`).

Reads `times.txt` plus the `image_0/` and `image_1/` grayscale stereo pairs
of a KITTI odometry sequence directory (reference
include/common/read_kitii_dataset.hpp:16-60), and the ground-truth poses
file (reference scripts/kitti_poses_and_timestamps_to_trajectory.py:14-25).
Images are decoded by the port's native library (`native/`), never by
OpenCV, which the GPU's host lacks. `write_gray_png` and `write_sequence`
write that layout with the standard library's zlib, for synthetic
sequences.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Iterator, List, Tuple

import numpy as np

from ssvio_tpu_torch import native


def load_image_paths_and_timestamps(seq_dir: str
                                    ) -> Tuple[List[str], List[str],
                                               np.ndarray]:
    """Returns (left_paths, right_paths, timestamps [N]) of the layout
    `<seq>/times.txt`, `<seq>/image_0/%06d.png`, `<seq>/image_1/%06d.png`."""
    with open(os.path.join(seq_dir, "times.txt")) as f:
        timestamps = np.array([float(line.strip()) for line in f
                               if line.strip()], dtype=np.float64)
    n = len(timestamps)
    left = [os.path.join(seq_dir, "image_0", f"{i:06d}.png") for i in range(n)]
    right = [os.path.join(seq_dir, "image_1", f"{i:06d}.png")
             for i in range(n)]
    return left, right, timestamps


def read_gray(path: str) -> np.ndarray:
    """Load a grayscale image as float32 [H, W] in [0, 255]."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return native.decode_gray(path)


def prefetching_reader(left: List[str], right: List[str],
                       n_threads: int = 4, capacity: int = 8,
                       ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """In-order stereo pairs decoded in the background by the native ring
    loader, so the per-frame device step never waits on disk or PNG
    inflate (the reference decodes on the caller thread, reference
    test/test_system.cpp:40-43). A pair that fails to decode is skipped."""
    loader = native.StereoLoader(left, right, n_threads=n_threads,
                                 capacity=capacity)
    try:
        yield from loader
    finally:
        loader.close()


def iterate_stereo(seq_dir: str) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                                   float]]:
    left, right, ts = load_image_paths_and_timestamps(seq_dir)
    for lp, rp, t in zip(left, right, ts):
        yield read_gray(lp), read_gray(rp), float(t)


def load_kitti_gt_poses(poses_path: str) -> np.ndarray:
    """KITTI ground-truth poses file: N lines of 12 floats (3x4 T_wc).

    Returns [N, 3, 4] float64 (camera-to-world, KITTI convention)."""
    data = np.loadtxt(poses_path, dtype=np.float64)
    if data.ndim == 1:
        data = data[None]
    return data.reshape(-1, 3, 4)


def kitti_gt_to_tum(poses_path: str, times_path: str, out_path: str) -> None:
    """Ground truth + times -> TUM trajectory file, the reference's evo
    preparation step (reference
    scripts/kitti_poses_and_timestamps_to_trajectory.py)."""
    from ssvio_tpu_torch.dataio import tum
    poses = load_kitti_gt_poses(poses_path)
    with open(times_path) as f:
        ts = np.array([float(x) for x in f.read().split() if x],
                      dtype=np.float64)
    tum.save_tum(out_path, ts[:len(poses)], poses)


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_gray_png(path: str, img_u8: np.ndarray) -> None:
    """Write an 8-bit grayscale PNG (every scanline with filter 0)."""
    img = np.asarray(img_u8)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"need a 2-D uint8 image, got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape
    raw = np.zeros((h, w + 1), np.uint8)       # a filter byte a scanline
    raw[:, 1:] = img
    data = (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _png_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def write_sequence(out_dir: str, L, R, times, poses=None,
                   first: int = 0) -> None:
    """Write stereo frames in the KITTI layout: `image_0/%06d.png` (L),
    `image_1/%06d.png` (R), uint8 [N, H, W] each, numbered from `first`.
    `times` (seconds of the whole sequence, when given) goes to
    `times.txt`, and `poses` ([N, 3, 4] T_wc, when given) to `poses.txt`
    as KITTI's 12 numbers a line."""
    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    for j, (a, b) in enumerate(zip(L, R)):
        name = f"{first + j:06d}.png"
        write_gray_png(os.path.join(out_dir, "image_0", name), np.asarray(a))
        write_gray_png(os.path.join(out_dir, "image_1", name), np.asarray(b))
    if times is not None:
        with open(os.path.join(out_dir, "times.txt"), "w") as f:
            f.write("".join(f"{t:.6e}\n" for t in times))
    if poses is not None:
        with open(os.path.join(out_dir, "poses.txt"), "w") as f:
            f.write("".join(" ".join(f"{v:.9e}" for v in np.ravel(p)) + "\n"
                            for p in poses))
