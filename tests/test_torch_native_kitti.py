"""The port's native loader and KITTI reader/writer against the JAX
package's (`ssvio_tpu/native`, `ssvio_tpu/dataio/kitti.py`).

Decoded pixels are integers: every comparison is exact, except RGB luma
against OpenCV's (both BT.601, rounding may differ by one level, as
tests/test_native_loader.py holds the JAX decoder).
"""

import os
import struct
import subprocess
import sys
import time
import zlib

import numpy as np
import pytest

from ssvio_tpu import native as native_j
from ssvio_tpu.dataio import kitti as kitti_j
from ssvio_tpu_torch import native
from ssvio_tpu_torch.dataio import kitti
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def decode_j():
    """The JAX package's decoder. Its library is built in its package
    directory by whichever test process first imports it; a process that
    lost that race caches a failed load, so it is retried once built."""
    for _ in range(60):
        if native_j.load() is not None:
            return native_j.decode_gray
        native_j._tried = False
        time.sleep(1.0)
    pytest.fail("the JAX package's native library did not load")


def _filter_rows(raw: np.ndarray, bpp: int, ftype: int) -> np.ndarray:
    """PNG-filter the scanlines `raw` [h, stride] (uint8) with filter
    `ftype` (RFC 2083 section 6); returns [h, stride + 1]."""
    h, stride = raw.shape
    out = np.zeros((h, stride + 1), np.uint8)
    out[:, 0] = ftype
    x = raw.astype(np.int32)
    up = np.vstack([np.zeros((1, stride), np.int32), x[:-1]])
    left = np.hstack([np.zeros((h, bpp), np.int32), x[:, :-bpp]])
    ul = np.hstack([np.zeros((h, bpp), np.int32), up[:, :-bpp]])
    if ftype == 0:
        pred = np.zeros_like(x)
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = up
    elif ftype == 3:
        pred = (left + up) >> 1
    else:
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, ul))
    out[:, 1:] = ((x - pred) & 0xFF).astype(np.uint8)
    return out


def _png(path, img: np.ndarray, ftype: int):
    """Write `img` ([h, w] gray or [h, w, 3] RGB; uint8 or uint16) with
    every scanline filtered by `ftype`."""
    h, w = img.shape[:2]
    depth = 16 if img.dtype == np.uint16 else 8
    ctype = 2 if img.ndim == 3 else 0
    raw = img.astype(">u2" if depth == 16 else np.uint8).view(np.uint8)
    raw = raw.reshape(h, -1)
    bpp = (3 if ctype == 2 else 1) * depth // 8
    body = zlib.compress(_filter_rows(raw, bpp, ftype).tobytes())

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                             0, 0, 0))
                + chunk(b"IDAT", body) + chunk(b"IEND", b""))


def _texture(shape, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    img[:shape[0] // 2] = ((yy + 2 * xx)[:shape[0] // 2] % 256).astype(
        np.uint8)
    return img


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["gray8", "rgb8", "gray16"])
def test_decode_every_filter_matches_jax(tmp_path, decode_j, kind, ftype):
    rng = np.random.default_rng(10 * ftype + len(kind))
    if kind == "gray8":
        img = _texture((37, 53), ftype)
    elif kind == "rgb8":
        img = rng.integers(0, 256, size=(21, 34, 3), dtype=np.uint8)
    else:
        img = rng.integers(0, 65536, size=(20, 30), dtype=np.uint16)
    p = str(tmp_path / f"{kind}_{ftype}.png")
    _png(p, img, ftype)
    out = native.decode_gray(p)
    np.testing.assert_array_equal(out, decode_j(p))
    if kind == "gray8":
        np.testing.assert_array_equal(out, img.astype(np.float32))
    elif kind == "gray16":
        np.testing.assert_array_equal(out, (img >> 8).astype(np.float32))
    else:
        c = img.astype(np.int64)
        luma = (299 * c[..., 0] + 587 * c[..., 1] + 114 * c[..., 2]
                + 500) // 1000
        np.testing.assert_array_equal(out, luma.astype(np.float32))


@pytest.mark.parametrize("shape", [(37, 53), (64, 64), (13, 201)])
def test_decode_opencv_files_matches_jax(tmp_path, decode_j, shape):
    """The files tests/test_native_loader.py makes with OpenCV: 8-bit gray
    of several shapes, RGB, 16-bit and PGM."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(shape[1])
    files = {"g.png": _texture(shape, 0),
             "c.png": rng.integers(0, 256, size=shape + (3,), dtype=np.uint8),
             "d16.png": rng.integers(0, 65536, size=shape, dtype=np.uint16),
             "g.pgm": rng.integers(0, 256, size=shape, dtype=np.uint8)}
    for name, img in files.items():
        p = str(tmp_path / name)
        assert cv2.imwrite(p, img)
        out = native.decode_gray(p)
        np.testing.assert_array_equal(out, decode_j(p))
        ref = cv2.imread(p, cv2.IMREAD_GRAYSCALE).astype(np.float32)
        assert np.max(np.abs(out - ref)) <= (1.0 if name == "c.png" else 0.0)


def test_write_gray_png_round_trips(tmp_path, decode_j):
    img = _texture((45, 77), 3)
    p = str(tmp_path / "w.png")
    kitti.write_gray_png(p, img)
    np.testing.assert_array_equal(native.decode_gray(p), img.astype(np.float32))
    np.testing.assert_array_equal(decode_j(p), img.astype(np.float32))
    np.testing.assert_array_equal(kitti.read_gray(p), kitti_j.read_gray(p))
    with pytest.raises(ValueError, match="uint8"):
        kitti.write_gray_png(p, img.astype(np.float32))
    with pytest.raises(FileNotFoundError):
        kitti.read_gray(str(tmp_path / "missing.png"))


def _sequence(tmp_path, n, shape=(8, 12)):
    L = [np.full(shape, i, np.uint8) for i in range(n)]
    R = [np.full(shape, 100 + i, np.uint8) for i in range(n)]
    poses = np.zeros((n, 3, 4))
    poses[:, :, :3] = np.eye(3)
    poses[:, :, 3] = np.random.default_rng(n).normal(size=(n, 3))
    seq = str(tmp_path / "seq")
    kitti.write_sequence(seq, L, R, [0.1 * i for i in range(n)], poses)
    return seq, poses


def test_stereo_loader_keeps_order_and_skips_a_bad_frame(tmp_path):
    n = 25
    seq, _ = _sequence(tmp_path, n)
    left, right, ts = kitti.load_image_paths_and_timestamps(seq)
    got = list(kitti.prefetching_reader(left, right, n_threads=3,
                                        capacity=4))
    assert len(got) == n
    for i, (a, b) in enumerate(got):
        assert a.shape == (8, 12) and a.dtype == np.float32
        assert a[0, 0] == i and b[0, 0] == 100 + i
    with open(left[2], "wb") as f:
        f.write(b"not a png at all")
    got = list(native.StereoLoader(left[:5], right[:5], n_threads=2,
                                   capacity=3))
    assert [int(a[0, 0]) for a, _ in got] == [0, 1, 3, 4]
    assert list(native.StereoLoader([], [])) == []


_STRESS = r"""
import sys
from ssvio_tpu_torch import native
left, right = sys.argv[1:3]
n = int(sys.argv[3])
L = [f"{left}/{i:06d}.png" for i in range(n)]
R = [f"{right}/{i:06d}.png" for i in range(n)]
for _ in range(int(sys.argv[4])):
    got = [int(a[0, 0]) for a, _ in native.StereoLoader(L, R, n_threads=8,
                                                        capacity=2)]
    assert got == [i % 256 for i in range(n)], got[:20]
print("OK")
"""


def test_stereo_loader_keeps_order_under_contention(tmp_path):
    """More decode threads than ring slots, on images that decode in
    microseconds: a frame's slot must wait for it, not for whichever
    thread with a frame `capacity` later reaches the freed slot first
    (that thread would hold the slot the consumer waits on for ever).
    Run in a subprocess so a deadlock fails on the timeout."""
    n = 300
    L = [np.full((4, 4), i % 256, np.uint8) for i in range(n)]
    seq = str(tmp_path / "seq")
    kitti.write_sequence(seq, L, L, None)
    env = dict(os.environ, PYTHONPATH=REPO)
    try:
        out = subprocess.run(
            [sys.executable, "-c", _STRESS, os.path.join(seq, "image_0"),
             os.path.join(seq, "image_1"), str(n), "40"],
            env=env, capture_output=True, text=True, timeout=120)
    except subprocess.TimeoutExpired:
        pytest.fail("the native loader deadlocked")
    assert out.returncode == 0 and out.stdout.strip() == "OK", out.stderr


def test_kitti_reader_matches_jax(tmp_path):
    n = 6
    seq, poses = _sequence(tmp_path, n)
    lt, rt, tt = kitti.load_image_paths_and_timestamps(seq)
    lj, rj, tj = kitti_j.load_image_paths_and_timestamps(seq)
    assert (lt, rt) == (lj, rj)
    np.testing.assert_array_equal(tt, tj)
    for (a, b, t), (c, d, u) in zip(kitti.iterate_stereo(seq),
                                    kitti_j.iterate_stereo(seq)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
        assert t == u
    gp = os.path.join(seq, "poses.txt")
    np.testing.assert_array_equal(kitti.load_kitti_gt_poses(gp),
                                  kitti_j.load_kitti_gt_poses(gp))
    np.testing.assert_allclose(kitti.load_kitti_gt_poses(gp), poses,
                               rtol=1e-8)
    one = str(tmp_path / "one.txt")
    with open(one, "w") as f:
        f.write(" ".join(["1.5"] * 12) + "\n")
    assert kitti.load_kitti_gt_poses(one).shape == (1, 3, 4)
    a, b = str(tmp_path / "a.tum"), str(tmp_path / "b.tum")
    kitti.kitti_gt_to_tum(gp, os.path.join(seq, "times.txt"), a)
    kitti_j.kitti_gt_to_tum(gp, os.path.join(seq, "times.txt"), b)
    with open(a) as fa, open(b) as fb:
        assert fa.read() == fb.read()


_BUILDER = r"""
import sys
from pathlib import Path
from ssvio_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
print(int(native.decode_gray(sys.argv[2]).sum()))
"""


def test_build_is_safe_when_processes_build_at_once(tmp_path):
    """Two processes build the library into one empty directory at once;
    both load a whole library and decode, and one library is left."""
    img = _texture((30, 40), 5)
    p = str(tmp_path / "x.png")
    kitti.write_gray_png(p, img)
    build = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER, str(build), p],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [pr.communicate(timeout=120) for pr in procs]
    for pr, (out, err) in zip(procs, outs):
        assert pr.returncode == 0, err[-2000:]
        assert int(out.strip()) == int(img.astype(np.int64).sum())
    assert [f.name for f in build.iterdir()] == [
        native.library_path().name]


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "b")
    with pytest.raises(RuntimeError, match="did not build"):
        native.build()
