"""The CUDA LK kernels and the chunk path on the card: tests that need a
CUDA device and nvcc.

Every test here is marked `gpu` and skips, with its reason, where there is no
CUDA device. This file imports neither jax nor the JAX package (the GPU's
host has neither), so it runs there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_gpu.py

Each kernel is held against its plain torch version (`lk_cuda.lk_level_ref`,
`lk_patch_cuda.lk_patch_ref`) on the same device. Tolerance on positions: 0.02 px on every track that
converged before the iteration cap (the two sum the 121 window products in
different orders and contract different FMAs, ~1e-6 px per step; a track
at the |delta| < 0.01 px convergence edge can take one more sub-0.01 px
step on one side only). A track still stepping at the cap amplifies that
noise without bound, so it is left out of the position check. Flags must
be equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ssvio_tpu_torch import frontend as fe
from ssvio_tpu_torch.config import Settings
from ssvio_tpu_torch.dataio import synthetic, synthetic_torch
from ssvio_tpu_torch.ops import lk, lk_cuda, lk_patch_cuda, pyramid
from ssvio_tpu_torch.system import System

pytestmark = pytest.mark.gpu

POS_ATOL = 0.02          # px, see module docstring
H, W, N = 192, 256, 48
KW = dict(win=11, iters=30, eps=0.01, min_eig=1e-4)


def _device() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _scene(seed, shift, sigma=2.0):
    """Smooth random texture, a copy moved by `shift` (bilinear), and N
    keypoints away from the border; float32 numpy."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (H, W))
    r = int(3 * sigma)
    k = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma) ** 2)
    k /= k.sum()
    for ax in (0, 1):
        img = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), ax, img)
    img = img / img.max() * 255.0
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    sx = np.clip(xx - shift[0], 0, W - 1)
    sy = np.clip(yy - shift[1], 0, H - 1)
    x0 = np.minimum(np.floor(sx).astype(int), W - 2)
    y0 = np.minimum(np.floor(sy).astype(int), H - 2)
    fx, fy = sx - x0, sy - y0
    img2 = ((1 - fy) * ((1 - fx) * img[y0, x0] + fx * img[y0, x0 + 1])
            + fy * ((1 - fx) * img[y0 + 1, x0] + fx * img[y0 + 1, x0 + 1]))
    pts = rng.uniform([30, 30], [W - 30, H - 30], (N, 2))
    return img.astype(np.float32), img2.astype(np.float32), \
        pts.astype(np.float32)


def _converged(args, kw):
    """Tracks whose plain-version answer no longer moves at the last step."""
    out = lk_cuda.lk_level_ref(*args, **kw)[0]
    out_short = lk_cuda.lk_level_ref(*args, **dict(kw, iters=kw["iters"] - 1))[0]
    return torch.all(out == out_short, dim=-1)


def test_cuda_kernel_matches_plain_version_on_gpu():
    """One level, zero-padded bounds included: a 190x250 level with the
    192x256 bounds of the padded plane."""
    dev = _device()
    img, img2, pts = _scene(208, (3.1, -2.2))
    img_t = torch.from_numpy(img)
    gx, gy = pyramid.sobel_gradients(img_t)
    planes = [t[:190, :250].contiguous().to(dev)
              for t in (img_t, gx, gy, torch.from_numpy(img2))]
    p = torch.from_numpy(pts).to(dev)
    frozen0 = torch.zeros((N, 1), dtype=torch.int32, device=dev)
    frozen0[:4] = 1
    args = (*planes, p, p, frozen0)
    kw = dict(KW, padded_hw=(192, 256))
    before = lk_cuda.LAUNCHES
    out_k, flag_k = lk_cuda.lk_level(*args, **kw)
    torch.cuda.synchronize()
    assert lk_cuda.LAUNCHES == before + 1
    out_r, flag_r = lk_cuda.lk_level_ref(*args, **kw)
    assert torch.equal(flag_k, flag_r)
    assert torch.isfinite(out_k).all()
    check = (flag_k[:, 0] > 0) & _converged(args, kw)
    assert int(check.sum()) >= N // 2
    assert torch.max(torch.abs(out_k[check] - out_r[check])).item() < POS_ATOL
    # frozen keypoints keep their guess (less r, plus r: an ulp or so)
    assert torch.allclose(out_k[:4], p[:4], rtol=0, atol=1e-4)
    # the live keypoints found the shift
    moved = (out_k - p)[check & (frozen0[:, 0] == 0)].cpu().numpy()
    np.testing.assert_allclose(np.median(moved, axis=0), [3.1, -2.2],
                               atol=0.05)


def test_track_dispatch_launches_the_kernel_once_per_level():
    """lk.track on CUDA tensors ("auto") goes through the kernel on every
    level and agrees with the kernel semantics' plain version ("ref")."""
    dev = _device()
    img, img2, pts = _scene(209, (4.0, 1.5))
    pyr = [[t.to(dev) for t in pyramid.build_lk_pyramid(torch.from_numpy(a), 3)]
           for a in (img, img2)]
    p = torch.from_numpy(pts).to(dev)
    valid = torch.ones(N, dtype=torch.bool, device=dev)
    before = lk_cuda.LAUNCHES
    out_k, ok_k, _ = lk.track(pyr[0], pyr[1], p, p, valid, lk.LKParams())
    torch.cuda.synchronize()
    assert lk_cuda.LAUNCHES == before + 3
    out_r, ok_r, _ = lk.track(pyr[0], pyr[1], p, p, valid,
                              lk.LKParams(backend="ref"))
    assert lk_cuda.LAUNCHES == before + 3      # the plain version never counts
    assert torch.equal(ok_k, ok_r)
    assert int(ok_k.sum()) >= 0.8 * N
    flow = (out_k - p)[ok_k].cpu().numpy()
    np.testing.assert_allclose(np.median(flow, axis=0), [4.0, 1.5], atol=0.1)
    # coarse-level noise reseeds the finer levels, so compare the typical
    # track: the median disagreement stays at float-order size
    d = torch.max(torch.abs(out_k - out_r), dim=-1).values[ok_k]
    assert float(d.median()) < POS_ATOL


def test_wrapper_rejects_what_the_kernel_does_not_take():
    dev = _device()
    img, img2, pts = _scene(210, (1.0, 1.0))
    img_t = torch.from_numpy(img)
    gx, gy = pyramid.sobel_gradients(img_t)
    planes = [t.to(dev) for t in (img_t, gx, gy, torch.from_numpy(img2))]
    p = torch.from_numpy(pts).to(dev)
    frozen0 = torch.zeros((N, 1), dtype=torch.int32, device=dev)
    kw = dict(KW, padded_hw=(H, W))
    before = lk_cuda.LAUNCHES
    bad = [
        ((planes[0].double(), *planes[1:], p, p, frozen0), kw),
        ((planes[0].t().contiguous().t(), *planes[1:], p, p, frozen0),
         kw),                                                  # strided
        ((*planes, p[:-1], p, frozen0), kw),                    # shape
        ((*planes, p.cpu(), p, frozen0), kw),                   # device
        ((*planes, p, p, frozen0), dict(kw, win=13)),           # 169 pixels
        ((*planes, p, p, frozen0), dict(kw, padded_hw=(H - 8, W))),
    ]
    for args, k in bad:
        with pytest.raises(ValueError):
            lk_cuda.lk_level(*args, **k)
    assert lk_cuda.LAUNCHES == before


def _patch_args(seed, shift, dev, sigma=2.0):
    img, img2, pts = _scene(seed, shift, sigma)
    img_t = torch.from_numpy(img)
    gx, gy = pyramid.sobel_gradients(img_t)
    planes = [t.to(dev) for t in (img_t, gx, gy, torch.from_numpy(img2))]
    p = torch.from_numpy(pts).to(dev)
    valid = torch.ones(N, dtype=torch.bool, device=dev)
    valid[:4] = False
    args, kw, org_C = lk.patch_inputs(H, W, p, p, valid, lk.LKParams())
    return planes, args, kw, org_C, p


def test_patch_kernel_matches_plain_version_on_gpu():
    """Kernel #2 (the patch box at a (128, 8)-aligned origin) against
    lk_patch_ref on one 192x256 level of a smooth texture, shifted 8 px
    right and 6 px down."""
    dev = _device()
    planes, args, kw, org_C, p = _patch_args(211, (8.0, 6.0), dev, sigma=5.0)
    before = lk_patch_cuda.LAUNCHES
    out_k, flag_k = lk_patch_cuda.lk_patch(*planes, *args, **kw)
    torch.cuda.synchronize()
    assert lk_patch_cuda.LAUNCHES == before + 1
    out_r, flag_r = lk_patch_cuda.lk_patch_ref(*planes, *args, **kw)
    assert torch.equal(flag_k, flag_r)
    assert torch.isfinite(out_k).all()
    conv = torch.all(out_r == lk_patch_cuda.lk_patch_ref(
        *planes, *args, **dict(kw, iters=kw["iters"] - 1))[0], dim=-1)
    check = (flag_k[:, 0] > 0) & conv
    assert int(check.sum()) >= N // 2
    assert torch.max(torch.abs(out_k[check] - out_r[check])).item() < POS_ATOL
    # pre-frozen keypoints keep their guess
    assert torch.equal(out_k[:4], args[3][:4])
    r = lk.LKParams().window // 2
    moved = (org_C + r + out_k - p)[check & (args[4][:, 0] == 0)]
    assert float((torch.abs(moved - torch.tensor([8.0, 6.0], device=dev))
                  < 0.1).all(dim=-1).float().mean()) > 0.5


def test_track_dispatch_takes_the_patch_kernel_above_budget(monkeypatch):
    """With the plane budget at 0 every level takes kernel #2 on CUDA
    tensors ("auto"), and agrees with its plain version ("ref")."""
    dev = _device()
    monkeypatch.setattr(lk, "PLANE_BUDGET_BYTES", 0)
    img, img2, pts = _scene(212, (3.0, -2.0))
    pyr = [[t.to(dev) for t in pyramid.build_lk_pyramid(torch.from_numpy(a), 3)]
           for a in (img, img2)]
    p = torch.from_numpy(pts).to(dev)
    valid = torch.ones(N, dtype=torch.bool, device=dev)
    b1, b2 = lk_cuda.LAUNCHES, lk_patch_cuda.LAUNCHES
    out_k, ok_k, _ = lk.track(pyr[0], pyr[1], p, p, valid, lk.LKParams())
    torch.cuda.synchronize()
    assert (lk_cuda.LAUNCHES, lk_patch_cuda.LAUNCHES) == (b1, b2 + 3)
    out_r, ok_r, _ = lk.track(pyr[0], pyr[1], p, p, valid,
                              lk.LKParams(backend="ref"))
    assert lk_patch_cuda.LAUNCHES == b2 + 3   # the plain version never counts
    assert torch.equal(ok_k, ok_r)
    assert int(ok_k.sum()) >= 0.8 * N
    flow = (out_k - p)[ok_k].cpu().numpy()
    np.testing.assert_allclose(np.median(flow, axis=0), [3.0, -2.0], atol=0.1)
    d = torch.max(torch.abs(out_k - out_r), dim=-1).values[ok_k]
    assert float(d.median()) < POS_ATOL


def test_patch_wrapper_rejects_what_the_kernel_does_not_take():
    dev = _device()
    planes, args, kw, _, _ = _patch_args(213, (1.0, 1.0), dev)
    tl_prev, tl_cur, localT, local0, frozen0 = args
    before = lk_patch_cuda.LAUNCHES
    bad = [
        ((*planes, tl_prev.long(), tl_cur, localT, local0, frozen0), kw),
        ((*planes, tl_prev, tl_cur, localT[:-1], local0, frozen0), kw),
        ((*planes, tl_prev, tl_cur.cpu(), localT, local0, frozen0), kw),
        ((planes[0].double(), *planes[1:], *args), kw),
        ((*planes, *args), dict(kw, pty=36)),                 # not 8-aligned
        ((*planes, *args), dict(kw, padded_hw=(H, 128))),     # < 256 lanes
        ((*planes, *args), dict(kw, win=13)),
    ]
    for a, k in bad:
        with pytest.raises(ValueError):
            lk_patch_cuda.lk_patch(*a, **k)
    assert lk_patch_cuda.LAUNCHES == before


def test_chunk_path_on_gpu_matches_run_step():
    """The chunk API on the card (pinned host buffers, the upload stream,
    the prefetcher, pipelined dispatch/collect) gives what run_step gives,
    on 24 frames of tests/test_engine_chunked.py's 620x188 setup."""
    dev = _device()
    fx = 360.0
    s = Settings()
    cam = dataclasses.replace(s.cam_left, fx=fx, fy=fx, cx=310.0, cy=94.0)
    s.cam_left, s.cam_right = cam, dataclasses.replace(cam)
    s.image_width, s.image_height = 620, 188
    s.baseline_fx = 0.54 * fx
    s.max_features, s.max_landmarks, s.min_init_landmarks = 256, 4096, 100
    s.loop_closing_open = False
    poses = synthetic.straight_trajectory(24, speed=0.8)
    L, R = synthetic_torch.render_stereo_sequence_device(
        synthetic.SyntheticWorld(seed=3), poses, fx, fx, cam.cx, cam.cy,
        s.baseline, s.image_width, s.image_height, device=dev)
    L, R = L.cpu().numpy(), R.cpu().numpy()
    a = System(s, enable_backend=True, device=dev)
    st_a = []
    for i in range(24):
        a.run_step(L[i], R[i], 0.1 * i)
        st_a.append(a.status)
    b = System(s, enable_backend=True, device=dev)
    pf = b.prefetcher(depth=2)
    chunks = [slice(k, k + 6) for k in range(0, 24, 6)]
    for sl in chunks[:2]:
        pf.submit(L[sl], R[sl])
    handles, prev = [], None
    for k, sl in enumerate(chunks):
        h = b.dispatch_chunk(*pf.get(), [0.1 * i for i in range(24)][sl])
        if k + 2 < len(chunks):
            pf.submit(L[chunks[k + 2]], R[chunks[k + 2]])
        if prev is not None:
            b.collect_chunk(prev)
        handles.append(h)
        prev = h
    b.collect_chunk(prev)
    pf.close()
    st_b = [int(v) for h in handles for v in h.outs.status]
    assert st_b == st_a
    assert st_a[0] == fe.TRACKING_GOOD and fe.LOST not in st_a
    assert b.stats == a.stats and b.stats["n_ba"] >= 1
    _, ta = a.frame_trajectory()
    _, tb = b.frame_trajectory()
    np.testing.assert_allclose(tb[:, :, 3], ta[:, :, 3], atol=1e-3)
