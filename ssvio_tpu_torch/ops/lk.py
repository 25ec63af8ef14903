"""Pyramidal Lucas-Kanade optical flow, batched over keypoints (port of
`ssvio_tpu/ops/lk.py`).

11x11 window, 3 pyramid levels, up to 30 iterations, eps 0.01, with
initial-flow seeding (reference src/ssvio/frontend.cpp:156-166).

Two level functions, as in the JAX package, and they are NOT the same
function (ROADMAP Queue 3):
- the patch-bounded path (`_track_level_xla`, the JAX package's XLA path):
  each keypoint samples from a fixed patch around its seed and freezes at
  the patch edge (margin 8);
- the kernel semantics (`lk_cuda.lk_level`, the JAX package's VMEM Pallas
  kernel): bounded only by the padded level.

`LKParams.backend` picks one (`_track_level`):
- "auto": the CUDA kernel for CUDA tensors, the patch-bounded path for
  CPU tensors (JAX's "auto" takes XLA off the TPU);
- "cuda": the CUDA kernel; raises for tensors that are not on a GPU;
- "xla": the patch-bounded path;
- "ref": the kernel's plain torch version `lk_cuda.lk_level_ref` (the
  port's analogue of JAX's "pallas_interpret").
A CUDA tensor never falls back from the kernel to a plain version.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from ssvio_tpu_torch.ops import lk_cuda
from ssvio_tpu_torch.ops import pyramid as pyr_ops
from ssvio_tpu_torch.ops import sampling

# Plane budget of the JAX package's VMEM-resident kernel
# (lk_pallas.VMEM_PLANE_BUDGET): above it JAX switches to the HBM-patch
# kernel lk_level_pallas, whose bounds differ; that kernel is not ported yet
# (ROADMAP Queue 2 #2), so the port raises there instead of silently
# computing the other function.
PLANE_BUDGET_BYTES = 12 << 20


class LKParams(NamedTuple):
    window: int = 11
    levels: int = 3
    iters: int = 30
    eps: float = 0.01
    min_eig: float = 1e-4     # per-pixel min eigenvalue threshold (OpenCV-like)
    margin: int = 8           # search slack around the seed per level (px)
    backend: str = "auto"     # "auto" | "cuda" | "xla" | "ref" (module doc)
    # level-kernel flavor: only "serial" is ported (ROADMAP Queue 2 #3-#5
    # hold the JAX package's "sw", "ymm"/"pkmm" and "mm"/"mm_f32")
    kernel: str = "serial"


_BACKENDS = ("auto", "cuda", "xla", "ref")


def _check_params(params: LKParams) -> None:
    if params.kernel != "serial":
        raise NotImplementedError(
            f"LK kernel {params.kernel!r} is not ported; only 'serial' is "
            "(ROADMAP Queue 2 #3-#5: lk_level_vmem_sw / _pk / _mm)")
    if params.backend not in _BACKENDS:
        raise ValueError(f"LK backend {params.backend!r} not in {_BACKENDS}")


def _patch_index(h: int, w: int, top_left: torch.Tensor, size: int):
    """Flat indices of [N, size, size] patches at integer (x, y) top-lefts,
    clamped into the image as lax.dynamic_slice clamps. Returns (idx,
    actual_top_left [N, 2])."""
    x0 = torch.clamp(top_left[:, 0], 0, w - size)
    y0 = torch.clamp(top_left[:, 1], 0, h - size)
    off = torch.arange(size, device=top_left.device)
    idx = ((y0[:, None, None] + off[None, :, None]) * w
           + x0[:, None, None] + off[None, None, :])
    return idx, torch.stack([x0, y0], dim=-1)


def _extract_patches(img: torch.Tensor, top_left: torch.Tensor, size: int):
    """Per-keypoint patch extraction. top_left: [N, 2] integer (x, y).
    Returns (patches [N, size, size], actual_top_left [N, 2])."""
    h, w = img.shape
    idx, org = _patch_index(h, w, top_left, size)
    return img.reshape(-1)[idx], org


def _sample_window(patches: torch.Tensor, local_tl: torch.Tensor, win: int):
    """Bilinear window sample from per-keypoint patches.

    patches: [N, P, P]; local_tl: [N, 2] float window top-left in patch
    coords. Returns [N, win, win]."""
    n, Pp = patches.shape[0], patches.shape[-1]
    base_x = torch.clamp(torch.nan_to_num(torch.floor(local_tl[:, 0])),
                         0, Pp - win - 1)
    base_y = torch.clamp(torch.nan_to_num(torch.floor(local_tl[:, 1])),
                         0, Pp - win - 1)
    fx = (local_tl[:, 0] - base_x)[:, None, None]
    fy = (local_tl[:, 1] - base_y)[:, None, None]
    off = torch.arange(win + 1, device=patches.device)
    idx = ((base_y.long()[:, None, None] + off[None, :, None]) * Pp
           + base_x.long()[:, None, None] + off[None, None, :])
    s = torch.gather(patches.reshape(n, -1), 1,
                     idx.reshape(n, -1)).reshape(n, win + 1, win + 1)
    return ((1 - fy) * (1 - fx) * s[:, :win, :win]
            + (1 - fy) * fx * s[:, :win, 1:win + 1]
            + fy * (1 - fx) * s[:, 1:win + 1, :win]
            + fy * fx * s[:, 1:win + 1, 1:win + 1])


def _int_floor(v: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(torch.floor(v)).long()


def padded_dims(h: int, w: int) -> Tuple[int, int]:
    """Bounds of the kernel semantics for an [h, w] level: the dims the JAX
    wrapper pads the level to (lk.py:131-132), (8, 128) multiples, at least
    32 x 256."""
    return max(-(-h // 8) * 8, 32), max(-(-w // 128) * 128, 256)


def _track_level_kernel(img_prev, img_cur, gx, gy, pts_prev, pts_guess,
                        valid, params: LKParams, level_fn):
    """Kernel-semantics level (JAX `_track_level_pallas`, VMEM branch)."""
    win = params.window
    r = win // 2
    h, w = img_cur.shape
    hv, wv = padded_dims(h, w)
    if 4 * hv * wv * 4 > PLANE_BUDGET_BYTES:
        raise NotImplementedError(
            f"LK level {h}x{w}: four padded planes exceed "
            f"{PLANE_BUDGET_BYTES} B, where the JAX package takes the "
            "HBM-patch kernel lk_level_pallas (ROADMAP Queue 2 #2, not "
            "ported)")
    frozen0 = (~valid | ~sampling.in_bounds(pts_guess, h, w, border=r + 1)) \
        .to(torch.int32)[:, None]
    pts_out, flag = level_fn(img_prev, gx, gy, img_cur,
                             pts_prev.contiguous(), pts_guess.contiguous(),
                             frozen0, win=win, iters=params.iters,
                             eps=params.eps, min_eig=params.min_eig,
                             padded_hw=(hv, wv))
    ok = (flag[:, 0] > 0) & sampling.in_bounds(pts_out, h, w, border=1.0) \
        & sampling.in_bounds(pts_prev, img_prev.shape[0], img_prev.shape[1],
                             border=1.0)
    return pts_out, ok


def _track_level_xla(img_prev, img_cur, gx, gy, pts_prev, pts_guess, valid,
                     params: LKParams):
    """Patch-bounded level (the JAX package's XLA path, lk.py:225-301)."""
    win = params.window
    r = win // 2
    margin = params.margin
    h, w = img_cur.shape
    Pt = win + 2                      # template patch (fixed position)
    Pc = min(win + 2 * margin + 2, h, w)

    # --- template + gradient windows at the (fractional) prev position
    idx_T, org_T = _patch_index(*img_prev.shape, _int_floor(pts_prev) - r, Pt)
    local_T = pts_prev - r - org_T.to(pts_prev.dtype)
    T = _sample_window(img_prev.reshape(-1)[idx_T], local_T, win)
    Gx = _sample_window(gx.reshape(-1)[idx_T], local_T, win)
    Gy = _sample_window(gy.reshape(-1)[idx_T], local_T, win)

    gxx = torch.sum(Gx * Gx, dim=(1, 2))
    gxy = torch.sum(Gx * Gy, dim=(1, 2))
    gyy = torch.sum(Gy * Gy, dim=(1, 2))
    det = gxx * gyy - gxy * gxy
    trace = gxx + gyy
    min_eig = (trace - torch.sqrt(torch.clamp(trace * trace - 4 * det,
                                              min=0.0))) * 0.5
    good_g = (min_eig / (win * win)) > params.min_eig
    inv_det = torch.where(torch.abs(det) > 1e-9, 1.0 / det,
                          torch.zeros_like(det))

    # --- current-image search patches around the integer seed
    tl_cur = torch.nan_to_num(torch.round(pts_guess)).long() - (r + margin)
    patch_C, org_C = _extract_patches(img_cur, tl_cur, Pc)
    org_Cf = org_C.to(pts_guess.dtype)

    def outside(local, pts):
        return ((local[:, 0] < 0) | (local[:, 1] < 0)
                | (local[:, 0] > Pc - win - 1) | (local[:, 1] > Pc - win - 1)
                | ~sampling.in_bounds(pts, h, w, border=r + 1))

    pts = pts_guess
    frozen = ~valid | outside(pts - r - org_Cf, pts)
    for _ in range(params.iters):
        I = _sample_window(patch_C, pts - r - org_Cf, win)
        diff = T - I
        bx = torch.sum(diff * Gx, dim=(1, 2))
        by = torch.sum(diff * Gy, dim=(1, 2))
        dx = (gyy * bx - gxy * by) * inv_det
        dy = (gxx * by - gxy * bx) * inv_det
        delta = torch.stack([dx, dy], dim=-1)
        step = torch.where((frozen | ~good_g)[:, None],
                           torch.zeros_like(delta), delta)
        new_pts = pts + step
        converged = torch.sum(delta * delta, dim=-1) < params.eps ** 2
        # leaving the search patch (or the image) freezes the point
        frozen = frozen | converged | outside(new_pts - r - org_Cf, new_pts)
        pts = new_pts
    ok = good_g & sampling.in_bounds(pts, h, w, border=1.0) \
        & sampling.in_bounds(pts_prev, img_prev.shape[0], img_prev.shape[1],
                             border=1.0)
    return pts, ok


def _track_level(img_prev: torch.Tensor, img_cur: torch.Tensor,
                 gx: torch.Tensor, gy: torch.Tensor,
                 pts_prev: torch.Tensor, pts_guess: torch.Tensor,
                 valid: torch.Tensor,
                 params: LKParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pyramid level of KLT. Returns (pts_cur [N,2], ok [N]).

    `valid` pre-freezes dead keypoints. Dispatch on `params.backend`: see
    the module docstring."""
    _check_params(params)
    backend = params.backend
    if backend == "xla" or (backend == "auto" and not img_cur.is_cuda):
        return _track_level_xla(img_prev, img_cur, gx, gy, pts_prev,
                                pts_guess, valid, params)
    if backend == "ref":
        level_fn = lk_cuda.lk_level_ref
    else:                                   # "auto" or "cuda"
        if not img_cur.is_cuda:
            raise RuntimeError(
                "LK backend 'cuda' needs CUDA tensors; got tensors on "
                f"{img_cur.device} (the kernel has no CPU fallback)")
        level_fn = lk_cuda.lk_level
    return _track_level_kernel(img_prev, img_cur, gx, gy, pts_prev,
                               pts_guess, valid, params, level_fn)


def track(pyr_prev: List[torch.Tensor], pyr_cur: List[torch.Tensor],
          pts_prev: torch.Tensor, pts_init: torch.Tensor,
          valid: torch.Tensor, params: LKParams = LKParams(),
          compute_err: bool = True, grads_prev=None
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Track keypoints from prev to cur through the pyramid.

    Args:
      pyr_prev/pyr_cur: power-of-two pyramids (finest first).
      pts_prev: [N, 2] positions in the prev frame (finest level coords).
      pts_init: [N, 2] initial guesses in cur frame (pass pts_prev for none).
      valid:    [N] input validity mask.
      compute_err: when False, skip the final photometric window resample
        (err returned as zeros).
      grads_prev: optional ((gx per level), (gy per level)) Sobel gradients
        of pyr_prev; None recomputes them here.

    Returns (pts_cur [N, 2], ok [N] bool, err [N] mean abs window residual).
    """
    levels = min(params.levels, len(pyr_prev))
    flow = (pts_init - pts_prev) / (2.0 ** (levels - 1))
    pts_lvl = pts_prev / (2.0 ** (levels - 1))
    ok = valid
    for l in range(levels - 1, -1, -1):
        img_p = pyr_prev[l]
        img_c = pyr_cur[l]
        if grads_prev is not None:
            gx, gy = grads_prev[0][l], grads_prev[1][l]
        else:
            gx, gy = pyr_ops.sobel_gradients(img_p)
        pts_cur_lvl, ok_lvl = _track_level(img_p, img_c, gx, gy, pts_lvl,
                                           pts_lvl + flow, valid, params)
        flow = pts_cur_lvl - pts_lvl
        ok = ok & ok_lvl
        if l > 0:
            pts_lvl = pts_prev / (2.0 ** (l - 1))
            flow = flow * 2.0
    pts_cur = pts_prev + flow
    if compute_err:
        # final photometric error on the finest level (window resample)
        win = params.window
        r = win // 2
        patch_T, org_T = _extract_patches(pyr_prev[0],
                                          _int_floor(pts_prev) - r, win + 2)
        T = _sample_window(patch_T, pts_prev - r - org_T.to(pts_prev.dtype),
                           win)
        patch_I, org_I = _extract_patches(pyr_cur[0],
                                          _int_floor(pts_cur) - r, win + 2)
        I = _sample_window(patch_I, pts_cur - r - org_I.to(pts_cur.dtype),
                           win)
        err = torch.mean(torch.abs(T - I), dim=(1, 2))
    else:
        err = torch.zeros(pts_cur.shape[0], dtype=pts_cur.dtype,
                          device=pts_cur.device)
    ok = ok & sampling.in_bounds(pts_cur, pyr_cur[0].shape[0],
                                 pyr_cur[0].shape[1], border=1.0)
    return pts_cur, ok, err
