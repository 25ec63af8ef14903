"""Pyramidal Lucas-Kanade optical flow, batched over keypoints (port of
`ssvio_tpu/ops/lk.py`).

11x11 window, 3 pyramid levels, up to 30 iterations, eps 0.01, with
initial-flow seeding (reference src/ssvio/frontend.cpp:156-166).

Three level functions, as in the JAX package, and they are NOT the same
function (ROADMAP Queue 3):
- the patch-bounded path (`_track_level_xla`, the JAX package's XLA path):
  each keypoint samples from a fixed patch around its seed and freezes at
  the patch edge (margin 8);
- kernel #1's function (the JAX package's VMEM Pallas kernels): bounded
  only by the padded level. `LKParams.kernel` picks how its window is
  sampled, as in the JAX package, and each flavour has its own CUDA kernel
  and plain version (`_level_fns`):
  - "serial": kernel #1, `lk_cuda.lk_level` (four-corner blend, search
    windows from a region of the current plane staged once a level);
  - "sw": kernel #3, `lk_variants_cuda.lk_level_sw` (a launch of kernel
    #1's design: kernel #1's values);
  - "ymm", "pkmm": kernel #4, `lk_variants_cuda.lk_level_pk` (separable:
    y blend, then x; one function for both);
  - "mm", "mm_f32": kernel #5, `lk_variants_cuda.lk_level_mm` ("mm"
    samples By S Bx^T on the tensor cores in bf16, "mm_f32" in float32);
- kernel #2's function (`lk_patch_cuda.lk_patch`, the JAX package's
  HBM-patch Pallas kernel): bounded by a 256-lane patch box at a (128,
  8)-aligned origin. The JAX package takes it, whatever the flavour, where
  kernel #1's four padded planes exceed `PLANE_BUDGET_BYTES`
  (`uses_patch_kernel`).

`LKParams.backend` picks one (`_track_level`):
- "auto": the CUDA kernels for CUDA tensors, the patch-bounded path for
  CPU tensors (JAX's "auto" takes XLA off the TPU), whatever the flavour;
- "cuda": the CUDA kernels; raises for tensors that are not on a GPU;
- "xla": the patch-bounded path, whatever the flavour;
- "ref": the kernels' plain torch versions (the flavour's, and
  `lk_patch_cuda.lk_patch_ref` above the budget; the port's analogue of
  JAX's "pallas_interpret").
The kernel backends choose between the flavour's kernel and kernel #2 per
level by the budget, as the JAX package does (`ssvio_tpu/ops/lk.py:133`).
A CUDA tensor never falls back from a kernel to a plain version.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import torch

from ssvio_tpu_torch.ops import lk_cuda, lk_patch_cuda, lk_variants_cuda
from ssvio_tpu_torch.ops import pyramid as pyr_ops
from ssvio_tpu_torch.ops import sampling

# Plane budget of the JAX package's VMEM-resident kernel
# (lk_pallas.VMEM_PLANE_BUDGET): above it JAX switches to the HBM-patch
# kernel lk_level_pallas, whose bounds differ. On the card it is no memory
# limit; it is the rule that picks which function a level computes, and
# parity with the JAX package needs it.
PLANE_BUDGET_BYTES = 12 << 20


class LKParams(NamedTuple):
    window: int = 11
    levels: int = 3
    iters: int = 30
    eps: float = 0.01
    min_eig: float = 1e-4     # per-pixel min eigenvalue threshold (OpenCV-like)
    margin: int = 8           # search slack around the seed per level (px)
    backend: str = "auto"     # "auto" | "cuda" | "xla" | "ref" (module doc)
    kernel: str = "serial"    # level-kernel flavour, one of FLAVOURS


_BACKENDS = ("auto", "cuda", "xla", "ref")
FLAVOURS = ("serial", "sw", "ymm", "pkmm", "mm", "mm_f32")


def _check_params(params: LKParams) -> None:
    # the JAX package runs 'serial' for a name it does not know; the port
    # refuses it (ROADMAP Queue 3)
    if params.kernel not in FLAVOURS:
        raise ValueError(f"LK kernel {params.kernel!r} not in {FLAVOURS}")
    if params.backend not in _BACKENDS:
        raise ValueError(f"LK backend {params.backend!r} not in {_BACKENDS}")


def _level_fns(kernel: str):
    """(CUDA kernel wrapper, plain version) of a flavour's level function
    (`ssvio_tpu/ops/lk.py:144-168`), looked up when called."""
    lkv = lk_variants_cuda
    if kernel == "sw":
        return lkv.lk_level_sw, lkv.lk_level_sw_ref
    if kernel in ("ymm", "pkmm"):          # one function (lk_level_pk)
        return lkv.lk_level_pk, lkv.lk_level_pk_ref
    if kernel in ("mm", "mm_f32"):
        kw = dict(use_bf16=kernel == "mm")
        return (functools.partial(lkv.lk_level_mm, **kw),
                functools.partial(lkv.lk_level_mm_ref, **kw))
    return lk_cuda.lk_level, lk_cuda.lk_level_ref


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


def uses_patch_kernel(h: int, w: int) -> bool:
    """True where the JAX package takes the HBM-patch kernel for an [h, w]
    level: kernel #1's four padded f32 planes exceed the budget."""
    hv, wv = padded_dims(h, w)
    return 4 * hv * wv * 4 > PLANE_BUDGET_BYTES


def _frozen0(pts_guess, valid, h, w, r) -> torch.Tensor:
    return (~valid | ~sampling.in_bounds(pts_guess, h, w, border=r + 1)) \
        .to(torch.int32)[:, None]


def _level_ok(flag, pts_out, pts_prev, img_prev, h, w) -> torch.Tensor:
    return (flag[:, 0] > 0) & sampling.in_bounds(pts_out, h, w, border=1.0) \
        & sampling.in_bounds(pts_prev, img_prev.shape[0], img_prev.shape[1],
                             border=1.0)


def _track_level_kernel(img_prev, img_cur, gx, gy, pts_prev, pts_guess,
                        valid, params: LKParams, level_fn):
    """Kernel #1's function with the flavour's sampler `level_fn` (JAX
    `_track_level_pallas`, VMEM branch)."""
    win = params.window
    h, w = img_cur.shape
    pts_out, flag = level_fn(img_prev, gx, gy, img_cur,
                             pts_prev.contiguous(), pts_guess.contiguous(),
                             _frozen0(pts_guess, valid, h, w, win // 2),
                             win=win, iters=params.iters,
                             eps=params.eps, min_eig=params.min_eig,
                             padded_hw=padded_dims(h, w))
    return pts_out, _level_ok(flag, pts_out, pts_prev, img_prev, h, w)


def patch_inputs(h: int, w: int, pts_prev: torch.Tensor,
                 pts_guess: torch.Tensor, valid: torch.Tensor,
                 params: LKParams):
    """Kernel #2's per-keypoint inputs for an [h, w] level, as the JAX
    wrapper computes them (`ssvio_tpu/ops/lk.py:174-212`).

    Returns (args, kw, org_C): `args` = (tl_prev, tl_cur, localT, local0,
    frozen0) for lk_patch / lk_patch_ref after the four planes, `kw` their
    keyword arguments, and org_C [N, 2] float32 the search-patch origins
    (pts_out = org_C + r + local_out)."""
    win = params.window
    r = win // 2
    margin = params.margin
    rup8 = lambda v: -(-v // 8) * 8
    # patch footprints: +7 rows of slack so 8-aligned row origins still
    # cover the window; x spans two 128-lane tiles at a 128-aligned origin;
    # >= 32 rows (the TPU kernel's 32-row slab)
    pty = max(rup8(win + 2 + 7), 32)
    pcy = max(rup8(win + 2 * margin + 2 + 7), 32)
    # tiny coarse levels are zero-padded so the patch footprint fits
    hp = max(rup8(h), pcy)
    wp = max(-(-w // 128) * 128, lk_patch_cuda.LANES)

    def aligned_origin(tl, py):
        ox = torch.clamp(torch.div(tl[:, 0], 128, rounding_mode="floor") * 128,
                         0, wp - lk_patch_cuda.LANES)
        oy = torch.clamp(torch.div(tl[:, 1], 8, rounding_mode="floor") * 8,
                         0, hp - py)
        return torch.stack([ox, oy], dim=-1).to(torch.int32)

    org_T = aligned_origin(_int_floor(pts_prev) - r, pty)
    localT = pts_prev - r - org_T.to(pts_prev.dtype)
    rc = torch.nan_to_num(torch.round(pts_guess)).long()
    tlc = torch.stack([rc[:, 0] - r, rc[:, 1] - r - margin], dim=-1)
    org_C = aligned_origin(tlc, pcy)
    org_Cf = org_C.to(pts_guess.dtype)
    local0 = pts_guess - r - org_Cf
    args = (org_T, org_C, localT.contiguous(), local0.contiguous(),
            _frozen0(pts_guess, valid, h, w, r))
    kw = dict(win=win, pty=pty, pcy=pcy, iters=params.iters, eps=params.eps,
              min_eig=params.min_eig, padded_hw=(hp, wp))
    return args, kw, org_Cf


def _track_level_patch(img_prev, img_cur, gx, gy, pts_prev, pts_guess,
                       valid, params: LKParams, patch_fn):
    """Kernel #2's level (JAX `_track_level_pallas`, HBM-patch branch)."""
    h, w = img_cur.shape
    args, kw, org_C = patch_inputs(h, w, pts_prev, pts_guess, valid, params)
    local_out, flag = patch_fn(img_prev, gx, gy, img_cur, *args, **kw)
    pts_out = org_C + params.window // 2 + local_out
    return pts_out, _level_ok(flag, pts_out, pts_prev, img_prev, h, w)


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
    if backend != "ref" and not img_cur.is_cuda:   # "auto" / "cuda"
        raise RuntimeError(
            "LK backend 'cuda' needs CUDA tensors; got tensors on "
            f"{img_cur.device} (the kernel has no CPU fallback)")
    if uses_patch_kernel(*img_cur.shape):
        return _track_level_patch(
            img_prev, img_cur, gx, gy, pts_prev, pts_guess, valid, params,
            lk_patch_cuda.lk_patch_ref if backend == "ref"
            else lk_patch_cuda.lk_patch)
    kernel, plain = _level_fns(params.kernel)
    return _track_level_kernel(
        img_prev, img_cur, gx, gy, pts_prev, pts_guess, valid, params,
        plain if backend == "ref" else kernel)


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
