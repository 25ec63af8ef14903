"""One pyramid level of KLT for N keypoints: the hand-written CUDA kernel,
its ctypes binding, and its plain torch version.

Replaces the TPU kernel `ssvio_tpu/ops/lk_pallas.py::lk_level_vmem`
(body `_make_serial_vmem_kernel`, sampler `_make_vmem_kernel`), the Pallas
kernel of every LK level whose padded planes fit the 12 MiB budget
(`ops/lk.py`; larger levels take `ops/lk_patch_cuda.py`). Both compute, per
keypoint:
bilinear 11x11 template and Sobel windows at `pts_prev` (the window moves
rigidly, so it shares one fractional offset), a min-eigenvalue gate on the
2x2 structure tensor, then up to `iters` forward-additive steps with
per-keypoint early exit on |delta| < eps or on leaving the padded level
(`lim = Wb - win - 2`, `Hb - win - 2`). Reads between the true level dims
(H, W) and the padded dims (Hb, Wb) return 0, as the TPU wrapper's zero
padding does; the CUDA kernel bounds-checks instead of padding physically.

What bounds it on the card: it is latency-bound, not bandwidth- or
FLOP-bound. A 512-keypoint call is 512 warps, about 4 per SM of an H100,
and each iteration is a dependent chain of L2 reads (the four level-0
planes, 4 x 384 x 1280 x 4 B = 7.9 MB, stay resident in the 50 MB L2),
a 5-step shuffle reduction and a 2x2 solve. The design keeps everything
that does not move in registers: one warp per keypoint, each lane holding
T, Gx and Gy for its <= 4 of the 121 window pixels for the whole loop, and
`__shfl_xor_sync` sums that leave bit-identical totals in every lane, so
the per-keypoint `while` loop stays warp-uniform (the solve is shared with
kernel #2 in `csrc/lk_klt.cuh`). wgmma, TMA and batching levels or tracks
into one launch are later work.

`lk_level` launches the kernel for CUDA tensors (or raises) and takes the
plain version `lk_level_ref` only for CPU tensors. `LAUNCHES` counts kernel
launches; nothing else increments it.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from ssvio_tpu_torch.ops import _nvcc
from ssvio_tpu_torch.ops._nvcc import MAX_WINDOW_PIXELS, check

LAUNCHES = 0          # kernel launches made by lk_level (CUDA tensors only)

SRC = _nvcc.CSRC / "lk_level.cu"

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_nvcc.build(SRC)))
        fn = lib.ssvio_lk_level
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def lk_level(img_prev: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
             img_cur: torch.Tensor, pts_prev: torch.Tensor,
             pts_guess: torch.Tensor, frozen0: torch.Tensor, *,
             win: int, iters: int, eps: float, min_eig: float,
             padded_hw: Tuple[int, int],
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KLT level, `lk_pallas.lk_level_vmem` semantics.

    Planes [H, W] float32 (true level dims); `padded_hw` = (Hb, Wb) the
    padded dims that set the bounds. pts_prev/pts_guess [N, 2] float32
    global (x, y) in this level's coordinates; frozen0 [N, 1] int32.
    Returns (pts_out [N, 2] float32, good_flag [N, 1] int32).

    CUDA tensors launch the kernel or raise; CPU tensors take lk_level_ref.
    """
    global LAUNCHES
    if img_cur.device.type == "cpu":
        return lk_level_ref(img_prev, gx, gy, img_cur, pts_prev, pts_guess,
                            frozen0, win=win, iters=iters, eps=eps,
                            min_eig=min_eig, padded_hw=padded_hw)
    if img_cur.device.type != "cuda":
        raise ValueError(f"lk_level: unsupported device {img_cur.device}")
    dev = img_cur.device
    H, W = img_cur.shape
    Hb, Wb = padded_hw
    n = pts_prev.shape[0]
    for name, t in (("img_prev", img_prev), ("gx", gx), ("gy", gy),
                    ("img_cur", img_cur)):
        check(name, t, torch.float32, (H, W), dev)
    check("pts_prev", pts_prev, torch.float32, (n, 2), dev)
    check("pts_guess", pts_guess, torch.float32, (n, 2), dev)
    check("frozen0", frozen0, torch.int32, (n, 1), dev)
    if win < 1 or win * win > MAX_WINDOW_PIXELS:
        raise ValueError(f"lk_level: win={win} outside 1..11 "
                         f"(win*win <= {MAX_WINDOW_PIXELS})")
    if Hb < H or Wb < W or Hb - win - 2 < 0 or Wb - win - 2 < 0:
        raise ValueError(f"lk_level: padded dims {padded_hw} do not cover "
                         f"the level {(H, W)} and a {win}x{win} window")
    pts_out = torch.empty((n, 2), dtype=torch.float32, device=dev)
    flag = torch.empty((n, 1), dtype=torch.int32, device=dev)
    if n == 0:
        return pts_out, flag
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ssvio_lk_level(
        img_prev.data_ptr(), gx.data_ptr(), gy.data_ptr(), img_cur.data_ptr(),
        H, W, Hb, Wb, pts_prev.data_ptr(), pts_guess.data_ptr(),
        frozen0.data_ptr(), pts_out.data_ptr(), flag.data_ptr(),
        n, win, iters, float(eps), float(min_eig), stream)
    if rc != 0:
        raise RuntimeError(f"ssvio_lk_level launch failed: cudaError {rc}")
    LAUNCHES += 1
    return pts_out, flag


def lk_level_ref(img_prev: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
                 img_cur: torch.Tensor, pts_prev: torch.Tensor,
                 pts_guess: torch.Tensor, frozen0: torch.Tensor, *,
                 win: int, iters: int, eps: float, min_eig: float,
                 padded_hw: Tuple[int, int],
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the kernel (same contract as lk_level).

    A masked loop of exactly `iters` steps over all keypoints that carries
    `frozen`: a frozen keypoint keeps its position, which is the answer the
    kernel's per-keypoint `while` loop gives."""
    H, W = img_cur.shape
    Hb, Wb = padded_hw
    dev = img_cur.device
    pad = (0, Wb - W, 0, Hb - H)
    planes = [F.pad(p, pad) if pad != (0, 0, 0, 0) else p
              for p in (img_prev, gx, gy, img_cur)]
    prev_p, gx_p, gy_p, cur_p = [p.reshape(-1) for p in planes]
    r = win // 2
    lim_x = float(Wb - win - 2)
    lim_y = float(Hb - win - 2)
    off = torch.arange(win + 1, device=dev)

    def base(v, lim):
        return torch.clamp(torch.nan_to_num(torch.floor(v)), 0.0, lim)

    def sample(flat, bx, by, fx, fy):
        idx = ((by.long()[:, None, None] + off[None, :, None]) * Wb
               + bx.long()[:, None, None] + off[None, None, :])
        s = flat[idx]
        fx = fx[:, None, None]
        fy = fy[:, None, None]
        return ((1 - fy) * (1 - fx) * s[:, :win, :win]
                + (1 - fy) * fx * s[:, :win, 1:]
                + fy * (1 - fx) * s[:, 1:, :win]
                + fy * fx * s[:, 1:, 1:])

    tx = pts_prev[:, 0] - r
    ty = pts_prev[:, 1] - r
    btx = base(tx, lim_x)
    bty = base(ty, lim_y)
    T = sample(prev_p, btx, bty, tx - btx, ty - bty)
    Gx = sample(gx_p, btx, bty, tx - btx, ty - bty)
    Gy = sample(gy_p, btx, bty, tx - btx, ty - bty)
    gxx = torch.sum(Gx * Gx, dim=(1, 2))
    gxy = torch.sum(Gx * Gy, dim=(1, 2))
    gyy = torch.sum(Gy * Gy, dim=(1, 2))
    det = gxx * gyy - gxy * gxy
    trace = gxx + gyy
    me = (trace - torch.sqrt(torch.clamp(trace * trace - 4 * det, min=0.0))) * 0.5
    good_g = (me / (win * win)) > min_eig
    inv_det = torch.where(torch.abs(det) > 1e-9, 1.0 / det,
                          torch.zeros_like(det))

    lx = pts_guess[:, 0] - r
    ly = pts_guess[:, 1] - r

    def oob(x, y):
        return (x < 0.0) | (y < 0.0) | (x > lim_x) | (y > lim_y)

    frozen = (frozen0[:, 0] > 0) | oob(lx, ly) | ~good_g
    for _ in range(iters):
        bx = base(lx, lim_x)
        by = base(ly, lim_y)
        I = sample(cur_p, bx, by, lx - bx, ly - by)
        diff = T - I
        bxs = torch.sum(diff * Gx, dim=(1, 2))
        bys = torch.sum(diff * Gy, dim=(1, 2))
        dx = (gyy * bxs - gxy * bys) * inv_det
        dy = (gxx * bys - gxy * bxs) * inv_det
        nlx = lx + dx
        nly = ly + dy
        stop = (dx * dx + dy * dy < eps * eps) | oob(nlx, nly)
        lx = torch.where(frozen, lx, nlx)
        ly = torch.where(frozen, ly, nly)
        frozen = frozen | stop
    pts_out = torch.stack([lx + r, ly + r], dim=-1)
    return pts_out, good_g.to(torch.int32)[:, None]

