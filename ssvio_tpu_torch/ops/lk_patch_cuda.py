"""One pyramid level of KLT whose search is bounded by a per-keypoint patch
box: the hand-written CUDA kernel, its ctypes binding, and its plain torch
version.

Replaces the TPU kernel `ssvio_tpu/ops/lk_pallas.py::lk_level_pallas`
(the HBM-patch kernel: `_make_kernel`, `_dyn_window`, `_blend`). The JAX
package takes it at a level whose four padded planes exceed the 12 MiB
budget (level 0 of any camera above ~0.79 MP, e.g. 1280x960), and it is a
third LK function, neither the XLA path nor kernel #1 (`lk_cuda.py`):
- the template window is clipped to a [pty, 256] patch at the (128, 8)-
  aligned origin `tl_prev`;
- the search freezes outside the box [0, 256 - win - 1] x
  [0, pcy - win - 1] of a [pcy, 256] patch at the aligned origin `tl_cur`.
  With the origin aligned down to 128 in x and 8 in y, the slack runs from
  0 to 127 px on the left and 117 to 244 px on the right, and from 8 to
  15 px up and 13 to 20 px down (win 11, margin 8: pty 32, pcy 40).
Positions come in and go out in patch coordinates, as the TPU kernel's do;
`ops/lk.py::patch_inputs` computes the origins from the padded dims exactly
as `ssvio_tpu/ops/lk.py:174-212` does.

What bounds it on the card: as kernel #1, latency. The TPU kernel copies
four patches per keypoint into VMEM; the CUDA kernel works in plane
coordinates, origin + local (the four level-0 planes at 1280x960, 19.7 MB,
stay in the 50 MB L2), with one warp per keypoint, T, Gx and Gy in
registers (4 pixels a lane at win <= 11, 8 at <= 16, 18 at <= 24, the
largest window the JAX kernel's 32-row slab holds) and warp-uniform
`__shfl_xor_sync` sums (the solve in `csrc/lk_klt.cuh`, shared with kernel
#1). Each warp copies kernel #1's region of the current plane around its
first search window into its own shared memory once a level (cp.async;
32 x 36 floats, 48 x 52 above win 16) and blends every later search window
inside it from there with kernel #1's pinned blend; the template windows,
and a search window that leaves the region, read L2. The values do not
depend on where a window was read and equal the first, all-L2 design's bit
for bit.

`lk_patch` launches the kernel for CUDA tensors (or raises) and takes the
plain version `lk_patch_ref` only for CPU tensors. `LAUNCHES` counts kernel
launches; nothing else increments it. With `stats`, an int32 [3] CUDA
tensor, the kernel adds to it the search windows read outside the staged
region and the keypoint-iterations, and raises its third entry to the most
iterations of any keypoint (chip_smoke.py; the path passes none).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ssvio_tpu_torch.ops import _nvcc, lk_cuda
from ssvio_tpu_torch.ops._nvcc import check, check_window

LAUNCHES = 0          # kernel launches made by lk_patch (CUDA tensors only)
LANES = 256           # patch width (lk_pallas.LANES)

SRC = _nvcc.CSRC / "lk_patch.cu"

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_nvcc.build(SRC)))
        fn = lib.ssvio_lk_patch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                       + [ctypes.c_void_p]                # stats
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def lk_patch(img_prev: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
             img_cur: torch.Tensor, tl_prev: torch.Tensor,
             tl_cur: torch.Tensor, localT: torch.Tensor, local0: torch.Tensor,
             frozen0: torch.Tensor, *, win: int, pty: int, pcy: int,
             iters: int, eps: float, min_eig: float,
             padded_hw: Tuple[int, int],
             stats: Optional[torch.Tensor] = None,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KLT level, `lk_pallas.lk_level_pallas` semantics.

    Planes [H, W] float32 (true level dims); `padded_hw` = (Hp, Wp) the
    dims the TPU wrapper pads to, which the origins were clipped into.
    tl_prev/tl_cur [N, 2] int32 patch origins (x, y); localT/local0 [N, 2]
    float32 window top-lefts in patch coordinates; frozen0 [N, 1] int32.
    Returns (local_out [N, 2] float32 in search-patch coordinates,
    good_flag [N, 1] int32).

    CUDA tensors launch the kernel or raise; CPU tensors take lk_patch_ref.
    Either raises for win > 24, the kernel's limit. `stats`: see the module
    note (CUDA only).
    """
    global LAUNCHES
    check_window("lk_patch", win)
    kw = dict(win=win, pty=pty, pcy=pcy, iters=iters, eps=eps,
              min_eig=min_eig, padded_hw=padded_hw)
    if img_cur.device.type == "cpu":
        if stats is not None:
            raise ValueError("lk_patch: stats are the kernel's (CUDA)")
        return lk_patch_ref(img_prev, gx, gy, img_cur, tl_prev, tl_cur,
                            localT, local0, frozen0, **kw)
    if img_cur.device.type != "cuda":
        raise ValueError(f"lk_patch: unsupported device {img_cur.device}")
    dev = img_cur.device
    H, W = img_cur.shape
    Hp, Wp = padded_hw
    n = tl_prev.shape[0]
    for name, t in (("img_prev", img_prev), ("gx", gx), ("gy", gy),
                    ("img_cur", img_cur)):
        check(name, t, torch.float32, (H, W), dev)
    for name, t in (("tl_prev", tl_prev), ("tl_cur", tl_cur)):
        check(name, t, torch.int32, (n, 2), dev)
    for name, t in (("localT", localT), ("local0", local0)):
        check(name, t, torch.float32, (n, 2), dev)
    check("frozen0", frozen0, torch.int32, (n, 1), dev)
    if pty % 8 or pcy % 8 or pty < win + 2 or pcy < win + 2:
        raise ValueError(f"lk_patch: patch rows pty={pty}, pcy={pcy} must be "
                         f"multiples of 8 and hold a {win}x{win} window")
    if Hp < max(H, pty, pcy) or Wp < max(W, LANES):
        raise ValueError(f"lk_patch: padded dims {padded_hw} do not cover "
                         f"the level {(H, W)} and the patches")
    local_out = torch.empty((n, 2), dtype=torch.float32, device=dev)
    flag = torch.empty((n, 1), dtype=torch.int32, device=dev)
    if n == 0:
        return local_out, flag
    stats_p = lk_cuda.stats_ptr(stats, dev)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ssvio_lk_patch(
        img_prev.data_ptr(), gx.data_ptr(), gy.data_ptr(), img_cur.data_ptr(),
        H, W, tl_prev.data_ptr(), tl_cur.data_ptr(), localT.data_ptr(),
        local0.data_ptr(), frozen0.data_ptr(), local_out.data_ptr(),
        flag.data_ptr(), n, win, pty, pcy, iters, float(eps), float(min_eig),
        stats_p, stream)
    if rc != 0:
        raise RuntimeError(f"ssvio_lk_patch launch failed: cudaError {rc}")
    LAUNCHES += 1
    return local_out, flag


def lk_patch_ref(img_prev: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
                 img_cur: torch.Tensor, tl_prev: torch.Tensor,
                 tl_cur: torch.Tensor, localT: torch.Tensor,
                 local0: torch.Tensor, frozen0: torch.Tensor, *, win: int,
                 pty: int, pcy: int, iters: int, eps: float, min_eig: float,
                 padded_hw: Tuple[int, int], counts: Optional[dict] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the kernel (same contract as lk_patch; see
    lk_cuda.klt_solve_ref for `counts`).

    Zero-pads the planes to `padded_hw` and samples them at origin + local
    coordinate, through the solve that every kernel's plain version shares
    (lk_cuda.klt_solve_ref), with kernel #2's frames."""
    lim_x = float(LANES - win - 1)
    lx, ly, good = lk_cuda.klt_solve_ref(
        lk_cuda.pad_flat((img_prev, gx, gy, img_cur), padded_hw),
        padded_hw[1], lk_cuda.Frame(tl_prev, lim_x, float(pty - win - 1)),
        (localT[:, 0], localT[:, 1]),
        lk_cuda.Frame(tl_cur, lim_x, float(pcy - win - 1)),
        (local0[:, 0], local0[:, 1]), frozen0, win=win, iters=iters, eps=eps,
        min_eig=min_eig, counts=counts)
    return torch.stack([lx, ly], dim=-1), good.to(torch.int32)[:, None]
