"""One pyramid level of KLT for N keypoints: the hand-written CUDA kernel,
its ctypes binding, and its plain torch version.

Replaces the TPU kernel `ssvio_tpu/ops/lk_pallas.py::lk_level_vmem`
(body `_make_serial_vmem_kernel`, sampler `_make_vmem_kernel`), the Pallas
kernel of every LK level whose padded planes fit the 12 MiB budget
(`ops/lk.py`; larger levels take `ops/lk_patch_cuda.py`). Both compute, per
keypoint:
bilinear win x win (11 x 11 on the path) template and Sobel windows at
`pts_prev` (the window moves
rigidly, so it shares one fractional offset), a min-eigenvalue gate on the
2x2 structure tensor, then up to `iters` forward-additive steps with
per-keypoint early exit on |delta| < eps or on leaving the padded level
(`lim = Wb - win - 2`, `Hb - win - 2`). Reads between the true level dims
(H, W) and the padded dims (Hb, Wb) return 0, as the TPU wrapper's zero
padding does; the CUDA kernel bounds-checks instead of padding physically.

What bounds it on the card: it is latency-bound, not bandwidth- or
FLOP-bound. A 512-keypoint call is 512 warps, about 4 per SM of an H100,
and each iteration of a keypoint is one dependent chain: sample the
window, two 5-step shuffle reductions, a 2x2 solve, the convergence test.
A level lasts as long as its longest chain. The design keeps everything
that does not move in registers: one warp per keypoint, each lane holding
T, Gx and Gy for its window pixels (4 a lane at win <= 11, 8 at <= 16, 18
at <= 24) for the whole loop, and `__shfl_xor_sync` sums that leave
bit-identical totals in every lane, so the per-keypoint `while` loop stays
warp-uniform. Each warp copies a region of the current plane around its
first search window into its own shared memory once a level (cp.async)
and blends every search window inside it from there, with no barrier in
the loop; the template windows, and a search window that leaves the
region, read L2 (the four level-0 planes, 4 x 384 x 1280 x 4 B = 7.9 MB,
stay resident in the 50 MB L2). The blend's FMA contraction is pinned, so
the values do not depend on where a window was read and equal the first,
all-L2 design's bit for bit. Window limit 24, where the JAX kernel's
32-row slab stops holding a window at every row offset.

Shared with the other LK kernels: the level kernel, the solve and the
sampler (`csrc/lk_klt.cuh`, generic over a window sampler; this kernel's
is `FourCornerSampler`, which kernel #3 launches too), the checks and
launch of a kernel with this function (`launch_level`, used by
`lk_variants_cuda.py`), and the plain solve `klt_solve_ref` (generic over
a `blend`, with the frames of `csrc/lk_klt.cuh::Frame`), which every
kernel's plain version runs.

`lk_level` launches the kernel for CUDA tensors (or raises) and takes the
plain version `lk_level_ref` only for CPU tensors. `LAUNCHES` counts kernel
launches; nothing else increments it. With `stats`, an int32 [3] CUDA
tensor, the kernel adds to it the search windows read outside the staged
region and the keypoint-iterations, and raises its third entry to the most
iterations of any keypoint (chip_smoke.py; the path passes none).
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ssvio_tpu_torch.ops import _nvcc
from ssvio_tpu_torch.ops._nvcc import check, check_window

LAUNCHES = 0          # kernel launches made by lk_level (CUDA tensors only)

SRC = _nvcc.CSRC / "lk_level.cu"

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_nvcc.build(SRC)))
        lib.ssvio_lk_level.argtypes = (LEVEL_ARGTYPES[:-1]
                                       + [ctypes.c_void_p]        # stats
                                       + LEVEL_ARGTYPES[-1:])
        lib.ssvio_lk_level.restype = ctypes.c_int
        _lib = lib
    return _lib


# the C entry point of every kernel with kernel #1's function
# (csrc/lk_klt.cuh::launch_level): 4 planes, H, W, Hb, Wb, pts_prev,
# pts_guess, frozen0, pts_out, flag, n, win, iters, eps, min_eig, the
# kernel's own arguments, stream
LEVEL_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                  + [ctypes.c_void_p] * 5
                  + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
                  + [ctypes.c_void_p])


def stats_ptr(stats: Optional[torch.Tensor], dev) -> Optional[int]:
    """The pointer a staged level kernel adds its stats to: None, or an
    int32 [3] tensor on `dev`."""
    if stats is None:
        return None
    check("stats", stats, torch.int32, (3,), dev)
    return stats.data_ptr()


def launch_level(fn, name: str, planes, pts_prev: torch.Tensor,
                 pts_guess: torch.Tensor, frozen0: torch.Tensor, *,
                 win: int, iters: int, eps: float, min_eig: float,
                 padded_hw: Tuple[int, int], plane_dtype=torch.float32,
                 extra=()) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """Check the inputs of a kernel with kernel #1's function and launch
    it: `fn()` returns its ctypes entry point (LEVEL_ARGTYPES, then
    `extra` arguments before the stream). Planes [H, W] of `plane_dtype`;
    the caller has checked the window against its kernel's limit
    (`_nvcc.check_window`). Returns (pts_out, flag, launched); raises on
    anything else the kernel does not take and on a failed launch."""
    img_cur = planes[3]
    dev = img_cur.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    H, W = img_cur.shape
    Hb, Wb = padded_hw
    n = pts_prev.shape[0]
    for pname, t in zip(("img_prev", "gx", "gy", "img_cur"), planes):
        check(pname, t, plane_dtype, (H, W), dev)
    check("pts_prev", pts_prev, torch.float32, (n, 2), dev)
    check("pts_guess", pts_guess, torch.float32, (n, 2), dev)
    check("frozen0", frozen0, torch.int32, (n, 1), dev)
    if Hb < H or Wb < W or Hb - win - 2 < 0 or Wb - win - 2 < 0:
        raise ValueError(f"{name}: padded dims {padded_hw} do not cover "
                         f"the level {(H, W)} and a {win}x{win} window")
    pts_out = torch.empty((n, 2), dtype=torch.float32, device=dev)
    flag = torch.empty((n, 1), dtype=torch.int32, device=dev)
    if n == 0:
        return pts_out, flag, False
    entry = fn()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = entry(*[t.data_ptr() for t in planes], H, W, Hb, Wb,
               pts_prev.data_ptr(), pts_guess.data_ptr(), frozen0.data_ptr(),
               pts_out.data_ptr(), flag.data_ptr(), n, win, iters,
               float(eps), float(min_eig), *extra, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    return pts_out, flag, True


def lk_level(img_prev: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
             img_cur: torch.Tensor, pts_prev: torch.Tensor,
             pts_guess: torch.Tensor, frozen0: torch.Tensor, *,
             win: int, iters: int, eps: float, min_eig: float,
             padded_hw: Tuple[int, int],
             stats: Optional[torch.Tensor] = None,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KLT level, `lk_pallas.lk_level_vmem` semantics.

    Planes [H, W] float32 (true level dims); `padded_hw` = (Hb, Wb) the
    padded dims that set the bounds. pts_prev/pts_guess [N, 2] float32
    global (x, y) in this level's coordinates; frozen0 [N, 1] int32.
    Returns (pts_out [N, 2] float32, good_flag [N, 1] int32).

    CUDA tensors launch the kernel or raise; CPU tensors take lk_level_ref.
    Either raises for win > 24, the kernel's limit. `stats`: see the module
    note (CUDA only).
    """
    global LAUNCHES
    check_window("lk_level", win)
    kw = dict(win=win, iters=iters, eps=eps, min_eig=min_eig,
              padded_hw=padded_hw)
    planes = (img_prev, gx, gy, img_cur)
    if img_cur.device.type == "cpu":
        if stats is not None:
            raise ValueError("lk_level: stats are the kernel's (CUDA)")
        return lk_level_ref(*planes, pts_prev, pts_guess, frozen0, **kw)
    pts_out, flag, launched = launch_level(
        lambda: _library().ssvio_lk_level, "lk_level", planes, pts_prev,
        pts_guess, frozen0, extra=(stats_ptr(stats, img_cur.device),), **kw)
    LAUNCHES += launched
    return pts_out, flag


class Frame(NamedTuple):
    """A local window frame (csrc/lk_klt.cuh::Frame): the integer origin
    [N, 2] (x, y) in the padded plane (None: 0) and the clip box
    [0, lim_x] x [0, lim_y] of the window's local top-left."""
    org: Optional[torch.Tensor]
    lim_x: float
    lim_y: float


def blend_bilinear(s: torch.Tensor, fx: torch.Tensor,
                   fy: torch.Tensor) -> torch.Tensor:
    """[N, win, win] bilinear samples of the integer windows s
    [N, win+1, win+1] at fraction (fx, fy) [N, 1, 1], in the TPU kernels'
    four-corner order (csrc/lk_klt.cuh::blend)."""
    return ((1 - fy) * (1 - fx) * s[:, :-1, :-1]
            + (1 - fy) * fx * s[:, :-1, 1:]
            + fy * (1 - fx) * s[:, 1:, :-1]
            + fy * fx * s[:, 1:, 1:])


def klt_solve_ref(planes, wb: int, ft: Frame, t_xy, fc: Frame, l_xy,
                  frozen0: torch.Tensor, *, win: int, iters: int, eps: float,
                  min_eig: float, blend: Callable = blend_bilinear,
                  counts: Optional[dict] = None):
    """The plain torch version of csrc/lk_klt.cuh::klt_solve, shared by
    the plain versions of every LK kernel.

    planes: (prev, gx, gy, cur) flattened [Hb * wb] padded planes; template
    window at local top-left t_xy = (tx, ty) of frame `ft`, search from
    l_xy = (lx, ly) of frame `fc` ([N] float32 each); `blend(s, fx, fy)`
    samples the integer windows (the kernel's Sampler). A masked loop of
    exactly `iters` steps over all keypoints that carries `frozen`: a frozen
    keypoint keeps its position, which is the answer the kernels' `while`
    loops give. Returns (lx, ly, good [N] bool).

    With `counts`, counts what a kernel must do on these inputs: adds to
    counts["kp_iters"] (a tensor) the keypoint-iterations it executes and
    to counts["live0"] the keypoints live when the loop starts, raises
    counts["max_iters"] (a tensor) to the most iterations of any keypoint
    (the length of the level's longest chain), and
    marks in counts["touched"] (four bool masks over the flat planes) the
    pixels the function needs: the gx and gy template windows of every
    keypoint (the gate of each flag), the prev template window of each
    keypoint still live when the loop starts, and every search window an
    executed iteration samples; `touched_pixels` counts them.
    """
    prev_p, gx_p, gy_p, cur_p = planes
    off = torch.arange(win + 1, device=cur_p.device)
    touched = None
    if counts is not None:
        touched = counts.setdefault("touched", [
            torch.zeros(p.numel(), dtype=torch.bool, device=p.device)
            for p in planes])

    def base(v, lim):
        return torch.clamp(torch.nan_to_num(torch.floor(v)), 0.0, lim)

    def window(fr, x, y):
        """Flat indices [N, win+1, win+1] of the integer windows, fx, fy."""
        bx, by = base(x, fr.lim_x), base(y, fr.lim_y)
        x0, y0 = bx.long(), by.long()
        if fr.org is not None:
            x0 = x0 + fr.org[:, 0].long()
            y0 = y0 + fr.org[:, 1].long()
        idx = ((y0[:, None, None] + off[None, :, None]) * wb
               + x0[:, None, None] + off[None, None, :])
        return idx, (x - bx)[:, None, None], (y - by)[:, None, None]

    def sample(flat, idx, fx, fy):
        return blend(flat[idx], fx, fy)

    tx, ty = t_xy
    t_win = window(ft, tx, ty)
    T = sample(prev_p, *t_win)
    Gx = sample(gx_p, *t_win)
    Gy = sample(gy_p, *t_win)
    gxx = torch.sum(Gx * Gx, dim=(1, 2))
    gxy = torch.sum(Gx * Gy, dim=(1, 2))
    gyy = torch.sum(Gy * Gy, dim=(1, 2))
    det = gxx * gyy - gxy * gxy
    trace = gxx + gyy
    me = (trace - torch.sqrt(torch.clamp(trace * trace - 4 * det, min=0.0))) * 0.5
    good_g = (me / (win * win)) > min_eig
    inv_det = torch.where(torch.abs(det) > 1e-9, 1.0 / det,
                          torch.zeros_like(det))

    lx, ly = l_xy

    def oob(x, y):
        return (x < 0.0) | (y < 0.0) | (x > fc.lim_x) | (y > fc.lim_y)

    frozen = (frozen0[:, 0] > 0) | oob(lx, ly) | ~good_g
    if touched is not None:
        counts["live0"] = counts.get("live0", 0) + (~frozen).sum()
        touched[1][t_win[0]] = True
        touched[2][t_win[0]] = True
        touched[0][t_win[0][~frozen]] = True
        n_it = torch.zeros_like(frozen, dtype=torch.int32)
    for _ in range(iters):
        c_win = window(fc, lx, ly)
        if counts is not None:
            counts["kp_iters"] = counts.get("kp_iters", 0) + (~frozen).sum()
            n_it += ~frozen
            counts["max_iters"] = torch.maximum(
                counts.get("max_iters", n_it.max()), n_it.max())
            touched[3][c_win[0][~frozen]] = True
        I = sample(cur_p, *c_win)
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
    return lx, ly, good_g


def touched_pixels(counts: dict, padded_hw: Tuple[int, int],
                   hw: Tuple[int, int]) -> int:
    """The pixels of the four planes marked in counts["touched"]
    (klt_solve_ref, planes padded to `padded_hw`) that lie inside the true
    level dims hw = (H, W): the kernels read nothing beyond them."""
    (Hb, Wb), (H, W) = padded_hw, hw
    return sum(int(m.view(Hb, Wb)[:H, :W].sum()) for m in counts["touched"])


def pad_flat(planes, padded_hw: Tuple[int, int]):
    """The planes zero-padded to `padded_hw` (the TPU wrappers' padding),
    flattened."""
    H, W = planes[3].shape
    Hb, Wb = padded_hw
    pad = (0, Wb - W, 0, Hb - H)
    return [(F.pad(p, pad) if pad != (0, 0, 0, 0) else p).reshape(-1)
            for p in planes]


def level_ref(img_prev, gx, gy, img_cur, pts_prev, pts_guess, frozen0, *,
              win: int, iters: int, eps: float, min_eig: float,
              padded_hw: Tuple[int, int], blend: Callable = blend_bilinear,
              counts: Optional[dict] = None):
    """Kernel #1's function with the window sampler `blend`: the plain
    version of csrc/lk_klt.cuh::level_kernel (same contract as lk_level)."""
    Hb, Wb = padded_hw
    r = win // 2
    level = Frame(None, float(Wb - win - 2), float(Hb - win - 2))
    lx, ly, good = klt_solve_ref(
        pad_flat((img_prev, gx, gy, img_cur), padded_hw), Wb, level,
        (pts_prev[:, 0] - r, pts_prev[:, 1] - r), level,
        (pts_guess[:, 0] - r, pts_guess[:, 1] - r), frozen0, win=win,
        iters=iters, eps=eps, min_eig=min_eig, blend=blend, counts=counts)
    return torch.stack([lx + r, ly + r], dim=-1), good.to(torch.int32)[:, None]


def lk_level_ref(img_prev: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
                 img_cur: torch.Tensor, pts_prev: torch.Tensor,
                 pts_guess: torch.Tensor, frozen0: torch.Tensor, *,
                 win: int, iters: int, eps: float, min_eig: float,
                 padded_hw: Tuple[int, int], counts: Optional[dict] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the kernel (same contract as lk_level; see
    klt_solve_ref for `counts`): the four-corner bilinear sampler."""
    return level_ref(img_prev, gx, gy, img_cur, pts_prev, pts_guess, frozen0,
                     win=win, iters=iters, eps=eps, min_eig=min_eig,
                     padded_hw=padded_hw, counts=counts)
