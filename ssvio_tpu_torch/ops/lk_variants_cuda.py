"""The other samplers of kernel #1's function (`Settings.lk_kernel` =
"sw", "ymm", "pkmm", "mm", "mm_f32"): the hand-written CUDA kernels #3-#5,
their ctypes bindings and their plain torch versions. Mirrors
`ssvio_tpu/ops/lk_pallas_variants.py`; follows `lk_cuda.py` (kernel #1).

Each computes one pyramid level of forward-additive KLT with kernel #1's
bounds (`lim = Wb - win - 2`, `Hb - win - 2` of the padded level), gate,
per-keypoint freeze and exit; they differ only in how the bilinear window
is sampled, as the JAX variants do. The CUDA kernels share the level kernel
and the solve of `csrc/lk_klt.cuh` with kernel #1 (a Sampler each); the
plain versions share `lk_cuda.klt_solve_ref` (a `blend` each):

- #3, flavour sw: `lk_level_vmem_sw` (lk_pallas_variants.py:167) ->
  csrc/lk_level_sw.cu. A launch of kernel #1's level kernel and region
  sampler: kernel #1's function and values. win <= 23.
- #4, flavours ymm and pkmm: `lk_level_vmem_pk` (:104) ->
  csrc/lk_level_pk.cu. Separable: y blend, then x, in registers. win <= 16.
- #5, flavours mm and mm_f32: `lk_level_vmem_mm` (:416) ->
  csrc/lk_level_mm.cu. mm samples W = By S Bx^T on register-resident
  mma.sync fragments in bf16 (planes, weights and R rounded to bf16, f32
  accumulation), mm_f32 takes #4's separable f32 sampler. win <= 16.

What bounds them on the card: latency (`lk_cuda.py`). A 512-keypoint
level is 512 warps, about 4 an SM; each iteration is one dependent chain
(sample the window, two 5-step shuffle reductions, a 2x2 solve), and the
level lasts as long as its slowest keypoint's chain. Each kernel copies a
search region of `cur` around the first search window into the warp's
shared memory once a level (cp.async), samples every window inside it from
there with no barrier in the loop (L2 outside it), and lets each keypoint
exit on its own: the JAX `mm` kernel's lockstep groups of 8 change no
keypoint's answer (a frozen keypoint keeps its position) and buy nothing on
a card where a warp holds one keypoint. mm keeps every operand of its two
products in registers. The source notes (`csrc/*.cu`) give the details.

Why #3 is kernel #1's launch: on the TPU, `sw` replaced the serial
kernel's dynamic sublane roll with a static-slice switch; Hopper has no
such roll, so the switch has no counterpart. Staging each window through
shared memory (two __syncwarp a window) measured 1.27x kernel #1's device
time on an H100 (PERF.md); staging a region once a level is what "staged"
means on this card, and that is kernel #1's design.

Window limits (`_nvcc.MAX_WIN`), the JAX kernels': #3 takes win <= 23
(JAX's `sw` assert); #4 and #5 take 16, where JAX's `mm` has no guard and
would silently drop window rows above it (ROADMAP Queue 3). Each wrapper
raises above its limit, on either device.

Each wrapper launches its kernel for CUDA tensors (or raises) and takes
its plain version only for CPU tensors. Each kernel has its own launch
counter (`LAUNCHES`); nothing else increments it. Each takes `stats`, as
`lk_cuda.lk_level` does: an int32 [3] CUDA tensor the kernel adds to
(search windows read outside the staged region, keypoint-iterations, and
as a maximum the most iterations of any keypoint; chip_smoke.py; the path
passes none).
`mm_windows` runs #5's samplers alone, for the checks that hold mm's
tensor-core windows against the plain blend (chip_smoke.py,
tests/test_torch_gpu.py); no path calls it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ssvio_tpu_torch.ops import _nvcc, lk_cuda

# kernel launches per kernel (CUDA tensors only)
LAUNCHES = {"lk_level_sw": 0, "lk_level_pk": 0, "lk_level_mm": 0,
            "lk_level_mm_f32": 0}

SRC = {"lk_level_sw": _nvcc.CSRC / "lk_level_sw.cu",
       "lk_level_pk": _nvcc.CSRC / "lk_level_pk.cu",
       "lk_level_mm": _nvcc.CSRC / "lk_level_mm.cu"}

_libs: dict = {}
_fns: dict = {}


def _library(stem: str):
    """csrc/<stem>.cu, built and loaded at first use."""
    if stem not in _libs:
        _libs[stem] = ctypes.CDLL(str(_nvcc.build(SRC[stem])))
    return _libs[stem]


def _entry(stem: str):
    """The level entry point `ssvio_<stem>` of csrc/<stem>.cu."""
    if stem not in _fns:
        fn = getattr(_library(stem), f"ssvio_{stem}")
        extra = {"lk_level_sw": [ctypes.c_void_p],                 # stats
                 "lk_level_pk": [ctypes.c_void_p],                 # stats
                 "lk_level_mm": [ctypes.c_int, ctypes.c_void_p],   # use_bf16
                 }[stem]
        fn.argtypes = lk_cuda.LEVEL_ARGTYPES[:-1] + extra + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[stem] = fn
    return _fns[stem]


def _launch(counter: str, stem: str, planes, pts_prev, pts_guess, frozen0,
            kw, plane_dtype=torch.float32, extra=()):
    pts_out, flag, launched = lk_cuda.launch_level(
        lambda: _entry(stem), counter, planes, pts_prev, pts_guess, frozen0,
        plane_dtype=plane_dtype, extra=extra, **kw)
    LAUNCHES[counter] += launched
    return pts_out, flag


def lk_level_sw(img_prev: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
                img_cur: torch.Tensor, pts_prev: torch.Tensor,
                pts_guess: torch.Tensor, frozen0: torch.Tensor, *, win: int,
                iters: int, eps: float, min_eig: float,
                padded_hw: Tuple[int, int],
                stats: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel #3 (flavour "sw"), `lk_level_vmem_sw` semantics; the contract
    of `lk_cuda.lk_level`. CUDA tensors launch the kernel or raise; CPU
    tensors take lk_level_sw_ref; either raises for win > 23. `stats`: see
    the module note (CUDA only)."""
    _nvcc.check_window("lk_level_sw", win)
    kw = dict(win=win, iters=iters, eps=eps, min_eig=min_eig,
              padded_hw=padded_hw)
    planes = (img_prev, gx, gy, img_cur)
    if img_cur.device.type == "cpu":
        if stats is not None:
            raise ValueError("lk_level_sw: stats are the kernel's (CUDA)")
        return lk_level_sw_ref(*planes, pts_prev, pts_guess, frozen0, **kw)
    return _launch("lk_level_sw", "lk_level_sw", planes, pts_prev, pts_guess,
                   frozen0, kw, extra=(lk_cuda.stats_ptr(stats,
                                                         img_cur.device),))


def lk_level_sw_ref(img_prev, gx, gy, img_cur, pts_prev, pts_guess, frozen0,
                    *, win: int, iters: int, eps: float, min_eig: float,
                    padded_hw: Tuple[int, int], counts: Optional[dict] = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel #3. The JAX kernel's static-slice switch
    selects the same window rows as kernel #1's roll, so this is kernel
    #1's function and its plain version's arithmetic (the four-corner
    blend)."""
    return lk_cuda.level_ref(img_prev, gx, gy, img_cur, pts_prev, pts_guess,
                             frozen0, win=win, iters=iters, eps=eps,
                             min_eig=min_eig, padded_hw=padded_hw,
                             counts=counts)


def blend_separable(s: torch.Tensor, fx: torch.Tensor,
                    fy: torch.Tensor) -> torch.Tensor:
    """Separable sample of the integer windows s [N, win+1, win+1]: rows
    y-blended first, then x (csrc/lk_klt.cuh::SeparableSampler; the
    order of the JAX kernels' two-hot products)."""
    r = (1 - fy) * s[:, :-1, :] + fy * s[:, 1:, :]
    return (1 - fx) * r[:, :, :-1] + fx * r[:, :, 1:]


def lk_level_pk(img_prev: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
                img_cur: torch.Tensor, pts_prev: torch.Tensor,
                pts_guess: torch.Tensor, frozen0: torch.Tensor, *, win: int,
                iters: int, eps: float, min_eig: float,
                padded_hw: Tuple[int, int], x_mm: bool = False,
                stats: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel #4 (flavours "ymm" and "pkmm"), `lk_level_vmem_pk` semantics;
    the contract of `lk_cuda.lk_level`.

    `x_mm` is the JAX signature's choice between an x blend by lane roll
    ("ymm") and a second two-hot matmul ("pkmm"). It selects nothing here,
    and the dispatch (`ops/lk.py::_level_fns`) does not pass it: every
    output of either is a sum of exactly two non-zero products,
    (1-fx) r[j] + fx r[j+1], so both are one function, and the card has no
    lane roll to avoid. CUDA tensors launch the kernel or raise; CPU tensors
    take lk_level_pk_ref; either raises for win > 16. `stats`: see the
    module note (CUDA only)."""
    _nvcc.check_window("lk_level_pk", win)
    kw = dict(win=win, iters=iters, eps=eps, min_eig=min_eig,
              padded_hw=padded_hw)
    planes = (img_prev, gx, gy, img_cur)
    if img_cur.device.type == "cpu":
        if stats is not None:
            raise ValueError("lk_level_pk: stats are the kernel's (CUDA)")
        return lk_level_pk_ref(*planes, pts_prev, pts_guess, frozen0, **kw)
    return _launch("lk_level_pk", "lk_level_pk", planes, pts_prev, pts_guess,
                   frozen0, kw,
                   extra=(lk_cuda.stats_ptr(stats, img_cur.device),))


def lk_level_pk_ref(img_prev, gx, gy, img_cur, pts_prev, pts_guess, frozen0,
                    *, win: int, iters: int, eps: float, min_eig: float,
                    padded_hw: Tuple[int, int], counts: Optional[dict] = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel #4 (flavours "ymm" and "pkmm"): kernel #1's
    function with the separable sampler."""
    return lk_cuda.level_ref(img_prev, gx, gy, img_cur, pts_prev, pts_guess,
                             frozen0, win=win, iters=iters, eps=eps,
                             min_eig=min_eig, padded_hw=padded_hw,
                             blend=blend_separable, counts=counts)


def bf16(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to bf16 (round to nearest even) and back."""
    return t.to(torch.bfloat16).float()


def blend_mm_bf16(s: torch.Tensor, fx: torch.Tensor,
                  fy: torch.Tensor) -> torch.Tensor:
    """W = By S Bx^T of the "mm" flavour, from windows s already rounded to
    bf16: bf16(1-f) and bf16(f) rounded separately
    (lk_pallas_variants.py:244, :251), R = By S rounded to bf16 (:258).
    Each product of two bf16 values is exact in float32, so every output is
    its two-term sum rounded once."""
    r = bf16(bf16(1 - fy) * s[:, :-1, :] + bf16(fy) * s[:, 1:, :])
    return bf16(1 - fx) * r[:, :, :-1] + bf16(fx) * r[:, :, 1:]


def lk_level_mm(img_prev: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
                img_cur: torch.Tensor, pts_prev: torch.Tensor,
                pts_guess: torch.Tensor, frozen0: torch.Tensor, *, win: int,
                iters: int, eps: float, min_eig: float,
                padded_hw: Tuple[int, int], use_bf16: bool = True,
                stats: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel #5 (flavours "mm", use_bf16, and "mm_f32"),
    `lk_level_vmem_mm` semantics; the contract of `lk_cuda.lk_level`, on
    float32 planes. With use_bf16 the wrapper casts the four planes to bf16
    before the launch, as the JAX wrapper does (lk_pallas_variants.py:459).
    CUDA tensors launch the kernel or raise; CPU tensors take
    lk_level_mm_ref; either raises for win > 16. `stats`: see the module
    note (CUDA only)."""
    counter = "lk_level_mm" if use_bf16 else "lk_level_mm_f32"
    _nvcc.check_window(counter, win)
    kw = dict(win=win, iters=iters, eps=eps, min_eig=min_eig,
              padded_hw=padded_hw)
    planes = (img_prev, gx, gy, img_cur)
    if img_cur.device.type == "cpu":
        if stats is not None:
            raise ValueError(f"{counter}: stats are the kernel's (CUDA)")
        return lk_level_mm_ref(*planes, pts_prev, pts_guess, frozen0,
                               use_bf16=use_bf16, **kw)
    dev = img_cur.device
    for name, t in zip(("img_prev", "gx", "gy", "img_cur"), planes):
        _nvcc.check(name, t, torch.float32, img_cur.shape, dev)
    if use_bf16:
        planes = tuple(p.to(torch.bfloat16) for p in planes)
    return _launch(counter, "lk_level_mm", planes, pts_prev, pts_guess,
                   frozen0, kw, plane_dtype=planes[0].dtype,
                   extra=(int(use_bf16), lk_cuda.stats_ptr(stats, dev)))


def lk_level_mm_ref(img_prev, gx, gy, img_cur, pts_prev, pts_guess, frozen0,
                    *, win: int, iters: int, eps: float, min_eig: float,
                    padded_hw: Tuple[int, int], use_bf16: bool = True,
                    counts: Optional[dict] = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel #5. use_bf16: the planes rounded to bf16 and
    the sampler blend_mm_bf16 (the three bf16 roundings of the JAX kernel);
    else the separable float32 sampler. A masked loop of exactly `iters`
    steps, as lk_cuda.lk_level_ref runs: per keypoint the answer of the
    JAX kernel's lockstep group, which is each keypoint's own."""
    planes = (img_prev, gx, gy, img_cur)
    if use_bf16:
        planes = tuple(bf16(p) for p in planes)
    return lk_cuda.level_ref(*planes, pts_prev, pts_guess, frozen0, win=win,
                             iters=iters, eps=eps, min_eig=min_eig,
                             padded_hw=padded_hw,
                             blend=blend_mm_bf16 if use_bf16
                             else blend_separable, counts=counts)


def mm_windows(plane: torch.Tensor, tl: torch.Tensor, *, win: int,
               use_bf16: bool = True, staged: bool = False) -> torch.Tensor:
    """The windows kernel #5's sampler takes at top-lefts tl [n, 2] (x, y)
    of `plane` [H, W] float32: [n, win, win] float32. With use_bf16 the
    plane is rounded to bf16 first, as lk_level_mm does, and sampled on the
    tensor cores; else the separable float32 sampler of "mm_f32". With
    `staged` each window is read from a search region staged around it
    (the solve's search path), else from L2 (its template path). A check
    of the sampler alone, run by no path: no launch is counted. CUDA
    tensors launch csrc/lk_level_mm.cu::windows_kernel or raise; CPU
    tensors take mm_windows_ref. Raises for win > 16."""
    _nvcc.check_window("lk_level_mm", win)
    if plane.device.type == "cpu":
        return mm_windows_ref(plane, tl, win=win, use_bf16=use_bf16)
    dev = plane.device
    H, W = plane.shape
    n = tl.shape[0]
    _nvcc.check("plane", plane, torch.float32, (H, W), dev)
    _nvcc.check("tl", tl, torch.float32, (n, 2), dev)
    if n and not bool(((tl >= 0) & (tl < torch.tensor(
            [W, H], dtype=tl.dtype, device=dev))).all()):
        raise ValueError("mm_windows: a top-left outside the plane")
    if use_bf16:
        plane = plane.to(torch.bfloat16)
    out = torch.empty((n, win, win), dtype=torch.float32, device=dev)
    fn = _library("lk_level_mm").ssvio_lk_mm_windows
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    rc = fn(plane.data_ptr(), H, W, tl.data_ptr(), out.data_ptr(), n, win,
            int(use_bf16), int(staged),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mm_windows launch failed: cudaError {rc}")
    return out


def mm_windows_ref(plane: torch.Tensor, tl: torch.Tensor, *, win: int,
                   use_bf16: bool = True) -> torch.Tensor:
    """Plain version of mm_windows: the integer windows (0 beyond the
    plane) blended by blend_mm_bf16 on the bf16-rounded plane, or by
    blend_separable."""
    p = bf16(plane) if use_bf16 else plane
    p = torch.nn.functional.pad(p, (0, win + 1, 0, win + 1))
    b = torch.floor(tl)
    off = torch.arange(win + 1, device=plane.device)
    x0, y0 = b[:, 0].long(), b[:, 1].long()
    s = p[(y0[:, None, None] + off[None, :, None]),
          (x0[:, None, None] + off[None, None, :])]
    f = (tl - b)[:, :, None, None]
    return (blend_mm_bf16 if use_bf16 else blend_separable)(s, f[:, 0],
                                                            f[:, 1])
