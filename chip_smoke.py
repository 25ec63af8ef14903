"""Drive the PyTorch port's main paths once on one NVIDIA GPU, and check them.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
1. device: a CUDA device is required; prints nvidia-smi's name and power
   limit line.
2. build: compiles the five LK kernel sources of the checkout
   (ssvio_tpu_torch/csrc/lk_level.cu, lk_patch.cu, lk_level_sw.cu,
   lk_level_pk.cu, lk_level_mm.cu; each with every pixel class its
   windows need), one nvcc each, all started together.
3. kernels vs plain: for the KITTI bench configuration (1241x376) and the
   RobotCar XB3 wide configuration (1280x960), renders a scene on the card,
   detects 512 keypoints as the keyframe step does, and at every level of
   the 4-level pyramid runs the kernel that level takes (ops/lk.py: kernel
   #1 lk_cuda.lk_level within the 12 MiB plane budget, kernel #2
   lk_patch_cuda.lk_patch above it: level 0 at 1280x960) and its plain torch
   version on the same inputs, for a temporal pair and a stereo pair, coarse
   to fine as lk.track seeds them. Flags must be equal and converged
   positions within POS_TOL_PX; both are timed with CUDA events. Kernel
   #2's chain is read there too (_chain: slope, fixed part, windows read
   outside the staged region), and at RobotCar level 0 it is also held at
   its widest window and with guesses REGION_OFFSET_PX off
   (_check_patch_region_fallback).
3b. flavours vs plain: at every KITTI level of phase 3, on the same inputs,
   each `Settings.lk_kernel` flavour's kernel (serial: #1 again, sw: #3,
   ymm and pkmm: #4, one function, run once; mm and mm_f32: #5;
   ops/lk_variants_cuda.py) against its plain version, with phase 3's
   checks (for mm, MM_MIN_AGREE_SHARE replaces the cap share and the
   converged tolerance, and the tight checks of _mm_tight and their
   control are added) and times; at every temporal level its device time
   from torch.profiler and its ratio to kernel #1's there (phase 3), the
   most iterations of any keypoint, the time per iteration of that chain
   as a slope between the path's iterations and one, with the fixed part,
   and the search windows read outside the staged region (_chain); prints
   each flavour's largest position difference from kernel #1, which must
   be 0 for serial and sw (one kernel). Then two checks of every flavour:
   the region fallback (guesses REGION_OFFSET_PX off at REGION_LEVEL, so
   that searches leave the staged region: outside count > 0, held against
   the plain versions) and its kernel's widest window (at WIDE_LEVEL; mm
   with _mm_tight); kernel #2's widest window is held in phase 3, at
   RobotCar level 0.
4. the run_step path: System(device="cuda") with the bench configuration
   (512 features, 8192 landmarks, window 16, 8 FAST octaves, LK 11x11 / 3
   levels / 30 iterations, local BA on, loop closing off) runs 96 frames of
   the bench's straight sequence (world seed 4, 0.6 m per frame), rendered
   on the card, through run_step. The run must never go LOST, make >= 2
   keyframes and >= 1 local BA, launch kernel #1 exactly as often as the
   statuses imply (and no other kernel), and keep ATE under 0.5 m.
5. the chunk path: the RobotCar configuration runs 96 frames of a straight
   drive down a street (SCENES; rendered on the card, handed over as host
   uint8 as a camera's are) in chunks of 32
   through the prefetcher and pipelined dispatch_chunk / collect_chunk, as
   bench.py drives the JAX package, then finish(). Same checks as phase 4
   with both kernels' launch counts; the same frames through run_step must
   give the same statuses and keyframes and trajectories within 1e-3 m.
6. the flavours: phase 4's frames through run_step once for each of sw,
   ymm, pkmm, mm and mm_f32 (bench configuration with lk_kernel set). Same
   checks as phase 4, with the flavour's kernel launched as often as the
   statuses imply and kernel #1 never, and pkmm's run equal to ymm's;
   prints ms per frame and the status and position differences from phase
   4's serial run.
7. place recognition at KITTI width (run before phase 6, so that phase
   6's cut sees its time): the bench configuration drives a circle that
   passes over its start again (LOOP_* below) through run_step with loop
   closing off, with phase 4's checks. Every keyframe's image, features
   and landmarks are kept and run through the loop-closing ops on the card
   (512 features x Settings.loop_desc_scales octaves):
   loopclosing.loop_describe on every keyframe, bow.train (host) on the
   first half lap's descriptors, bow.transform into a database,
   score_l1_database for the last keyframe (the best candidate at least
   LOOP_MIN_GAP_KF keyframes older must be one of the first pass
   within LOOP_MAX_DIST_M of the query's true position), the multi-scale
   Hamming match against it, pnp.pnp_ransac on the matched landmarks (ok,
   and T_cw within LOOP_PNP_TOL_* of the ground truth), and pgo.optimize
   on the keyframes' pose graph with drifted odometry and that loop edge
   (dense) and on a circle of PGO_CG_POSES poses (above DENSE_MAX_POSES:
   CG): both must cut the error to PGO_MAX_ERR_SHARE.
   Card against the port's own CPU result on the same inputs: equal for
   words_of, the Hamming match, fast_check_sparse and the descriptors
   from one angle array; within the CPU tests' tolerances for
   ic_angle_integral, transform, pnp_ransac and pgo.optimize. Prints each
   op's CUDA-event ms beside the card's name and power limit.
8. prints the kernel table as one JSON line (with each kernel's bound,
   bound_ms: the plane pixels the level needs over the memory rate, or
   its operations over the peak rate, BOUND_*), then the result line.
"""

import dataclasses
import functools
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ssvio_tpu_torch import frontend as fe
from ssvio_tpu_torch import interop, loopclosing
from ssvio_tpu_torch.config import (Settings, bench_settings,
                                    robotcar_xb3_wide_settings)
from ssvio_tpu_torch.dataio import synthetic, synthetic_torch
from ssvio_tpu_torch.eval import ate
from ssvio_tpu_torch.ops import (_nvcc, bow, fast, lk, lk_cuda, lk_patch_cuda,
                                 orb, pgo, pnp, pyramid, sampling, se3)
from ssvio_tpu_torch.ops import lk_variants_cuda as lkv
from ssvio_tpu_torch.system import System

# Kernel vs plain version, positions (px), on every live track that
# converged before the iteration cap. Both run the same float32 steps;
# they differ in FMA contraction (the kernel's bilinear blend) and in the
# order the 121 window products are summed (warp butterfly vs torch's
# reduction), ~1e-6 px per step. A track whose last step sits at the
# |delta| < 0.01 px convergence edge can take one more sub-0.01 px step on
# one side only, hence 0.02 px. A track still stepping at the cap (an
# oscillation that never converges) amplifies that noise without bound;
# those are counted and printed, not held to the tolerance, and they must
# stay a small share of the live tracks.
POS_TOL_PX = 0.02
MAX_CAPPED_SHARE = 0.05
N_FRAMES = 96
CHUNK = 32
ATE_MAX_M = 0.5          # the bound of tests/test_system_e2e.py
# The synthetic scene of each configuration, and its speed (m per frame).
# KITTI: the bench's world (walls 16 m apart) at 0.6 m per 10 Hz frame.
# RobotCar: a street 8 m wall to wall under an overhead plane 5 m up, at
# 0.4 m per 16 Hz frame (6.4 m/s). The geometry is a choice made so that
# the run initialises at the first frame, not a measured street: the wide
# baseline's triangulation cap is 60 x 0.24 m = 14.4 m, and in the bench's
# 16 m world too few points fall inside it for the init gate (150
# landmarks). A 12 m street initialises only at frame 25 (PERF.md, Cells).
SCENES = {"kitti_bench": (dict(), 0.6),
          "robotcar_xb3_wide": (dict(wall_x=4.0, ceiling_y=-5.0), 0.4)}
CHUNK_VS_STEP_M = 1e-3   # run_chunk vs run_step on one card: the same ops
                         # in the same order; atomics may reorder sums
# mm (bf16): its windows carry about half an intensity unit of rounding
# noise, and a one-ulp difference between kernel and plain version (how the
# tensor cores round an f32 accumulation, the order of the window sums) can
# flip a bf16 rounding and move a track to another point inside that noise
# floor, whether it then converges or not (one converged track 0.034 px
# apart at KITTI level 0, measured on one H100). So after 30 iterations mm
# is held by the share of live tracks within POS_TOL_PX, which must be at
# least MM_MIN_AGREE_SHARE; and where noise cannot build up, tightly: every
# value of the windows its tensor-core sampler takes
# (lk_variants_cuda.mm_windows) at the level's template and search
# top-lefts must lie within MM_WINDOW_ULPS float32 ulps (of its window's
# largest magnitude) of the plain blend's, where one bf16 rounding that
# went the other way is ~2^15 of them; and one step (iters = 1) must land
# within MM_STEP_TOL_PX of the plain version on every live track, or within
# one float32 ulp of the position where that is coarser (1.22e-04 px at
# x >= 1024, the right fifth of KITTI level 0: a step summed in another
# order can round the position one ulp the other way there). Control:
# the mm_f32 kernel, which leaves out the bf16 roundings, held against mm's
# plain version must fail each of the three.
MM_MIN_AGREE_SHARE = 1.0 - MAX_CAPPED_SHARE
MM_WINDOW_ULPS = 2.0
MM_STEP_TOL_PX = 1e-4
FLAVOUR_FRAMES_CUT = 48     # phase 6 frames of the flavours other than mm
                            # when the script would pass SCRIPT_BUDGET_S,
SCRIPT_BUDGET_S = 420.0     # which keeps it well inside its 1200 s limit
                            # on a slow host (one H100: 288-351 s in all)
PLAIN_REPS = 5              # timed calls of a plain version (~30 ms each)
# Phase 7: a circle of LOOP_RADIUS_M driven once in LOOP_LAP_FRAMES frames
# (1.5 degrees and 0.26 m a frame, the turn eased in over LOOP_EASE_FRAMES)
# and LOOP_OVERLAP_FRAMES further, over the start again, between walls
# LOOP_WORLD["wall_x"] from the centre line (the circle spans x in [0, 20]).
LOOP_RADIUS_M = 10.0
LOOP_LAP_FRAMES = 240
LOOP_EASE_FRAMES = 8
LOOP_OVERLAP_FRAMES = 24
LOOP_WORLD = dict(wall_x=24.0, ceiling_y=-5.0)
LOOP_MIN_GAP_KF = 10      # Settings.loop_min_age is 20, more than the ~20
                          # keyframes of this run leave room for
LOOP_MAX_DIST_M = 4.0     # keyframes lie ~3.5 m apart
LOOP_PNP_TOL_M = 0.5      # ATE_MAX_M: the candidate's landmarks carry the
LOOP_PNP_TOL_RAD = 0.05   # run's own error
PGO_DRIFT = 0.05          # per odometry edge, on the twist (rotation x 0.3)
PGO_CG_POSES = 600        # tests/test_pgo.py:122's circle, in 640 slots
PGO_MAX_ERR_SHARE = 0.35  # tests/test_pgo.py:90 and :135
# card against CPU, the CPU tests' tolerances
# (tests/test_torch_loop_ops.py, tests/test_torch_loop_geom.py)
INTEGRAL_MEDIAN_TOL, INTEGRAL_WIDE_TOL, INTEGRAL_WIDE_MIN_SHARE = \
    1e-3, 2e-2, 0.98
TRANSFORM_TOL = 1e-6
PNP_POSE_TOL = 1e-3
PGO_DENSE_TOL, PGO_CG_TOL = 1e-4, 1e-3
KERNELS = {
    "lk_level": dict(source="ssvio_tpu_torch/csrc/lk_level.cu",
                     replaces="ssvio_tpu/ops/lk_pallas.py:344"),
    "lk_patch": dict(source="ssvio_tpu_torch/csrc/lk_patch.cu",
                     replaces="ssvio_tpu/ops/lk_pallas.py:375"),
    "lk_level_sw": dict(source="ssvio_tpu_torch/csrc/lk_level_sw.cu",
                        replaces="ssvio_tpu/ops/lk_pallas_variants.py:167"),
    "lk_level_pk": dict(source="ssvio_tpu_torch/csrc/lk_level_pk.cu",
                        replaces="ssvio_tpu/ops/lk_pallas_variants.py:104"),
    "lk_level_mm": dict(source="ssvio_tpu_torch/csrc/lk_level_mm.cu",
                        replaces="ssvio_tpu/ops/lk_pallas_variants.py:416"),
    "lk_level_mm_f32": dict(source="ssvio_tpu_torch/csrc/lk_level_mm.cu",
                            replaces="ssvio_tpu/ops/lk_pallas_variants.py:416"),
}
# the kernel pairs of phase 3b: launch counter, wrapper, plain version,
# keywords (ops/lk.py::_level_fns; ymm and pkmm are one function)
PAIRS = {
    "serial": ("lk_level", lk_cuda.lk_level, lk_cuda.lk_level_ref, {}),
    "sw": ("lk_level_sw", lkv.lk_level_sw, lkv.lk_level_sw_ref, {}),
    "ymm/pkmm": ("lk_level_pk", lkv.lk_level_pk, lkv.lk_level_pk_ref, {}),
    "mm": ("lk_level_mm", lkv.lk_level_mm, lkv.lk_level_mm_ref,
           dict(use_bf16=True)),
    "mm_f32": ("lk_level_mm_f32", lkv.lk_level_mm, lkv.lk_level_mm_ref,
               dict(use_bf16=False)),
}
# the flavours of phase 6 and the launch counter of each one's kernel
FLAVOURS = {"sw": "lk_level_sw", "ymm": "lk_level_pk", "pkmm": "lk_level_pk",
            "mm": "lk_level_mm", "mm_f32": "lk_level_mm_f32"}
# The least time one H100 SXM could take for a kernel's work (the
# card's published peaks, at 700 W): device memory
# 3.35 TB/s; 67 TFLOP/s float32 on the CUDA cores, 989 TFLOP/s bf16 on the
# tensor cores (mm's sampling products).
BOUND_BYTES_PER_S = 3.35e12
BOUND_F32_PER_S = 67e12
BOUND_BF16_PER_S = 989e12


def bound_ms(n_kp: int, work: dict, win: int, bf16: bool,
             io_words: int = 8):
    """(ms, "bytes" or "operations"): the larger of the two times for one
    KLT level of n_kp keypoints doing `work` (_work: counted by the plain
    version on this run's inputs).
    Bytes: each plane pixel the function needs, read once (the union of
    the windows of _work, at 4 B, 2 B for bf16 planes), plus io_words
    4-byte words a keypoint in and out.
    Operations: sampling the gx and gy template windows of every keypoint,
    the prev one of each keypoint live at the start and one search window
    per keypoint-iteration, separably, 3 per output of the y pass
    (win x (win+1)) and of the x pass (win x win), on the tensor cores for
    bf16; the structure tensor (6 per pixel) and per iteration the residual
    and two sums (5 per pixel) and the 2x2 solve (20), in float32."""
    w1 = win + 1
    kp_iters = work["kp_iters"]
    windows = 2 * n_kp + work["live0"] + kp_iters
    nbytes = work["pixels"] * (2 if bf16 else 4) + 4 * io_words * n_kp
    sample_ops = windows * 3 * (win * w1 + win * win)
    other_ops = n_kp * 6 * win * win + kp_iters * (5 * win * win + 20)
    t_bytes = nbytes / BOUND_BYTES_PER_S
    t_ops = (sample_ops / (BOUND_BF16_PER_S if bf16 else BOUND_F32_PER_S)
             + other_ops / BOUND_F32_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); the port's main path needs one")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    return line


def phase_build() -> None:
    t0 = time.perf_counter()
    sources = (lk_cuda.SRC, lk_patch_cuda.SRC, *lkv.SRC.values())
    with ThreadPoolExecutor(len(sources)) as ex:
        list(ex.map(_nvcc.build, sources))
    lk_cuda._library()
    lk_patch_cuda._library()
    for stem in lkv.SRC:
        lkv._entry(stem)
    print(f"build: {len(sources)} kernel sources in "
          f"{time.perf_counter() - t0:.2f} s")
    for src in sources:
        info = _nvcc.build_info[src.stem]
        print(f"  {info['path']} (nvcc {info['seconds']:.2f} s)")
        for ln in info["log"].splitlines():
            if "registers" in ln or "spill" in ln:
                print("  ptxas:", ln.strip())


def _time_ms(fn, reps=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _timed_once(fn):
    """(fn(), its CUDA-event ms): one call, no warm-up."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _device_ms(fn, reps=20, tries=3) -> float:
    """Device time of one launch of the LK kernel `fn` launches: the mean
    of the kernel's own durations in a torch.profiler trace of `reps`
    calls (the CUDA-event time of back-to-back wrapper calls also holds
    the host work of each call). The trace may miss launches (19 of 20
    seen on one H100, and once none of 20 in a process that took ~100
    traces), so the mean is over those it holds, and a trace that holds
    fewer than half is taken again, up to `tries` times."""
    fn()
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages()
                if "level_kernel" in e.key or "lk_patch_kernel" in e.key]
        if len(evts) > 1:
            break
        if evts and reps // 2 <= evts[0].count <= reps:
            return evts[0].device_time_total / 1e3 / evts[0].count
    raise AssertionError(
        f"profiler: expected one LK kernel launched {reps} times, got "
        f"{[(e.key, e.count) for e in evts]}")


def _level_pair(name, pa, pb, l, pts, guess, valid, params):
    """The kernel `name` and its plain version as closures over the same
    inputs at level l. Returns (kernel(**overrides of its keywords, e.g.
    iters, stats), plain(iters, **counts),
    to_global(out): the output as level positions, frozen0, level
    arguments (planes, pts, guess, frozen0) or None for kernel #2, the
    padded dims the plain version pads to)."""
    h, w = pa.levels[l].shape
    planes = (pa.levels[l], pa.gx[l], pa.gy[l], pb.levels[l])
    r = params.window // 2
    if name == "lk_patch":
        args, kw, org_C = lk.patch_inputs(h, w, pts, guess, valid, params)
        return (lambda **o: lk_patch_cuda.lk_patch(*planes, *args,
                                                   **dict(kw, **o)),
                lambda it, **c: lk_patch_cuda.lk_patch_ref(
                    *planes, *args, **dict(kw, iters=it), **c),
                lambda out: org_C + r + out, args[-1], None,
                kw["padded_hw"])
    frozen0 = (~valid | ~sampling.in_bounds(guess, h, w, r + 1)) \
        .to(torch.int32)[:, None]
    kw = dict(win=params.window, eps=params.eps, min_eig=params.min_eig,
              padded_hw=lk.padded_dims(h, w))
    args = (*planes, pts, guess, frozen0)
    return (lambda **o: lk_cuda.lk_level(
                *args, **dict(kw, iters=params.iters, **o)),
            lambda it, **c: lk_cuda.lk_level_ref(*args, iters=it, **kw, **c),
            lambda out: out, frozen0, (args, kw), kw["padded_hw"])


def _hold(label, out_k, flag_k, plain, iters, frozen0, to_global, h, w,
          mm=False):
    """Phase 3's checks of a kernel's output against its plain version.
    Returns (stats, plain output as level positions)."""
    out_r, flag_r = plain(iters)
    # tracks still stepping at the iteration cap: the plain version one
    # step short lands elsewhere. They have not converged, so float-order
    # noise is not bounded there; they are reported, and the tolerance
    # holds on every track that converged
    capped = torch.any(plain(iters - 1)[0] != out_r, dim=-1)
    torch.cuda.synchronize()
    n_flag_diff = int((flag_k != flag_r).sum())
    g_r = to_global(out_r)
    live = (flag_k[:, 0] > 0) & (frozen0[:, 0] == 0) \
        & sampling.in_bounds(g_r, h, w, 1.0)
    d = torch.max(torch.abs(out_k - out_r), dim=-1).values
    err = float(d[live & ~capped].max()) if bool((live & ~capped).any()) \
        else 0.0
    err_capped = float(d[live & capped].max()) \
        if bool((live & capped).any()) else 0.0
    n_live, n_capped = int(live.sum()), int((live & capped).sum())
    agree = float((d[live] <= POS_TOL_PX).float().mean()) if n_live else 1.0
    res = dict(live=n_live, capped=n_capped, flag_diff=n_flag_diff,
               max_abs_err=err, max_abs_err_capped=err_capped,
               agree_share=agree)
    if n_flag_diff:
        raise AssertionError(f"{label}: {n_flag_diff} flags differ")
    if mm:
        if agree < MM_MIN_AGREE_SHARE:
            raise AssertionError(f"{label}: {agree:.3f} of the live tracks "
                                 f"agree, < {MM_MIN_AGREE_SHARE}")
    elif n_capped > MAX_CAPPED_SHARE * n_live:
        raise AssertionError(f"{label}: {n_capped} of {n_live} live tracks "
                             "hit the cap")
    elif not err <= POS_TOL_PX:
        raise AssertionError(f"{label}: positions differ by {err} px > "
                             f"{POS_TOL_PX}")
    if not bool(torch.isfinite(out_k).all()):
        raise AssertionError(f"{label}: non-finite")
    return res, g_r, live


def _work(plain, iters, padded_hw, hw) -> dict:
    """What the kernel must do on these inputs, counted by its plain
    version (lk_cuda.klt_solve_ref): keypoint-iterations, keypoints live
    at the loop's start, the most iterations of any keypoint (the level's
    longest chain) and the distinct plane pixels the function needs inside
    the true level dims hw."""
    counts = {}
    plain(iters, counts=counts)
    return dict(kp_iters=int(counts["kp_iters"]), live0=int(counts["live0"]),
                max_iters=int(counts["max_iters"]),
                pixels=lk_cuda.touched_pixels(counts, padded_hw, hw))


def phase_kernels_vs_plain(tag: str, s: Settings, dev):
    """Every level of a temporal and a stereo track, each on the kernel
    the level takes, against its plain version. Returns one row per level,
    and the inputs of every level on kernel #1 (for phase 3b)."""
    front = System(s, enable_loop_closing=False, device=dev).frontend
    world = synthetic.SyntheticWorld(seed=4, **SCENES[tag][0])
    cam = s.cam_left
    T0 = synthetic.straight_trajectory(1)[0]
    T1 = T0.copy()                        # a few px of temporal flow
    T1[:3, 3] += [0.02, 0.0, 0.1]
    c, sn = np.cos(0.003), np.sin(0.003)
    T1[:3, :3] = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]])
    L, R = synthetic_torch.render_stereo_sequence_device(
        world, np.stack([T0, T1]), cam.fx, cam.fy, cam.cx, cam.cy, s.baseline,
        s.image_width, s.image_height, pad_w=front.w, pad_h=front.h,
        u8=False, device=dev)
    pyr = {k: front._build_pyramid(v) for k, v in
           (("L0", L[0]), ("L1", L[1]), ("R0", R[0]))}
    feat, _ = front._detect_merge(pyr["L0"].levels[0],
                                  fe.empty_feat_state(s.max_features, dev))
    print(f"kernels-vs-plain [{tag}]: {int(feat.valid.sum())} of "
          f"{s.max_features} keypoints detected (the rest ride along "
          "frozen, as on the path)")
    params = front.lk_params_stereo          # 4 levels
    rows, levels = [], []
    for pair, (a, b) in (("temporal", ("L0", "L1")), ("stereo", ("L0", "R0"))):
        pa, pb = pyr[a], pyr[b]
        flow = torch.zeros_like(feat.xy)
        for l in range(len(pa.levels) - 1, -1, -1):
            h, w = pa.levels[l].shape
            name = "lk_patch" if lk.uses_patch_kernel(h, w) else "lk_level"
            pts = (feat.xy / 2.0 ** l).contiguous()
            guess = (pts + flow).contiguous()
            kern, plain, to_global, frozen0, level_args, padded_hw = \
                _level_pair(name, pa, pb, l, pts, guess, feat.valid, params)
            out_k, flag_k = kern()
            res, g_r, live = _hold(f"{tag} {pair} level {l}", out_k, flag_k,
                                   plain, params.iters, frozen0, to_global,
                                   h, w)
            if name == "lk_patch" and pair == "temporal":
                _check_patch_wide(pa, pb, l, pts, guess, feat.valid, params)
                _check_patch_region_fallback(pa, pb, l, pts, guess,
                                             feat.valid, params)
            ms_k = _time_ms(kern)
            ms_r = _time_ms(lambda: plain(params.iters), reps=PLAIN_REPS)
            chain = None
            if name == "lk_patch":      # phase 3b has kernel #1's chain
                chain = _chain(kern, dict(pair=pair, out_1=out_k,
                                          device_ms_1=None))
                dev_ms = chain["device_ms"]
            else:
                dev_ms = _device_ms(kern) if pair == "temporal" else None
            n_kp = pts.shape[0]
            work = _work(plain, params.iters, padded_hw, (h, w))
            kp_iters = work["kp_iters"]
            b_ms, b_by = bound_ms(n_kp, work, params.window, False,
                                  io_words=12 if name == "lk_patch" else 8)
            moved = torch.linalg.norm(g_r[live] - pts[live], dim=-1)
            print(f"  {pair:8s} level {l} [{h}x{w}] {name} live "
                  f"{res['live']:3d} capped {res['capped']} flag_diff "
                  f"{res['flag_diff']} max_abs_err {res['max_abs_err']:.3g} px"
                  f" (capped {res['max_abs_err_capped']:.3g} px) median_flow "
                  f"{float(moved.median()) if res['live'] else 0:.2f} px "
                  f"kernel {ms_k:.4f} ms plain {ms_r:.4f} ms kp_iters "
                  f"{kp_iters} max_iters {work['max_iters']} needed_px "
                  f"{work['pixels']} bound {b_ms:.6f} ms ({b_by}) "
                  + (_chain_text(chain) if chain else
                     f"device {dev_ms:.4f} ms" if dev_ms else ""))
            rows.append(dict(config=tag, pair=pair, level=l, kernel=name,
                             pixels=h * w, max_abs_err=res["max_abs_err"],
                             ms=ms_k, plain_ms=ms_r, bound_ms=b_ms,
                             bound_by=b_by, kp_iters=kp_iters,
                             needed_px=work["pixels"],
                             **(chain or dict(device_ms=dev_ms))))
            if level_args is not None:
                levels.append(dict(pair=pair, level=l, h=h, w=w,
                                   args=level_args, out_1=out_k,
                                   device_ms_1=dev_ms, frozen0=frozen0,
                                   iters=params.iters, padded_hw=padded_hw))
            if l > 0:
                flow = (g_r - pts) * 2.0
    return rows, levels


def _check_patch_wide(pa, pb, l, pts, guess, valid, params):
    """Kernel #2 at its widest window (_nvcc.MAX_WIN: 24, 18 pixels a
    lane) on phase 3's inputs at level l, against its plain version with
    phase 3's checks."""
    wide = params._replace(window=_nvcc.MAX_WIN["lk_patch"])
    h, w = pa.levels[l].shape
    kern, plain, to_global, frozen0, _, _ = _level_pair(
        "lk_patch", pa, pb, l, pts, guess, valid, wide)
    out_k, flag_k = kern()
    res, _, _ = _hold(f"win {wide.window} lk_patch", out_k, flag_k, plain,
                      wide.iters, frozen0, to_global, h, w)
    print(f"  win {wide.window} [lk_patch] temporal level {l}: "
          + json.dumps(res))


def _check_patch_region_fallback(pa, pb, l, pts, guess, valid, params):
    """Kernel #2 at level l with every guess REGION_OFFSET_PX off the one
    phase 3 gave (its patch boxes follow the guesses), so that searches
    walk past the staged region and read L2: _check_region_fallback's
    checks."""
    h, w = pa.levels[l].shape
    off = (guess + torch.tensor(REGION_OFFSET_PX,
                                device=guess.device)).contiguous()
    kern, plain, to_global, frozen0, _, _ = _level_pair(
        "lk_patch", pa, pb, l, pts, off, valid, params)
    stats = torch.zeros(3, dtype=torch.int32, device=guess.device)
    out_k, flag_k = kern(stats=stats)
    res, _, _ = _hold("region fallback lk_patch", out_k, flag_k, plain,
                      params.iters, frozen0, to_global, h, w, mm=True)
    n_out, kp_iters, max_iters = (int(v) for v in stats.cpu())
    print(f"  region fallback [lk_patch] temporal level {l}, guesses "
          f"{REGION_OFFSET_PX} px off: outside_region {n_out} of {kp_iters} "
          f"search windows, max_iters {max_iters}, " + json.dumps(res))
    if n_out <= 0:
        raise AssertionError("region fallback lk_patch: no search window "
                             "left the staged region")
    if not res["max_abs_err"] <= POS_TOL_PX:
        raise AssertionError("region fallback lk_patch: converged positions "
                             f"differ by {res['max_abs_err']} px > "
                             f"{POS_TOL_PX}")


def phase_flavours_vs_plain(levels) -> list:
    """Phase 3b: each flavour's kernel against its plain version at the
    KITTI levels of phase 3 (kernel #1's inputs), and its largest position
    difference from kernel #1 there."""
    print("flavours-vs-plain [kitti_bench]:")
    rows = []
    for flavour, (counter, fn, ref, extra) in PAIRS.items():
        diff_1 = 0.0
        for lv in levels:
            (args, kw), h, w, l = lv["args"], lv["h"], lv["w"], lv["level"]
            kern = functools.partial(fn, *args, iters=lv["iters"], **kw,
                                     **extra)
            def plain(it, **c):
                return ref(*args, iters=it, **kw, **extra, **c)
            out_k, flag_k = kern()
            res, _, live = _hold(f"{flavour} {lv['pair']} level {l}", out_k,
                                 flag_k, plain, lv["iters"], lv["frozen0"],
                                 lambda out: out, h, w, mm=flavour == "mm")
            d1 = float(torch.max(torch.abs(out_k - lv["out_1"])[live])) \
                if res["live"] else 0.0
            diff_1 = max(diff_1, d1)
            tight = _mm_tight(lv, plain(lv["iters"])[0]) \
                if flavour == "mm" else None
            ms_k = _time_ms(kern)
            ms_r = _time_ms(lambda: plain(lv["iters"]), reps=PLAIN_REPS)
            work = _work(plain, lv["iters"], lv["padded_hw"], (h, w))
            b_ms, b_by = bound_ms(args[4].shape[0], work, kw["win"],
                                  flavour == "mm")
            chain = _chain(kern, lv)
            print(f"  {flavour:8s} {lv['pair']:8s} level {l} [{h}x{w}] "
                  f"{counter} live {res['live']:3d} capped {res['capped']} "
                  f"agree {res['agree_share']:.3f} max_abs_err "
                  f"{res['max_abs_err']:.3g} px (capped "
                  f"{res['max_abs_err_capped']:.3g} px) vs kernel #1 "
                  f"{d1:.3g} px kernel {ms_k:.4f} ms plain {ms_r:.4f} ms "
                  f"kp_iters {work['kp_iters']} needed_px {work['pixels']} "
                  f"bound {b_ms:.6f} ms ({b_by}) {_chain_text(chain)}")
            if tight:
                print("    mm tight: " + json.dumps(tight))
            rows.append(dict(config="kitti_bench", pair=lv["pair"], level=l,
                             kernel=counter, flavour=flavour, pixels=h * w,
                             max_abs_err=res["max_abs_err"], ms=ms_k,
                             plain_ms=ms_r, bound_ms=b_ms, bound_by=b_by,
                             kp_iters=work["kp_iters"],
                             needed_px=work["pixels"], vs_kernel1_px=d1,
                             **chain))
        print(f"  {flavour}: largest position difference from kernel #1 on "
              f"the same inputs {diff_1:.3g} px (live tracks)")
        if counter in ("lk_level", "lk_level_sw") and diff_1 != 0.0:
            raise AssertionError(f"{flavour}: differs from kernel #1 by "
                                 f"{diff_1} px; it is kernel #1's kernel")
    _check_region_fallback(levels)
    _check_wide(levels)
    return rows


# the region fallback check's offset of the guesses from the true motion
# (px) and its KITTI level; the KITTI level of the widest-window check
REGION_OFFSET_PX = (12.0, 0.0)
REGION_LEVEL = ("stereo", 2)
WIDE_LEVEL = ("temporal", 0)


def _chain(kern, lv) -> dict:
    """A staged kernel's chain at one level, from its `stats`: the most
    iterations of any keypoint and the search windows read outside the
    staged region; at temporal levels its device time, the ratio to kernel
    #1's at the level (kernel #2 has none: lv["device_ms_1"] None), the
    time per iteration as a slope, (device at the
    path's iterations - device at one) / (the difference in longest chain,
    max_iters - 1), and the fixed part (device at one less one slope:
    template windows, staging, write-back, launch)."""
    out = dict(device_ms=None, ratio_to_1=None, us_per_iter=None,
               fixed_ms=None)
    stats = torch.zeros(3, dtype=torch.int32, device=lv["out_1"].device)
    kern(stats=stats)
    out["outside"], _, out["max_iters"] = (int(v) for v in stats.cpu())
    if lv["pair"] == "temporal":
        out["device_ms"] = _device_ms(kern)
        if lv["device_ms_1"] is not None:
            out["ratio_to_1"] = out["device_ms"] / lv["device_ms_1"]
        if out["max_iters"] > 1:        # one iteration: a chain of 1
            ms_1 = _device_ms(functools.partial(kern, iters=1))
            us = 1e3 * (out["device_ms"] - ms_1) / (out["max_iters"] - 1)
            out.update(us_per_iter=us, fixed_ms=ms_1 - 1e-3 * us)
    return out


def _chain_text(c) -> str:
    s = f"max_iters {c['max_iters']} outside_region {c['outside']}"
    if c["device_ms"] is not None:
        s += f" device {c['device_ms']:.4f} ms"
        if c["ratio_to_1"] is not None:
            s += f" ratio_to_1 {c['ratio_to_1']:.3f}"
        if c["us_per_iter"] is not None:
            s += (f" us_per_iter {c['us_per_iter']:.4f} (slope) fixed "
                  f"{c['fixed_ms']:.4f} ms")
    return s


def _find_level(levels, which):
    return next(lv for lv in levels
                if (lv["pair"], lv["level"]) == which)


def _check_region_fallback(levels):
    """Every flavour at REGION_LEVEL with every guess REGION_OFFSET_PX off
    the one phase 3 gave, so that searches walk past the region staged
    around their first window and read L2. Each kernel reports windows read
    outside it (> 0) and is held against its plain version: flags equal,
    at least MM_MIN_AGREE_SHARE of the live tracks within POS_TOL_PX, and
    (not mm) every converged one. Starting 12 px off, a quarter to a half
    of the tracks still step at the cap (one H100), so phase 3's bound on
    that share does not apply here; the agree share holds them instead.
    (Kernel #2: _check_patch_region_fallback, in phase 3.)"""
    lv = _find_level(levels, REGION_LEVEL)
    (args, kw), h, w = lv["args"], lv["h"], lv["w"]
    guess = (args[5] + torch.tensor(REGION_OFFSET_PX,
                                    device=args[5].device)).contiguous()
    frozen0 = (lv["frozen0"].bool() | ~sampling.in_bounds(
        guess, h, w, kw["win"] // 2 + 1)[:, None]).to(torch.int32)
    a = (*args[:5], guess, frozen0)
    for flavour, (counter, fn, ref, extra) in PAIRS.items():
        stats = torch.zeros(3, dtype=torch.int32, device=guess.device)
        out_k, flag_k = fn(*a, iters=lv["iters"], **kw, **extra, stats=stats)
        res, _, _ = _hold(f"region fallback {flavour}", out_k, flag_k,
                          lambda it, **c: ref(*a, iters=it, **kw, **extra,
                                              **c),
                          lv["iters"], frozen0, lambda out: out, h, w,
                          mm=True)
        n_out, kp_iters, max_iters = (int(v) for v in stats.cpu())
        print(f"  region fallback [{flavour}] {lv['pair']} level "
              f"{lv['level']}, guesses {REGION_OFFSET_PX} px off: "
              f"outside_region {n_out} of {kp_iters} search windows, "
              f"max_iters {max_iters}, " + json.dumps(res))
        if n_out <= 0:
            raise AssertionError(f"region fallback {flavour}: no search "
                                 "window left the staged region")
        if flavour != "mm" and not res["max_abs_err"] <= POS_TOL_PX:
            raise AssertionError(f"region fallback {flavour}: converged "
                                 f"positions differ by {res['max_abs_err']}"
                                 f" px > {POS_TOL_PX}")


def _check_wide(levels):
    """Every flavour's kernel at its widest window (_nvcc.MAX_WIN: #1 24,
    #3 23, #4 and #5 16; 18 or 8 pixels a lane, two k-steps of mm's
    products) at WIDE_LEVEL against its plain version, with phase 3's
    checks; mm by its agree share and _mm_tight."""
    lv = _find_level(levels, WIDE_LEVEL)
    (args, kw), h, w = lv["args"], lv["h"], lv["w"]
    for flavour, (counter, fn, ref, extra) in PAIRS.items():
        kw_w = dict(kw, win=_nvcc.MAX_WIN[counter])
        out_k, flag_k = fn(*args, iters=lv["iters"], **kw_w, **extra)
        def plain(it, **c):
            return ref(*args, iters=it, **kw_w, **extra, **c)
        res, _, _ = _hold(f"win {kw_w['win']} {flavour}", out_k, flag_k,
                          plain, lv["iters"], lv["frozen0"], lambda out: out,
                          h, w, mm=flavour == "mm")
        print(f"  win {kw_w['win']} [{flavour}] {lv['pair']} level "
              f"{lv['level']}: " + json.dumps(res))
        if flavour == "mm":
            print("    mm tight: " + json.dumps(_mm_tight(
                dict(lv, args=(args, kw_w)), plain(lv["iters"])[0])))


def window_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| over windows [n, win, win], in float32
    ulps (2^-23) of each window's largest magnitude in `want`."""
    scale = want.abs().amax(dim=(1, 2), keepdim=True).clamp_min(2.0 ** -126)
    return float(((got - want).abs() / (scale * 2.0 ** -23)).max())


def _mm_tight(lv, out_r, check=True) -> dict:
    """mm's tight checks at one level of phase 3b, and their control
    (MM_* above): the windows the tensor-core sampler takes at the level's
    template (prev, gx, gy; read from L2) and search-start (cur; read from
    a staged region) top-lefts, clipped as
    the solve clips them, against the plain blend's; one step against the
    plain version on every live track; and the mm_f32 kernel against mm's
    plain version through all three checks. `out_r`: the plain version's
    answer at lv["iters"]. Raises unless mm passes and the control fails
    each check (`check`)."""
    (args, kw), h, w = lv["args"], lv["h"], lv["w"]
    planes, pts, guess, frozen0 = args[:4], args[4], args[5], args[6]
    win, r = kw["win"], kw["win"] // 2
    hb, wb = kw["padded_hw"]
    lim = torch.tensor([min(wb - win - 2, w - 1), min(hb - win - 2, h - 1)],
                       dtype=torch.float32, device=pts.device)

    def top_left(p):
        return torch.minimum(torch.clamp(p - r, min=0.0), lim).contiguous()

    t_tl, c_tl = top_left(pts), top_left(guess)
    one = dict(kw, iters=1)
    step_r, flag_r = lkv.lk_level_mm_ref(*args, **one, use_bf16=True)
    live = (flag_r[:, 0] > 0) & (frozen0[:, 0] == 0)
    pos = step_r[live].abs()
    step_tol = torch.clamp(torch.nextafter(pos, pos + 1.0) - pos,
                           min=MM_STEP_TOL_PX)
    res = {}
    for tag, use_bf16 in (("mm", True), ("control_mm_f32", False)):
        n_eq = n_all = 0
        d_win = ulps = 0.0
        for k, (plane, tl) in enumerate(zip(planes, (t_tl, t_tl, t_tl,
                                                     c_tl))):
            # the search windows (cur) from a staged region, as the solve
            # reads them; the templates from L2
            got = lkv.mm_windows(plane, tl, win=win, use_bf16=use_bf16,
                                 staged=k == 3)
            want = lkv.mm_windows_ref(plane, tl, win=win, use_bf16=True)
            n_eq += int((got == want).sum())
            n_all += got.numel()
            d_win = max(d_win, float((got - want).abs().max()))
            ulps = max(ulps, window_ulps(got, want))
        step_k, _ = lkv.lk_level_mm(*args, **one, use_bf16=use_bf16)
        out_k, flag_k = lkv.lk_level_mm(*args, **kw, iters=lv["iters"],
                                        use_bf16=use_bf16)
        d = torch.max(torch.abs(out_k - out_r), dim=-1).values
        live30 = live & (flag_k[:, 0] > 0) \
            & sampling.in_bounds(out_r, h, w, 1.0)
        res[tag] = dict(
            window_ulps=ulps, window_equal_share=n_eq / n_all,
            window_max_diff=d_win,
            step_max_px=float(torch.abs(step_k - step_r)[live].max()),
            step_over_tol=float((torch.abs(step_k - step_r)[live]
                                 / step_tol).max()),
            agree_share=float((d[live30] <= POS_TOL_PX).float().mean()))
    torch.cuda.synchronize()
    mm, ctl = res["mm"], res["control_mm_f32"]
    passes = [mm["window_ulps"] <= MM_WINDOW_ULPS,
              mm["step_over_tol"] <= 1.0,
              mm["agree_share"] >= MM_MIN_AGREE_SHARE]
    control_fails = [ctl["window_ulps"] > MM_WINDOW_ULPS,
                     ctl["step_over_tol"] > 1.0,
                     ctl["agree_share"] < MM_MIN_AGREE_SHARE]
    if check and not (all(passes) and all(control_fails)):
        raise AssertionError(f"mm {lv['pair']} level {lv['level']}: tight "
                             f"checks {passes}, control fails "
                             f"{control_fails}: {res}")
    return res


def _implied_launches(before, after):
    """Kernel launches that the statuses before and after each frame
    imply: a stereo match (init attempt, steady keyframe) is 2 tracks x 4
    levels, a tracked frame 2 tracks x 3 levels. Counts for a camera whose
    level 0 stays on kernel #1 and for one whose level 0 takes kernel #2."""
    n_init = sum(b == fe.INITING for b in before)
    tracked = [b in (fe.TRACKING_GOOD, fe.TRACKING_BAD) for b in before]
    n_track = sum(tracked)
    n_kf = sum(t and a == fe.TRACKING_BAD for t, a in zip(tracked, after))
    return dict(n_init_attempts=n_init, n_tracked=n_track,
                n_steady_keyframes=n_kf,
                level0_on_level=dict(lk_level=8 * n_init + 6 * n_track
                                     + 8 * n_kf, lk_patch=0),
                level0_on_patch=dict(lk_level=6 * n_init + 4 * n_track
                                     + 6 * n_kf,
                                     lk_patch=2 * n_init + 2 * n_track
                                     + 2 * n_kf))


def _check_run(tag, sys_, after, est, poses, launches, expected):
    res = dict(n_keyframes=sys_.stats["n_keyframes"], n_ba=sys_.stats["n_ba"],
               n_lost=sum(a == fe.LOST for a in after))
    stats = ate.ape_translation(est[:, :, 3], poses[:, :, 3])
    res["ate_rmse_m"] = stats["rmse"]
    if res["n_lost"]:
        raise AssertionError(f"{tag}: the run went LOST")
    if res["n_keyframes"] < 2 or res["n_ba"] < 1:
        raise AssertionError(f"{tag}: need >= 2 keyframes and >= 1 BA: {res}")
    if launches != expected:
        raise AssertionError(f"{tag}: kernel launches {launches} != "
                             f"{expected} implied by the statuses")
    if not np.all(np.isfinite(est)) or est.shape != (len(poses), 3, 4):
        raise AssertionError(f"{tag}: trajectory not finite / wrong shape")
    if not stats["rmse"] < ATE_MAX_M:
        raise AssertionError(f"{tag}: ATE {stats['rmse']} m >= {ATE_MAX_M} m")
    return res


def _launches():
    return dict(lk_level=lk_cuda.LAUNCHES, lk_patch=lk_patch_cuda.LAUNCHES,
                **lkv.LAUNCHES)


def _zero_launches():
    lk_cuda.LAUNCHES = 0
    lk_patch_cuda.LAUNCHES = 0
    for k in lkv.LAUNCHES:
        lkv.LAUNCHES[k] = 0


def _expect(**counts):
    """Every kernel's launch count: `counts`, and 0 for the others."""
    return dict(dict.fromkeys(_launches(), 0), **counts)


def _render(tag, s, sys_, dev):
    cam = s.cam_left
    scene, speed = SCENES[tag]
    poses = synthetic.straight_trajectory(N_FRAMES, speed=speed, yaw_rate=0.0)
    t0 = time.perf_counter()
    L, R = synthetic_torch.render_stereo_sequence_device(
        synthetic.SyntheticWorld(seed=4, **scene), poses, cam.fx, cam.fy, cam.cx,
        cam.cy, s.baseline, s.image_width, s.image_height, pad_w=sys_.w,
        pad_h=sys_.h, device=dev)
    torch.cuda.synchronize()
    print(f"  rendered {N_FRAMES} {s.image_width}x{s.image_height} stereo "
          f"pairs on the card in {time.perf_counter() - t0:.2f} s")
    return poses, L, R


def _run_steps(sys_, L, R, ts):
    before, after, ms = [], [], []
    for i in range(len(L)):
        before.append(sys_.status)
        t = time.perf_counter()
        sys_.run_step(L[i], R[i], ts[i])         # returns numpy: synchronized
        ms.append(1e3 * (time.perf_counter() - t))
        after.append(sys_.status)
    return before, after, ms


def phase_run_step(s: Settings, dev):
    print("run_step path [kitti_bench]:")
    sys_ = System(s, enable_backend=True, enable_loop_closing=False,
                  device=dev)
    poses, L, R = _render("kitti_bench", s, sys_, dev)
    _zero_launches()
    before, after, ms = _run_steps(sys_, L, R, [i / s.fps for i in range(N_FRAMES)])
    launches = _launches()
    imp = _implied_launches(before, after)
    _, est = sys_.frame_trajectory()
    res = _check_run("run_step", sys_, after, est, poses, launches,
                     _expect(**imp["level0_on_level"]))
    res.update(launches=launches, median_ms_per_frame=float(np.median(ms)),
               median_ms_tracked_good=float(np.median(
                   [m for m, b, a in zip(ms, before, after)
                    if b in (fe.TRACKING_GOOD, fe.TRACKING_BAD)
                    and a == fe.TRACKING_GOOD])),
               total_s=sum(ms) / 1e3, n_init_attempts=imp["n_init_attempts"],
               n_tracked=imp["n_tracked"])
    print("  run_step: " + json.dumps(res))
    return res, dict(poses=poses, L=L, R=R, after=after, est=est)


def phase_chunks(s: Settings, dev) -> dict:
    print(f"chunk path [robotcar_xb3_wide]: {N_FRAMES} frames in chunks of "
          f"{CHUNK}; frame period {1e3 / s.fps:.1f} ms at {s.fps:g} Hz")
    sys_ = System(s, enable_backend=True, enable_loop_closing=False,
                  device=dev)
    poses, L, R = _render("robotcar_xb3_wide", s, sys_, dev)
    # set-up: the frames reach the System from the host, as a camera's do
    L, R = L.cpu().numpy(), R.cpu().numpy()
    ts = [i / s.fps for i in range(N_FRAMES)]
    chunks = [slice(a, a + CHUNK) for a in range(0, N_FRAMES, CHUNK)]

    _zero_launches()
    t0 = time.perf_counter()
    pf = sys_.prefetcher(depth=2)
    for sl in chunks[:2]:
        pf.submit(L[sl], R[sl])
    handles, chunk_ms, prev = [], [], None
    for k, sl in enumerate(chunks):
        t = time.perf_counter()
        h = sys_.dispatch_chunk(*pf.get(), ts[sl])
        if k + 2 < len(chunks):
            pf.submit(L[chunks[k + 2]], R[chunks[k + 2]])
        if prev is not None:
            sys_.collect_chunk(prev)
        chunk_ms.append(1e3 * (time.perf_counter() - t))
        handles.append(h)
        prev = h
    sys_.collect_chunk(prev)
    sys_.finish()
    pf.close()
    total_s = time.perf_counter() - t0
    launches = _launches()

    after = [int(v) for h in handles for v in h.outs.status]
    before = [fe.INITING] + after[:-1]
    imp = _implied_launches(before, after)
    _, est = sys_.frame_trajectory()
    res = _check_run("run_chunk", sys_, after, est, poses, launches,
                     _expect(**imp["level0_on_patch"]))
    res.update(launches=launches, n_init_attempts=imp["n_init_attempts"],
               n_tracked=imp["n_tracked"],
               chunk_ms=chunk_ms, median_ms_per_chunk=float(np.median(chunk_ms)),
               median_ms_per_frame=float(np.median(chunk_ms)) / CHUNK,
               total_s=total_s, ms_per_frame_overall=1e3 * total_s / N_FRAMES)
    print("  run_chunk: " + json.dumps(res))

    # the same host frames through run_step
    ref = System(s, enable_backend=True, enable_loop_closing=False,
                 device=dev)
    _zero_launches()
    before2, after2, ms = _run_steps(ref, L, R, ts)
    imp2 = _implied_launches(before2, after2)
    if _launches() != _expect(**imp2["level0_on_patch"]):
        raise AssertionError(f"run_step at 1280x960: launches {_launches()} "
                             f"!= {imp2['level0_on_patch']}")
    _, est2 = ref.frame_trajectory()
    d = float(np.abs(est[:, :, 3] - est2[:, :, 3]).max())
    print(f"  run_step on the same frames: median {np.median(ms):.2f} "
          f"ms/frame, keyframes {ref.stats['n_keyframes']}, max position "
          f"difference to run_chunk {d:.3g} m")
    if after2 != after or ref.stats["n_keyframes"] != res["n_keyframes"]:
        raise AssertionError("run_chunk and run_step disagree on statuses "
                             "or keyframes")
    if not d <= CHUNK_VS_STEP_M:
        raise AssertionError(f"run_chunk vs run_step: positions differ by "
                             f"{d} m > {CHUNK_VS_STEP_M}")
    res.update(run_step_median_ms_per_frame=float(np.median(ms)),
               chunk_vs_step_max_m=d)
    return res


def phase_flavours(s: Settings, dev, serial: dict, t_start: float) -> dict:
    """Phase 6: phase 4's frames through run_step on each flavour."""
    est_s = len(FLAVOURS) * serial["seconds"]
    n_cut = N_FRAMES
    if time.perf_counter() - t_start + est_s > SCRIPT_BUDGET_S:
        n_cut = FLAVOUR_FRAMES_CUT
        print(f"flavours: the script would pass {SCRIPT_BUDGET_S:.0f} s; "
              f"the flavours other than mm run {n_cut} of {N_FRAMES} frames")
    out = {}
    for flavour, counter in FLAVOURS.items():
        n = N_FRAMES if flavour == "mm" else n_cut
        sk = dataclasses.replace(s, lk_kernel=flavour)
        sys_ = System(sk, enable_backend=True, enable_loop_closing=False,
                      device=dev)
        _zero_launches()
        before, after, ms = _run_steps(sys_, serial["L"][:n], serial["R"][:n],
                                       [i / s.fps for i in range(n)])
        launches = _launches()
        imp = _implied_launches(before, after)
        _, est = sys_.frame_trajectory()
        res = _check_run(f"run_step [{flavour}]", sys_, after, est,
                         serial["poses"][:n], launches,
                         _expect(**{counter: imp["level0_on_level"]
                                    ["lk_level"]}))
        res.update(frames=n, launches=launches,
                   median_ms_per_frame=float(np.median(ms)),
                   status_diff_vs_serial=sum(
                       a != b for a, b in zip(after, serial["after"][:n])),
                   max_position_diff_vs_serial_m=float(np.abs(
                       est[:, :, 3] - serial["est"][:n, :, 3]).max()))
        print(f"  run_step [{flavour}]: " + json.dumps(res))
        out[flavour] = dict(res, est=est, after=after)
    # ymm and pkmm name one function: the runs must be the same
    y, p = out["ymm"], out["pkmm"]
    if y["after"] != p["after"] or not np.array_equal(y["est"], p["est"]):
        raise AssertionError("run_step [pkmm] differs from run_step [ymm]")
    print("  run_step [pkmm] = run_step [ymm]: statuses and trajectory equal")
    return out


def _loop_drive() -> np.ndarray:
    """[N, 3, 4] T_wc on a circle through the origin, heading along the
    tangent (synthetic.loop_trajectory's), a lap and LOOP_OVERLAP_FRAMES
    more, the turn rate eased in over the first frames."""
    n = LOOP_LAP_FRAMES + LOOP_OVERLAP_FRAMES
    step = 2.0 * np.pi / LOOP_LAP_FRAMES * np.minimum(
        1.0, (np.arange(n) + 1.0) / LOOP_EASE_FRAMES)
    ang = np.concatenate([[0.0], np.cumsum(step)[:-1]])
    c, sn = np.cos(ang), np.sin(ang)
    poses = np.zeros((n, 3, 4))
    poses[:, 0, 0], poses[:, 0, 2], poses[:, 1, 1] = c, sn, 1.0
    poses[:, 2, 0], poses[:, 2, 2] = -sn, c
    poses[:, 0, 3] = LOOP_RADIUS_M * sn
    poses[:, 2, 3] = LOOP_RADIUS_M * (1.0 - c)
    return poses


def _match_multiscale(desc_q, val_q, desc_c, val_c, F: int, S: int):
    """The loop closer's multi-scale brute-force Hamming match
    (ssvio_tpu/loopclosing.py::_match_impl, the adaptive gate): the
    [S F, S F] distance matrix reduced over both octave axes to [F, F],
    then best match, mutual check and d <= max(2 min_d, 30). Returns
    (best_j [F], dist [F], ok [F])."""
    d = orb.hamming_distance(desc_q[:, None, :], desc_c[None, :, :])
    big = 1 << 20
    d = torch.where(val_q[:, None] & val_c[None, :], d,
                    torch.full_like(d, big))
    d = d.reshape(S, F, S, F).amin(dim=(0, 2))
    best_j = torch.argmin(d, dim=1)
    best = torch.amin(d, dim=1)
    thresh = torch.clamp(2 * torch.min(best), min=30)
    back = torch.argmin(d, dim=0)
    mutual = back[best_j] == torch.arange(F, device=d.device)
    return best_j, best, (best <= thresh) & (best < big) & mutual


def _ang_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a.double().cpu() - b.double().cpu()
    return torch.abs(torch.atan2(torch.sin(d), torch.cos(d)))


def _twist_err(A: torch.Tensor, B: torch.Tensor):
    """(|rho|, |phi|) of log(A B^-1), on the CPU."""
    xi = se3.log(se3.compose(A.cpu(), se3.inverse(B.cpu())))
    return float(torch.linalg.norm(xi[:3])), float(torch.linalg.norm(xi[3:]))


def _centre_err(T_cw, centres_true: np.ndarray) -> np.ndarray:
    """Per-pose distance of the camera centres of T_cw [K, 3, 4] from
    centres_true [K, 3]."""
    c = se3.translation(se3.inverse(torch.as_tensor(
        np.asarray(T_cw, np.float32)))).numpy()
    return np.linalg.norm(c - centres_true, axis=1)


def _circle_graph(n: int, slots: int, drift: float, seed: int):
    """tests/test_pgo.py's graph: true poses on a circle of radius 10 m,
    exact odometry edges, estimates integrated from drifted odometry, loop
    edges last->first and across the middle; the first pose fixed; `slots`
    pose slots. Returns (PGOProblem of CPU tensors, true centres [n, 3])."""
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(n) / n
    c, sn = np.cos(ang), np.sin(ang)
    T_wc = np.zeros((n, 3, 4), np.float32)
    T_wc[:, 0, 0], T_wc[:, 0, 2], T_wc[:, 1, 1] = c, sn, 1.0
    T_wc[:, 2, 0], T_wc[:, 2, 2] = -sn, c
    T_wc[:, 0, 3], T_wc[:, 2, 3] = 10.0 * sn, 10.0 * (1 - c)
    T_true = se3.inverse_np(T_wc)
    Zs = se3.compose_np(T_true[1:], se3.inverse_np(T_true[:-1]))
    noise = rng.normal(0, drift, (n - 1, 6)).astype(np.float32)
    noise[:, 3:] *= 0.3
    Zn = se3.compose(se3.exp(torch.from_numpy(noise)),
                     torch.from_numpy(Zs)).numpy()
    est = [T_true[0]]
    for k in range(n - 1):
        est.append(se3.compose_np(Zn[k], est[-1]))
    loops = [(n - 1, 0), (n // 2, n // 2 - 1)]
    ei = np.concatenate([np.arange(1, n), [i for i, _ in loops]])
    ej = np.concatenate([np.arange(0, n - 1), [j for _, j in loops]])
    Z = np.concatenate([Zs, np.stack([se3.compose_np(
        T_true[i], se3.inverse_np(T_true[j])) for i, j in loops])])
    poses = np.tile(np.eye(3, 4, dtype=np.float32), (slots, 1, 1))
    poses[:n] = np.stack(est)
    valid = np.arange(slots) < n
    prob = pgo.PGOProblem(
        poses=torch.from_numpy(poses), pose_valid=torch.from_numpy(valid),
        pose_fixed=torch.from_numpy(np.arange(slots) == 0),
        edge_i=torch.from_numpy(ei.astype(np.int32)),
        edge_j=torch.from_numpy(ej.astype(np.int32)),
        edge_Z=torch.from_numpy(Z.astype(np.float32)),
        edge_valid=torch.ones(len(ei), dtype=torch.bool),
        edge_weight=torch.ones(len(ei), dtype=torch.float32))
    return prob, T_wc[:, :, 3]


def phase_place_recognition(s: Settings, dev, card: str) -> dict:
    """Phase 7 (module docstring)."""
    print(f"place recognition [kitti_bench]: a circle of {LOOP_RADIUS_M:g} m "
          f"in {LOOP_LAP_FRAMES} frames and {LOOP_OVERLAP_FRAMES} more")
    cam = s.cam_left
    F, S = s.max_features, s.loop_desc_scales
    sys_ = System(s, enable_backend=True, enable_loop_closing=False,
                  device=dev)
    poses = _loop_drive()
    n = len(poses)
    t0 = time.perf_counter()
    L, R = synthetic_torch.render_stereo_sequence_device(
        synthetic.SyntheticWorld(seed=4, **LOOP_WORLD), poses, cam.fx, cam.fy,
        cam.cx, cam.cy, s.baseline, s.image_width, s.image_height,
        pad_w=sys_.w, pad_h=sys_.h, device=dev)
    torch.cuda.synchronize()
    print(f"  rendered {n} stereo pairs on the card in "
          f"{time.perf_counter() - t0:.2f} s")

    # --- the run that feeds it: keyframes with image, features, landmarks
    _zero_launches()
    before, after, ms, kfs = [], [], [], []
    for i in range(n):
        before.append(sys_.status)
        t = time.perf_counter()
        sys_.run_step(L[i], R[i], i / s.fps)
        ms.append(1e3 * (time.perf_counter() - t))
        after.append(sys_.status)
        if len(sys_.keyframes) > len(kfs):
            feat, m = sys_.feat, sys_.map
            slot = torch.clamp(feat.lm_slot, min=0).long()
            has_lm = feat.valid & (feat.lm_slot >= 0) & m.lm_valid[slot] \
                & (m.lm_gid[slot] == feat.lm_gid)
            kfs.append(dict(rec=sys_.keyframes[-1], frame=i,
                            img=sys_.last_pyr.levels[0].clone(),
                            xy=feat.xy.clone(), valid=feat.valid.clone(),
                            has_lm=has_lm, lm_pos=m.lm_pos[slot].clone()))
    launches = _launches()
    imp = _implied_launches(before, after)
    _, est = sys_.frame_trajectory()
    res = _check_run("place recognition run", sys_, after, est, poses,
                     launches, _expect(**imp["level0_on_level"]))
    res.update(launches=launches, frames=n,
               median_ms_per_frame=float(np.median(ms)))
    print("  run_step: " + json.dumps(res))
    K = len(kfs)
    # the vocabulary's training set: the keyframes of the first half lap
    first = [k for k, kf in enumerate(kfs)
             if kf["frame"] < LOOP_LAP_FRAMES // 2]
    if K < LOOP_MIN_GAP_KF + 4 or len(first) < 4 \
            or kfs[-1]["frame"] < LOOP_LAP_FRAMES:
        raise AssertionError(f"place recognition: {K} keyframes, "
                             f"{len(first)} in the first half lap, the last "
                             f"at frame {kfs[-1]['frame']}")
    times = {}

    def timed(name, fn, reps=5, warmup=1):
        times[name] = _time_ms(fn, reps=reps, warmup=warmup)

    # --- descriptors of every keyframe
    screen = float(s.min_th_fast) if s.loop_screen_fast else 0.0
    pattern = loopclosing.pattern_from_settings(s)

    def describe(kf):
        return loopclosing.loop_describe(kf["img"], kf["xy"], kf["valid"],
                                         S, s.scale_factor,
                                         screen_threshold=screen,
                                         pattern=pattern)

    for kf in kfs:
        kf["desc"], kf["dval"] = describe(kf)
    timed("loop_describe (1 keyframe)", lambda: describe(kfs[-1]))
    n_rows = [int(kf["dval"].sum()) for kf in kfs]
    print(f"  {K} keyframes ({len(first)} in the first half lap), {F} "
          f"features x "
          f"{S} octaves = {F * S} descriptor rows each, valid rows "
          f"{min(n_rows)}-{max(n_rows)}")

    # --- vocabulary (host) and database
    docs = [interop.descriptors_numpy(kfs[k]["desc"][kfs[k]["dval"]])
            for k in first]
    t0 = time.perf_counter()
    vocab_cpu = bow.train(docs, k=s.vocab_k, levels=s.vocab_levels)
    train_s = time.perf_counter() - t0
    vocab = vocab_cpu.to(dev)
    print(f"  bow.train on the host: {sum(len(d) for d in docs)} descriptors "
          f"of {len(docs)} keyframes, k={s.vocab_k} L={s.vocab_levels} -> "
          f"{vocab.n_words} words in {train_s:.2f} s")
    Lv = s.vocab_levels
    db = torch.stack([bow.transform(vocab, kf["desc"], kf["dval"], Lv)
                      for kf in kfs])
    q = K - 1
    kq = kfs[q]
    timed("bow.words_of", lambda: bow.words_of(vocab, kq["desc"], kq["dval"],
                                               Lv))
    timed("bow.transform", lambda: bow.transform(vocab, kq["desc"],
                                                 kq["dval"], Lv))

    # --- retrieval
    cand_ok = torch.arange(K, device=dev) <= q - LOOP_MIN_GAP_KF
    scores = bow.score_l1_database(db[q], db, cand_ok)
    timed("bow.score_l1_database", lambda: bow.score_l1_database(
        db[q], db, cand_ok))
    c = int(torch.argmax(scores))
    kc = kfs[c]
    dist = float(np.linalg.norm(poses[kq["frame"], :, 3]
                                - poses[kc["frame"], :, 3]))
    print(f"  query keyframe {q} (frame {kq['frame']}): best candidate "
          f"{c} (frame {kc['frame']}) score {float(scores[c]):.4f}, true "
          f"distance {dist:.3f} m; scores "
          + json.dumps([round(float(v), 4) for v in scores.cpu()]))
    if kc["frame"] >= LOOP_LAP_FRAMES // 2 or not dist <= LOOP_MAX_DIST_M:
        raise AssertionError(f"place recognition: candidate {c} (frame "
                             f"{kc['frame']}, {dist} m away) is not a "
                             "keyframe of the first pass near the query")

    # --- match and PnP
    best_j, hd, ok = _match_multiscale(kq["desc"], kq["dval"], kc["desc"],
                                       kc["dval"], F, S)
    timed("multi-scale Hamming match", lambda: _match_multiscale(
        kq["desc"], kq["dval"], kc["desc"], kc["dval"], F, S))
    ok = ok & kc["has_lm"][best_j]
    p_w = kc["lm_pos"][best_j].contiguous()
    gen = torch.Generator(device=dev).manual_seed(6)
    idx = pnp.sample_indices(ok, 128, 6, gen)
    K4 = (cam.fx, cam.fy, cam.cx, cam.cy)
    r_pnp = pnp.pnp_ransac(p_w, kq["xy"], ok, *K4, sample_idx=idx)
    timed("pnp.pnp_ransac", lambda: pnp.pnp_ransac(p_w, kq["xy"], ok, *K4,
                                                   sample_idx=idx), reps=3)
    T_true = torch.from_numpy(se3.inverse_np(
        poses[kq["frame"]].astype(np.float32)))
    e_t, e_r = _twist_err(r_pnp.T_cw, T_true)
    print(f"  match: {int(ok.sum())} mutual matches with a landmark (median "
          f"Hamming {float(hd[ok].float().median()):.0f}); pnp_ransac ok "
          f"{bool(r_pnp.ok)}, {int(r_pnp.n_inliers)} inliers, T_cw off the "
          f"ground truth by {e_t:.4f} m, {e_r:.5f} rad")
    if not bool(r_pnp.ok) or not (e_t <= LOOP_PNP_TOL_M
                                  and e_r <= LOOP_PNP_TOL_RAD):
        raise AssertionError("place recognition: pnp_ransac did not recover "
                             f"the pose ({e_t} m, {e_r} rad)")

    # --- pose graphs: the keyframes' with drifted odometry + the loop edge
    gid_ix = {kf["rec"]["gid"]: k for k, kf in enumerate(kfs)}
    T_kf = np.stack([kf["rec"]["T_cw"] for kf in kfs]).astype(np.float32)
    centres = np.stack([poses[kf["frame"], :, 3] for kf in kfs])
    edges = [(gid_ix[g], gid_ix[gp], Z) for gp, g, Z in sys_.kf_rel_edges]
    rng = np.random.default_rng(8)
    noise = rng.normal(0, PGO_DRIFT, (len(edges), 6)).astype(np.float32)
    noise[:, 3:] *= 0.3
    Zn = se3.compose(se3.exp(torch.from_numpy(noise)), torch.from_numpy(
        np.stack([Z for _, _, Z in edges]).astype(np.float32))).numpy()
    drifted = T_kf.copy()
    for (i, j, _), Z in zip(edges, Zn):     # in keyframe order
        drifted[i] = se3.compose_np(Z, drifted[j])
    Z_loop = se3.compose_np(r_pnp.T_cw.cpu().numpy(), se3.inverse_np(T_kf[c]))
    prob_kf = pgo.PGOProblem(
        poses=torch.from_numpy(drifted),
        pose_valid=torch.ones(K, dtype=torch.bool),
        pose_fixed=torch.arange(K) == 0,
        edge_i=torch.tensor([i for i, _, _ in edges] + [q],
                            dtype=torch.int32),
        edge_j=torch.tensor([j for _, j, _ in edges] + [c],
                            dtype=torch.int32),
        edge_Z=torch.from_numpy(np.concatenate([Zn, Z_loop[None]])),
        edge_valid=torch.ones(len(edges) + 1, dtype=torch.bool),
        edge_weight=torch.ones(len(edges) + 1, dtype=torch.float32))
    prob_cg, centres_cg = _circle_graph(PGO_CG_POSES, 640, 0.01, seed=9)
    if not K <= pgo.DENSE_MAX_POSES < prob_cg.poses.shape[0]:
        raise AssertionError("pose graphs: one dense, one CG")
    pgo_out = {}
    for name, prob, cen, iters, tol in (
            ("dense", prob_kf, centres, 20, PGO_DENSE_TOL),
            ("cg", prob_cg, centres_cg, 15, PGO_CG_TOL)):
        nv = len(cen)
        prob_d = pgo.PGOProblem(*[t.to(dev) for t in prob])
        out, times[f"pgo.optimize ({name}, {prob.poses.shape[0]} poses, "
                   f"{iters} LM steps)"] = _timed_once(
            lambda: pgo.optimize(prob_d, iters=iters))
        t0 = time.perf_counter()
        out_cpu = pgo.optimize(prob, iters=iters)
        cpu_s = time.perf_counter() - t0
        e0 = _centre_err(prob.poses[:nv], cen)
        e1 = _centre_err(out.cpu()[:nv], cen)
        d_cpu = float((out.cpu() - out_cpu).abs().max())
        # the end point: the query keyframe; the circle's, its mean error
        # (tests/test_pgo.py's `ate`)
        b, a = (e0[q], e1[q]) if name == "dense" else (e0.mean(), e1.mean())
        pgo_out[name] = dict(poses=int(prob.poses.shape[0]), before_m=float(b),
                             after_m=float(a), mean_before_m=float(e0.mean()),
                             mean_after_m=float(e1.mean()),
                             card_vs_cpu_max=d_cpu, cpu_s=cpu_s)
        print(f"  pgo.optimize [{name}]: " + json.dumps(pgo_out[name]))
        if not bool(torch.isfinite(out).all()) or not a < PGO_MAX_ERR_SHARE * b:
            raise AssertionError(f"pgo [{name}]: error {b} m -> {a} m, not "
                                 f"under {PGO_MAX_ERR_SHARE} of it")
        if not d_cpu <= tol:
            raise AssertionError(f"pgo [{name}]: card and CPU differ by "
                                 f"{d_cpu} > {tol}")

    # --- card against the port's own CPU result on the same inputs
    xy_c, val_c = kq["xy"].cpu(), kq["valid"].cpu()
    dq_c, dvq_c = kq["desc"].cpu(), kq["dval"].cpu()
    dc_c, dvc_c = kc["desc"].cpu(), kc["dval"].cpu()
    exact = {}
    exact["words_of"] = torch.equal(
        bow.words_of(vocab, kq["desc"], kq["dval"], Lv).cpu(),
        bow.words_of(vocab_cpu, dq_c, dvq_c, Lv))
    m_cpu = _match_multiscale(dq_c, dvq_c, dc_c, dvc_c, F, S)
    exact["hamming match"] = all(torch.equal(a.cpu(), b) for a, b in zip(
        _match_multiscale(kq["desc"], kq["dval"], kc["desc"], kc["dval"],
                          F, S), m_cpu))
    exact["hamming_distance"] = torch.equal(
        orb.hamming_distance(kq["desc"][:, None, :],
                             kc["desc"][None, :F, :]).cpu(),
        orb.hamming_distance(dq_c[:, None, :], dc_c[None, :F, :]))
    lvl1 = pyramid.build_orb_pyramid(kq["img"], 2, s.scale_factor)[1]
    xy1 = kq["xy"] / s.scale_factor
    exact["fast_check_sparse"] = torch.equal(
        fast.fast_check_sparse(lvl1, xy1, screen or 7.0).cpu(),
        fast.fast_check_sparse(lvl1.cpu(), xy1.cpu(), screen or 7.0))
    blurred = pyramid.blur(kq["img"], sigma=2.0, radius=3)
    ang = orb.ic_angle_integral(blurred, kq["xy"])
    timed("orb.ic_angle_integral", lambda: orb.ic_angle_integral(blurred,
                                                                kq["xy"]))
    timed("orb.compute_descriptors_pool",
          lambda: orb.compute_descriptors_pool(blurred, kq["xy"], ang))
    timed("fast.fast_check_sparse",
          lambda: fast.fast_check_sparse(lvl1, xy1, 7.0))
    ang_c = ang.cpu()                   # one angle array for both sides
    for name, fn in (("descriptors (pool)", orb.compute_descriptors_pool),
                     ("descriptors (classic)", orb.compute_descriptors)):
        exact[name] = torch.equal(fn(blurred, kq["xy"], ang).cpu(),
                                  fn(blurred.cpu(), xy_c, ang_c))
    inb = sampling.in_bounds(xy_c, *blurred.shape, border=22.0) & val_c
    d_ang = _ang_diff(ang, orb.ic_angle_integral(blurred.cpu(), xy_c))[inb]
    d_ref = _ang_diff(ang, orb.ic_angle(blurred.cpu(), xy_c))[inb]
    d_tr = float((bow.transform(vocab, kq["desc"], kq["dval"], Lv).cpu()
                  - bow.transform(vocab_cpu, dq_c, dvq_c, Lv)).abs().max())
    r_cpu = pnp.pnp_ransac(p_w.cpu(), xy_c, ok.cpu(), *K4,
                           sample_idx=idx.cpu())
    e_pnp = max(_twist_err(r_pnp.T_cw, r_cpu.T_cw))
    close = dict(
        ic_angle_integral_median=float(d_ang.median()),
        ic_angle_integral_share_within=float(
            (d_ang < INTEGRAL_WIDE_TOL).float().mean()),
        ic_angle_integral_max=float(d_ang.max()),
        ic_angle_integral_vs_ic_angle_median=float(d_ref.median()),
        transform_max=d_tr, pnp_pose=e_pnp,
        pnp_inliers_equal=bool(torch.equal(r_pnp.inlier.cpu(), r_cpu.inlier)),
        pnp_ok_equal=bool(r_pnp.ok) == bool(r_cpu.ok),
        pgo_dense_max=pgo_out["dense"]["card_vs_cpu_max"],
        pgo_cg_max=pgo_out["cg"]["card_vs_cpu_max"])
    print("  card == CPU: " + json.dumps(exact))
    print("  card vs CPU: " + json.dumps(close))
    if not all(exact.values()):
        raise AssertionError(f"card and CPU differ: {exact}")
    if not (close["ic_angle_integral_median"] < INTEGRAL_MEDIAN_TOL
            and close["ic_angle_integral_share_within"]
            >= INTEGRAL_WIDE_MIN_SHARE
            and close["ic_angle_integral_vs_ic_angle_median"]
            < INTEGRAL_MEDIAN_TOL
            and d_tr <= TRANSFORM_TOL and e_pnp <= PNP_POSE_TOL
            and close["pnp_inliers_equal"] and close["pnp_ok_equal"]):
        raise AssertionError(f"card and CPU too far apart: {close}")
    print(f"  op times (CUDA events, {card}):")
    for name, t in times.items():
        print(f"    {name}: {t:.4f} ms")
    res.update(n_keyframes_trained_on=len(first), candidate=c,
               candidate_distance_m=dist, pnp_err_m=e_t, pnp_err_rad=e_r,
               train_s=train_s, op_ms=times, pgo=pgo_out)
    return res


def main() -> None:
    t_start = time.perf_counter()
    card = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    kitti, robotcar = bench_settings(), robotcar_xb3_wide_settings()
    with torch.no_grad():
        rows, levels = phase_kernels_vs_plain("kitti_bench", kitti, dev)
        rows += phase_kernels_vs_plain("robotcar_xb3_wide", robotcar, dev)[0]
        rows += phase_flavours_vs_plain(levels)
        t0 = time.perf_counter()
        step, frames = phase_run_step(kitti, dev)
        frames["seconds"] = time.perf_counter() - t0
        chunk = phase_chunks(robotcar, dev)
        place = phase_place_recognition(kitti, dev, card)
        flavours = phase_flavours(kitti, dev, frames, t_start)
    table = []
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        # timed at the largest level it ran, temporal pair
        big = max((r for r in mine if r["pair"] == "temporal"),
                  key=lambda r: r["pixels"])
        table.append(dict(
            name=name, route="cuda", **meta,
            launches=(step["launches"][name] + chunk["launches"][name]
                      + place["launches"][name]
                      + sum(f["launches"][name] for f in flavours.values())),
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=big["ms"], plain_ms=big["plain_ms"], bound_ms=big["bound_ms"],
            bound_by=big["bound_by"], library_ms=None))
    for name in KERNELS:
        big = max((r for r in rows if r["kernel"] == name
                   and r["pair"] == "temporal"), key=lambda r: r["pixels"])
        print(f"device time [{name}] at {big['config']} level "
              f"{big['level']}: {big['device_ms']:.4f} ms a launch "
              f"(torch.profiler), bound {big['bound_ms']:.6f} ms "
              f"({big['bound_by']}): {big['bound_ms'] / big['device_ms']:.4f}"
              " of the bound")
    print(f"script: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
