"""Drive the PyTorch port's main paths once on one NVIDIA GPU, and check them.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
1. device: a CUDA device is required; prints nvidia-smi's name and power
   limit line.
2. build: compiles both LK level kernels from the checkout's sources
   (ssvio_tpu_torch/csrc/lk_level.cu and lk_patch.cu), one nvcc each, both
   started together.
3. kernels vs plain: for the KITTI bench configuration (1241x376) and the
   RobotCar XB3 wide configuration (1280x960), renders a scene on the card,
   detects 512 keypoints as the keyframe step does, and at every level of
   the 4-level pyramid runs the kernel that level takes (ops/lk.py: kernel
   #1 lk_cuda.lk_level within the 12 MiB plane budget, kernel #2
   lk_patch_cuda.lk_patch above it: level 0 at 1280x960) and its plain torch
   version on the same inputs, for a temporal pair and a stereo pair, coarse
   to fine as lk.track seeds them. Flags must be equal and converged
   positions within POS_TOL_PX; both are timed with CUDA events.
4. the run_step path: System(device="cuda") with the bench configuration
   (512 features, 8192 landmarks, window 16, 8 FAST octaves, LK 11x11 / 3
   levels / 30 iterations, local BA on, loop closing off) runs 96 frames of
   the bench's straight sequence (world seed 4, 0.6 m per frame), rendered
   on the card, through run_step. The run must never go LOST, make >= 2
   keyframes and >= 1 local BA, launch kernel #1 exactly as often as the
   statuses imply (and kernel #2 never), and keep ATE under 0.5 m.
5. the chunk path: the RobotCar configuration runs 96 frames of a straight
   drive down a street (SCENES; rendered on the card, handed over as host
   uint8 as a camera's are) in chunks of 32
   through the prefetcher and pipelined dispatch_chunk / collect_chunk, as
   bench.py drives the JAX package, then finish(). Same checks as phase 4
   with both kernels' launch counts; the same frames through run_step must
   give the same statuses and keyframes and trajectories within 1e-3 m.
6. prints the kernel table as one JSON line, then the result line.
"""

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ssvio_tpu_torch import frontend as fe
from ssvio_tpu_torch.config import (Settings, bench_settings,
                                    robotcar_xb3_wide_settings)
from ssvio_tpu_torch.dataio import synthetic, synthetic_torch
from ssvio_tpu_torch.eval import ate
from ssvio_tpu_torch.ops import _nvcc, lk, lk_cuda, lk_patch_cuda, sampling
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
KERNELS = {
    "lk_level": dict(source="ssvio_tpu_torch/csrc/lk_level.cu",
                     replaces="ssvio_tpu/ops/lk_pallas.py:344"),
    "lk_patch": dict(source="ssvio_tpu_torch/csrc/lk_patch.cu",
                     replaces="ssvio_tpu/ops/lk_pallas.py:375"),
}


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
    sources = (lk_cuda.SRC, lk_patch_cuda.SRC)
    with ThreadPoolExecutor(len(sources)) as ex:
        list(ex.map(_nvcc.build, sources))
    lk_cuda._library()
    lk_patch_cuda._library()
    print(f"build: both kernels in {time.perf_counter() - t0:.2f} s")
    for src in sources:
        info = _nvcc.build_info[src.stem]
        print(f"  {info['path']} (nvcc {info['seconds']:.2f} s)")
        for ln in info["log"].splitlines():
            if "registers" in ln or "spill" in ln:
                print("  ptxas:", ln.strip())


def _time_ms(fn, reps=20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _level_pair(name, pa, pb, l, pts, guess, valid, params):
    """The kernel `name` and its plain version as closures over the same
    inputs at level l. Returns (kernel(), plain(iters), to_global(out):
    the output as level positions, frozen0)."""
    h, w = pa.levels[l].shape
    planes = (pa.levels[l], pa.gx[l], pa.gy[l], pb.levels[l])
    r = params.window // 2
    if name == "lk_patch":
        args, kw, org_C = lk.patch_inputs(h, w, pts, guess, valid, params)
        return (lambda: lk_patch_cuda.lk_patch(*planes, *args, **kw),
                lambda it: lk_patch_cuda.lk_patch_ref(
                    *planes, *args, **dict(kw, iters=it)),
                lambda out: org_C + r + out, args[-1])
    frozen0 = (~valid | ~sampling.in_bounds(guess, h, w, r + 1)) \
        .to(torch.int32)[:, None]
    kw = dict(win=params.window, eps=params.eps, min_eig=params.min_eig,
              padded_hw=lk.padded_dims(h, w))
    args = (*planes, pts, guess, frozen0)
    return (lambda: lk_cuda.lk_level(*args, iters=params.iters, **kw),
            lambda it: lk_cuda.lk_level_ref(*args, iters=it, **kw),
            lambda out: out, frozen0)


def phase_kernels_vs_plain(tag: str, s: Settings, dev) -> list:
    """Every level of a temporal and a stereo track, each on the kernel
    the level takes, against its plain version. Returns one row per level."""
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
    rows = []
    for pair, (a, b) in (("temporal", ("L0", "L1")), ("stereo", ("L0", "R0"))):
        pa, pb = pyr[a], pyr[b]
        flow = torch.zeros_like(feat.xy)
        for l in range(len(pa.levels) - 1, -1, -1):
            h, w = pa.levels[l].shape
            name = "lk_patch" if lk.uses_patch_kernel(h, w) else "lk_level"
            pts = (feat.xy / 2.0 ** l).contiguous()
            guess = (pts + flow).contiguous()
            kern, plain, to_global, frozen0 = _level_pair(
                name, pa, pb, l, pts, guess, feat.valid, params)
            out_k, flag_k = kern()
            out_r, flag_r = plain(params.iters)
            # tracks still stepping at the iteration cap: the plain version
            # one step short lands elsewhere. They have not converged, so
            # float-order noise is not bounded there; they are reported,
            # and the tolerance holds on every track that converged
            capped = torch.any(plain(params.iters - 1)[0] != out_r, dim=-1)
            torch.cuda.synchronize()
            n_flag_diff = int((flag_k != flag_r).sum())
            g_r = to_global(out_r)
            live = (flag_k[:, 0] > 0) & (frozen0[:, 0] == 0) \
                & sampling.in_bounds(g_r, h, w, 1.0)
            d = torch.max(torch.abs(out_k - out_r), dim=-1).values
            err = float(d[live & ~capped].max()) \
                if bool((live & ~capped).any()) else 0.0
            err_capped = float(d[live & capped].max()) \
                if bool((live & capped).any()) else 0.0
            ms_k = _time_ms(kern)
            ms_r = _time_ms(lambda: plain(params.iters))
            moved = torch.linalg.norm(g_r[live] - pts[live], dim=-1)
            n_live, n_capped = int(live.sum()), int((live & capped).sum())
            print(f"  {pair:8s} level {l} [{h}x{w}] {name} live {n_live:3d}"
                  f" capped {n_capped} flag_diff {n_flag_diff}"
                  f" max_abs_err {err:.3g} px (capped {err_capped:.3g} px)"
                  f" median_flow {float(moved.median()) if n_live else 0:.2f}"
                  f" px kernel {ms_k:.4f} ms plain {ms_r:.4f} ms")
            if n_flag_diff:
                raise AssertionError(f"{tag} {pair} level {l}: {n_flag_diff} "
                                     "flags differ")
            if n_capped > MAX_CAPPED_SHARE * n_live:
                raise AssertionError(f"{tag} {pair} level {l}: {n_capped} of "
                                     f"{n_live} live tracks hit the cap")
            if not err <= POS_TOL_PX:
                raise AssertionError(f"{tag} {pair} level {l}: positions "
                                     f"differ by {err} px > {POS_TOL_PX}")
            if not bool(torch.isfinite(out_k).all()):
                raise AssertionError(f"{tag} {pair} level {l}: non-finite")
            rows.append(dict(config=tag, pair=pair, level=l, kernel=name,
                             pixels=h * w, max_abs_err=err, ms=ms_k,
                             plain_ms=ms_r))
            if l > 0:
                flow = (g_r - pts) * 2.0
    return rows


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
    return dict(lk_level=lk_cuda.LAUNCHES, lk_patch=lk_patch_cuda.LAUNCHES)


def _zero_launches():
    lk_cuda.LAUNCHES = 0
    lk_patch_cuda.LAUNCHES = 0


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


def phase_run_step(s: Settings, dev) -> dict:
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
                     imp["level0_on_level"])
    res.update(launches=launches, median_ms_per_frame=float(np.median(ms)),
               median_ms_tracked_good=float(np.median(
                   [m for m, b, a in zip(ms, before, after)
                    if b in (fe.TRACKING_GOOD, fe.TRACKING_BAD)
                    and a == fe.TRACKING_GOOD])),
               total_s=sum(ms) / 1e3, n_init_attempts=imp["n_init_attempts"],
               n_tracked=imp["n_tracked"])
    print("  run_step: " + json.dumps(res))
    return res


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
                     imp["level0_on_patch"])
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
    if _launches() != imp2["level0_on_patch"]:
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


def main() -> None:
    phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    kitti, robotcar = bench_settings(), robotcar_xb3_wide_settings()
    with torch.no_grad():
        rows = (phase_kernels_vs_plain("kitti_bench", kitti, dev)
                + phase_kernels_vs_plain("robotcar_xb3_wide", robotcar, dev))
        step = phase_run_step(kitti, dev)
        chunk = phase_chunks(robotcar, dev)
    table = []
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        # timed at the largest level it ran, temporal pair
        big = max((r for r in mine if r["pair"] == "temporal"),
                  key=lambda r: r["pixels"])
        table.append(dict(
            name=name, route="cuda", **meta,
            launches=step["launches"][name] + chunk["launches"][name],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=big["ms"], plain_ms=big["plain_ms"]))
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
