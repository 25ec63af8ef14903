"""Drive the PyTorch port's main path once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
1. device: a CUDA device is required; prints nvidia-smi's name and power
   limit line.
2. build: compiles the LK level kernel (ssvio_tpu_torch/csrc/lk_level.cu)
   from the checkout's sources with nvcc.
3. kernel vs plain: renders a KITTI-resolution scene on the card, detects
   512 keypoints as the keyframe step does, and at every level of the
   4-level pyramid runs the CUDA kernel and its plain torch version
   (lk_cuda.lk_level_ref) on the same inputs, for a temporal pair and a
   stereo pair, coarse to fine as lk.track seeds them. Flags must be equal
   and converged positions within POS_TOL_PX; both are timed with CUDA
   events.
4. the slice: System(device="cuda") with the bench configuration (KITTI
   intrinsics at 1241x376, 512 features, 8192 landmarks, window 16, 8 FAST
   octaves, LK 11x11 / 3 levels / 30 iterations, local BA on, loop
   closing off) runs 96 frames of the bench's straight sequence (world
   seed 4, 0.6 m per frame), rendered on the card, through run_step. The
   run must never go LOST, make >= 2 keyframes and >= 1 local BA, launch
   the kernel exactly as often as the statuses imply, and keep the frame
   trajectory's ATE under 0.5 m.
5. prints the kernel table as one JSON line, then the result line.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from ssvio_tpu_torch import frontend as fe
from ssvio_tpu_torch.config import Settings
from ssvio_tpu_torch.dataio import synthetic, synthetic_torch
from ssvio_tpu_torch.eval import ate
from ssvio_tpu_torch.ops import lk, lk_cuda, sampling
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
ATE_MAX_M = 0.5          # the bound of tests/test_system_e2e.py
KERNEL_SOURCE = "ssvio_tpu_torch/csrc/lk_level.cu"
REPLACES = "ssvio_tpu/ops/lk_pallas.py:344"


def bench_settings() -> Settings:
    """bench.py's configuration (bench.py:51-69) with loop closing off."""
    s = Settings()
    s.max_features = 512
    s.max_landmarks = 8192
    s.min_init_landmarks = 150
    s.tracking_good = 120
    s.n_init_features = 512
    s.n_new_features = 512
    s.loop_closing_open = False
    return s


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
    lk_cuda._library()
    print(f"build: {lk_cuda.build_info['path']} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {lk_cuda.build_info['seconds']:.2f} s)")
    for ln in lk_cuda.build_info["log"].splitlines():
        if "registers" in ln or "spill" in ln:
            print("ptxas:", ln.strip())


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


def phase_kernel_vs_plain(s: Settings, dev) -> dict:
    front = System(s, enable_loop_closing=False, device=dev).frontend
    world = synthetic.SyntheticWorld(seed=4)
    cam = s.cam_left
    T0 = synthetic.straight_trajectory(1)[0]
    T1 = T0.copy()                        # ~2-3 px of temporal flow
    T1[:3, 3] += [0.02, 0.0, 0.1]
    c, sn = np.cos(0.003), np.sin(0.003)
    T1[:3, :3] = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]])
    L, R = synthetic_torch.render_stereo_sequence_device(
        world, np.stack([T0, T1]), cam.fx, cam.fy, cam.cx, cam.cy, s.baseline,
        s.image_width, s.image_height, pad_w=front.w, pad_h=front.h,
        u8=False, device=dev)
    pyr = {k: front.build_pyramid(v) for k, v in
           (("L0", L[0]), ("L1", L[1]), ("R0", R[0]))}
    feat, _ = front._detect_merge(pyr["L0"].levels[0],
                                  fe.empty_feat_state(s.max_features, dev))
    print(f"kernel-vs-plain: {int(feat.valid.sum())} of {s.max_features} "
          "keypoints detected (the rest ride along frozen, as on the path)")
    params = front.lk_params_stereo          # 4 levels
    r = params.window // 2
    kw = dict(win=params.window, iters=params.iters, eps=params.eps,
              min_eig=params.min_eig)
    rows, worst = [], 0.0
    for pair, (a, b) in (("temporal", ("L0", "L1")), ("stereo", ("L0", "R0"))):
        pa, pb = pyr[a], pyr[b]
        n_lv = len(pa.levels)
        flow = torch.zeros_like(feat.xy)
        for l in range(n_lv - 1, -1, -1):
            h, w = pa.levels[l].shape
            pts = (feat.xy / 2.0 ** l).contiguous()
            guess = (pts + flow).contiguous()
            frozen0 = (~feat.valid | ~sampling.in_bounds(guess, h, w, r + 1)) \
                .to(torch.int32)[:, None]
            args = (pa.levels[l], pa.gx[l], pa.gy[l], pb.levels[l], pts, guess,
                    frozen0)
            lkw = dict(kw, padded_hw=lk.padded_dims(h, w))
            out_k, flag_k = lk_cuda.lk_level(*args, **lkw)
            out_r, flag_r = lk_cuda.lk_level_ref(*args, **lkw)
            # tracks still stepping at the iteration cap: the plain version
            # one step short lands elsewhere. They have not converged, so
            # float-order noise is not bounded there; they are reported,
            # and the tolerance holds on every track that converged
            capped = torch.any(lk_cuda.lk_level_ref(
                *args, **dict(lkw, iters=params.iters - 1))[0] != out_r, dim=-1)
            torch.cuda.synchronize()
            n_flag_diff = int((flag_k != flag_r).sum())
            live = (flag_k[:, 0] > 0) & (frozen0[:, 0] == 0) \
                & sampling.in_bounds(out_r, h, w, 1.0)
            d = torch.max(torch.abs(out_k - out_r), dim=-1).values
            err = float(d[live & ~capped].max()) \
                if bool((live & ~capped).any()) else 0.0
            err_capped = float(d[live & capped].max()) \
                if bool((live & capped).any()) else 0.0
            ms_k = _time_ms(lambda: lk_cuda.lk_level(*args, **lkw))
            ms_r = _time_ms(lambda: lk_cuda.lk_level_ref(*args, **lkw))
            moved = torch.linalg.norm(out_r[live] - pts[live], dim=-1)
            print(f"  {pair:8s} level {l} [{h}x{w}] live {int(live.sum()):3d}"
                  f" capped {int((live & capped).sum())}"
                  f" flag_diff {n_flag_diff} max_abs_err {err:.3g} px"
                  f" (capped {err_capped:.3g} px)"
                  f" median_flow {float(moved.median()) if len(moved) else 0:.2f}"
                  f" px kernel {ms_k:.4f} ms plain {ms_r:.4f} ms")
            if n_flag_diff:
                raise AssertionError(f"{pair} level {l}: {n_flag_diff} flags differ")
            n_live, n_capped = int(live.sum()), int((live & capped).sum())
            if n_capped > MAX_CAPPED_SHARE * n_live:
                raise AssertionError(f"{pair} level {l}: {n_capped} of {n_live} "
                                     "live tracks hit the iteration cap")
            if not err <= POS_TOL_PX:
                raise AssertionError(f"{pair} level {l}: positions differ by "
                                     f"{err} px > {POS_TOL_PX}")
            if not bool(torch.isfinite(out_k).all()):
                raise AssertionError(f"{pair} level {l}: non-finite output")
            rows.append(dict(pair=pair, level=l, ms=ms_k, plain_ms=ms_r))
            worst = max(worst, err)
            if l > 0:
                flow = (out_r - pts) * 2.0
    lvl0 = next(x for x in rows if x["pair"] == "temporal" and x["level"] == 0)
    return dict(max_abs_err=worst, ms=lvl0["ms"], plain_ms=lvl0["plain_ms"],
                rows=rows)


def phase_slice(s: Settings, dev) -> dict:
    sys_ = System(s, enable_backend=True, enable_loop_closing=False,
                  device=dev)
    cam = s.cam_left
    poses = synthetic.straight_trajectory(N_FRAMES, speed=0.6, yaw_rate=0.0)
    t0 = time.perf_counter()
    L, R = synthetic_torch.render_stereo_sequence_device(
        synthetic.SyntheticWorld(seed=4), poses, cam.fx, cam.fy, cam.cx,
        cam.cy, s.baseline, s.image_width, s.image_height, pad_w=sys_.w,
        pad_h=sys_.h, device=dev)
    torch.cuda.synchronize()
    print(f"slice: rendered {N_FRAMES} KITTI-res stereo pairs on the card in "
          f"{time.perf_counter() - t0:.2f} s")

    before, after, ms = [], [], []
    lk_cuda.LAUNCHES = 0
    for i in range(N_FRAMES):
        before.append(sys_.status)
        t = time.perf_counter()
        sys_.run_step(L[i], R[i], 0.1 * i)       # returns numpy: synchronized
        ms.append(1e3 * (time.perf_counter() - t))
        after.append(sys_.status)
    launches = lk_cuda.LAUNCHES

    n_init = sum(b == fe.INITING for b in before)
    tracked = [b in (fe.TRACKING_GOOD, fe.TRACKING_BAD) for b in before]
    n_track = sum(tracked)
    n_kf_steady = sum(t and a == fe.TRACKING_BAD for t, a in zip(tracked, after))
    expected = 8 * n_init + 6 * n_track + 8 * n_kf_steady
    _, est = sys_.frame_trajectory()
    stats = ate.ape_translation(est[:, :, 3], poses[:, :, 3])
    res = dict(n_init_attempts=n_init, n_tracked=n_track,
               n_keyframes=sys_.stats["n_keyframes"], n_ba=sys_.stats["n_ba"],
               n_lost=sum(a == fe.LOST for a in after), launches=launches,
               expected_launches=expected, ate_rmse_m=stats["rmse"],
               median_ms_per_frame=float(np.median(ms)),
               median_ms_tracked_good=float(np.median(
                   [m for m, t, a in zip(ms, tracked, after)
                    if t and a == fe.TRACKING_GOOD])),
               total_s=sum(ms) / 1e3)
    print("slice: " + json.dumps(res))
    if res["n_lost"]:
        raise AssertionError("the slice went LOST")
    if res["n_keyframes"] < 2 or res["n_ba"] < 1:
        raise AssertionError(f"need >= 2 keyframes and >= 1 BA: {res}")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected} "
                             "implied by the statuses")
    if not np.all(np.isfinite(est)) or est.shape != (N_FRAMES, 3, 4):
        raise AssertionError("trajectory is not finite / of the right shape")
    if not stats["rmse"] < ATE_MAX_M:
        raise AssertionError(f"ATE {stats['rmse']} m >= {ATE_MAX_M} m")
    return res


def main() -> None:
    phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    s = bench_settings()
    with torch.no_grad():
        kvp = phase_kernel_vs_plain(s, dev)
        sl = phase_slice(s, dev)
    print(json.dumps({"kernels": [{
        "name": "lk_level", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": sl["launches"],
        "max_abs_err": kvp["max_abs_err"], "ms": kvp["ms"],
        "plain_ms": kvp["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
