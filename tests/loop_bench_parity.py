"""The loop bench of bench.py (the JAX package) and of
scripts/torch_bench.py (the port) on the same frames, on the CPU.

Usage: JAX_PLATFORMS=cpu python tests/loop_bench_parity.py [--laps N]
           [--lap-frames F] [--chunk C] [--narrow] [--threads T]
           [--correction-min M]

Renders the loop bench's scene (bench.py:294-307: a circle of 10 m in F
frames driven N laps and a quarter, trimmed to whole chunks of C, world
seed 11, sensor noise 2.0) once, with the port's renderer on the CPU, and
hands the same uint8 frames to both benches:
  * the port: `torch_bench.loop_accuracy_bench`, its renderer replaced by
    the frames;
  * the JAX package: bench.py's own passes (`bench._run_pass`) in the
    order of `bench._loop_accuracy_bench` (a cold pass that is not
    pipelined, then loop on and loop off on the same System after
    reset(keep_vocab=True), loop off warmed by two chunks), and its metric
    lines (bench.py:334-346). `bench._loop_accuracy_bench` itself fixes
    its scene at 5 laps of 288 frames and renders its own frames.
Prints one JSON line: {"jax": {...}, "port": {...}, "frames", "laps",
"lap_frames", "chunk", "settings"}; each side's loop-on tag lists its loop
verifications (`events`).

--narrow takes tests/test_torch_bench.py's 256x128 cut of the bench's
settings (`narrow_j`); without it the bench's own (1241x376, 8192
landmarks: about a quarter of an hour for JAX and half an hour for the
port a lap on four cores). --correction-min sets both packages'
`loop_correction_min`, the lower end of the window a verification's
|log C| must fall in to correct (scaled down to 0.5% of the keyframes'
extent by default, ~0.13 on this circle).
"""

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import os
import sys
import time
from unittest import mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ssvio_tpu_torch import interop  # noqa: E402
from ssvio_tpu_torch.dataio import synthetic, synthetic_torch  # noqa: E402
import torch_bench  # noqa: E402

BENCH_PY = os.path.join(REPO, "bench.py")


def load_bench():
    """The root bench.py as a module (its top level imports no jax)."""
    spec = importlib.util.spec_from_file_location("bench", BENCH_PY)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def narrow_j(loop: bool = False):
    """bench._make_settings() cut to a 256x128 rig (fx 360, baseline
    0.54 m), 256 features, 1024 landmarks, a window of 6, at which the
    bench's straight scene initialises; small loop-closing tables."""
    s = load_bench()._make_settings()
    fx = 360.0
    cam = dataclasses.replace(s.cam_left, fx=fx, fy=fx, cx=128.0, cy=64.0)
    s.cam_left, s.cam_right = cam, dataclasses.replace(cam)
    s.image_width, s.image_height = 256, 128
    s.baseline_fx = 0.54 * fx
    s.max_features, s.max_landmarks, s.max_window = 256, 1024, 6
    s.n_init_features = s.n_new_features = 256
    s.active_map_size = 4
    s.min_init_landmarks, s.init_good = 40, 40
    s.tracking_good, s.tracking_bad = 50, 10
    s.grid_cell, s.detect_octaves = 24, 2
    s.loop_desc_scales, s.vocab_k, s.vocab_levels = 2, 4, 2
    s.max_keyframes_db, s.loop_db_min_size = 16, 4
    s.loop_closing_open = loop
    return s


def loop_frames(s, laps: int, lap_frames: int, chunk: int):
    """(poses T_wc [n, 3, 4], L, R uint8 [n, H, W]) of the loop scene."""
    circ = synthetic.loop_trajectory(lap_frames,
                                     radius=torch_bench.LOOP_RADIUS_M)
    poses = np.concatenate([circ] * laps + [circ[:lap_frames // 4]], axis=0)
    poses = poses[:len(poses) // chunk * chunk]
    cam = s.cam_left
    L, R = synthetic_torch.render_stereo_sequence_device(
        synthetic.SyntheticWorld(**torch_bench.LOOP_WORLD), poses, cam.fx,
        cam.fy, cam.cx, cam.cy, s.baseline, s.image_width, s.image_height,
        noise_std=torch_bench.LOOP_NOISE, device="cpu")
    return poses, L.numpy(), R.numpy()


def _events(evs) -> list:
    return [dict(cur=int(e.cur_gid), loop=int(e.loop_gid),
                 score=float(e.score), matches=int(e.n_matches),
                 inliers=int(e.n_inliers), error=float(e.error),
                 corrected=bool(e.corrected), fused=int(e.n_fused))
            for e in evs]


def jax_loop_bench(s_j, poses, L, R, chunk: int) -> dict:
    """bench._loop_accuracy_bench's passes and metrics on these frames."""
    from ssvio_tpu.eval import ate as ate_j
    from ssvio_tpu.system import System as SystemJ

    bench = load_bench()
    bench.CHUNK = chunk                 # _run_pass reads it
    n = len(L)
    sys_ = SystemJ(s_j, enable_backend=True, enable_loop_closing=True)
    t0 = time.perf_counter()
    bench._run_pass(sys_, L, R, n, pipelined=False)
    out = {"cold_s": time.perf_counter() - t0}
    for tag, loop_on in (("loop_on", True), ("loop_off", False)):
        sys_.reset(keep_vocab=True)
        if not loop_on:                 # bench.py:320-329
            sys_.loopclosing = None
            sys_._engine = None
            bench._run_pass(sys_, L, R, 2 * chunk)
            sys_.reset(keep_vocab=True)
            sys_.loopclosing = None
        t0 = time.perf_counter()
        bench._run_pass(sys_, L, R, n, pipelined=True)
        wall = time.perf_counter() - t0
        _, est = sys_.keyframe_trajectory()
        gids = [k["frame_id"] for k in sys_.keyframes]
        gt = poses[gids]
        stats = ate_j.ape_translation(est[:, :, 3], gt[:, :, 3])
        q = max(4, len(gids) // 4)
        _, Rm, t = ate_j.umeyama_alignment(est[:q, :, 3], gt[:q, :, 3])
        est_al = est[:, :, 3] @ Rm.T + t
        out[tag] = {"ate_rmse_m": float(stats["rmse"]),
                    "end_drift_m": float(np.linalg.norm(est_al[-1]
                                                        - gt[-1][:, 3])),
                    "n_keyframes": len(gids), "fps": n / wall}
        if loop_on:
            out[tag].update(n_loops=sys_.stats["n_loops"],
                            n_fused=sys_.stats.get("n_fused", 0),
                            events=_events(sys_.loopclosing.events))
    return out


def port_loop_bench(s_t, L, R, laps: int, lap_frames: int,
                    chunk: int) -> dict:
    """torch_bench.loop_accuracy_bench on these frames."""
    made = []

    class Recorded(torch_bench.System):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    with mock.patch.object(torch_bench, "_render", lambda *a, **k: (L, R)), \
            mock.patch.object(torch_bench, "System", Recorded), \
            torch.no_grad():
        out = torch_bench.loop_accuracy_bench(s_t, chunk, laps, lap_frames,
                                              device="cpu")
    if out["frames"] != len(L):
        raise AssertionError(f"the port's bench drove {out['frames']} "
                             f"frames, not the {len(L)} rendered")
    out["loop_on"]["events"] = _events(made[0].loopclosing.events)
    return out


def run(laps: int, lap_frames: int, chunk: int, narrow: bool,
        correction_min=None) -> dict:
    s_j = narrow_j(loop=True) if narrow else load_bench()._make_settings()
    if correction_min is not None:
        s_j.loop_correction_min = correction_min
    poses, L, R = loop_frames(s_j, laps, lap_frames, chunk)
    return {"port": port_loop_bench(interop.settings(s_j), L, R, laps,
                                    lap_frames, chunk),
            "jax": jax_loop_bench(s_j, poses, L, R, chunk),
            "frames": len(L), "laps": laps, "lap_frames": lap_frames,
            "chunk": chunk, "settings": "narrow" if narrow else "bench",
            "loop_correction_min": s_j.loop_correction_min}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--laps", type=int, default=1)
    p.add_argument("--lap-frames", type=int,
                   default=torch_bench.LOOP_LAP_FRAMES)
    p.add_argument("--chunk", type=int, default=32)
    p.add_argument("--narrow", action="store_true")
    p.add_argument("--threads", type=int, default=4,
                   help="torch threads (JAX takes its own)")
    p.add_argument("--correction-min", type=float, default=None)
    args = p.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(args.threads)
    with contextlib.redirect_stdout(sys.stderr):
        out = run(args.laps, args.lap_frames, args.chunk, args.narrow,
                  args.correction_min)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
