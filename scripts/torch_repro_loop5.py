"""The five-lap loop-closing stress scene on the PyTorch port: the
counterpart of scripts/repro_loop5.py. It runs on the current CUDA device,
or on the CPU with `--device cpu`.

A 6 m circle of 120 frames driven `--laps` times and a quarter lap more
(320x128, 192 features, a keyframe nearly every frame) through the
pipelined chunk API with loop closing on, so that many closures fire;
prints the keyframe ATE, the end drift, a per-frame error profile and
every loop event. The bisection flags switch off one part of the loop
closer at a time.

Usage: python scripts/torch_repro_loop5.py [--laps 5] [--chunk 10]
           [--per-frame] [--loop-off] [--no-pgo] [--probe] [--no-screen]
           [--no-anchor-seed] [--no-fuse] [--device cpu]
"""

import argparse
import collections
import dataclasses
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ssvio_tpu_torch.config import Settings  # noqa: E402
from ssvio_tpu_torch.dataio import synthetic, synthetic_torch  # noqa: E402
from ssvio_tpu_torch.eval import ate  # noqa: E402
from ssvio_tpu_torch.ops import se3  # noqa: E402
from ssvio_tpu_torch.system import System  # noqa: E402

LAP_FRAMES = 120


def small_settings() -> Settings:
    s = Settings()
    fx = 320.0
    s.cam_left = dataclasses.replace(s.cam_left, fx=fx, fy=fx, cx=160.0,
                                     cy=64.0)
    s.cam_right = dataclasses.replace(s.cam_right, fx=fx, fy=fx, cx=160.0,
                                      cy=64.0)
    s.image_width, s.image_height = 320, 128
    s.baseline_fx = 0.5 * fx
    s.max_features = 192
    s.max_landmarks = 4096
    s.max_window = 8
    s.min_init_landmarks = 60
    s.tracking_good = 10 ** 6     # keyframe nearly every frame
    s.tracking_bad = 10
    s.loop_db_min_size = 12
    s.loop_min_age = 14
    s.loop_min_gap = 5
    s.max_keyframes_db = 128
    s.loop_desc_scales = 2
    s.vocab_k = 6
    s.vocab_levels = 2
    s.loop_correction_min = 0.3   # test-scene scaling (see Settings)
    return s


def run(sys_, L, R, CH, pipelined=True, timeline=False):
    n = len(L)
    pending = None
    tl = []
    for c in range(0, n, CH):
        h = sys_.dispatch_chunk(L[c:c + CH], R[c:c + CH],
                                [0.1 * (c + j) for j in range(CH)])
        if not pipelined:
            sys_.collect_chunk(h)
        else:
            if pending is not None:
                sys_.collect_chunk(pending)
            pending = h
        if timeline:
            tl.append((c, sys_.track_health, sys_.status,
                       sys_.stats["n_loops"]))
    if pending is not None:
        sys_.collect_chunk(pending)
    sys_.finish()
    if timeline:
        print("timeline (frame, health, status, n_loops):")
        print("  " + " ".join(f"{c}:{h if h is None else int(h)}/{st}/{nl}"
                              for c, h, st, nl in tl))


def evaluate(sys_, poses):
    _, est = sys_.keyframe_trajectory()
    fids = [k["frame_id"] for k in sys_.records.keyframes]
    gt = poses[fids]
    stats = ate.ape_translation(est[:, :, 3], gt[:, :, 3])
    q = max(4, len(fids) // 4)
    _, Rm, t = ate.umeyama_alignment(est[:q, :, 3], gt[:q, :, 3])
    est_al = est[:, :, 3] @ Rm.T + t
    end_drift = float(np.linalg.norm(est_al[-1] - gt[-1][:, 3]))
    return stats["rmse"], end_drift, len(fids)


def _no_fuse(m, feat, best_j, ok, loop_pos, loop_gid_arr, loop_has,
             loop_kf_gid):
    M = m.lm_valid.shape[0]
    zero = torch.zeros((), dtype=torch.int32, device=m.lm_valid.device)
    return (m, torch.arange(M, dtype=torch.int32, device=m.lm_valid.device),
            m.lm_gid, zero, zero)


def _probe(sys_, poses):
    """Wrap the loop closer's _complete_loop to print the ground-truth
    errors of the current and loop keyframe records at each event."""
    lc = sys_.loopclosing
    orig_complete = lc._complete_loop

    def rec_err(gid):
        rec = sys_.records.by_gid.get(gid)
        if rec is None:
            return float("nan")
        T_wc = se3.inverse_np(rec["T_cw"])
        return float(np.linalg.norm(T_wc[:, 3] - poses[rec["frame_id"]][:, 3]))

    def probed(system, kf_gid, row, feat, T_cw, best_row, best_score,
               gauge_idx=0):
        loop_gid = int(lc.db_gid[best_row])
        pre_cur, pre_loop = rec_err(kf_gid), rec_err(loop_gid)
        ev = orig_complete(system, kf_gid, row, feat, T_cw, best_row,
                           best_score, gauge_idx)
        if ev is not None and (ev.corrected or ev.error > 0):
            print(f"  PROBE kf={kf_gid} loop={loop_gid} "
                  f"pre_cur_err={pre_cur:.2f} loop_rec_err={pre_loop:.2f} "
                  f"post_cur_err={rec_err(kf_gid):.2f} "
                  f"corr={ev.error:.2f} acc={ev.corrected}", flush=True)
        return ev

    lc._complete_loop = probed


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--laps", type=int, default=5)
    ap.add_argument("--chunk", type=int, default=10)
    ap.add_argument("--per-frame", action="store_true",
                    help="collect each chunk before dispatching the next")
    ap.add_argument("--loop-off", action="store_true")
    ap.add_argument("--no-pgo", action="store_true",
                    help="bisect: skip pose-graph optimization")
    ap.add_argument("--probe", action="store_true",
                    help="log GT errors of cur/loop KF records at each event")
    ap.add_argument("--no-screen", action="store_true",
                    help="bisect: disable per-octave FAST re-screen")
    ap.add_argument("--no-anchor-seed", action="store_true",
                    help="bisect: start the drift-rate gate un-anchored")
    ap.add_argument("--no-fuse", action="store_true",
                    help="bisect: skip mappoint fusion")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        raise RuntimeError("torch_repro_loop5: no CUDA device; pass "
                           "--device cpu to run on the CPU")
    device = torch.device(args.device or "cuda")

    s = small_settings()
    if args.no_screen:
        s.loop_screen_fast = False
    world = synthetic.SyntheticWorld(seed=11, wall_x=16.0, ceiling_y=-5.0)
    circ = synthetic.loop_trajectory(LAP_FRAMES, radius=6.0)
    poses = np.concatenate([circ] * args.laps + [circ[:LAP_FRAMES // 4]],
                           axis=0)
    n_frames = (len(poses) // args.chunk) * args.chunk
    poses = poses[:n_frames]
    print(f"rendering {n_frames} frames ...", flush=True)
    L, R = synthetic_torch.render_stereo_sequence_device(
        world, poses, s.cam_left.fx, s.cam_left.fy, s.cam_left.cx,
        s.cam_left.cy, s.baseline, s.image_width, s.image_height, u8=False,
        device=device)

    sys_ = System(s, enable_backend=True,
                  enable_loop_closing=not args.loop_off, device=device)
    lc = sys_.loopclosing
    if lc is not None:
        if args.no_pgo:
            lc._pose_graph_optimize = lambda system: None
        if args.no_fuse:
            lc._fuse_impl = _no_fuse
        if args.no_anchor_seed:
            lc._residual_anchor = None
        if args.probe:
            _probe(sys_, poses)
    t0 = time.time()
    with torch.no_grad():
        run(sys_, L, R, args.chunk, pipelined=not args.per_frame,
            timeline=True)
    wall = time.time() - t0
    rmse, end_drift, nkf = evaluate(sys_, poses)
    print(f"ate_rmse={rmse:.3f} m  end_drift={end_drift:.3f} m  "
          f"n_kf={nkf}  wall={wall:.1f}s  fps={n_frames / wall:.1f}")
    wc = collections.Counter(w.split(" at ")[0].split(" gid")[0]
                             for w in sys_.stats.get("warnings", []))
    if wc:
        print("warnings:", dict(wc))
    print(f"relocalizations={sys_.stats.get('n_relocalizations', 0)}")
    # per-frame live-estimate error profile: where does the estimate jump?
    _, fposes = sys_.frame_trajectory()
    ferr = np.linalg.norm(fposes[:, :, 3] - poses[:len(fposes), :, 3], axis=1)
    print("frame_err_profile (every 10th frame): "
          + " ".join(f"{e:.1f}" for e in ferr[::10]))
    if lc is not None:
        evs = lc.events
        print(f"events={len(evs)} "
              f"accepted={sum(e.corrected for e in evs)} "
              f"n_fused={sys_.stats.get('n_fused', 0)}")
        for e in evs:
            print(f"  kf={e.cur_gid:4d} loop={e.loop_gid:4d} "
                  f"score={e.score:.3f} m={e.n_matches:3d} "
                  f"inl={e.n_inliers:3d} err={e.error:7.3f} "
                  f"{'ACCEPT' if e.corrected else 'reject'} "
                  f"fused={e.n_fused}")
    return {"ate_rmse_m": rmse, "end_drift_m": end_drift, "n_keyframes": nkf,
            "n_frames": n_frames, "wall_s": wall,
            "n_loops": sys_.stats["n_loops"]}


if __name__ == "__main__":
    main()
