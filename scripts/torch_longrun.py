"""The long KITTI-layout run of the PyTorch port: the counterpart of
scripts/longrun.py.

Renders a KITTI-layout synthetic sequence at the KITTI-00 camera (1241x376,
fx 718.856, baseline 0.537 m) with outdoor depth statistics (ground plane
at KITTI camera height, walls 75 m out): `--laps` laps (default 4) of a
60 m-radius circuit, so the run revisits places, with sensor noise 2.0. It
renders on the torch device (`dataio/synthetic_torch.py`) and writes
`<out>/times.txt image_0/%06d.png image_1/%06d.png poses.txt` with
`dataio/kitti.write_sequence`. Then it drives the driver's pipelined chunk
loop (`scripts/torch_run_kitti.py --chunk`: native PNG decode, prefetch
upload, chunked step, loop closing at collect) with loop closing on and
off, and reports the keyframe ATE against the ground truth in a JSON file.
The settings are the JAX script's YAML, built in code (the GPU's host has
no YAML parser); its loop database starts at 256 rows, so a long run
grows it.

Usage:
  python scripts/torch_longrun.py [--out build/longrun_kitti]
      [--frames 4608] [--laps 4] [--chunk 32] [--skip-generate]
      [--json-out build/torch_longrun.json] [--device cpu]
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import torch_run_kitti  # noqa: E402
from ssvio_tpu_torch.config import CameraConfig, Settings  # noqa: E402
from ssvio_tpu_torch.dataio import kitti, synthetic, synthetic_torch, tum  # noqa: E402
from ssvio_tpu_torch.eval import ate  # noqa: E402
from ssvio_tpu_torch.system import System  # noqa: E402

FX, FY = 718.856, 718.856
CX, CY = 607.1928, 185.2157
BASE = 0.537
W_IMG, H_IMG = 1241, 376
NOISE_STD = 2.0
PERIOD_S = 0.1


def longrun_settings() -> Settings:
    """scripts/longrun.py:write_config's YAML as a Settings object."""
    s = Settings()
    cam = CameraConfig(fx=FX, fy=FY, cx=CX, cy=CY)
    s.cam_left, s.cam_right = cam, CameraConfig(fx=FX, fy=FY, cx=CX, cy=CY)
    s.image_width, s.image_height = W_IMG, H_IMG
    s.baseline_fx = BASE * FX
    s.fps = 10.0
    s.active_map_size = 12
    s.init_good = 100
    s.tracking_good = 120
    s.tracking_bad = 10
    s.n_init_features = 512
    s.n_new_features = 512
    s.min_init_landmarks = 150
    s.backend_open = True
    s.loop_closing_open = True
    s.max_features = 512
    s.max_landmarks = 8192
    s.max_keyframes_db = 256
    return s


def longrun_poses(n_frames: int, laps: int) -> np.ndarray:
    """[n_frames, 3, 4] T_wc: `laps` laps of the 60 m-radius circuit."""
    circ = synthetic.loop_trajectory(n_frames // laps, radius=60.0)
    return np.concatenate([circ] * laps, axis=0)[:n_frames]


def longrun_world() -> synthetic.SyntheticWorld:
    # ground at KITTI camera height (1.65 m), walls 75 m out (structure
    # 15-135 m away: most parallax comes from the road, as on KITTI), an
    # open sky far above
    return synthetic.SyntheticWorld(seed=23, ground_y=1.65, wall_x=75.0,
                                    ceiling_y=-30.0)


def gen_dataset(out: str, n_frames: int, laps: int, chunk: int,
                device) -> None:
    """Render the sequence chunk by chunk on `device` and write it."""
    poses = longrun_poses(n_frames, laps)
    world = longrun_world()
    t0 = time.time()
    for c in range(0, n_frames, chunk):
        L, R = synthetic_torch.render_stereo_sequence_device(
            world, poses[c:c + chunk], FX, FY, CX, CY, BASE, W_IMG, H_IMG,
            noise_std=NOISE_STD, noise_seed=c, device=device)
        kitti.write_sequence(out, L.cpu().numpy(), R.cpu().numpy(), None,
                             first=c)
        if c % (chunk * 16) == 0:
            print(f"[longrun] rendered {c}/{n_frames} "
                  f"({c / max(time.time() - t0, 1e-9):.1f} fps)", flush=True)
    kitti.write_sequence(out, [], [], [PERIOD_S * i for i in range(n_frames)],
                         poses)
    print(f"[longrun] dataset at {out}: {n_frames} stereo pairs "
          f"({time.time() - t0:.0f}s)")


def run_pass(out: str, settings: Settings, chunk: int, loop_on: bool,
             tag: str, device):
    """One driver pass; returns (TUM path, the driver's result, System)."""
    traj = os.path.join(out, f"traj_{tag}.tum")
    argv = ["--kitti_dataset_path", out,
            "--gt_poses", os.path.join(out, "poses.txt"),
            "--chunk", str(chunk), "--save_traj", traj]
    if not loop_on:
        argv.append("--no_loop")
    system = System(settings, enable_loop_closing=loop_on, device=device)
    with torch.no_grad():
        res = torch_run_kitti.run(system, torch_run_kitti.parse_args(argv))
    return traj, res, system


def evaluate(out: str, traj: str) -> dict:
    """Keyframe ATE, and the end drift with the gauge fixed on the first
    quarter of the keyframes."""
    gt = kitti.load_kitti_gt_poses(os.path.join(out, "poses.txt"))
    ts, est = tum.load_tum(traj)
    idx = np.clip(np.round(np.asarray(ts) / PERIOD_S).astype(int), 0,
                  len(gt) - 1)
    gt_sel = gt[idx]
    stats = ate.ape_translation(est[:, :, 3], gt_sel[:, :, 3])
    q = max(4, len(idx) // 4)
    _, Rm, t = ate.umeyama_alignment(est[:q, :, 3], gt_sel[:q, :, 3])
    est_al = est[:, :, 3] @ Rm.T + t
    end_drift = float(np.linalg.norm(est_al[-1] - gt_sel[-1][:, 3]))
    return {"ate_rmse_m": stats["rmse"], "ate_max_m": stats["max"],
            "end_drift_m": end_drift, "n_keyframes": int(len(ts))}


def card(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    device's name off a GPU."""
    if device.type != "cuda":
        return str(device)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[device.index or 0]


def main(argv=None) -> dict:
    """Run the long run; returns the report."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "longrun_kitti"))
    ap.add_argument("--frames", type=int, default=4608)
    ap.add_argument("--laps", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--skip-generate", action="store_true")
    ap.add_argument("--json-out", default=os.path.join(REPO, "build",
                                                       "torch_longrun.json"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        raise RuntimeError("torch_longrun: no CUDA device; pass --device cpu "
                           "to run on the CPU")
    device = torch.device(args.device or "cuda")
    settings = longrun_settings()

    if not args.skip_generate:
        gen_dataset(args.out, args.frames, args.laps, args.chunk, device)
    report = {"frames": args.frames, "laps": args.laps,
              "device": card(device),
              "dataset": {"resolution": f"{W_IMG}x{H_IMG}",
                          "intrinsics": "KITTI-00", "baseline_m": BASE,
                          "trajectory": f"{args.laps} laps x 60 m radius "
                                        f"(~{377 * args.laps} m path)",
                          "noise_std_gray": NOISE_STD},
              "db_initial_cap": settings.max_keyframes_db}
    for tag, loop_on in (("loop_on", True), ("loop_off", False)):
        traj, res, system = run_pass(args.out, settings, args.chunk, loop_on,
                                     tag, device)
        # the keyframe ATE needs 3 keyframes (a run may stay INITING)
        kfs = system.records.keyframes
        r = (evaluate(args.out, traj) if len(kfs) >= 3
             else {"n_keyframes": len(kfs)})
        r.update(init_frame=kfs[0]["frame_id"] if kfs else None,
                 frames=res["frames"], wall_s=res["wall_s"],
                 fps=res["frames"] / res["wall_s"],
                 ms_per_frame=1e3 * res["wall_s"] / res["frames"],
                 n_loops=system.stats["n_loops"])
        grew = [w for w in system.stats["warnings"] if "database grown" in w]
        if grew:
            r["db_growth"] = grew
        report[tag] = r
        print(f"[longrun] {tag}: {r}")

    os.makedirs(os.path.dirname(os.path.abspath(args.json_out)),
                exist_ok=True)
    with open(args.json_out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"[longrun] wrote {args.json_out}")
    return report


if __name__ == "__main__":
    main()
