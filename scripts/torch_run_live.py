#!/usr/bin/env python
"""Live stereo-camera driver of the PyTorch port: the counterpart of
scripts/run_live.py (the reference's RealSense entry point,
test/test_realsense_d435i.cpp:68-231).

Runs the port on a live stereo stream from any cv2.VideoCapture source:
two device indices, or one side-by-side stereo frame to split. It needs a
camera and OpenCV, and exits cleanly when either is missing (the
reference build skips its target when librealsense is missing,
test/CMakeLists.txt:7-10). Runs on the current CUDA device unless
--device names another.

Usage:
    python scripts/torch_run_live.py --config_yaml_path rig.yaml --left 0 --right 1
    python scripts/torch_run_live.py --config_yaml_path rig.yaml --sbs 0
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config_yaml_path", required=True,
                   help="stereo rig config (intrinsics/baseline/size)")
    p.add_argument("--left", type=int, default=None, help="left cam index")
    p.add_argument("--right", type=int, default=None, help="right cam index")
    p.add_argument("--sbs", type=int, default=None,
                   help="single side-by-side stereo camera index")
    p.add_argument("--save_traj", default="./live_trajectory.tum")
    p.add_argument("--max_frames", type=int, default=0)
    p.add_argument("--viewer", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)

    try:
        import cv2
    except ImportError:
        print("[run_live] OpenCV is not installed: no camera capture — "
              "nothing to do")
        return 0
    from ssvio_tpu_torch.config import Settings
    from ssvio_tpu_torch.system import System

    if args.sbs is not None:
        caps = [cv2.VideoCapture(args.sbs)]
    elif args.left is not None and args.right is not None:
        caps = [cv2.VideoCapture(args.left), cv2.VideoCapture(args.right)]
    else:
        print("[run_live] specify --sbs or --left/--right", file=sys.stderr)
        return 2
    if not all(c.isOpened() for c in caps):
        for c in caps:
            c.release()
        print("[run_live] no stereo camera found — nothing to do "
              "(hardware-gated, like the reference's realsense target)")
        return 0

    system = System(Settings.from_yaml(args.config_yaml_path),
                    device=args.device)
    viewer = None
    if args.viewer:
        from ssvio_tpu_torch.viz import LiveViewer
        viewer = LiveViewer(update_every=5)

    def gray(frame):
        return cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY).astype(np.float32)

    def grab():
        if len(caps) == 1:
            ok, frame = caps[0].read()
            if not ok:
                return None
            g = gray(frame)
            half = g.shape[1] // 2
            return g[:, :half], g[:, half:]
        ok_l, fl = caps[0].read()
        ok_r, fr = caps[1].read()
        if not (ok_l and ok_r):
            return None
        return gray(fl), gray(fr)

    i, t0 = 0, time.time()
    try:
        with torch.no_grad():
            while True:
                pair = grab()
                if pair is None:
                    break
                system.run_step(pair[0], pair[1], time.time() - t0)
                i += 1
                if viewer is not None:
                    viewer.update(system)
                if i % 30 == 0:
                    print(f"[run_live] frame {i}  status={system.status}  "
                          f"{i / (time.time() - t0):.1f} fps")
                if args.max_frames and i >= args.max_frames:
                    break
    except KeyboardInterrupt:
        pass
    finally:
        for c in caps:
            c.release()
    system.save_trajectory_tum(args.save_traj)
    print(f"[run_live] {i} frames; trajectory -> {args.save_traj}")
    if viewer is not None:
        viewer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
