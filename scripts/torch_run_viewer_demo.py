#!/usr/bin/env python
"""Viewer-only demo with synthetic motion on the PyTorch port's viewer:
the counterpart of scripts/run_viewer_demo.py (the reference's UI smoke
test, test/test_ui.cpp:20-72).

Drives `ssvio_tpu_torch.viz` alone with a constant-velocity circular
trajectory (no images, no tracking): the trajectory plot, the orientation
plot and the TUM export, without any dataset. Headless by default (writes
a PNG); pass --live for an interactive window. Needs matplotlib.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ssvio_tpu_torch import viz  # noqa: E402
from ssvio_tpu_torch.dataio import tum  # noqa: E402


class _FakeSystem:
    """The System attributes the viewer reads, fed poses directly."""

    def __init__(self):
        self.trajectory = []
        self.keyframes = []
        self.last_stereo = None
        self.map = type("M", (), {})()
        self.map.lm_pos = torch.zeros((1, 3), dtype=torch.float32)
        self.map.lm_valid = torch.zeros((1,), dtype=torch.bool)

    def push(self, t, T_wc):
        self.trajectory.append((t, len(self.trajectory), T_wc))
        self.keyframes.append({"gid": len(self.keyframes),
                               "frame_id": len(self.trajectory) - 1,
                               "timestamp": t, "T_wc": T_wc})

    def keyframe_trajectory(self):
        ts = np.array([k["timestamp"] for k in self.keyframes])
        return ts, np.array([k["T_wc"] for k in self.keyframes])

    def frame_trajectory(self):
        ts = np.array([t for t, _, _ in self.trajectory])
        return ts, np.array([T for _, _, T in self.trajectory])


def circular_pose(t: float, radius: float = 10.0, omega: float = 0.15):
    """Constant-velocity circle in the x-z plane (test_ui.cpp:27-70), the
    camera yawing along the tangent."""
    a = omega * t
    pos = np.array([radius * np.sin(a), 0.0, radius * (1 - np.cos(a))])
    c, s = np.cos(a), np.sin(a)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)
    return np.concatenate([R, pos[:, None]], axis=1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n_frames", type=int, default=200)
    p.add_argument("--out", default="./viewer_demo.png")
    p.add_argument("--save_traj", default="./viewer_demo.tum")
    p.add_argument("--live", action="store_true")
    args = p.parse_args(argv)

    sys_ = _FakeSystem()
    viewer = viz.LiveViewer(update_every=10) if args.live else None
    for i in range(args.n_frames):
        sys_.push(i * 0.1, circular_pose(i * 0.1))
        if viewer is not None:
            viewer.update(sys_)
    viz.snapshot(sys_, args.out, title="viewer demo — synthetic circle")
    ts, poses = sys_.frame_trajectory()
    tum.save_tum(args.save_traj, ts, poses)
    print(f"[viewer_demo] {args.n_frames} poses -> {args.out}, "
          f"{args.save_traj}")
    if viewer is not None:
        viewer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
