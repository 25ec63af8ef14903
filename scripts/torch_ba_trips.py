#!/usr/bin/env python
"""The LM steps the port's local BAs take on chip_smoke.py's phase 4
sequence, against the steps their fixed trip runs.

`ops/ba.py::local_ba` runs JAX's two `while_loop`s (rounds until the
inlier ratio passes 0.7, LM steps until the step stalls) as a fixed trip
of 5 rounds x 10 steps, the state frozen after each stop, so that a CUDA
graph holds it (whose replay skips the rounds after the ratio flag). Each result counts the rounds and steps the loops would
have run (`LocalBAResult.rounds` / `.iterations`; the engine logs them in
`Engine.ba_trips`). This tool renders phase 4's sequence (bench_settings():
1241x376, 512 features, 8192 landmarks, window 16; world seed 4, 0.6 m a
frame, no yaw; `--frames`, 96 by default) on the device, runs it through
`System.run_step` with loop closing off, and prints each local BA's rounds
and steps, their sums and the fixed trip's 50 a BA. It runs on the current
CUDA device unless --device names another (--device cpu for the CPU, where
a full-size frame takes seconds); without a CUDA device and without
--device it raises.

Usage: python scripts/torch_ba_trips.py [--frames 96] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ssvio_tpu_torch.config import bench_settings  # noqa: E402
from ssvio_tpu_torch.dataio import synthetic, synthetic_torch  # noqa: E402
from ssvio_tpu_torch.system import System  # noqa: E402
import torch_tools as tools  # noqa: E402

SEED, SPEED = 4, 0.6           # chip_smoke.py's phase 4 sequence


def settings():
    """Phase 4's configuration: the bench's."""
    return bench_settings()


def trips(engine) -> dict:
    """The rounds and LM steps of each local BA the engine logged
    (`Engine.ba_trips`), read once, beside the fixed trip's steps."""
    t = (torch.stack(list(engine.ba_trips)).cpu().numpy()
         if engine.ba_trips else np.zeros((0, 2), np.int64))
    return dict(n_ba=len(t), rounds=t[:, 0].tolist(), steps=t[:, 1].tolist(),
                steps_total=int(t[:, 1].sum()), fixed_trip_steps=50 * len(t))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--frames", type=int, default=96)
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)
    dev = tools.tool_device("torch_ba_trips", args.device)
    card = tools.card_line(dev)
    print(card)
    s = settings()
    sys_ = System(s, enable_backend=True, enable_loop_closing=False,
                  device=dev)
    cam = s.cam_left
    poses = synthetic.straight_trajectory(args.frames, speed=SPEED,
                                          yaw_rate=0.0)
    L, R = synthetic_torch.render_stereo_sequence_device(
        synthetic.SyntheticWorld(seed=SEED), poses, cam.fx, cam.fy, cam.cx,
        cam.cy, s.baseline, s.image_width, s.image_height, pad_w=sys_.w,
        pad_h=sys_.h, device=dev)
    with torch.no_grad():
        for i in range(args.frames):
            sys_.run_step(L[i], R[i], i / s.fps)
    sys_.close()
    res = dict(card=card, device=str(dev), frames=args.frames,
               path=sys_._engine.keyframe_path,
               n_keyframes=sys_.stats["n_keyframes"], **trips(sys_._engine))
    print(f"{res['n_ba']} local BAs: rounds {res['rounds']}, LM steps "
          f"{res['steps']}: {res['steps_total']} of the fixed trip's "
          f"{res['fixed_trip_steps']}")
    print("BA_TRIPS " + json.dumps(res))
    return res


if __name__ == "__main__":
    main()
