"""The one generator of drives: a traffic file's parameters and the seed
make the drive's poses and its world; the device renderer makes its
frames at the configuration's rig.

A traffic file (`benchmark/traffic/<name>.json`) holds:
  mode          "offline" (chunks through the chunk API, closed loop) or
                "live" (run_step on the camera's schedule, open loop)
  chunk         frames a chunk (offline)
  prefetch_depth  chunks the prefetcher holds (offline)
  rate_hz       frames a second released (live)
  drive         path: "straight" (frames; speed_m, the mean metres a
                frame; speed_swing and swing_frames, the speed's swing
                about that mean, speed_m * (1 - speed_swing * sin(2 pi i /
                swing_frames)) at frame i, so that the tracker's
                constant-velocity prior is off and LK has to find each
                track; yaw_rate); world: SyntheticWorld's geometry
                (wall_x, ceiling_y, ground_y); world_seed: the textures'
                seed (without it the run's seed draws them); noise_std:
                sensor noise, drawn from the run's seed
  why           one line
The path and geometry are the file's, the same for every seed. A fixed
`world_seed` gives every seed the same scene, so the seed changes the
sensor noise and not the amount of work.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from benchmark import render, world

SEED_MOD = 2 ** 62


class Drive(NamedTuple):
    poses: np.ndarray         # [N, 3, 4] T_wc, the ground truth
    left: np.ndarray          # [N, h, w] uint8 on the host
    right: np.ndarray


def poses_of(drive: Dict) -> np.ndarray:
    """The drive's T_wc poses [N, 3, 4]."""
    if drive["path"] != "straight":
        raise ValueError(f"unknown path {drive['path']!r}")
    n = int(drive["frames"])
    speed = float(drive["speed_m"])
    swing = float(drive.get("speed_swing", 0.0))
    if swing:
        i = np.arange(n, dtype=np.float64)
        speed = speed * (1.0 - swing * np.sin(
            2.0 * np.pi * i / float(drive["swing_frames"])))
    return world.straight_trajectory(n, speed=speed,
                                     yaw_rate=float(drive.get("yaw_rate",
                                                              0.0)))


def world_of(drive: Dict, seed: int) -> world.SyntheticWorld:
    textures = drive.get("world_seed", seed)
    return world.SyntheticWorld(seed=textures % SEED_MOD,
                                **drive.get("world", {}))


def make_drive(drive: Dict, seed: int, settings, pad_w: int, pad_h: int,
               device) -> Drive:
    """Render the drive on `device` at the settings' rig, padded to the
    engine's canvas, and copy it to the host as uint8."""
    poses = poses_of(drive)
    cam = settings.cam_left
    L, R = render.render_stereo_sequence_device(
        world_of(drive, seed), poses, cam.fx, cam.fy, cam.cx, cam.cy,
        settings.baseline, settings.image_width, settings.image_height,
        pad_w=pad_w, pad_h=pad_h, noise_std=float(drive.get("noise_std", 0.0)),
        noise_seed=seed % 2 ** 40, device=device)
    left, right = L.cpu().numpy(), R.cpu().numpy()
    del L, R
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return Drive(poses, left, right)
