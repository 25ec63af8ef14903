"""Synthetic stereo sequence generator with exact ground truth.

The reference's only correctness check is an end-to-end KITTI run evaluated
with evo (reference test/test_system.cpp:16-53). KITTI itself is a large
external download, so for hermetic tests and benchmarks we render a
deterministic textured 3D world (ground plane + side walls, procedural
block-noise texture) through the same pinhole stereo model the engine uses.
Perspective raycasting gives true parallax, so LK tracking, triangulation,
BA and loop closing can all be validated against exact ground-truth poses
and the evo-style ATE gate — the synthetic analog of the reference's KITTI
protocol. (The reference's own synthetic path is the UI demo's
constant-velocity pose generator, reference test/test_ui.cpp:27-70.)

Copy of the numpy parts of `ssvio_tpu/dataio/synthetic.py` (the port cannot
import the JAX package). The device renderer is
`ssvio_tpu_torch.dataio.synthetic_torch`.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


class BlockNoiseTexture:
    """Procedural texture: nearest-neighbor random blocks (sharp corners for
    FAST) + one smooth bilinear octave (gradients for LK)."""

    def __init__(self, seed: int, table: int = 512):
        rng = np.random.default_rng(seed)
        self.blocks = rng.uniform(40.0, 230.0, size=(table, table)).astype(np.float32)
        self.smooth = rng.uniform(-30.0, 30.0, size=(table, table)).astype(np.float32)
        self.table = table

    def sample(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        t = self.table
        # blocky octave at 1m period
        iu = np.floor(u).astype(np.int64) % t
        iv = np.floor(v).astype(np.int64) % t
        val = self.blocks[iu, iv]
        # fine blocky octave at 0.25m period (denser corners)
        iu2 = np.floor(u * 4.0 + 131).astype(np.int64) % t
        iv2 = np.floor(v * 4.0 + 57).astype(np.int64) % t
        val = 0.65 * val + 0.35 * self.blocks[iu2, iv2]
        # coarse octave at 8m period keeps contrast alive at long range
        # (otherwise distant surfaces alias into flat gray and the horizon
        # band of the image carries no trackable texture)
        iu3 = (np.floor(u / 8.0) + 811).astype(np.int64) % t
        iv3 = (np.floor(v / 8.0) + 409).astype(np.int64) % t
        val = 0.6 * val + 0.4 * self.blocks[iu3, iv3]
        # smooth octave (bilinear) at 3m period
        us, vs = u / 3.0, v / 3.0
        i0 = np.floor(us).astype(np.int64)
        j0 = np.floor(vs).astype(np.int64)
        fu = (us - i0).astype(np.float32)
        fv = (vs - j0).astype(np.float32)
        i0 %= t
        j0 %= t
        i1 = (i0 + 1) % t
        j1 = (j0 + 1) % t
        s = (self.smooth[i0, j0] * (1 - fu) * (1 - fv)
             + self.smooth[i1, j0] * fu * (1 - fv)
             + self.smooth[i0, j1] * (1 - fu) * fv
             + self.smooth[i1, j1] * fu * fv)
        return np.clip(val + s, 0.0, 255.0)


class SyntheticWorld:
    """Ground plane at y=+h, two walls at x=+/-w (camera convention: x right,
    y DOWN, z forward, like KITTI).

    `end_z=(z_back, z_front)` closes the corridor into a room with two more
    walls at z=z_back and z=z_front (textures seed+4, seed+5): no ray then
    runs to the vanishing point of an endless corridor. Not in the JAX
    package's world; None (the default) renders it exactly."""

    def __init__(self, seed: int = 0, ground_y: float = 1.6, wall_x: float = 8.0,
                 ceiling_y: float = -6.0,
                 end_z: Tuple[float, float] | None = None):
        self.seed = seed
        self.ground_y = ground_y
        self.wall_x = wall_x
        self.ceiling_y = ceiling_y
        self.end_z = end_z
        self.tex_ground = BlockNoiseTexture(seed)
        self.tex_wall_l = BlockNoiseTexture(seed + 1)
        self.tex_wall_r = BlockNoiseTexture(seed + 2)
        self.tex_ceil = BlockNoiseTexture(seed + 3)
        if end_z is not None:
            self.tex_back = BlockNoiseTexture(seed + 4)
            self.tex_front = BlockNoiseTexture(seed + 5)

    def render(self, T_wc: np.ndarray, fx: float, fy: float, cx: float, cy: float,
               width: int, height: int, supersample: int = 2) -> np.ndarray:
        """Render a grayscale frame [H, W] float32 from camera pose T_wc [3,4].

        `supersample` raycasts an s x s grid per pixel and box-averages:
        point-sampled block textures otherwise alias, which injects ~0.4 px
        of shimmer into LK tracking — enough to corrupt VO accuracy tests.
        """
        if supersample > 1:
            s = supersample
            img = self.render(T_wc, fx * s, fy * s, cx * s + (s - 1) / 2.0,
                              cy * s + (s - 1) / 2.0, width * s, height * s,
                              supersample=1)
            return img.reshape(height, s, width, s).mean(axis=(1, 3)).astype(np.float32)
        R = T_wc[:3, :3].astype(np.float64)
        o = T_wc[:3, 3].astype(np.float64)
        u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                           np.arange(height, dtype=np.float64))
        d_c = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], axis=-1)
        d_w = d_c @ R.T  # [H, W, 3]
        img = np.full((height, width), 128.0, dtype=np.float32)
        best_t = np.full((height, width), np.inf)

        def shade(mask, tvals, tex, axis_u, axis_v):
            hit = mask & (tvals > 0.05) & (tvals < best_t)
            if not np.any(hit):
                return
            p = o[None, :] + tvals[hit, None] * d_w[hit]
            img[hit] = tex.sample(p[:, axis_u], p[:, axis_v])
            best_t[hit] = tvals[hit]

        with np.errstate(divide="ignore", invalid="ignore"):
            tg = (self.ground_y - o[1]) / d_w[..., 1]
            shade(d_w[..., 1] > 1e-9, tg, self.tex_ground, 0, 2)
            tc = (self.ceiling_y - o[1]) / d_w[..., 1]
            shade(d_w[..., 1] < -1e-9, tc, self.tex_ceil, 0, 2)
            tl = (-self.wall_x - o[0]) / d_w[..., 0]
            shade(d_w[..., 0] < -1e-9, tl, self.tex_wall_l, 2, 1)
            tr = (self.wall_x - o[0]) / d_w[..., 0]
            shade(d_w[..., 0] > 1e-9, tr, self.tex_wall_r, 2, 1)
            if self.end_z is not None:
                tb = (self.end_z[0] - o[2]) / d_w[..., 2]
                shade(d_w[..., 2] < -1e-9, tb, self.tex_back, 0, 1)
                tf = (self.end_z[1] - o[2]) / d_w[..., 2]
                shade(d_w[..., 2] > 1e-9, tf, self.tex_front, 0, 1)
        return img


def straight_trajectory(n_frames: int, speed: float = 0.4,
                        yaw_rate: float = 0.0) -> np.ndarray:
    """[N, 3, 4] T_wc poses: forward motion along z with optional yaw."""
    poses = np.zeros((n_frames, 3, 4))
    pos = np.zeros(3)
    yaw = 0.0
    for i in range(n_frames):
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        poses[i, :3, :3] = R
        poses[i, :3, 3] = pos
        pos = pos + R @ np.array([0.0, 0.0, speed])
        yaw += yaw_rate
    return poses


def loop_trajectory(n_frames: int, radius: float = 12.0) -> np.ndarray:
    """Closed circular loop (revisits the start): exercises loop closing."""
    poses = np.zeros((n_frames, 3, 4))
    for i in range(n_frames):
        ang = 2.0 * np.pi * i / n_frames
        # camera on circle, facing tangentially
        pos = np.array([radius * np.sin(ang), 0.0, radius * (1 - np.cos(ang))])
        yaw = ang
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        poses[i, :3, :3] = R
        poses[i, :3, 3] = pos
    return poses


def render_stereo_sequence_numpy(world: SyntheticWorld, poses_wc: np.ndarray,
                                 fx: float, fy: float, cx: float, cy: float,
                                 baseline: float, width: int, height: int
                                 ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Pure-numpy raycast render (the f64 oracle of the device renderers).
    Slow at KITTI resolution: use synthetic_torch on a GPU instead."""
    lefts, rights = [], []
    for T in poses_wc:
        lefts.append(world.render(T, fx, fy, cx, cy, width, height))
        T_r = T.copy()
        T_r[:3, 3] = T[:3, 3] + T[:3, :3] @ np.array([baseline, 0.0, 0.0])
        rights.append(world.render(T_r, fx, fy, cx, cy, width, height))
    return lefts, rights
