"""The benchmark's frozen copy of the device renderer
(`ssvio_tpu_torch/dataio/synthetic_torch.py` as of the benchmark's first
version): renders `benchmark.world.SyntheticWorld` (same texture tables,
plane geometry and 2x supersampling) in float32 torch ops, so a drive is
made directly in device memory. The optional sensor noise draws from a
`torch.Generator` seeded per frame.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark import world as syn


class WorldArrays(NamedTuple):
    """SyntheticWorld's texture tables + plane geometry as tensors."""
    blocks: torch.Tensor    # [P, T, T] f32 — ground, wall_l, wall_r,
    smooth: torch.Tensor    # ceiling (+ back, front with end_z); [P, T, T]
    ground_y: float
    wall_x: float
    ceiling_y: float
    end_z: tuple | None


def world_arrays(world: syn.SyntheticWorld, device=None) -> WorldArrays:
    texs = [world.tex_ground, world.tex_wall_l, world.tex_wall_r,
            world.tex_ceil]
    if world.end_z is not None:
        texs += [world.tex_back, world.tex_front]
    return WorldArrays(
        blocks=torch.from_numpy(np.stack([t.blocks for t in texs])).to(device),
        smooth=torch.from_numpy(np.stack([t.smooth for t in texs])).to(device),
        ground_y=float(world.ground_y), wall_x=float(world.wall_x),
        ceiling_y=float(world.ceiling_y),
        end_z=None if world.end_z is None else tuple(map(float, world.end_z)))


def _sample_texture(blocks_flat, smooth_flat, base, u, v, t: int):
    """BlockNoiseTexture.sample; each pixel samples only its winning plane's
    tables (`base` = plane id * T * T). Integer texel math is int64 (JAX:
    int32), equal wherever int32 does not overflow."""
    def tap(tab, iu, iv):
        return tab[base + iu * t + iv]

    def ifloor(x):
        return torch.floor(x).to(torch.int64)

    val = tap(blocks_flat, ifloor(u) % t, ifloor(v) % t)
    val = 0.65 * val + 0.35 * tap(blocks_flat, ifloor(u * 4.0 + 131) % t,
                                  ifloor(v * 4.0 + 57) % t)
    val = 0.6 * val + 0.4 * tap(blocks_flat, (ifloor(u / 8.0) + 811) % t,
                                (ifloor(v / 8.0) + 409) % t)
    us, vs = u / 3.0, v / 3.0
    i0f = torch.floor(us)
    j0f = torch.floor(vs)
    fu = us - i0f
    fv = vs - j0f
    i0 = i0f.to(torch.int64) % t
    j0 = j0f.to(torch.int64) % t
    i1 = (i0 + 1) % t
    j1 = (j0 + 1) % t
    s = (tap(smooth_flat, i0, j0) * (1 - fu) * (1 - fv)
         + tap(smooth_flat, i1, j0) * fu * (1 - fv)
         + tap(smooth_flat, i0, j1) * (1 - fu) * fv
         + tap(smooth_flat, i1, j1) * fu * fv)
    return torch.clamp(val + s, 0.0, 255.0)


def render_one(w: WorldArrays, T_wc: torch.Tensor, fx, fy, cx, cy, width: int,
               height: int, supersample: int = 2) -> torch.Tensor:
    """One grayscale frame [H, W] f32 (synthetic.SyntheticWorld.render)."""
    s = supersample
    fx, fy = fx * s, fy * s
    cx, cy = cx * s + (s - 1) / 2.0, cy * s + (s - 1) / 2.0
    W, H = width * s, height * s
    dev = T_wc.device
    R = T_wc[:3, :3]
    o = T_wc[:3, 3]
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    d_c = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], -1)
    d_w = d_c @ R.T                                     # [H, W, 3]
    dx, dy, dz = d_w[..., 0], d_w[..., 1], d_w[..., 2]
    inf = torch.tensor(float("inf"), device=dev)

    def plane_t(num, den, sign):
        # hit distance along the ray; inf where the ray can't hit the plane
        ok = (den * sign) > 1e-9
        t = num / torch.where(ok, den, torch.ones_like(den))
        return torch.where(ok & (t > 0.05), t, inf)

    ts = [
        plane_t(w.ground_y - o[1], dy, 1.0),            # ground  (tex 0)
        plane_t(-w.wall_x - o[0], dx, -1.0),            # wall_l  (tex 1)
        plane_t(w.wall_x - o[0], dx, 1.0),              # wall_r  (tex 2)
        plane_t(w.ceiling_y - o[1], dy, -1.0),          # ceiling (tex 3)
    ]
    if w.end_z is not None:
        ts += [plane_t(w.end_z[0] - o[2], dz, -1.0),    # back    (tex 4)
               plane_t(w.end_z[1] - o[2], dz, 1.0)]     # front   (tex 5)
    tbest, best = torch.min(torch.stack(ts), dim=0)     # first min wins ties
    hit = torch.isfinite(tbest)
    p = o + torch.where(hit, tbest, torch.zeros_like(tbest))[..., None] * d_w
    wall = (best == 1) | (best == 2)
    end = best >= 4
    pu = torch.where(wall, p[..., 2], p[..., 0])
    pv = torch.where(wall | end, p[..., 1], p[..., 2])
    t = w.blocks.shape[-1]
    shade = _sample_texture(w.blocks.reshape(-1), w.smooth.reshape(-1),
                            best * (t * t), pu, pv, t)
    img = torch.where(hit, shade, torch.full_like(shade, 128.0))
    if s > 1:
        img = img.reshape(height, s, width, s).mean(dim=(1, 3))
    return img.to(torch.float32)


def render_stereo_sequence_device(world: syn.SyntheticWorld, poses_wc,
                                  fx, fy, cx, cy, baseline, width, height,
                                  pad_w: int = 0, pad_h: int = 0,
                                  u8: bool = True, noise_std: float = 0.0,
                                  noise_seed: int = 0, device=None):
    """Render a [N, 3, 4] T_wc trajectory into device memory.

    The right camera sits at +baseline along the left camera's x axis.
    `pad_w`/`pad_h` edge-pad to the engine's device dims; u8=True returns
    camera-native uint8. Returns (left [N, h, w], right [N, h, w])."""
    w = world_arrays(world, device)
    poses = torch.as_tensor(np.asarray(poses_wc, np.float32), device=device)
    pw, ph = pad_w or width, pad_h or height
    rows = torch.clamp(torch.arange(ph, device=device), max=height - 1)
    cols = torch.clamp(torch.arange(pw, device=device), max=width - 1)
    ex = torch.tensor([1.0, 0.0, 0.0], device=device)

    def finish(img, gen):
        if noise_std > 0.0:
            img = img + noise_std * torch.randn(img.shape, generator=gen,
                                                device=device)
        img = img[rows][:, cols]
        return torch.clamp(img, 0, 255).to(torch.uint8) if u8 else img

    outs_l, outs_r = [], []
    for i, T in enumerate(poses):
        gen = None
        if noise_std > 0.0:
            gen = torch.Generator(device=device)
            gen.manual_seed(noise_seed * 1_000_003 + i)
        T_r = torch.cat([T[:, :3], (T[:, 3] + T[:, :3] @ ex * baseline)[:, None]],
                        dim=1)
        outs_l.append(finish(render_one(w, T, fx, fy, cx, cy, width, height),
                             gen))
        outs_r.append(finish(render_one(w, T_r, fx, fy, cx, cy, width, height),
                             gen))
    return torch.stack(outs_l), torch.stack(outs_r)
