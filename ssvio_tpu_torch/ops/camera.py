"""Pinhole stereo camera model (port of `ssvio_tpu/ops/camera.py`).

The left camera frame IS the body frame; the right camera sits at a pure
baseline translation `p_right = p_left + [-b, 0, 0]` (reference
src/ssvio/system.cpp:54-113). Everything broadcasts over leading dims.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ssvio_tpu_torch.ops import se3


class Intrinsics(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor

    @property
    def K(self) -> torch.Tensor:
        fx, fy, cx, cy = self.fx, self.fy, self.cx, self.cy
        z = torch.zeros_like(fx)
        o = torch.ones_like(fx)
        return torch.stack([
            torch.stack([fx, z, cx], dim=-1),
            torch.stack([z, fy, cy], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ], dim=-2)


class StereoRig(NamedTuple):
    """Static description of the rectified stereo pair."""
    intr_left: Intrinsics
    intr_right: Intrinsics
    baseline: torch.Tensor    # metres; right cam at [-b,0,0] in left frame

    @classmethod
    def from_settings(cls, s, device=None) -> "StereoRig":
        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        il = Intrinsics(f32(s.cam_left.fx), f32(s.cam_left.fy),
                        f32(s.cam_left.cx), f32(s.cam_left.cy))
        ir = Intrinsics(f32(s.cam_right.fx), f32(s.cam_right.fy),
                        f32(s.cam_right.cx), f32(s.cam_right.cy))
        return cls(il, ir, f32(s.baseline))


def camera2pixel(intr: Intrinsics, p_c: torch.Tensor) -> torch.Tensor:
    """[..., 3] camera coords -> [..., 2] pixels. No z clamp; callers mask."""
    z = p_c[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = intr.fx * p_c[..., 0] / safe_z + intr.cx
    v = intr.fy * p_c[..., 1] / safe_z + intr.cy
    return torch.stack([u, v], dim=-1)


def pixel2camera(intr: Intrinsics, uv: torch.Tensor,
                 depth: torch.Tensor) -> torch.Tensor:
    """[..., 2] pixels + [...] depth -> [..., 3] camera coords."""
    x = (uv[..., 0] - intr.cx) / intr.fx * depth
    y = (uv[..., 1] - intr.cy) / intr.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def world2camera(T_cw: torch.Tensor, p_w: torch.Tensor) -> torch.Tensor:
    return se3.transform(T_cw, p_w)


def camera2world(T_cw: torch.Tensor, p_c: torch.Tensor) -> torch.Tensor:
    return se3.transform(se3.inverse(T_cw), p_c)


def world2pixel(intr: Intrinsics, T_cw: torch.Tensor,
                p_w: torch.Tensor) -> torch.Tensor:
    return camera2pixel(intr, world2camera(T_cw, p_w))


def right_from_left_cam(rig: StereoRig, p_cl: torch.Tensor) -> torch.Tensor:
    """Left-camera coords -> right-camera coords (rectified pair)."""
    b = rig.baseline
    offset = torch.stack([-b, torch.zeros_like(b), torch.zeros_like(b)], dim=-1)
    return p_cl + offset


def stereo_project(rig: StereoRig, T_cw: torch.Tensor, p_w: torch.Tensor):
    """Project world points into both eyes. Returns (uv_l, uv_r, z_left)."""
    p_cl = world2camera(T_cw, p_w)
    uv_l = camera2pixel(rig.intr_left, p_cl)
    uv_r = camera2pixel(rig.intr_right, right_from_left_cam(rig, p_cl))
    return uv_l, uv_r, p_cl[..., 2]


def undistort_points(intr: Intrinsics, dist, uv: torch.Tensor,
                     iters: int = 5) -> torch.Tensor:
    """Iterative plumb-bob undistortion of pixel points (k1,k2,p1,p2)."""
    k1, k2, p1, p2 = dist
    x = (uv[..., 0] - intr.cx) / intr.fx
    y = (uv[..., 1] - intr.cy) / intr.fy
    x0, y0 = x, y
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + k2 * r2)
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (x0 - dx) / radial
        y = (y0 - dy) / radial
    return torch.stack([x * intr.fx + intr.cx, y * intr.fy + intr.cy], dim=-1)


def distort_normalized(dist, x: torch.Tensor, y: torch.Tensor):
    """Forward plumb-bob distortion of normalized coords (k1,k2,p1,p2)."""
    k1, k2, p1, p2 = dist
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + k2 * r2)
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return xd, yd


def undistort_image(intr: Intrinsics, dist, img: torch.Tensor) -> torch.Tensor:
    """Whole-image undistortion (reference Camera::UndistortImage,
    src/ssvio/camera.cpp:43-55): output pixel -> normalized ideal coords ->
    distorted source pixel -> one bilinear gather pass over the image."""
    h, w = img.shape
    dev = img.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    xn = ((xx - intr.cx) / intr.fx).expand(h, w)
    yn = ((yy - intr.cy) / intr.fy).expand(h, w)
    xd, yd = distort_normalized(dist, xn, yn)
    u = torch.clamp(xd * intr.fx + intr.cx, 0.0, w - 1.0)
    v = torch.clamp(yd * intr.fy + intr.cy, 0.0, h - 1.0)
    u0 = torch.floor(u).long()
    v0 = torch.floor(v).long()
    u1 = torch.clamp(u0 + 1, max=w - 1)
    v1 = torch.clamp(v0 + 1, max=h - 1)
    fu = u - u0
    fv = v - v0
    top = img[v0, u0] * (1 - fu) + img[v0, u1] * fu
    bot = img[v1, u0] * (1 - fu) + img[v1, u1] * fu
    return top * (1 - fv) + bot * fv
