"""Closed-form rectified two-view triangulation (port of
`ssvio_tpu/ops/triangulation.py::triangulate_stereo_rectified`, the form
the keyframe step uses; algebraically identical to the reference's SVD
triangulation for a rectified pair, include/ssvio/algorithm.hpp:23-45)."""

from __future__ import annotations

import torch


def triangulate_stereo_rectified(uv_l: torch.Tensor, uv_r: torch.Tensor,
                                 fx, fy, cx, cy, baseline,
                                 min_disparity: float = 0.1):
    """z = fx * b / disparity in the LEFT camera frame.

    Returns (p_cam [..., 3], ok [...])."""
    disp = uv_l[..., 0] - uv_r[..., 0]
    ok = disp > min_disparity
    safe_disp = torch.where(ok, disp, torch.ones_like(disp))
    z = fx * baseline / safe_disp
    x = (uv_l[..., 0] - cx) / fx * z
    y = (uv_l[..., 1] - cy) / fy * z
    return torch.stack([x, y, z], dim=-1), ok
