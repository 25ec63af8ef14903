"""Triangulation (port of `ssvio_tpu/ops/triangulation.py`).

`triangulate_stereo_rectified` is the closed form the keyframe step uses
(algebraically identical to the reference's SVD triangulation for a
rectified pair, include/ssvio/algorithm.hpp:23-45); `triangulate_dlt` is
the reference's multi-view SVD triangulation with its quality gate, which
no step of the engine calls.
"""

from __future__ import annotations

import torch


def triangulate_dlt(proj: torch.Tensor, uv_norm: torch.Tensor,
                    valid: torch.Tensor | None = None,
                    sv_ratio_gate: float = 1e-2):
    """DLT triangulation from V views per landmark (reference
    algorithm.hpp:23-45), through the 4x4 normal matrix A^T A (the same
    right singular vectors as A, at a fixed shape whatever V).

    proj: [..., V, 3, 4] T_cw of normalized cameras; uv_norm: [..., V, 2]
    normalized image coordinates; valid: [..., V] usable views (None: all).
    Returns (p_w [..., 3], ok [...]): ok where the smallest singular value
    is below sv_ratio_gate times the next one, and that one is well above
    zero (a ray configuration with a 2-D nullspace fails)."""
    r0 = uv_norm[..., 0:1] * proj[..., 2, :] - proj[..., 0, :]   # [..., V, 4]
    r1 = uv_norm[..., 1:2] * proj[..., 2, :] - proj[..., 1, :]
    A = torch.cat([r0, r1], dim=-2)                               # [..., 2V, 4]
    if valid is not None:
        A = A * torch.repeat_interleave(valid.to(A.dtype), 2,
                                        dim=-1)[..., None]
    evals, evecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)  # ascending
    x = evecs[..., :, 0]
    w_h = x[..., 3]
    p = x[..., :3] / torch.where(torch.abs(w_h) < 1e-12,
                                 torch.full_like(w_h, 1e-12), w_h)[..., None]
    s_small = torch.sqrt(torch.clamp(evals[..., 0], min=0.0))
    s_next = torch.sqrt(torch.clamp(evals[..., 1], min=0.0))
    s_big = torch.sqrt(torch.clamp(evals[..., 3], min=1e-20))
    ok = (s_next > 1e-4 * s_big) & (
        s_small < sv_ratio_gate * torch.clamp(s_next, min=1e-20))
    return p, ok


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
