"""SO(3)/SE(3) Lie-group operations on batched tensors.

Port of `ssvio_tpu/ops/se3.py`. Poses are plain `[..., 3, 4]` float tensors
(`[R | t]`), every op broadcasts over leading batch dims, and the series
expansions use Taylor fallbacks selected with `torch.where`, so no op
branches on data. Twist ordering: `xi = [rho(3), phi(3)]`.
"""

from __future__ import annotations

import numpy as np
import torch


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def hat(phi: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def vee(m: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] skew -> [..., 3]."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula with Taylor fallback near 0. [...,3] -> [...,3,3]."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    small = theta < 1e-5
    one = torch.ones_like(theta)
    a = torch.where(small, 1.0 - theta2 / 6.0,
                    torch.sin(theta) / torch.where(small, one, theta))
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one, theta2))
    K = hat(phi)
    return _eye3(phi) + a[..., None, None] * K + b[..., None, None] * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3]. Handles theta near 0 and near pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    w = vee(R - R.transpose(-1, -2)) * 0.5
    small = theta < 1e-5
    sin_t = torch.sin(theta)
    scale = torch.where(small, 1.0 + theta * theta / 6.0,
                        theta / torch.where(small, torch.ones_like(sin_t), sin_t))
    generic = w * scale[..., None]
    # near pi: axis from the diagonal of (R + I) / 2, signs from the
    # off-diagonal sums R[i,j] + R[j,i] = 2 a_i a_j (1 - cos)
    near_pi = theta > 3.0
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, min=0.0))
    sxy = R[..., 0, 1] + R[..., 1, 0]
    sxz = R[..., 0, 2] + R[..., 2, 0]
    syz = R[..., 1, 2] + R[..., 2, 1]
    ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
    x_big = (ax >= ay) & (ax >= az)
    y_big = (~x_big) & (ay >= az)

    def sign(v):
        return torch.where(v >= 0, 1.0, -1.0).to(v.dtype)

    cand_x = torch.stack([ax, sign(sxy) * ay, sign(sxz) * az], dim=-1)
    cand_y = torch.stack([sign(sxy) * ax, ay, sign(syz) * az], dim=-1)
    cand_z = torch.stack([sign(sxz) * ax, sign(syz) * ay, az], dim=-1)
    axis_signed = torch.where(x_big[..., None], cand_x,
                              torch.where(y_big[..., None], cand_y, cand_z))
    near_pi_val = axis_signed * theta[..., None]
    flip = torch.sum(near_pi_val * w, dim=-1, keepdim=True) < 0
    near_pi_val = torch.where(flip, -near_pi_val, near_pi_val)
    return torch.where(near_pi[..., None], near_pi_val, generic)


# ---------------------------------------------------------------------------
# SE(3): pose stored as [..., 3, 4] = [R | t], mapping points by R p + t.
# ---------------------------------------------------------------------------

def identity(batch_shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    T = torch.zeros((3, 4), dtype=dtype, device=device)
    T[:, :3] = torch.eye(3, dtype=dtype, device=device)
    return T.expand(*batch_shape, 3, 4).clone()


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def make(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([R, t[..., None]], dim=-1)


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", M, v)


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B as SE3: (Ra Rb, Ra tb + ta)."""
    Ra, ta = rotation(A), translation(A)
    Rb, tb = rotation(B), translation(B)
    return make(Ra @ Rb, _matvec(Ra, tb) + ta)


def inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = rotation(T).transpose(-1, -2)
    return make(Rt, -_matvec(Rt, translation(T)))


def transform(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply pose to points. T [...,3,4], p [...,3] -> [...,3]."""
    return _matvec(rotation(T), p) + translation(T)


# Host-side (NumPy) variants for bookkeeping on small per-keyframe records.

def compose_np(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """A @ B as SE3 on host numpy arrays ([..., 3, 4])."""
    A = np.asarray(A)
    B = np.asarray(B)
    out = np.empty(np.broadcast_shapes(A.shape, B.shape), A.dtype)
    out[..., :3] = A[..., :3] @ B[..., :3]
    out[..., 3] = np.einsum("...ij,...j->...i", A[..., :3], B[..., 3]) + A[..., 3]
    return out


def inverse_np(T: np.ndarray) -> np.ndarray:
    """SE3 inverse on host numpy arrays ([..., 3, 4])."""
    T = np.asarray(T)
    Rt = np.swapaxes(T[..., :3], -1, -2)
    out = np.empty_like(T)
    out[..., :3] = Rt
    out[..., 3] = -np.einsum("...ij,...j->...i", Rt, T[..., 3])
    return out


def _so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """V matrix in se3 exp: p-part = V rho."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    small = theta < 1e-5
    one = torch.ones_like(theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one, theta2))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta))
                    / torch.where(small, one, theta2 * theta))
    K = hat(phi)
    return _eye3(phi) + b[..., None, None] * K + c[..., None, None] * (K @ K)


def _so3_left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    small = theta < 1e-5
    one = torch.ones_like(theta)
    half = theta * 0.5
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.where(small, one, torch.sin(half)))
        / torch.where(small, one, theta2),
    )
    K = hat(phi)
    return _eye3(phi) - 0.5 * K + cot_term[..., None, None] * (K @ K)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """se3 exp. xi [..., 6] = [rho, phi] -> [..., 3, 4]."""
    rho, phi = xi[..., :3], xi[..., 3:]
    return make(so3_exp(phi), _matvec(_so3_left_jacobian(phi), rho))


def log(T: torch.Tensor) -> torch.Tensor:
    """se3 log. [..., 3, 4] -> [..., 6] = [rho, phi]."""
    phi = so3_log(rotation(T))
    rho = _matvec(_so3_left_jacobian_inv(phi), translation(T))
    return torch.cat([rho, phi], dim=-1)


def adjoint(T: torch.Tensor) -> torch.Tensor:
    """Adjoint matrix [..., 6, 6] for [rho, phi] ordering:
    Ad = [[R, hat(t) R], [0, R]]."""
    R, t = rotation(T), translation(T)
    top = torch.cat([R, hat(t) @ R], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)
