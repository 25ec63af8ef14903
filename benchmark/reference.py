"""The plain reference of the check that decides `correct`: the optimum of
the two least-squares problems that a stereo VO step must solve, worked
out in float64 with plain torch operations from the inputs of each
problem, and the cost of any answer to them.

- The pose-only problem of a tracked frame: the camera pose that
  minimises the robust (Huber, 5.991 px^2) reprojection cost of the
  frame's inlier tracks against the landmarks they are linked to. The
  reference solves it from the frame's previous pose, where the tracker
  starts.
- The window problem after a steady keyframe (local BA): the poses of the
  window's keyframes and the positions of its landmarks that minimise the
  robust (Huber, 5.891 px^2) reprojection cost of every live observation
  in both eyes, with the oldest keyframe held as the gauge and every
  landmark first seen by a keyframe that has left the window held fixed.
  The reference solves it by Levenberg-Marquardt on the Schur complement
  from a seeded perturbation of the state it judges.

An answer is judged by its cost gap: (cost of the answer - cost of the
reference's optimum) / cost of the optimum, all costs in float64. The
same solvers run in a lower precision (`precision="tf32"`) are the
control that the check must fail.

Imports torch only: no module of the program under test and no JAX.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

CHI2_TRACK = 5.991       # 2-dof chi-square at 95%: the tracking inlier gate
CHI2_BA = 5.891          # the window problem's Huber threshold
Z_MIN = 0.05             # a point must lie this far in front of the camera
F64 = torch.float64


_TF32 = [False]          # matrix products in TF32 (the control) when set


@contextlib.contextmanager
def precision(name: str):
    """Run the solvers in float64 ("f64"), or in float32 with every matrix
    product in TF32 ("tf32", the control): each product's inputs rounded
    to TF32's 10-bit mantissa and summed in float32, as the tensor cores
    do (cuBLAS leaves products this small on its float32 kernels, so the
    rounding is made explicit). Restores the flags it sets."""
    if name not in ("f64", "tf32"):
        raise ValueError(f"unknown precision {name!r}")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32, _TF32[0])
    tf32 = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    _TF32[0] = tf32
    try:
        yield torch.float32 if tf32 else F64
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, _TF32[0]) = old


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (10 mantissa bits)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b, in TF32 inside precision("tf32")."""
    if _TF32[0] and a.dtype == torch.float32:
        return to_tf32(a) @ to_tf32(b)
    return a @ b


def huber(chi2: torch.Tensor, delta2: float) -> torch.Tensor:
    """The Huber cost of a squared error."""
    return torch.where(chi2 <= delta2, chi2,
                       2.0 * torch.sqrt(delta2 * chi2.clamp_min(1e-30))
                       - delta2)


def huber_weight(chi2: torch.Tensor, delta2: float) -> torch.Tensor:
    """d huber / d chi2: the weight of an error in the normal equations."""
    return torch.where(chi2 <= delta2, torch.ones_like(chi2),
                       torch.sqrt(delta2 / chi2.clamp_min(1e-30)))


def hat(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> the cross-product matrices [..., 3, 3]."""
    z = torch.zeros_like(v[..., 0])
    x, y, w = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([torch.stack([z, -w, y], -1),
                        torch.stack([w, z, -x], -1),
                        torch.stack([-y, x, z], -1)], -2)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, [..., 3] -> [..., 3, 3]."""
    theta2 = (phi * phi).sum(-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2)
    small = theta2 < 1e-16
    safe = torch.where(small, torch.ones_like(theta), theta)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe) / safe)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(safe)) / (safe * safe))
    K = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + a * K + b * mm(K, K)


def retract(R, t, dx):
    """The pose after the step dx = (rho, phi), applied on the left:
    R' = exp(phi) R, t' = exp(phi) t + rho (a camera-frame point p_c
    moves to exp(phi) p_c + rho)."""
    E = so3_exp(dx[..., 3:])
    return mm(E, R), mm(E, t[..., None])[..., 0] + dx[..., :3]


class Camera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float          # m: the right eye sits at +baseline along x


def _project(pc, shift, cam: Camera):
    """Pixel of camera-frame points pc [..., 3] in the eye `shift` metres
    along x; with the depth mask z > Z_MIN and the safe depth."""
    z = pc[..., 2]
    ok = z > Z_MIN
    zs = torch.where(ok, z, torch.ones_like(z))
    u = cam.fx * (pc[..., 0] - shift) / zs + cam.cx
    v = cam.fy * pc[..., 1] / zs + cam.cy
    return torch.stack([u, v], -1), ok, zs


def _proj_jac(pc, shift, zs, cam: Camera):
    """d (u, v) / d pc: [..., 2, 3]."""
    iz = 1.0 / zs
    x = pc[..., 0] - shift
    y = pc[..., 1]
    zero = torch.zeros_like(iz)
    return torch.stack([
        torch.stack([cam.fx * iz, zero, -cam.fx * x * iz * iz], -1),
        torch.stack([zero, cam.fy * iz, -cam.fy * y * iz * iz], -1)], -2)


# ---------------------------------------------------------------------------
# the pose-only problem of tracked frames, batched over frames
# ---------------------------------------------------------------------------

class TrackProblem(NamedTuple):
    """B frames' tracks: p [B, N, 3] world points, uv [B, N, 2] tracked
    pixels in the left eye, mask [B, N] the inlier tracks."""
    p: torch.Tensor
    uv: torch.Tensor
    mask: torch.Tensor


def track_cost(prob: TrackProblem, R, t, cam: Camera):
    """(cost [B], chi2 [B, N], z_ok [B, N]) of poses R [B, 3, 3], t [B, 3]."""
    pc = mm(R[:, None], prob.p[..., None])[..., 0] + t[:, None]
    uv, ok, _ = _project(pc, 0.0, cam)
    e = uv - prob.uv
    chi2 = (e * e).sum(-1)
    ok = ok & prob.mask
    return (huber(chi2, CHI2_TRACK) * ok).sum(-1), chi2, ok


def solve_track(prob: TrackProblem, R0, t0, cam: Camera, iters: int = 40):
    """Levenberg-Marquardt on each frame's pose from (R0, t0), in the
    dtype of the inputs. Returns (R, t)."""
    R, t = R0, t0
    B = R.shape[0]
    lam = torch.full((B,), 1e-4, dtype=R.dtype, device=R.device)
    eye = torch.eye(6, dtype=R.dtype, device=R.device)
    F, _, _ = track_cost(prob, R, t, cam)
    for _ in range(iters):
        pc = mm(R[:, None], prob.p[..., None])[..., 0] + t[:, None]
        uv, ok, zs = _project(pc, 0.0, cam)
        e = uv - prob.uv
        chi2 = (e * e).sum(-1)
        w = huber_weight(chi2, CHI2_TRACK) * (ok & prob.mask)
        Jc = _proj_jac(pc, 0.0, zs, cam)                      # [B, N, 2, 3]
        J = torch.cat([Jc, -mm(Jc, hat(pc))], -1)             # [B, N, 2, 6]
        Jw = (J * w[..., None, None]).reshape(B, -1, 6)
        H = mm(Jw.transpose(1, 2), J.reshape(B, -1, 6))
        g = mm(Jw.transpose(1, 2), e.reshape(B, -1, 1))[..., 0]
        Hd = H + lam[:, None, None] * torch.diag_embed(
            torch.diagonal(H, dim1=-2, dim2=-1)) + 1e-12 * eye
        dx, info = torch.linalg.solve_ex(Hd, -g[..., None])
        dx = torch.where((info == 0)[:, None], dx[..., 0], 0.0)
        R_n, t_n = retract(R, t, dx)
        F_n, _, _ = track_cost(prob, R_n, t_n, cam)
        acc = torch.isfinite(F_n) & (F_n < F) & (info == 0)
        R = torch.where(acc[:, None, None], R_n, R)
        t = torch.where(acc[:, None], t_n, t)
        F = torch.where(acc, F_n, F)
        lam = torch.where(acc, lam / 3.0, lam * 4.0)
    return R, t


# ---------------------------------------------------------------------------
# the window problem of a steady keyframe (local BA), as a list of edges
# ---------------------------------------------------------------------------

class WindowProblem(NamedTuple):
    """One window: W poses and L landmarks (those observed at least
    once), E observations. pose_free [W] / lm_free [L] say what moves."""
    pose_free: torch.Tensor
    lm_free: torch.Tensor
    e_w: torch.Tensor         # [E] keyframe of the observation
    e_l: torch.Tensor         # [E] landmark
    e_shift: torch.Tensor     # [E] m: 0 (left eye) or the baseline (right)
    uv: torch.Tensor          # [E, 2]


def window_from_map(kf_gid, kf_valid, lm_valid, lm_first_kf, obs_uv,
                    obs_valid, baseline: float):
    """The window problem of a map's tables (kf_gid [W], kf_valid [W],
    lm_valid [M], lm_first_kf [M], obs_uv [M, W, 2, 2], obs_valid
    [M, W, 2]; a map as the program keeps it): every valid observation of
    a valid landmark in a valid keyframe. Returns (WindowProblem, the map
    rows of its landmarks [L])."""
    live = obs_valid & lm_valid[:, None, None] & kf_valid[None, :, None]
    rows = torch.nonzero(live.flatten(1).any(1))[:, 0]
    m_i, w_i, c_i = torch.nonzero(live[rows], as_tuple=True)
    gids = torch.where(kf_valid, kf_gid, torch.full_like(kf_gid, 2 ** 30))
    pose_free = kf_valid & (gids != gids.min())
    in_window = (lm_first_kf[rows, None]
                 == torch.where(kf_valid, kf_gid,
                                torch.full_like(kf_gid, -2))[None]).any(1)
    dt = obs_uv.dtype
    prob = WindowProblem(
        pose_free=pose_free, lm_free=in_window, e_w=w_i, e_l=m_i,
        e_shift=c_i.to(dt) * baseline,
        uv=obs_uv[rows][m_i, w_i, c_i])
    return prob, rows


def window_cost(prob: WindowProblem, R, t, p, cam: Camera):
    """The window's robust reprojection cost at poses R [W, 3, 3], t [W, 3]
    and points p [L, 3]."""
    pc = mm(R[prob.e_w], p[prob.e_l][..., None])[..., 0] + t[prob.e_w]
    uv, ok, _ = _project(pc, prob.e_shift, cam)
    e = uv - prob.uv
    return (huber((e * e).sum(-1), CHI2_BA) * ok).sum()


def solve_window(prob: WindowProblem, R0, t0, p0, cam: Camera,
                 iters: int = 30):
    """Levenberg-Marquardt with the landmarks eliminated by the Schur
    complement, from (R0, t0, p0), in the dtype of the inputs. Returns
    (R, t, p)."""
    R, t, p = R0, t0, p0
    W, L = R.shape[0], p.shape[0]
    dt, dev = R.dtype, R.device
    pf = prob.pose_free.to(dt)
    lf = prob.lm_free.to(dt)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    F = window_cost(prob, R, t, p, cam)
    lam = 1e-4
    for _ in range(iters):
        Rw = R[prob.e_w]
        pc = mm(Rw, p[prob.e_l][..., None])[..., 0] + t[prob.e_w]
        uv, ok, zs = _project(pc, prob.e_shift, cam)
        e = uv - prob.uv
        w = huber_weight((e * e).sum(-1), CHI2_BA) * ok
        Jc = _proj_jac(pc, prob.e_shift, zs, cam)              # [E, 2, 3]
        Jp = torch.cat([Jc, -mm(Jc, hat(pc))], -1) \
            * pf[prob.e_w][:, None, None]                      # [E, 2, 6]
        Jl = mm(Jc, Rw) * lf[prob.e_l][:, None, None]          # [E, 2, 3]
        Jpw, Jlw = Jp * w[:, None, None], Jl * w[:, None, None]
        Hpp = torch.zeros(W, 6, 6, dtype=dt, device=dev).index_add_(
            0, prob.e_w, mm(Jpw.transpose(1, 2), Jp))
        Hll = torch.zeros(L, 3, 3, dtype=dt, device=dev).index_add_(
            0, prob.e_l, mm(Jlw.transpose(1, 2), Jl))
        Hpl = torch.zeros(L * W, 6, 3, dtype=dt, device=dev).index_add_(
            0, prob.e_l * W + prob.e_w, mm(Jpw.transpose(1, 2), Jl)
        ).reshape(L, W, 6, 3)
        gp = torch.zeros(W, 6, dtype=dt, device=dev).index_add_(
            0, prob.e_w, mm(Jpw.transpose(1, 2), e[..., None])[..., 0])
        gl = torch.zeros(L, 3, dtype=dt, device=dev).index_add_(
            0, prob.e_l, mm(Jlw.transpose(1, 2), e[..., None])[..., 0])
        # damping on the diagonal; what is held fixed gets an identity
        Hpp_d = Hpp + lam * torch.diag_embed(
            torch.diagonal(Hpp, dim1=-2, dim2=-1)) \
            + (1.0 - pf)[:, None, None] * eye6 + 1e-9 * eye6
        Hll_d = Hll + lam * torch.diag_embed(
            torch.diagonal(Hll, dim1=-2, dim2=-1)) \
            + (1.0 - lf)[:, None, None] * eye3 + 1e-9 * eye3
        Hll_inv = torch.linalg.inv(Hll_d)                      # [L, 3, 3]
        A = mm(Hpl, Hll_inv[:, None])                          # [L, W, 6, 3]
        A2 = A.permute(1, 2, 0, 3).reshape(W * 6, L * 3)
        B2 = Hpl.permute(1, 2, 0, 3).reshape(W * 6, L * 3)
        S = torch.block_diag(*Hpp_d) - mm(A2, B2.T)
        rhs = -gp.reshape(-1) + mm(A2, gl.reshape(-1, 1))[:, 0]
        dp, info = torch.linalg.solve_ex(S, rhs)
        if int(info) != 0:          # a singular system: a rejected step
            lam *= 4.0
            continue
        dp = dp.reshape(W, 6) * pf[:, None]
        back = mm(Hpl.permute(0, 3, 1, 2).reshape(L, 3, W * 6),
                  dp.reshape(W * 6, 1))[..., 0]
        dl = mm(Hll_inv, (-gl - back)[..., None])[..., 0] * lf[:, None]
        R_n, t_n = retract(R, t, dp)
        p_n = p + dl
        F_n = window_cost(prob, R_n, t_n, p_n, cam)
        if bool(torch.isfinite(F_n)) and float(F_n) < float(F):
            R, t, p, F = R_n, t_n, p_n, F_n
            lam = max(lam / 3.0, 1e-12)
        else:
            lam *= 4.0
    return R, t, p


def perturb(prob: WindowProblem, R, t, p, seed: int):
    """The reference's start: the state it judges, with every free pose
    moved by ~5 mm and ~0.5 mrad and every free landmark by ~2 cm, drawn
    from `seed` on the host (the same start in every precision)."""
    g = torch.Generator().manual_seed(seed % (2 ** 63))
    W, L = R.shape[0], p.shape[0]
    dx = torch.randn(W, 6, generator=g, dtype=F64)
    dx[:, :3] *= 5e-3
    dx[:, 3:] *= 5e-4
    dl = 2e-2 * torch.randn(L, 3, generator=g, dtype=F64)
    dx = dx.to(R.device, R.dtype) * prob.pose_free.to(R.dtype)[:, None]
    dl = dl.to(p.device, p.dtype) * prob.lm_free.to(p.dtype)[:, None]
    R2, t2 = retract(R, t, dx)
    return R2, t2, p + dl


def gap(cost, cost_ref) -> float:
    """The cost gap of an answer: how far its cost lies above the
    reference's optimum, as a share of the optimum."""
    cost, cost_ref = float(cost), float(cost_ref)
    return (cost - cost_ref) / max(cost_ref, 1e-12)

