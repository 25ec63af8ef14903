"""Batched Gauss-Newton / Levenberg-Marquardt optimizers (port of
`ssvio_tpu/ops/ba.py`).

- `pose_only_optimize`: the frontend's EstimateCurrentPose (reference
  src/ssvio/frontend.cpp:184-300): 4 rounds x 10 LM iterations, Huber,
  chi2 > 5.991 outlier demotion between rounds.
- `local_ba`: the backend's OptimizeActiveMap (reference
  src/ssvio/backend.cpp:78-245): W poses + M landmarks over a dense
  [M, W, C] observation table, Schur complement of the 3x3 landmark blocks,
  g2o's gain-ratio LM schedule and the inlier-ratio round loop.

The JAX package's `while_loop`s with a scalar stop become Python loops that
read the stop flag on the host (`.item()`), which gives the same answer; a
few host syncs per frame are accepted here. Solves use
`torch.linalg.solve_ex`, which returns inf/nan on a singular system instead
of raising, as `jnp.linalg.solve` does; the finiteness test then rejects
the step. The multi-device (`axis_name`) branches are not ported yet
(ROADMAP Queue 1 #14).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ssvio_tpu_torch.ops import se3

CHI2_TH = 5.991          # 95% chi-square with 2 dof (reference threshold)
BACKEND_CHI2_TH = 5.891  # backend threshold (reference backend.cpp:172)


def _solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(A, b)[0]


# ---------------------------------------------------------------------------
# Reprojection residuals / Jacobians (analytic, matching g2otypes.hpp:86-101)
# ---------------------------------------------------------------------------

def reproject_residual(T_cw: torch.Tensor, p_w: torch.Tensor, uv: torch.Tensor,
                       fx, fy, cx, cy, baseline_x=0.0):
    """Residual r = uv_obs - proj(T_cw p_w + [-baseline_x, 0, 0]).

    Returns (r [..., 2], p_c [..., 3] LEFT-camera point, z_positive [...])."""
    p_cl = se3.transform(T_cw, p_w)
    bx = torch.as_tensor(baseline_x, dtype=p_cl.dtype, device=p_cl.device)
    z = p_cl[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    u = fx * (p_cl[..., 0] - bx) / safe_z + cx
    v = fy * p_cl[..., 1] / safe_z + cy
    r = uv - torch.stack([u, v], dim=-1)
    return r, p_cl, z > 0.05


def reproject_jacobians(p_cl: torch.Tensor, R_cw: torch.Tensor,
                        fx, fy, baseline_x=0.0):
    """Analytic Jacobians of the reprojection residual.

    Returns J_pose [..., 2, 6] (left-multiplicative xi = [rho, phi]) and
    J_point [..., 2, 3] d r / d p_w."""
    x, y, z = p_cl[..., 0], p_cl[..., 1], p_cl[..., 2]
    xs = x - torch.as_tensor(baseline_x, dtype=p_cl.dtype, device=p_cl.device)
    safe_z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    iz = 1.0 / safe_z
    iz2 = iz * iz
    zero = torch.zeros_like(iz)
    duv = torch.stack([
        torch.stack([fx * iz, zero, -fx * xs * iz2], dim=-1),
        torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=p_cl.dtype, device=p_cl.device)
    dp_dxi = torch.cat([eye.expand(*p_cl.shape[:-1], 3, 3), -se3.hat(p_cl)],
                       dim=-1)                     # [..., 3, 6]
    return -(duv @ dp_dxi), -(duv @ R_cw)


def huber_weight(chi2: torch.Tensor, delta2: float = CHI2_TH) -> torch.Tensor:
    """IRLS weight of the Huber kernel on squared error chi2."""
    return torch.where(chi2 <= delta2, torch.ones_like(chi2),
                       torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))


# ---------------------------------------------------------------------------
# Pose-only LM (frontend hot loop)
# ---------------------------------------------------------------------------

class PoseOnlyResult(NamedTuple):
    T_cw: torch.Tensor        # [3, 4] optimized pose
    inlier: torch.Tensor      # [N] bool final inlier mask
    n_inliers: torch.Tensor   # [] int32
    chi2: torch.Tensor        # [N] final per-edge chi2


def _pose_only_normal_eq(T, p_w, uv, w, fx, fy, cx, cy):
    r, p_cl, z_ok = reproject_residual(T, p_w, uv, fx, fy, cx, cy)
    w = w * z_ok.to(r.dtype)
    chi2 = torch.sum(r * r, dim=-1)
    hw = w * huber_weight(chi2)
    J, _ = reproject_jacobians(p_cl, se3.rotation(T), fx, fy)
    H = torch.einsum("nki,nkj,n->ij", J, J, hw)
    b = -torch.einsum("nki,nk,n->i", J, r, hw)
    F = torch.sum(hw * chi2)
    return H, b, F


def _lm_loop_6dof(T0, p_w, uv, weight, fx, fy, cx, cy, iters: int):
    """Adaptive-lambda LM on one 6-dof pose (g2o Levenberg semantics: gain
    ratio rho, lambda *= max(1/3, 1-(2 rho-1)^3) on success else *= nu),
    normal equations carried between iterations, early exit on a stalled
    step."""
    H, b, F = _pose_only_normal_eq(T0, p_w, uv, weight, fx, fy, cx, cy)
    lam = 1e-5 * torch.max(torch.diagonal(H))
    nu = torch.tensor(2.0, dtype=H.dtype, device=H.device)
    T = T0
    eye6 = torch.eye(6, dtype=H.dtype, device=H.device)
    for _ in range(iters):
        dx = _solve(H + lam * eye6, b)
        T_new = se3.compose(se3.exp(dx), T)
        H_new, b_new, F_new = _pose_only_normal_eq(T_new, p_w, uv, weight,
                                                   fx, fy, cx, cy)
        pred = 0.5 * torch.dot(dx, lam * dx + b)
        rho = (F - F_new) / torch.clamp(pred, min=1e-12)
        finite = torch.all(torch.isfinite(dx))
        accept = (rho > 0) & finite
        T = torch.where(accept, T_new, T)
        H = torch.where(accept, H_new, H)
        b = torch.where(accept, b_new, b)
        F = torch.where(accept, F_new, F)
        lam = torch.where(
            accept,
            lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0),
            lam * nu)
        nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
        if bool(((torch.max(torch.abs(dx)) < 1e-7) & finite).item()):
            break
    return T


def _pose_only_normal_eq_batched(T, p_w, uv, w, fx, fy, cx, cy):
    """_pose_only_normal_eq over a batch of poses: T [B, 3, 4], p_w
    [B, K, 3], uv [B, K, 2], w [B, K] -> H [B, 6, 6], b [B, 6], F [B]."""
    r, p_cl, z_ok = reproject_residual(T[:, None], p_w, uv, fx, fy, cx, cy)
    w = w * z_ok.to(r.dtype)
    chi2 = torch.sum(r * r, dim=-1)
    hw = w * huber_weight(chi2)
    J, _ = reproject_jacobians(p_cl, se3.rotation(T)[:, None], fx, fy)
    H = torch.einsum("bnki,bnkj,bn->bij", J, J, hw)
    b = -torch.einsum("bnki,bnk,bn->bi", J, r, hw)
    F = torch.sum(hw * chi2, dim=-1)
    return H, b, F


def _lm_loop_6dof_batched(T0, p_w, uv, weight, fx, fy, cx, cy, iters: int):
    """_lm_loop_6dof on B poses at once, each on its own points (T0
    [B, 3, 4], p_w [B, K, 3], uv [B, K, 2], weight [B, K]): exactly
    `iters` steps with no host read. A pose whose step has stalled is
    frozen with `torch.where`, which is the state a batched `while_loop`
    leaves (it runs until every pose's condition is false and keeps the
    carry of those that stopped earlier)."""
    H, b, F = _pose_only_normal_eq_batched(T0, p_w, uv, weight,
                                           fx, fy, cx, cy)
    lam = 1e-5 * torch.amax(torch.diagonal(H, dim1=-2, dim2=-1), dim=-1)
    nu = torch.full_like(lam, 2.0)
    stop = torch.zeros_like(lam, dtype=torch.bool)
    T = T0
    eye6 = torch.eye(6, dtype=H.dtype, device=H.device)
    for _ in range(iters):
        dx = _solve(H + lam[:, None, None] * eye6, b[..., None])[..., 0]
        T_new = se3.compose(se3.exp(dx), T)
        H_new, b_new, F_new = _pose_only_normal_eq_batched(
            T_new, p_w, uv, weight, fx, fy, cx, cy)
        pred = 0.5 * torch.sum(dx * (lam[:, None] * dx + b), dim=-1)
        rho = (F - F_new) / torch.clamp(pred, min=1e-12)
        finite = torch.all(torch.isfinite(dx), dim=-1)
        accept = (rho > 0) & finite & ~stop
        live = ~stop
        T = torch.where(accept[:, None, None], T_new, T)
        H = torch.where(accept[:, None, None], H_new, H)
        b = torch.where(accept[:, None], b_new, b)
        F = torch.where(accept, F_new, F)
        lam_next = torch.where(
            accept,
            lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0),
            lam * nu)
        nu_next = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
        lam = torch.where(live, lam_next, lam)
        nu = torch.where(live, nu_next, nu)
        stop = stop | ((torch.amax(torch.abs(dx), dim=-1) < 1e-7) & finite)
    return T


def pose_only_optimize(T_init: torch.Tensor, p_w: torch.Tensor,
                       uv: torch.Tensor, valid: torch.Tensor, fx, fy, cx, cy,
                       rounds: int = 4, iters: int = 10) -> PoseOnlyResult:
    """The reference's 4x10 pose-only BA with between-round chi2 gating;
    outliers may come back in a later round (frontend.cpp:244-268)."""
    inlier = valid
    T = T_init
    for _ in range(rounds):
        w = (valid & inlier).to(torch.float32)
        T = _lm_loop_6dof(T, p_w, uv, w, fx, fy, cx, cy, iters)
        r, _, z_ok = reproject_residual(T, p_w, uv, fx, fy, cx, cy)
        inlier = valid & z_ok & (torch.sum(r * r, dim=-1) < CHI2_TH)
    r, _, z_ok = reproject_residual(T, p_w, uv, fx, fy, cx, cy)
    chi2 = torch.sum(r * r, dim=-1)
    inlier = valid & z_ok & (chi2 < CHI2_TH)
    return PoseOnlyResult(T, inlier, torch.sum(inlier.to(torch.int32)), chi2)


# ---------------------------------------------------------------------------
# Local bundle adjustment with Schur-complement landmark marginalization
# ---------------------------------------------------------------------------

class LocalBAProblem(NamedTuple):
    """Dense sliding-window BA state. W = window capacity, M = landmark
    capacity, C = 2 eyes (left, right). All masked; shapes never change."""
    kf_T_cw: torch.Tensor      # [W, 3, 4]
    kf_valid: torch.Tensor     # [W] bool — slot holds a real keyframe
    kf_fixed: torch.Tensor     # [W] bool — pose held constant
    lm_pos: torch.Tensor       # [M, 3] world positions
    lm_valid: torch.Tensor     # [M] bool
    lm_fixed: torch.Tensor     # [M] bool (first obs outside window => fixed)
    obs_uv: torch.Tensor       # [M, W, C, 2] pixel observations
    obs_valid: torch.Tensor    # [M, W, C] bool


class LocalBAResult(NamedTuple):
    kf_T_cw: torch.Tensor      # [W, 3, 4] optimized poses
    lm_pos: torch.Tensor       # [M, 3] optimized landmarks
    obs_valid: torch.Tensor    # [M, W, C] with outlier edges detached
    chi2: torch.Tensor         # [M, W, C] final per-edge chi2
    inlier_ratio: torch.Tensor # [] float32


def _ba_residuals(prob: LocalBAProblem, kf_T_cw, lm_pos, fx, fy, cx, cy, bl):
    """All-edge residuals. Returns (r [M,W,C,2], p_cl [M,W,3], z_ok [M,W])."""
    p_cl = se3.transform(kf_T_cw[None], lm_pos[:, None, :])   # [M, W, 3]
    baseline = torch.stack([torch.zeros_like(bl), bl])        # [C]
    z = p_cl[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    xs = p_cl[..., 0:1] - baseline[None, None, :]             # [M, W, C]
    u = fx * xs / safe_z[..., None] + cx
    v = (fy * p_cl[..., 1] / safe_z)[..., None] + cy          # [M, W, 1]
    uv_hat = torch.stack([u, v.expand_as(u)], dim=-1)
    return prob.obs_uv - uv_hat, p_cl, z > 0.05


def _ba_cost_and_blocks(prob: LocalBAProblem, kf_T_cw, lm_pos,
                        fx, fy, cx, cy, bl, edge_active):
    """One linearization pass: cost F and the Hessian blocks, landmark axis
    M last as in the JAX package. Returns (F, Hpp [W,6,6], Hll [3,3,M],
    Hpl [W,6,3,M], bp [W,6], blm [3,M])."""
    R = se3.rotation(kf_T_cw)                                 # [W, 3, 3]
    t = kf_T_cw[:, :, 3]
    p_cl = R @ lm_pos.T[None] + t[:, :, None]                 # [W, 3, M]
    x, y, z = p_cl[:, 0], p_cl[:, 1], p_cl[:, 2]              # [W, M]
    safe_z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    iz = 1.0 / safe_z
    iz2 = iz * iz
    baseline = torch.stack([torch.zeros_like(bl), bl])        # [C]
    xs = x[:, None, :] - baseline[None, :, None]              # [W, C, M]
    u_hat = fx * xs * iz[:, None, :] + cx
    v_hat = (fy * y * iz + cy)[:, None, :]                    # [W, 1, M]
    obs = prob.obs_uv.permute(1, 2, 3, 0)                     # [W, C, 2, M]
    ru = obs[:, :, 0] - u_hat                                 # [W, C, M]
    rv = obs[:, :, 1] - v_hat
    chi2 = ru * ru + rv * rv
    z_ok = z > 0.05
    act = edge_active.permute(1, 2, 0)                        # [W, C, M]
    w_edge = (act & z_ok[:, None, :]).to(torch.float32)
    hw = w_edge * huber_weight(chi2, BACKEND_CHI2_TH)         # [W, C, M]
    F = torch.sum(hw * chi2)

    # Jacobian blocks (r = obs - proj => leading minus); pose columns 0..2
    # identity, 3..5 the columns of -hat(p_cl) (reference g2otypes.hpp)
    shape = xs.shape
    du_x = (fx * iz)[:, None, :].expand(shape)
    du_z = -fx * xs * iz2[:, None, :]
    dv_y = (fy * iz)[:, None, :].expand(shape)
    dv_z = (-fy * y * iz2)[:, None, :].expand(shape)
    zero = torch.zeros_like(du_z)
    xc = x[:, None, :].expand(shape)
    yc = y[:, None, :].expand(shape)
    zc = z[:, None, :].expand(shape)
    ju = [du_x, zero, du_z, du_z * yc, du_x * zc - du_z * xc, -du_x * yc]
    jv = [zero, dv_y, dv_z, -dv_y * zc + dv_z * yc, -dv_z * xc, dv_y * xc]
    J_pose = -torch.stack([torch.stack([ju[a], jv[a]], dim=2)
                           for a in range(6)], dim=1)         # [W,6,C,2,M]
    Rc = R[:, :, :, None, None]
    jpu = [du_x * Rc[:, 0, b] + du_z * Rc[:, 2, b] for b in range(3)]
    jpv = [dv_y * Rc[:, 1, b] + dv_z * Rc[:, 2, b] for b in range(3)]
    J_point = -torch.stack([torch.stack([jpu[b], jpv[b]], dim=2)
                            for b in range(3)], dim=1)        # [W,3,C,2,M]

    free_pose = (prob.kf_valid & ~prob.kf_fixed).to(torch.float32)
    free_lm = (prob.lm_valid & ~prob.lm_fixed).to(torch.float32)
    J_pose = J_pose * free_pose[:, None, None, None, None]
    J_point = J_point * free_lm[None, None, None, None, :]

    r = torch.stack([ru, rv], dim=2)                          # [W, C, 2, M]
    hw_k = hw[:, :, None, :]                                  # [W, C, 1, M]
    Jp_w = J_pose * hw_k[:, None]
    rw = r * hw_k
    Hpp = torch.einsum("wackm,wbckm->wab", Jp_w, J_pose)
    Hll = torch.einsum("wackm,wbckm->abm", J_point * hw_k[:, None], J_point)
    Hpl = torch.einsum("wackm,wbckm->wabm", Jp_w, J_point)
    bp = -torch.einsum("wackm,wckm->wa", J_pose, rw)
    blm = -torch.einsum("wackm,wckm->am", J_point, rw)
    return F, Hpp, Hll, Hpl, bp, blm


def _inv3x3_mlast(A: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse on [3, 3, M] (batch axis last)."""
    a, b, c = A[0, 0], A[0, 1], A[0, 2]
    d, e, f = A[1, 0], A[1, 1], A[1, 2]
    g, h, i = A[2, 0], A[2, 1], A[2, 2]
    co_a = e * i - f * h
    co_b = c * h - b * i
    co_c = b * f - c * e
    det = a * co_a + d * co_b + g * co_c
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20,
                                torch.full_like(det, 1e-20), det)
    adj = torch.stack([
        torch.stack([co_a, co_b, co_c], dim=0),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=0),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], dim=0),
    ], dim=0)
    return adj * inv_det[None, None]


def _schur_solve(Hpp, Hll, Hpl, bp, blm, lam, pose_free, lm_free):
    """Damped Schur-reduced solve on M-last blocks. Returns (dxp [W,6],
    dxl [M,3])."""
    W = Hpp.shape[0]
    M = Hll.shape[-1]
    dev, dt = Hpp.device, Hpp.dtype
    Hpp_d = Hpp + lam * torch.eye(6, dtype=dt, device=dev)[None]
    # unobserved / fixed landmarks get an identity block so the batched
    # inverse stays finite (their dxl is masked to 0 anyway)
    Hll_d = Hll + (lam + (1.0 - lm_free))[None, None, :] \
        * torch.eye(3, dtype=dt, device=dev)[:, :, None]
    Hll_inv = _inv3x3_mlast(Hll_d)                             # [3,3,M]

    # S = Hpp_d - sum_m Hpl Hll^-1 Hpl^T as ONE [6W, 3M] x [3M, 6W] product
    A = torch.einsum("wabm,bcm->wacm", Hpl, Hll_inv)           # [W,6,3,M]
    S_cross = (A.reshape(W * 6, 3 * M) @ Hpl.reshape(W * 6, 3 * M).T) \
        .reshape(W, 6, W, 6).permute(0, 2, 1, 3)
    corr = torch.einsum("wacm,cm->wa", A, blm)
    S = -S_cross
    ar = torch.arange(W, device=dev)
    S[ar, ar] += Hpp_d
    bs = bp - corr

    Sd = S.permute(0, 2, 1, 3).reshape(W * 6, W * 6)
    free = pose_free.repeat_interleave(6)
    Sd = Sd * (free[:, None] * free[None, :]) \
        + torch.diag(torch.where(free > 0, 0.0, 1.0).to(dt))
    rhs = bs.reshape(-1) * free
    dxp = _solve(Sd + 1e-6 * torch.eye(W * 6, dtype=dt, device=dev),
                 rhs).reshape(W, 6) * pose_free[:, None]

    rhs_l = blm - torch.einsum("wabm,wa->bm", Hpl, dxp)        # [3,M]
    dxl = torch.einsum("cbm,bm->cm", Hll_inv, rhs_l) * lm_free[None, :]
    return dxp, dxl.T


def local_ba(prob: LocalBAProblem, fx, fy, cx, cy, baseline,
             max_rounds: int = 5, iters: int = 10,
             target_inlier_ratio: float = 0.7) -> LocalBAResult:
    """Sliding-window local BA, g2o-LM semantics on dense masked tensors.

    Up to `max_rounds` rounds of `iters` LM iterations; after each round
    edges with chi2 > BACKEND_CHI2_TH count as outliers and the loop stops
    once the inlier ratio exceeds `target_inlier_ratio`; then outlier edges
    are detached (reference backend.cpp:172-227)."""
    bl = torch.as_tensor(baseline, dtype=torch.float32,
                         device=prob.lm_pos.device)
    pose_free = (prob.kf_valid & ~prob.kf_fixed).to(torch.float32)
    lm_has_obs = torch.any(prob.obs_valid.flatten(1), dim=1)
    lm_free = (prob.lm_valid & ~prob.lm_fixed & lm_has_obs).to(torch.float32)

    def lm_inner(kf_T_cw, lm_pos, edge_active, n_iters):
        blocks = _ba_cost_and_blocks(prob, kf_T_cw, lm_pos, fx, fy, cx, cy,
                                     bl, edge_active)
        lam = 1e-5 * torch.max(torch.diagonal(blocks[1], dim1=1, dim2=2))
        nu = torch.tensor(2.0, device=lam.device)
        T, lp = kf_T_cw, lm_pos
        for _ in range(n_iters):
            F, Hpp, Hll, Hpl, bp, blm = blocks
            dxp, dxl = _schur_solve(Hpp, Hll, Hpl, bp, blm, lam,
                                    pose_free, lm_free)
            T_new = se3.compose(se3.exp(dxp), T)
            lp_new = lp + dxl
            blocks_new = _ba_cost_and_blocks(prob, T_new, lp_new, fx, fy, cx,
                                             cy, bl, edge_active)
            pred = 0.5 * (torch.sum(dxp * (lam * dxp + bp))
                          + torch.sum(dxl * (lam * dxl + blm.T)))
            rho = (F - blocks_new[0]) / torch.clamp(pred, min=1e-9)
            finite = torch.all(torch.isfinite(dxp)) \
                & torch.all(torch.isfinite(dxl))
            accept = (rho > 0) & finite
            T = torch.where(accept, T_new, T)
            lp = torch.where(accept, lp_new, lp)
            blocks = tuple(torch.where(accept, n, o)
                           for n, o in zip(blocks_new, blocks))
            lam = torch.where(
                accept,
                lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0),
                lam * nu)
            nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
            step = torch.maximum(torch.max(torch.abs(dxp)),
                                 torch.max(torch.abs(dxl)))
            if bool(((step < 1e-5) & finite).item()):
                break
        return T, lp

    base_active = prob.obs_valid & prob.lm_valid[:, None, None] \
        & prob.kf_valid[None, :, None]
    n_act = torch.clamp(torch.sum(base_active), min=1)
    kf_T_cw, lm_pos = prob.kf_T_cw, prob.lm_pos
    inlier_edges = torch.ones_like(prob.obs_valid)
    for _ in range(max_rounds):
        kf_T_cw, lm_pos = lm_inner(kf_T_cw, lm_pos, base_active & inlier_edges,
                                   iters)
        r, _, z_ok = _ba_residuals(prob, kf_T_cw, lm_pos, fx, fy, cx, cy, bl)
        inlier_edges = (torch.sum(r * r, dim=-1) < BACKEND_CHI2_TH) \
            & z_ok[..., None]
        ratio = torch.sum(inlier_edges & base_active) / n_act
        if bool((ratio > target_inlier_ratio).item()):
            break

    r, _, z_ok = _ba_residuals(prob, kf_T_cw, lm_pos, fx, fy, cx, cy, bl)
    chi2 = torch.sum(r * r, dim=-1)
    final_inlier = (chi2 < BACKEND_CHI2_TH) & z_ok[..., None]
    ratio = torch.sum(final_inlier & base_active) / n_act
    return LocalBAResult(kf_T_cw, lm_pos, prob.obs_valid & final_inlier, chi2,
                         ratio.to(torch.float32))
