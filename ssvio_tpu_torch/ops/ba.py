"""Batched Gauss-Newton / Levenberg-Marquardt optimizers (port of
`ssvio_tpu/ops/ba.py`).

- `pose_only_optimize`: the frontend's EstimateCurrentPose (reference
  src/ssvio/frontend.cpp:184-300): 4 rounds x 10 LM iterations, Huber,
  chi2 > 5.991 outlier demotion between rounds.
- `local_ba`: the backend's OptimizeActiveMap (reference
  src/ssvio/backend.cpp:78-245): W poses + M landmarks over a dense
  [M, W, C] observation table, Schur complement of the 3x3 landmark blocks,
  g2o's gain-ratio LM schedule and the inlier-ratio round loop.

JAX's `while_loop`s run as fixed trips whose state freezes once the stop
flag is set, with no host read, so the tracking and keyframe steps are
captured into CUDA graphs (`graphs.py`): the pose-only LM takes `iters`
steps a round, `local_ba` `iters` steps in each of `max_rounds` rounds
(5 x 10 = 50 LM steps, where JAX's loops may stop sooner; each result
counts the rounds and steps the loops would have run). In a captured
graph each round of `local_ba` after the first is a CUDA conditional node
on the ratio flag (`_if_live`): a replay runs the rounds up to the flag,
each with all its `iters` steps, and skips the rest on the device; run
op by op, the fixed trip runs them all. Solves use
`torch.linalg.solve_ex` (the BA's Schur system its LU factors and two
triangular solves, `_solve_lu`: the same bits), which returns inf/nan on
a singular system instead of raising, as `jnp.linalg.solve` does; the
finiteness test then rejects the step.

`local_ba(..., mesh=...)` is the JAX package's `axis_name` form: the
problem's landmark axis is this rank's shard (`parallel/dist_ba.py`), and
the sums JAX takes with `psum`/`pmax`/`pmin` over the mesh axis are
`torch.distributed.all_reduce`s over the mesh's process group, at the same
places. It runs the same fixed trip op by op: its stop flags come from
reduced values, so every rank freezes its state on the same step and
makes the same all_reduce calls.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from ssvio_tpu_torch.ops import cuda_if, se3

CHI2_TH = 5.991          # 95% chi-square with 2 dof (reference threshold)
BACKEND_CHI2_TH = 5.891  # backend threshold (reference backend.cpp:172)
# local_ba's rounds and LM steps a round: op by op the fixed trip runs
# them all, a captured graph the rounds up to the ratio flag
LOCAL_BA_ROUNDS, LOCAL_BA_ITERS = 5, 10


def _solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(A, b)[0]


def _solve_lu(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`_solve` of one [n, n] system as its LU factors, the row swaps and
    two triangular solves: what solve_ex runs on the card (cuSOLVER's
    getrf and getrs), which gives the same bits, but with cuBLAS's
    triangular solves in place of getrs, which allocates memory inside a
    CUDA graph's conditional body (`_if_live`), where that is refused."""
    LU, piv, _ = torch.linalg.lu_factor_ex(A)
    perm = torch.lu_unpack(LU, piv, unpack_data=False)[0].argmax(dim=0)
    y = torch.linalg.solve_triangular(LU, b.index_select(0, perm)[:, None],
                                      upper=False, unitriangular=True)
    return torch.linalg.solve_triangular(LU, y, upper=True)[:, 0]


def _all_reduce(mesh, op, *ts):
    """Reduce each tensor over the mesh's ranks with `op` (one all_reduce
    of them packed; one dtype). Returns new tensors with the inputs'
    shapes and strides, so that what follows sums in the same order as
    without a mesh."""
    flat = torch.cat([t.reshape(-1) for t in ts])
    dist.all_reduce(flat, op=op, group=mesh.group)
    out = []
    for t, seg in zip(ts, torch.split(flat, [t.numel() for t in ts])):
        out.append(torch.empty_like(t).copy_(seg.view(t.shape)))
    return out


# ---------------------------------------------------------------------------
# Reprojection residuals / Jacobians (analytic, matching g2otypes.hpp:86-101)
# ---------------------------------------------------------------------------

def reproject_residual(T_cw: torch.Tensor, p_w: torch.Tensor, uv: torch.Tensor,
                       fx, fy, cx, cy, baseline_x=0.0):
    """Residual r = uv_obs - proj(T_cw p_w + [-baseline_x, 0, 0]).

    Returns (r [..., 2], p_c [..., 3] LEFT-camera point, z_positive [...])."""
    p_cl = se3.transform(T_cw, p_w)
    z = p_cl[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    u = fx * (p_cl[..., 0] - baseline_x) / safe_z + cx
    v = fy * p_cl[..., 1] / safe_z + cy
    r = uv - torch.stack([u, v], dim=-1)
    return r, p_cl, z > 0.05


def reproject_jacobians(p_cl: torch.Tensor, R_cw: torch.Tensor,
                        fx, fy, baseline_x=0.0):
    """Analytic Jacobians of the reprojection residual.

    Returns J_pose [..., 2, 6] (left-multiplicative xi = [rho, phi]) and
    J_point [..., 2, 3] d r / d p_w."""
    x, y, z = p_cl[..., 0], p_cl[..., 1], p_cl[..., 2]
    xs = x - baseline_x
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
    normal equations carried between iterations. Exactly `iters` steps
    with no host read: once a step stalls (`stop`), T, H, b, F, lam and nu
    are frozen with `torch.where`, which is the state JAX's `while_loop`
    leaves when it exits there (ssvio_tpu/ops/ba.py:146-173)."""
    H, b, F = _pose_only_normal_eq(T0, p_w, uv, weight, fx, fy, cx, cy)
    lam = 1e-5 * torch.max(torch.diagonal(H))
    nu = torch.full((), 2.0, dtype=H.dtype, device=H.device)
    stop = torch.zeros((), dtype=torch.bool, device=H.device)
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
        live = ~stop
        accept = (rho > 0) & finite & live
        T = torch.where(accept, T_new, T)
        H = torch.where(accept, H_new, H)
        b = torch.where(accept, b_new, b)
        F = torch.where(accept, F_new, F)
        lam_next = torch.where(
            accept,
            lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0),
            lam * nu)
        nu_next = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
        lam = torch.where(live, lam_next, lam)
        nu = torch.where(live, nu_next, nu)
        stop = stop | ((torch.max(torch.abs(dx)) < 1e-7) & finite)
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
    outliers may come back in a later round (frontend.cpp:244-268).

    The final gate, which gives the returned inliers, their count and
    chi2, is taken in float64 at the returned pose: in float32 the
    residual of a point near a 1280-px image's edge carries ~1e-4 px^2 of
    rounding in its chi2, enough to flip a track that lies on the gate, so
    that the count a frame's status follows would be one no exact
    computation at its pose gives. Intrinsics given as Python floats (the
    Frontend passes the settings') enter it exactly; the LM rounds them
    to float32 as it does float32 tensors."""
    inlier = valid
    T = T_init
    for _ in range(rounds):
        w = (valid & inlier).to(torch.float32)
        T = _lm_loop_6dof(T, p_w, uv, w, fx, fy, cx, cy, iters)
        r, _, z_ok = reproject_residual(T, p_w, uv, fx, fy, cx, cy)
        inlier = valid & z_ok & (torch.sum(r * r, dim=-1) < CHI2_TH)
    f64 = torch.float64
    cam = [c.to(f64) if torch.is_tensor(c) else float(c)
           for c in (fx, fy, cx, cy)]
    r, _, z_ok = reproject_residual(T.to(f64), p_w.to(f64), uv.to(f64),
                                    *cam)
    chi2 = torch.sum(r * r, dim=-1)
    inlier = valid & z_ok & (chi2 < CHI2_TH)
    return PoseOnlyResult(T, inlier, torch.sum(inlier.to(torch.int32)),
                          chi2.to(torch.float32))


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
    # [] int32: the rounds and LM steps JAX's while_loops run (the fixed
    # trip freezes the state after the stop)
    rounds: Optional[torch.Tensor] = None
    iterations: Optional[torch.Tensor] = None


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
                        fx, fy, cx, cy, bl, edge_active, mesh=None):
    """One linearization pass: cost F and the Hessian blocks, landmark axis
    M last as in the JAX package. Returns (F, Hpp [W,6,6], Hll [3,3,M],
    Hpl [W,6,3,M], bp [W,6], blm [3,M]); with a mesh, F, Hpp and bp are
    summed over its ranks."""
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
    if mesh is not None:
        F, Hpp, bp = _all_reduce(mesh, dist.ReduceOp.SUM, F, Hpp, bp)
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


def _schur_solve(Hpp, Hll, Hpl, bp, blm, lam, pose_free, lm_free,
                 mesh=None):
    """Damped Schur-reduced solve on M-last blocks. Returns (dxp [W,6],
    dxl [M,3]). With a mesh, Hpp and bp are already global; the landmark
    cross terms are this shard's and are summed over the ranks here, the
    small camera system is solved on every rank, and the landmark
    back-substitution stays local."""
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
    S_cross = A.reshape(W * 6, 3 * M) @ Hpl.reshape(W * 6, 3 * M).T
    corr = torch.einsum("wacm,cm->wa", A, blm)
    if mesh is not None:
        S_cross, corr = _all_reduce(mesh, dist.ReduceOp.SUM, S_cross, corr)
    S_cross = S_cross.reshape(W, 6, W, 6).permute(0, 2, 1, 3)
    S = -S_cross
    ar = torch.arange(W, device=dev)
    S[ar, ar] += Hpp_d
    bs = bp - corr

    Sd = S.permute(0, 2, 1, 3).reshape(W * 6, W * 6)
    free = pose_free[:, None].expand(W, 6).reshape(-1)
    Sd = Sd * (free[:, None] * free[None, :]) \
        + torch.diag(torch.where(free > 0, 0.0, 1.0).to(dt))
    rhs = bs.reshape(-1) * free
    dxp = _solve_lu(Sd + 1e-6 * torch.eye(W * 6, dtype=dt, device=dev),
                    rhs).reshape(W, 6) * pose_free[:, None]

    rhs_l = blm - torch.einsum("wabm,wa->bm", Hpl, dxp)        # [3,M]
    dxl = torch.einsum("cbm,bm->cm", Hll_inv, rhs_l) * lm_free[None, :]
    return dxp, dxl.T


def _if_live(live: torch.Tensor, body: Callable[[], None]) -> None:
    """Run `body`, a round of local_ba's fixed trip that writes its results
    into tensors made before it. Inside a graph's capture the body is
    captured into a conditional node on `live` ([] bool on the device,
    `cuda_if.if_node`), which a replay runs only while `live` is set.
    Elsewhere (the CPU, eagerly, a graph's warm-up) the body always runs,
    and its `torch.where` selects on `live` leave the state as it was:
    both leave the same state bit for bit."""
    if cuda_if.is_open(live.device):
        cuda_if.if_node(live, body)
    else:
        body()


def local_ba(prob: LocalBAProblem, fx, fy, cx, cy, baseline,
             max_rounds: int = LOCAL_BA_ROUNDS, iters: int = LOCAL_BA_ITERS,
             target_inlier_ratio: float = 0.7, mesh=None,
             hold: Optional[torch.Tensor] = None) -> LocalBAResult:
    """Sliding-window local BA, g2o-LM semantics on dense masked tensors.

    Up to `max_rounds` rounds of `iters` LM iterations; after each round
    edges with chi2 > BACKEND_CHI2_TH count as outliers and the loop stops
    once the inlier ratio exceeds `target_inlier_ratio`; then outlier edges
    are detached (reference backend.cpp:172-227). `hold` ([] bool on the
    device, or None): while it is set the ratio does not stop the loop and
    every round runs. The engine sets it for the first BA after a loop
    correction, whose fusion joined the window's landmarks to those an
    earlier pass saw: from there the first round ends with the ratio met
    far from the optimum (up to ~47% above it in the window's cost, on
    the card), where the reference stops.

    Both loops are fixed trips with no host read: an LM step whose stop
    flag is set leaves T, lp, lam, nu and the blocks as they were, and a
    round after the ratio flag leaves the poses, the landmarks and the
    inlier edges, which is the state JAX's two `while_loop`s leave
    (ssvio_tpu/ops/ba.py:516, :546). Op by op every round runs; captured
    into a CUDA graph, the rounds after the first are conditional nodes
    on the ratio flag, and a replay skips those after it (`_if_live`), to
    the same state bit for bit.

    `mesh` (`parallel.dist_ba.Mesh`): `prob`'s landmark fields are this
    rank's shard and every rank of the mesh calls local_ba together, op
    by op: all LOCAL_BA_ROUNDS x LOCAL_BA_ITERS steps. The poses and the
    inlier ratio come out equal on every rank; lm_pos, obs_valid and chi2
    are the shard's."""
    dev = prob.lm_pos.device
    bl = (baseline.to(device=dev, dtype=torch.float32)
          if torch.is_tensor(baseline) else
          torch.full((), float(baseline), dtype=torch.float32, device=dev))
    pose_free = (prob.kf_valid & ~prob.kf_fixed).to(torch.float32)
    lm_has_obs = torch.any(prob.obs_valid.flatten(1), dim=1)
    lm_free = (prob.lm_valid & ~prob.lm_fixed & lm_has_obs).to(torch.float32)

    def lm_inner(kf_T_cw, lm_pos, edge_active, n_iters, live_round):
        """One round's LM: (poses, landmarks, steps its loop would take)."""
        blocks = _ba_cost_and_blocks(prob, kf_T_cw, lm_pos, fx, fy, cx, cy,
                                     bl, edge_active, mesh)
        lam = 1e-5 * torch.max(torch.diagonal(blocks[1], dim1=1, dim2=2))
        nu = torch.full((), 2.0, dtype=lam.dtype, device=dev)
        live = live_round
        n_steps = torch.zeros((), dtype=torch.int32, device=dev)
        T, lp = kf_T_cw, lm_pos
        for _ in range(n_iters):
            F, Hpp, Hll, Hpl, bp, blm = blocks
            dxp, dxl = _schur_solve(Hpp, Hll, Hpl, bp, blm, lam,
                                    pose_free, lm_free, mesh)
            T_new = se3.compose(se3.exp(dxp), T)
            lp_new = lp + dxl
            blocks_new = _ba_cost_and_blocks(prob, T_new, lp_new, fx, fy, cx,
                                             cy, bl, edge_active, mesh)
            pred_l = torch.sum(dxl * (lam * dxl + blm.T))
            step = torch.maximum(torch.max(torch.abs(dxp)),
                                 torch.max(torch.abs(dxl)))
            finite = torch.all(torch.isfinite(dxp)) \
                & torch.all(torch.isfinite(dxl))
            if mesh is not None:
                # the landmark term of the gain ratio over every shard
                # (JAX's psum), and the stop test's step and finiteness
                # (pmax / pmin; the MIN as a MAX of the negation, packed):
                # the pose terms too, so that the stop flag is the same on
                # every rank whatever each rank's solve gave
                pred_l, = _all_reduce(mesh, dist.ReduceOp.SUM, pred_l)
                step, not_finite = _all_reduce(
                    mesh, dist.ReduceOp.MAX, step, (~finite).to(step.dtype))
                finite = not_finite == 0
            pred = 0.5 * (torch.sum(dxp * (lam * dxp + bp)) + pred_l)
            rho = (F - blocks_new[0]) / torch.clamp(pred, min=1e-9)
            # a stopped loop's state stays as it was (the fixed trip)
            accept = (rho > 0) & finite & live
            T = torch.where(accept, T_new, T)
            lp = torch.where(accept, lp_new, lp)
            blocks = tuple(torch.where(accept, n, o)
                           for n, o in zip(blocks_new, blocks))
            lam_next = torch.where(
                accept,
                lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0),
                lam * nu)
            nu_next = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
            lam = torch.where(live, lam_next, lam)
            nu = torch.where(live, nu_next, nu)
            n_steps = n_steps + live.to(torch.int32)
            live = live & ~((step < 1e-5) & finite)
        return T, lp, n_steps

    base_active = prob.obs_valid & prob.lm_valid[:, None, None] \
        & prob.kf_valid[None, :, None]
    def total(n):
        """An edge count over the whole problem (every shard's)."""
        if mesh is not None:
            n, = _all_reduce(mesh, dist.ReduceOp.SUM, n)
        return n

    n_act = torch.clamp(total(torch.sum(base_active)), min=1)

    def round_(state):
        """One round on `state` = [poses, landmarks, inlier edges, rounds,
        LM steps, live], returned updated; a round after the ratio flag
        returns it as it was (the fixed trip)."""
        kf_T_cw, lm_pos, inlier_edges, n_rounds, n_steps, live = state
        T_r, lp_r, steps_r = lm_inner(kf_T_cw, lm_pos,
                                      base_active & inlier_edges, iters, live)
        r, _, z_ok = _ba_residuals(prob, T_r, lp_r, fx, fy, cx, cy, bl)
        inl_r = (torch.sum(r * r, dim=-1) < BACKEND_CHI2_TH) \
            & z_ok[..., None]
        ratio = total(torch.sum(inl_r & base_active)) / n_act
        done = ratio > target_inlier_ratio
        if hold is not None:
            done = done & ~hold
        return [torch.where(live, T_r, kf_T_cw),
                torch.where(live, lp_r, lm_pos),
                torch.where(live, inl_r, inlier_edges),
                n_rounds + live.to(torch.int32), n_steps + steps_r,
                live & ~done]

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    state = round_([prob.kf_T_cw, prob.lm_pos,
                    torch.ones_like(prob.obs_valid), zero, zero,
                    torch.ones((), dtype=torch.bool, device=dev)])

    def next_round():
        # round 1's results are new tensors: the rounds after it update
        # them in place, and skip on the device once captured
        for old, new in zip(state, round_(state), strict=True):
            old.copy_(new)

    for _ in range(max_rounds - 1):
        _if_live(state[-1], next_round)
    kf_T_cw, lm_pos, _, n_rounds, n_steps, _ = state

    r, _, z_ok = _ba_residuals(prob, kf_T_cw, lm_pos, fx, fy, cx, cy, bl)
    chi2 = torch.sum(r * r, dim=-1)
    final_inlier = (chi2 < BACKEND_CHI2_TH) & z_ok[..., None]
    ratio = total(torch.sum(final_inlier & base_active)) / n_act
    return LocalBAResult(kf_T_cw, lm_pos, prob.obs_valid & final_inlier, chi2,
                         ratio.to(torch.float32), n_rounds, n_steps)
