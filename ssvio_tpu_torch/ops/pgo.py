"""Pose-graph optimization (PGO), batched over SE3 edges (port of
`ssvio_tpu/ops/pgo.py`).

All keyframes are SE3 vertices; odometry edges (relative pose to the
previous keyframe) and loop edges carry the residual `log(Z^-1 X_i
X_j^-1)`; fixed vertices are held, and ~20 LM iterations run. Edges live
in flat tensors (i, j, Z, valid); residuals and first-order SE3 Jacobians
are one batched pass. The Gauss-Newton normal system is solved dense
(jittered Cholesky on the [6P, 6P] block matrix) up to DENSE_MAX_POSES
poses and with matrix-free Jacobi-preconditioned CG beyond (O(E) memory
per matvec).

Jacobians use the second-order inverse-left-Jacobian approximation:
J0 = Jl^-1(r) Ad(Z^-1), J1 = -Jr^-1(r), with Jl^-1(xi) ~ I - 0.5 ad(xi)
+ (1/12) ad(xi)^2.

Nothing here reads the host inside a loop: the LM steps are a fixed loop
whose accept/reject is a `torch.where`, as the JAX package's `fori_loop`
is, and the CG freezes its state with `torch.where` once converged (the
state a `while_loop` leaves) and reads its stop flag once every
CG_CHECK_EVERY iterations, only to leave the loop early. A Cholesky
factorisation that fails (`cholesky_ex`'s info) rejects the step, as the
NaNs of `cho_factor` do in the JAX package. The scatter-adds
(`index_put_(accumulate=True)`, `index_add_`) run as atomics on the card,
so their float order varies from run to run there.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ssvio_tpu_torch.ops import se3


def se3_ad(xi: torch.Tensor) -> torch.Tensor:
    """adjoint (little ad) of a twist [..., 6] -> [..., 6, 6] for
    [rho, phi] ordering: [[hat(phi), hat(rho)], [0, hat(phi)]]."""
    rho, phi = xi[..., :3], xi[..., 3:]
    hp = se3.hat(phi)
    hr = se3.hat(rho)
    top = torch.cat([hp, hr], dim=-1)
    bot = torch.cat([torch.zeros_like(hp), hp], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _jl_inv(xi: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian of SE3, 2nd-order series. [..., 6] ->
    [..., 6, 6]."""
    a = se3_ad(xi)
    eye = torch.eye(6, dtype=xi.dtype, device=xi.device)
    return eye - 0.5 * a + (1.0 / 12.0) * (a @ a)


def _jr_inv(xi: torch.Tensor) -> torch.Tensor:
    a = se3_ad(xi)
    eye = torch.eye(6, dtype=xi.dtype, device=xi.device)
    return eye + 0.5 * a + (1.0 / 12.0) * (a @ a)


class PGOProblem(NamedTuple):
    poses: torch.Tensor       # [P, 3, 4] T_cw per keyframe slot
    pose_valid: torch.Tensor  # [P] bool
    pose_fixed: torch.Tensor  # [P] bool (active window + loop KF + first KF)
    edge_i: torch.Tensor      # [E] int32 vertex 0
    edge_j: torch.Tensor      # [E] int32 vertex 1
    edge_Z: torch.Tensor      # [E, 3, 4] measured T_cwi * T_cwj^-1
    edge_valid: torch.Tensor  # [E] bool
    edge_weight: torch.Tensor  # [E] float (information scale; 1.0 typical)


def _edge_residuals(poses, prob: PGOProblem):
    Xi = poses[prob.edge_i.long()]
    Xj = poses[prob.edge_j.long()]
    A = se3.compose(se3.compose(se3.inverse(prob.edge_Z), Xi), se3.inverse(Xj))
    return se3.log(A)                               # [E, 6]


def _linearize_edges(poses, prob: PGOProblem, free_mask):
    """Per-edge linearization shared by the dense and CG solvers.

    Returns (r [E,6], w [E], J0 [E,6,6], J1 [E,6,6], b [P,6], F) with
    fixed vertices' Jacobian blocks zeroed."""
    P = poses.shape[0]
    ei, ej = prob.edge_i.long(), prob.edge_j.long()
    r = _edge_residuals(poses, prob)
    # non-finite residuals (e.g. a degenerate edge whose rotation lands on
    # the log-map branch cut) must not poison the whole solve: one NaN in F
    # makes every LM step rejected and PGO returns its input
    r_ok = torch.all(torch.isfinite(r), dim=-1)
    r = torch.where(r_ok[:, None], r, torch.zeros_like(r))
    w = (prob.edge_valid & r_ok & prob.pose_valid[ei]
         & prob.pose_valid[ej]).to(poses.dtype) * prob.edge_weight
    # Huber weight on the edge residual norm (delta = 1.0 over the mixed
    # m / rad residual, as the JAX package has it): bounds a bad edge's
    # pull on the graph
    rn = torch.sqrt(torch.sum(r * r, dim=-1) + 1e-12)
    delta = 1.0
    w = w * torch.where(rn <= delta, torch.ones_like(rn), delta / rn)
    F = torch.sum(w * torch.sum(r * r, dim=-1))
    J0 = _jl_inv(r) @ se3.adjoint(se3.inverse(prob.edge_Z))     # [E, 6, 6]
    J1 = -_jr_inv(r)
    J0 = J0 * free_mask[ei][:, None, None]
    J1 = J1 * free_mask[ej][:, None, None]
    b0 = -torch.einsum("eba,eb->ea", J0, r * w[:, None])
    b1 = -torch.einsum("eba,eb->ea", J1, r * w[:, None])
    b = torch.zeros((P, 6), dtype=poses.dtype, device=poses.device)
    b.index_add_(0, ei, b0)
    b.index_add_(0, ej, b1)
    return r, w, J0, J1, b, F


def _build_normal_system(poses, prob: PGOProblem, free_mask):
    """Returns (H [P,P,6,6] dense, b [P,6], F cost)."""
    P = poses.shape[0]
    ei, ej = prob.edge_i.long(), prob.edge_j.long()
    _, w, J0, J1, b, F = _linearize_edges(poses, prob, free_mask)
    we = w[:, None, None]
    J0t, J1t = J0.transpose(-1, -2), J1.transpose(-1, -2)
    H00 = J0t @ J0 * we                             # [E, 6, 6]
    H11 = J1t @ J1 * we
    H01 = J0t @ J1 * we
    H = torch.zeros((P, P, 6, 6), dtype=poses.dtype, device=poses.device)
    H.index_put_((ei, ei), H00, accumulate=True)
    H.index_put_((ej, ej), H11, accumulate=True)
    H.index_put_((ei, ej), H01, accumulate=True)
    H.index_put_((ej, ei), H01.transpose(-1, -2), accumulate=True)
    return H, b, F


# above this pose count the dense [6P, 6P] factorization (P^2 * 36 floats:
# ~600 MB at P=2048) gives way to the matrix-free CG solver
DENSE_MAX_POSES = 512
CG_CHECK_EVERY = 32     # CG iterations between host reads of the stop flag


def optimize(prob: PGOProblem, iters: int = 20) -> torch.Tensor:
    """LM pose-graph optimization. Returns optimized poses [P, 3, 4]:
    dense Cholesky on the [6P, 6P] normal system up to DENSE_MAX_POSES,
    matrix-free Jacobi-block-preconditioned CG beyond."""
    if prob.poses.shape[0] <= DENSE_MAX_POSES:
        return _optimize_dense(prob, iters=iters)
    return _optimize_cg(prob, iters=iters)


def _lm_update(poses, poses_new, lam, nu, dx, rhs, F, F_new, solved=None):
    """The gain-ratio accept/reject of one LM step and g2o's lambda
    schedule. `solved`: a bool tensor, False where the linear solve
    reported a failure."""
    dxf = dx.reshape(-1)
    pred = 0.5 * torch.sum(dxf * (lam * dxf + rhs.reshape(-1)))
    rho = (F - F_new) / torch.clamp(pred, min=1e-12)
    accept = (rho > 0) & torch.all(torch.isfinite(dx))
    if solved is not None:
        accept = accept & solved
    poses = torch.where(accept, poses_new, poses)
    lam = torch.where(
        accept,
        lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0),
        lam * nu)
    nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
    return poses, lam, nu


def _optimize_dense(prob: PGOProblem, iters: int = 20) -> torch.Tensor:
    P = prob.poses.shape[0]
    dt, dev = prob.poses.dtype, prob.poses.device
    free = (prob.pose_valid & ~prob.pose_fixed).to(dt)
    freev = free.repeat_interleave(6)
    mask = freev[:, None] * freev[None, :]
    eye = torch.eye(P * 6, dtype=dt, device=dev)

    H0, _, _ = _build_normal_system(prob.poses, prob, free)
    diag0 = torch.abs(torch.einsum("ppii->pi", H0))
    lam = 1e-5 * torch.max(diag0) + 1e-8
    nu = torch.tensor(2.0, dtype=dt, device=dev)
    poses = prob.poses
    for _ in range(iters):
        H, b, F = _build_normal_system(poses, prob, free)
        Hd = H.permute(0, 2, 1, 3).reshape(P * 6, P * 6) * mask
        Hd = Hd + torch.diag(torch.where(freev > 0, lam, torch.ones_like(lam)))
        rhs = b.reshape(-1) * freev
        L, info = torch.linalg.cholesky_ex(Hd + 1e-8 * eye)
        dx = torch.cholesky_solve(rhs[:, None], L)[:, 0].reshape(P, 6)
        dx = dx * free[:, None]
        poses_new = se3.compose(se3.exp(dx), poses)
        _, _, F_new = _build_normal_system(poses_new, prob, free)
        poses, lam, nu = _lm_update(poses, poses_new, lam, nu, dx, rhs, F,
                                    F_new, info == 0)
    return poses


def _optimize_cg(prob: PGOProblem, iters: int = 20,
                 cg_iters: Optional[int] = None) -> torch.Tensor:
    """Large-P LM via matrix-free preconditioned CG.

    Never materializes H: each CG matvec is two gathers, two batched 6x6
    products and two scatter-adds over the edge list (O(E) memory).
    Preconditioner: the per-pose Jacobi 6x6 blocks (batched inverse).
    Information on a chain graph travels one vertex per CG step, so the
    iteration cap defaults to 2P, with an exit on the relative residual."""
    P = prob.poses.shape[0]
    if cg_iters is None:
        cg_iters = 2 * P
    dt, dev = prob.poses.dtype, prob.poses.device
    free = (prob.pose_valid & ~prob.pose_fixed).to(dt)
    ei, ej = prob.edge_i.long(), prob.edge_j.long()
    eye6 = torch.eye(6, dtype=dt, device=dev)

    def solve(J0, J1, w, lam, Minv, rhs):
        def matvec(v):
            u = (torch.einsum("eab,eb->ea", J0, v[ei])
                 + torch.einsum("eab,eb->ea", J1, v[ej])) * w[:, None]
            out = torch.zeros_like(v)
            out.index_add_(0, ei, torch.einsum("eba,eb->ea", J0, u))
            out.index_add_(0, ej, torch.einsum("eba,eb->ea", J1, u))
            return (out + lam * v) * free[:, None]

        def prec(v):
            return torch.einsum("pab,pb->pa", Minv, v) * free[:, None]

        x = torch.zeros_like(rhs)
        r = rhs                        # x0 = 0
        p = prec(r)
        rz = torch.sum(r * p)
        tol2 = 1e-10 * torch.clamp(rz, min=1e-30)
        for k in range(cg_iters):
            if k and k % CG_CHECK_EVERY == 0 and not bool(rz > tol2):
                break
            live = rz > tol2
            Ap = matvec(p)
            alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-30)
            x = torch.where(live, x + alpha * p, x)
            r = torch.where(live, r - alpha * Ap, r)
            z = prec(r)
            rz_new = torch.sum(r * z)
            p = torch.where(live,
                            z + (rz_new / torch.clamp(rz, min=1e-30)) * p, p)
            rz = torch.where(live, rz_new, rz)
        return x

    def linearize(poses):
        _, w, J0, J1, b, F = _linearize_edges(poses, prob, free)
        D = torch.zeros((P, 6, 6), dtype=dt, device=dev)
        we = w[:, None, None]
        D.index_add_(0, ei, J0.transpose(-1, -2) @ J0 * we)
        D.index_add_(0, ej, J1.transpose(-1, -2) @ J1 * we)
        return w, J0, J1, b, F, D

    D0 = linearize(prob.poses)[5]
    diag0 = torch.abs(torch.einsum("pii->pi", D0))
    lam = 1e-5 * torch.max(diag0) + 1e-8
    nu = torch.tensor(2.0, dtype=dt, device=dev)
    poses = prob.poses
    for _ in range(iters):
        w, J0, J1, b, F, D = linearize(poses)
        Minv = torch.linalg.inv_ex(D + (lam + 1e-8) * eye6[None])[0]
        rhs = b * free[:, None]
        dx = solve(J0, J1, w, lam, Minv, rhs) * free[:, None]
        poses_new = se3.compose(se3.exp(dx), poses)
        F_new = linearize(poses_new)[4]
        poses, lam, nu = _lm_update(poses, poses_new, lam, nu, dx, rhs, F,
                                    F_new)
    return poses


def make_odometry_edges(poses: torch.Tensor, n_valid, capacity: int):
    """Consecutive-keyframe odometry edges from current pose estimates
    (callers should pass the relative poses recorded at keyframe creation
    instead where they have them). Returns (i, j, Z, valid)."""
    P = poses.shape[0]
    idx = torch.arange(capacity, dtype=torch.int32, device=poses.device)
    i = torch.clamp(idx + 1, max=P - 1)
    j = idx
    # slots past the last pose read it (their edges are invalid), as an
    # out-of-range gather does in the JAX package
    Z = se3.compose(poses[i.long()],
                    se3.inverse(poses[torch.clamp(j, max=P - 1).long()]))
    valid = (idx + 1) < n_valid
    return i, j, Z, valid
