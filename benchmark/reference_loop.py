"""The plain reference of a loop correction: the pose graph's robust cost
and its optimum, and the rigid correction of the active window, worked
out with plain torch operations in float64 from the inputs of each
problem.

- `pgo_cost(problem, poses)`: the robust cost of a pose graph shaped as
  the program's `PGOProblem` (keyframe poses T_cw [P, 3, 4], their valid
  and fixed flags, edges i, j with their measurement Z [E, 3, 4], valid
  flags and weights). An edge's residual is r = log(Z^-1 X_i X_j^-1), the
  twist [rho, phi] of SE3's log; its cost is weight * huber(|r|^2) with
  the Huber threshold at |r| = 1.0.
- `pgo_solve(problem)`: the optimum of that cost over the valid vertices
  that are not fixed, by a dense Levenberg-Marquardt run to convergence
  from the problem's own poses (each step a left perturbation
  X <- exp(dx) X), with the exact Jacobians of the residual.
- `correct_active(kf_pose, lm_pos, lm_valid, C)`: the active window moved
  rigidly by the correction C: every keyframe pose T_cw -> T_cw C, every
  valid landmark p -> C^-1 p, the others as they were.

Where this departs from the published description of the system this
repository ports (`loopclosing.cpp:378-594`, LoopCorrect,
CorrectActivateKeyframeAndMappoint and PoseGraphOptimization):
- The published PGO runs g2o's LM for 20 iterations with no robust
  kernel. Here, as in the program, every edge carries a Huber kernel with
  a fixed threshold of 1.0 over the mixed metre / radian residual (a
  defect of the JAX package that the program keeps), and the solve runs
  to convergence: the reference is the optimum of the cost the program
  minimises, not a copy of its trip.
- g2o's pose-graph edge (and the program's) linearises with the
  second-order series of SE3's inverse Jacobians; here they are exact.
  The optimum is the same; only the path to it differs.
- The published correction re-anchors each active landmark through the
  keyframe that first observed it; here, as in the program, every valid
  landmark of the active map moves by C^-1. The two agree wherever the
  first observer is in the window, which holds for every landmark the
  program's active map holds.
- Map fusion is a discrete match-and-merge with no optimum to compare
  with; it is judged by the counts the program's loop tests hold.

The same solve in float32 with every matrix product in TF32
(`reference.precision("tf32")`) is the control that a check of the
program's PGO must fail.

Imports torch only: no module of the program under test and no JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark import reference as ref

F64 = torch.float64
HUBER_DELTA = 1.0        # on |r|, the program's fixed threshold


class PGOReference(NamedTuple):
    poses: torch.Tensor      # [P, 3, 4] the optimum
    cost: float              # its cost, float64
    iterations: int          # LM steps taken
    converged: bool


# ------------------------------------------------------------------ SE3
def _rot(T):
    return T[..., :3, :3]


def _trans(T):
    return T[..., :3, 3]


def _make(R, t):
    return torch.cat([R, t[..., None]], dim=-1)


def compose(A, B):
    """A B of [..., 3, 4] poses."""
    RA, RB = _rot(A), _rot(B)
    return _make(ref.mm(RA, RB),
                 ref.mm(RA, _trans(B)[..., None])[..., 0] + _trans(A))


def inverse(T):
    Rt = _rot(T).transpose(-1, -2)
    return _make(Rt, -ref.mm(Rt, _trans(T)[..., None])[..., 0])


def _coef(theta2, exact, series):
    """A scalar function of theta per pose, in float64 whatever the
    working precision (its closed form cancels near 0): `exact(theta)`
    above 1e-2 rad, else `series(theta^2)`."""
    t2 = theta2.to(F64)
    small = t2 < 1e-4
    th = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    return torch.where(small, series(t2), exact(th)).to(theta2.dtype)


def so3_log(R):
    """The rotation vector of R [..., 3, 3], through its unit quaternion
    (well conditioned at every angle up to pi)."""
    m = R
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    cands = torch.stack([1.0 + tr, 1.0 + m[..., 0, 0] - m[..., 1, 1]
                         - m[..., 2, 2], 1.0 - m[..., 0, 0] + m[..., 1, 1]
                         - m[..., 2, 2], 1.0 - m[..., 0, 0] - m[..., 1, 1]
                         + m[..., 2, 2]], dim=-1)
    k = torch.argmax(cands, dim=-1)
    s = [2.0 * torch.sqrt(torch.clamp(cands[..., i], min=1e-30))
         for i in range(4)]
    qw = torch.stack([s[0] / 4, (m[..., 2, 1] - m[..., 1, 2]) / s[0],
                      (m[..., 0, 2] - m[..., 2, 0]) / s[0],
                      (m[..., 1, 0] - m[..., 0, 1]) / s[0]], -1)
    qx = torch.stack([(m[..., 2, 1] - m[..., 1, 2]) / s[1], s[1] / 4,
                      (m[..., 0, 1] + m[..., 1, 0]) / s[1],
                      (m[..., 0, 2] + m[..., 2, 0]) / s[1]], -1)
    qy = torch.stack([(m[..., 0, 2] - m[..., 2, 0]) / s[2],
                      (m[..., 0, 1] + m[..., 1, 0]) / s[2], s[2] / 4,
                      (m[..., 1, 2] + m[..., 2, 1]) / s[2]], -1)
    qz = torch.stack([(m[..., 1, 0] - m[..., 0, 1]) / s[3],
                      (m[..., 0, 2] + m[..., 2, 0]) / s[3],
                      (m[..., 1, 2] + m[..., 2, 1]) / s[3], s[3] / 4], -1)
    q = torch.stack([qw, qx, qy, qz], dim=-2)
    q = torch.take_along_dim(q, k[..., None, None].expand(
        *k.shape, 1, 4), dim=-2)[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)       # w >= 0: angle <= pi
    w, v = q[..., 0], q[..., 1:]
    vn = torch.linalg.norm(v, dim=-1)
    theta = 2.0 * torch.atan2(vn, w)
    scale = torch.where(vn > 1e-12, theta / torch.clamp(vn, min=1e-30),
                        2.0 / torch.clamp(w, min=1e-30))
    return v * scale[..., None]


def _jl(phi):
    """SO3's left Jacobian [..., 3, 3]."""
    t2 = (phi * phi).sum(-1)
    a = _coef(t2, lambda t: (1 - torch.cos(t)) / t ** 2,
              lambda t2: 0.5 - t2 / 24)
    b = _coef(t2, lambda t: (t - torch.sin(t)) / t ** 3,
              lambda t2: 1.0 / 6 - t2 / 120)
    K = ref.hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + a[..., None, None] * K + b[..., None, None] * ref.mm(K, K)


def _jl_inv(phi):
    """SO3's inverse left Jacobian [..., 3, 3]."""
    t2 = (phi * phi).sum(-1)
    c = _coef(t2, lambda t: 1 / t ** 2 - (1 + torch.cos(t))
              / (2 * t * torch.sin(t)), lambda t2: 1.0 / 12 + t2 / 720)
    K = ref.hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye - 0.5 * K + c[..., None, None] * ref.mm(K, K)


def se3_exp(xi):
    """[..., 6] = [rho, phi] -> [..., 3, 4]."""
    rho, phi = xi[..., :3], xi[..., 3:]
    return _make(ref.so3_exp(phi), ref.mm(_jl(phi), rho[..., None])[..., 0])


def se3_log(T):
    """[..., 3, 4] -> [..., 6] = [rho, phi]."""
    phi = so3_log(_rot(T))
    rho = ref.mm(_jl_inv(phi), _trans(T)[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def _q(rho, phi):
    """The translational block of SE3's left Jacobian (Barfoot's Q)."""
    t2 = (phi * phi).sum(-1)
    c1 = _coef(t2, lambda t: (t - torch.sin(t)) / t ** 3,
               lambda t2: 1.0 / 6 - t2 / 120)
    c2 = _coef(t2, lambda t: (t * t + 2 * torch.cos(t) - 2) / (2 * t ** 4),
               lambda t2: 1.0 / 24 - t2 / 720)
    c3 = _coef(t2, lambda t: (2 * t - 3 * torch.sin(t) + t * torch.cos(t))
               / (2 * t ** 5), lambda t2: 1.0 / 120 - t2 / 2520)
    P, Rh = ref.hat(phi), ref.hat(rho)
    PR, RP = ref.mm(P, Rh), ref.mm(Rh, P)
    PRP = ref.mm(PR, P)
    PP = ref.mm(P, P)
    m1 = PR + RP + PRP
    m2 = ref.mm(PP, Rh) + ref.mm(RP, P) - 3 * PRP
    m3 = ref.mm(PRP, P) + ref.mm(PP, ref.mm(Rh, P))
    x = lambda c: c[..., None, None]      # noqa: E731
    return 0.5 * Rh + x(c1) * m1 + x(c2) * m2 + x(c3) * m3


def se3_jl_inv(xi):
    """SE3's inverse left Jacobian [..., 6, 6] for [rho, phi]:
    [[J^-1, -J^-1 Q J^-1], [0, J^-1]]."""
    rho, phi = xi[..., :3], xi[..., 3:]
    Ji = _jl_inv(phi)
    top = torch.cat([Ji, -ref.mm(ref.mm(Ji, _q(rho, phi)), Ji)], dim=-1)
    bot = torch.cat([torch.zeros_like(Ji), Ji], dim=-1)
    return torch.cat([top, bot], dim=-2)


def adjoint(T):
    """[[R, hat(t) R], [0, R]] for [rho, phi]."""
    R, t = _rot(T), _trans(T)
    top = torch.cat([R, ref.mm(ref.hat(t), R)], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


# ------------------------------------------------------------------ PGO
def _as(problem, dtype, device):
    """The problem's tensors: poses and measurements in `dtype`, indices
    long, flags bool, on `device`."""
    g = lambda x: torch.as_tensor(x).to(device)      # noqa: E731
    return dict(poses=g(problem.poses).to(dtype),
                valid=g(problem.pose_valid).bool(),
                fixed=g(problem.pose_fixed).bool(),
                i=g(problem.edge_i).long(), j=g(problem.edge_j).long(),
                Z=g(problem.edge_Z).to(dtype),
                ev=g(problem.edge_valid).bool(),
                w=g(problem.edge_weight).to(dtype))


def _weights(p):
    """Each edge's weight; 0 for an invalid edge or one that touches an
    invalid vertex."""
    ok = p["ev"] & p["valid"][p["i"]] & p["valid"][p["j"]]
    return torch.where(ok, p["w"], torch.zeros_like(p["w"]))


def _residuals(p, poses):
    Xi, Xj = poses[p["i"]], poses[p["j"]]
    return se3_log(compose(compose(inverse(p["Z"]), Xi), inverse(Xj)))


def _huber(s):
    return ref.huber(s, HUBER_DELTA ** 2)


def _cost(p, poses) -> torch.Tensor:
    r = _residuals(p, poses)
    return torch.sum(_weights(p) * _huber((r * r).sum(-1)))


def nearest_rigid(T):
    """[..., 3, 4] poses with each rotation block replaced by the nearest
    rotation (SVD): a float32 pose is a rigid motion only to its
    rounding, and a cost read through SE3's log must not profit from
    that."""
    T = torch.as_tensor(T).to(F64)
    u, _, vt = torch.linalg.svd(_rot(T))
    d = torch.linalg.det(u @ vt)
    u = torch.cat([u[..., :2], u[..., 2:] * d[..., None, None]], dim=-1)
    return _make(u @ vt, _trans(T))


def pgo_cost(problem, poses) -> float:
    """The robust cost of `problem` at `poses` [P, 3, 4] (their rotations
    made rigid, `nearest_rigid`), in float64."""
    dev = torch.as_tensor(poses).device
    p = _as(problem, F64, dev)
    return float(_cost(p, nearest_rigid(poses).to(dev)))


def pgo_solve(problem, max_iters: int = 200, device=None) -> PGOReference:
    """The optimum of `problem`'s robust cost over its valid, not fixed
    vertices: dense Levenberg-Marquardt from the problem's poses, in the
    working precision of `reference.precision` (float64 by default,
    float32 with TF32 products under precision("tf32")), until a step
    changes the cost by less than 1e-15 of it (1e-7 in float32) twice in
    a row, or no step is accepted at the largest damping."""
    dtype = torch.float32 if ref._TF32[0] else F64
    dev = device or torch.as_tensor(problem.poses).device
    p = _as(problem, dtype, dev)
    poses = nearest_rigid(p["poses"]).to(dtype)
    P = poses.shape[0]
    free = (p["valid"] & ~p["fixed"]).to(dtype)
    freev = free.repeat_interleave(6)
    w_e = _weights(p)
    Ad = adjoint(inverse(p["Z"]))
    tol = 1e-15 if dtype == F64 else 1e-7
    cost = _cost(p, poses)
    lam, calm, it = None, 0, 0
    converged = False
    for it in range(1, max_iters + 1):
        r = _residuals(p, poses)
        s = (r * r).sum(-1)
        # d huber / d s: the IRLS weight of each edge
        psi = ref.huber_weight(s, HUBER_DELTA ** 2) * w_e
        J0 = ref.mm(se3_jl_inv(r), Ad) * free[p["i"]][:, None, None]
        J1 = -se3_jl_inv(-r) * free[p["j"]][:, None, None]
        H = torch.zeros((P, P, 6, 6), dtype=dtype, device=dev)
        g = torch.zeros((P, 6), dtype=dtype, device=dev)
        pw = psi[:, None, None]
        J0t, J1t = J0.transpose(-1, -2), J1.transpose(-1, -2)
        H.index_put_((p["i"], p["i"]), ref.mm(J0t, J0) * pw, accumulate=True)
        H.index_put_((p["j"], p["j"]), ref.mm(J1t, J1) * pw, accumulate=True)
        H01 = ref.mm(J0t, J1) * pw
        H.index_put_((p["i"], p["j"]), H01, accumulate=True)
        H.index_put_((p["j"], p["i"]), H01.transpose(-1, -2),
                     accumulate=True)
        g.index_add_(0, p["i"], ref.mm(J0t, (psi[:, None] * r)[..., None])
                     [..., 0])
        g.index_add_(0, p["j"], ref.mm(J1t, (psi[:, None] * r)[..., None])
                     [..., 0])
        Hd = H.permute(0, 2, 1, 3).reshape(6 * P, 6 * P)
        Hd = Hd * freev[:, None] * freev[None, :] + torch.diag(1.0 - freev)
        rhs = -g.reshape(-1) * freev
        diag = torch.diagonal(Hd).clone()
        if lam is None:
            lam = 1e-6 * float(torch.max(diag * freev).clamp_min(1e-12))
        accepted = False
        while lam < 1e12:
            A = Hd + torch.diag(lam * torch.clamp(diag, min=1e-9) * freev)
            L, info = torch.linalg.cholesky_ex(A)
            if int(info) == 0:
                dx = torch.cholesky_solve(rhs[:, None], L)[:, 0]
                dx = (dx * freev).reshape(P, 6)
                # the fixed vertices are carried as they are: composed
                # with exp(0) in TF32 they would be rounded at every step
                trial = torch.where(free[:, None, None] > 0,
                                    compose(se3_exp(dx), poses), poses)
                c_new = _cost(p, trial)
                if bool(torch.isfinite(c_new)) and c_new <= cost:
                    accepted = True
                    break
            lam *= 10.0
        if not accepted:
            converged = True       # no step lowers the cost
            break
        drop = float(cost - c_new)
        poses, cost = trial, c_new
        lam = max(lam / 10.0, 1e-12)
        calm = calm + 1 if drop <= tol * max(float(cost), 1e-300) else 0
        if calm >= 2:
            converged = True
            break
    poses64 = nearest_rigid(poses)
    return PGOReference(poses=poses64,
                        cost=float(_cost(_as(problem, F64, dev), poses64)),
                        iterations=it, converged=converged)


# ------------------------------------------------------ active correction
def correct_active(kf_pose, lm_pos, lm_valid, C):
    """The active window moved rigidly by C [3, 4]: kf_pose [W, 3, 4] ->
    kf_pose C, and each valid landmark of lm_pos [M, 3] -> C^-1 p (the
    others unchanged). float64."""
    kf = torch.as_tensor(kf_pose).to(F64)
    lm = torch.as_tensor(lm_pos).to(F64)
    C = torch.as_tensor(C).to(F64)
    kf_new = compose(kf, C.expand(kf.shape))
    Ci = inverse(C)
    moved = lm @ _rot(Ci).T + _trans(Ci)
    lm_new = torch.where(torch.as_tensor(lm_valid).bool()[:, None], moved,
                         lm)
    return kf_new, lm_new
