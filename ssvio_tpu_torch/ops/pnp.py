"""Batched RANSAC PnP (3D->2D absolute pose), port of
`ssvio_tpu/ops/pnp.py`.

All RANSAC hypotheses run at once: one batched 6-point DLT (a 12x12
eigen-problem per hypothesis, `torch.linalg.eigh` / `svd` / `det` over the
batch), a batched 5-step LM polish of each hypothesis on its own sample
(`ba._lm_loop_6dof_batched`), a dense [hyp, N] reprojection inlier count,
a re-fit of every hypothesis on its inliers, and the 4x10 pose-only LM of
`ops/ba.py` on the best. `pnp_ransac` composes these as stages: the two
DLT fits (`minimal_fit`, `refit`) wait for the device (CUDA's `eigh` and
`svd` check their results on the host); what lies between them
(`sample_indices` on drawn uniforms, `polish_and_score`,
`select_and_refine`) reads nothing from the host, so the loop closer
replays it as CUDA graphs with the same ops.

The samples: the JAX package draws them from a `jax.random` key, whose
numbers a torch generator cannot give. `pnp_ransac` takes a
`torch.Generator`, or the sample indices themselves (`sample_idx`), which
is how the parity tests feed both packages the same hypotheses.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ssvio_tpu_torch.ops import ba, se3


class PnPResult(NamedTuple):
    T_cw: torch.Tensor       # [3, 4]
    inlier: torch.Tensor     # [N] bool
    n_inliers: torch.Tensor  # [] int32
    ok: torch.Tensor         # [] bool: enough inliers to trust the pose


def _dlt_pose(p_w: torch.Tensor, xn: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """Weighted DLT for T_cw from >= 6 3D-2D pairs in normalised image
    coordinates, over a batch of B problems: p_w [B, K, 3] (or [K, 3],
    shared), xn [B, K, 2] (or [K, 2]), w [B, K] weights. Returns T_cw
    [B, 3, 4]. Both point sets are Hartley-normalised first: the minimal
    6-point system is numerically marginal in float32 without it."""
    B, K = w.shape
    dt, dev = p_w.dtype, p_w.device
    p_w = p_w.expand(B, K, 3)
    xn = xn.expand(B, K, 2)
    wsum = torch.clamp(torch.sum(w, dim=1), min=1e-9)             # [B]
    # --- normalise 3D: zero centroid, RMS radius sqrt(3)
    c3 = torch.sum(p_w * w[..., None], dim=1) / wsum[:, None]     # [B, 3]
    Xc = p_w - c3[:, None]
    s3 = torch.sqrt(torch.sum(w * torch.sum(Xc * Xc, dim=-1), dim=1)
                    / wsum / 3.0)
    s3 = torch.clamp(s3, min=1e-9)
    Xn3 = Xc / s3[:, None, None]
    # --- normalise 2D: zero centroid, RMS radius sqrt(2)
    c2 = torch.sum(xn * w[..., None], dim=1) / wsum[:, None]      # [B, 2]
    xc = xn - c2[:, None]
    s2 = torch.sqrt(torch.sum(w * torch.sum(xc * xc, dim=-1), dim=1)
                    / wsum / 2.0)
    s2 = torch.clamp(s2, min=1e-9)
    xn2 = xc / s2[:, None, None]

    X = torch.cat([Xn3, torch.ones((B, K, 1), dtype=dt, device=dev)], dim=-1)
    zero = torch.zeros_like(X)
    # rows: [X 0 -x X ; 0 X -y X]
    r0 = torch.cat([X, zero, -xn2[..., 0:1] * X], dim=-1)         # [B, K, 12]
    r1 = torch.cat([zero, X, -xn2[..., 1:2] * X], dim=-1)
    A = torch.cat([r0 * w[..., None], r1 * w[..., None]], dim=1)  # [B, 2K, 12]
    AtA = A.transpose(-1, -2) @ A
    _, vecs = torch.linalg.eigh(AtA)
    pn = vecs[..., :, 0].reshape(B, 3, 4)
    # denormalise: P = T2^-1 Pn T3, with
    # T2^-1 = [[s2, 0, c2x], [0, s2, c2y], [0, 0, 1]],
    # T3 = [[I / s3, -c3 / s3], [0, 1]]
    T2inv = torch.zeros((B, 3, 3), dtype=dt, device=dev)
    T2inv[:, 0, 0] = s2
    T2inv[:, 1, 1] = s2
    T2inv[:, 0, 2] = c2[:, 0]
    T2inv[:, 1, 2] = c2[:, 1]
    T2inv[:, 2, 2] = 1.0
    T3 = torch.zeros((B, 4, 4), dtype=dt, device=dev)
    T3[:, :3, :3] = torch.eye(3, dtype=dt, device=dev) / s3[:, None, None]
    T3[:, :3, 3] = -c3 / s3[:, None]
    T3[:, 3, 3] = 1.0
    p = T2inv @ pn @ T3
    # the eigenvector is defined up to sign: P = alpha [R | t]. det(M) =
    # alpha^3, so flipping by sign(det) makes the remaining scale positive;
    # only then does the SVD's orthogonalisation recover the rotation.
    M = p[..., :3]
    sgn = torch.where(torch.linalg.det(M) < 0, -1.0, 1.0).to(dt)
    M = M * sgn[:, None, None]
    p4 = p[..., 3] * sgn[:, None]
    u, s, vt = torch.linalg.svd(M)
    det = torch.linalg.det(u @ vt)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    R = (u * d[:, None, :]) @ vt
    scale = torch.clamp(torch.mean(s, dim=-1), min=1e-12)
    return se3.make(R, p4 / scale[:, None])


def draw_uniforms(n_hypotheses: int, n_points: int,
                  generator: Optional[torch.Generator] = None,
                  device=None) -> torch.Tensor:
    """The [n_hypotheses, n_points] float32 uniforms behind
    `sample_indices`, drawn from `generator` (on its device) or from the
    default generator of `device`."""
    gdev = generator.device if generator is not None else device
    return torch.rand((n_hypotheses, n_points), generator=generator,
                      device=gdev, dtype=torch.float32)


def sample_indices(valid: torch.Tensor, n_hypotheses: int, sample_size: int,
                   generator: Optional[torch.Generator] = None,
                   uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[n_hypotheses, sample_size] indices, each row drawn without
    replacement from the valid points (Gumbel top-k, as the JAX package
    draws them; duplicated points would leave the 11-dof DLT
    underdetermined). Invalid points fill a row only where fewer than
    sample_size are valid. The uniforms are `uniforms` where given (what
    `draw_uniforms` drew: then nothing here reads the host or a
    generator, so a CUDA graph can hold it), else drawn from `generator`."""
    if uniforms is None:
        uniforms = draw_uniforms(n_hypotheses, valid.shape[0], generator,
                                 valid.device)
    u = uniforms.to(valid.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, 1e-20, 1.0 - 1e-7)))
    logits = torch.where(valid, 0.0, -1e9).to(torch.float32)
    return torch.topk(gumbel + logits[None, :], sample_size, dim=1).indices


# ---------------------------------------------------------------------------
# the stages pnp_ransac composes (module docstring)
# ---------------------------------------------------------------------------

def normalized(uv: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """uv [N, 2] pixels -> [N, 2] normalised image coordinates."""
    return torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], dim=-1)


def _ones(idx: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return torch.ones(idx.shape, dtype=like.dtype, device=like.device)


def minimal_fit(p_w: torch.Tensor, xn: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """The 6-point DLT of every hypothesis' sample (idx [H, S]): [H, 3, 4].
    Reads the host."""
    return _dlt_pose(p_w[idx], xn[idx], _ones(idx, p_w))


def _score(T, p_w, uv, valid, fx, fy, cx, cy, reproj_threshold):
    """Each pose's inliers [H, N] and their count [H] (-1 for a pose that
    is not finite)."""
    r, _, z_ok = ba.reproject_residual(T[:, None], p_w[None], uv[None],
                                       fx, fy, cx, cy)
    err2 = torch.sum(r * r, dim=-1)                           # [H, N]
    inl = (err2 < reproj_threshold ** 2) & z_ok & valid[None]
    finite = torch.all(torch.isfinite(T.reshape(T.shape[0], -1)), dim=1)
    n = torch.sum(inl, dim=1)
    return inl, torch.where(finite, n, torch.full_like(n, -1))


def polish_and_score(T_dlt, p_w, uv, valid, idx, fx, fy, cx, cy,
                     reproj_threshold: float):
    """The 5-step LM polish of each hypothesis on its own sample, its
    inliers and score, and the LO re-fit's weights. Returns (T_hyp
    [H, 3, 4], inl [H, N], scores [H], w_lo [H, N]). No host read."""
    # Gauss-Newton polish of each hypothesis on its own sample points: the
    # raw minimal DLT amplifies pixel noise badly; a few LM steps on the 6
    # points recover it
    T_hyp = ba._lm_loop_6dof_batched(T_dlt, p_w[idx], uv[idx],
                                     _ones(idx, p_w), fx, fy, cx, cy, 5)
    inl, scores = _score(T_hyp, p_w, uv, valid, fx, fy, cx, cy,
                         reproj_threshold)
    # LO-RANSAC: every hypothesis is re-fitted on all of its inliers
    # (refit, a non-minimal weighted DLT, still one batched pass)
    w_lo = inl.to(p_w.dtype) * (scores >= idx.shape[1])[:, None]
    return T_hyp, inl, scores, w_lo


def refit(p_w: torch.Tensor, xn: torch.Tensor,
          w_lo: torch.Tensor) -> torch.Tensor:
    """The LO re-fit: each hypothesis' weighted DLT on its inliers, [H, 3,
    4]. Reads the host."""
    return _dlt_pose(p_w, xn, w_lo)


def select_and_refine(T_lo, T_hyp, inl, scores, p_w, uv, valid, fx, fy, cx,
                      cy, reproj_threshold: float, min_inliers: int,
                      sample_size: int) -> PnPResult:
    """Each hypothesis keeps whichever of its pose and its re-fit scores
    better; the best is refined on its inliers by the 4x10 pose-only LM.
    No host read: the best is taken with index_select, which gives the
    bits indexing by it would."""
    inl_lo, scores_lo = _score(T_lo, p_w, uv, valid, fx, fy, cx, cy,
                               reproj_threshold)
    better = scores_lo > scores
    T_all = torch.where(better[:, None, None], T_lo, T_hyp)
    inl = torch.where(better[:, None], inl_lo, inl)
    scores = torch.maximum(scores, scores_lo)

    best = torch.argmax(scores).reshape(1)
    res = ba.pose_only_optimize(T_all.index_select(0, best)[0], p_w, uv,
                                inl.index_select(0, best)[0], fx, fy, cx, cy)
    ok = ((res.n_inliers >= min_inliers)
          & (scores.index_select(0, best)[0] >= sample_size))
    return PnPResult(res.T_cw, res.inlier, res.n_inliers, ok)


def pnp_ransac(p_w: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
               fx, fy, cx, cy, generator: Optional[torch.Generator] = None,
               n_hypotheses: int = 128, sample_size: int = 6,
               reproj_threshold: float = 5.991, min_inliers: int = 10,
               sample_idx: Optional[torch.Tensor] = None) -> PnPResult:
    """RANSAC + DLT + pose-only-LM refinement. p_w [N, 3], uv [N, 2], valid
    [N]. The hypotheses' samples come from `sample_idx` ([n_hypotheses,
    sample_size] integer indices into the points) where given, else from
    `generator` (the default generator of the points' device if None).
    `min_inliers` mirrors the reference's >= 10 gate. The stages above,
    op by op."""
    xn = normalized(uv, fx, fy, cx, cy)
    if sample_idx is None:
        idx = sample_indices(valid, n_hypotheses, sample_size, generator)
    else:
        idx = sample_idx.to(p_w.device).long()
        sample_size = idx.shape[1]
    T_hyp, inl, scores, w_lo = polish_and_score(
        minimal_fit(p_w, xn, idx), p_w, uv, valid, idx, fx, fy, cx, cy,
        reproj_threshold)
    return select_and_refine(refit(p_w, xn, w_lo), T_hyp, inl, scores, p_w,
                             uv, valid, fx, fy, cx, cy, reproj_threshold,
                             min_inliers, sample_size)
