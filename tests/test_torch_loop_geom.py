"""Parity of the port's loop-closing geometry with ssvio_tpu: batched
PnP-RANSAC (ops/pnp.py) and pose-graph optimization (ops/pgo.py). The
descriptor and vocabulary ops are in test_torch_loop_ops.py.

The scenes are those of tests/test_pnp.py and tests/test_pgo.py, each from
its own seed, fed to both packages. PnP's hypotheses are samples drawn
from a `jax.random` key, which a torch generator cannot repeat: the tests
draw the indices with JAX exactly as `ssvio_tpu/ops/pnp.py` does and hand
them to the port through `sample_idx`. Hypotheses are not compared one by
one (an eigenvector's sign and a near-degenerate 12x12 system differ
between LAPACK builds); the result is. Tolerances are stated where used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssvio_tpu.ops import ba as ba_j
from ssvio_tpu.ops import pgo as pgo_j
from ssvio_tpu.ops import pnp as pnp_j
from ssvio_tpu.ops import se3 as se3_j
from ssvio_tpu_torch import interop
from ssvio_tpu_torch.ops import ba as ba_t
from ssvio_tpu_torch.ops import pgo as pgo_t
from ssvio_tpu_torch.ops import pnp as pnp_t
from test_pgo import ate, build_problem, make_circle_graph
from test_pnp import CX, CY, FX, FY, make_scene, pose_err
from test_torch_ba import _twist_err
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

# pnp_ransac's pose after the 4x10 LM on the same inliers: both sides
# converge to the minimum of one cost, from float32 iterates that differ in
# summation order. Twist norm of T_port T_jax^-1 (rad and m); measured
# 1.2e-6 (exact scene) and 9e-7 (outliers).
PNP_POSE_TOL = 1e-3
# dense PGO, elementwise on [R | t]: the same 20 LM steps on Cholesky
# solves of the same system; measured 2.1e-5
PGO_DENSE_TOL = 1e-4
# CG against the JAX package's CG: two iterative solves stopped by a
# relative residual; measured 3.6e-5
PGO_CG_TOL = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_sample_idx(valid, key, n_hypotheses=128, sample_size=6):
    """The indices ssvio_tpu/ops/pnp.py:108-110 draws from `key`."""
    logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    gumbel = jax.random.gumbel(key, (n_hypotheses, len(valid)))
    return np.asarray(jax.lax.top_k(gumbel + logits[None, :], sample_size)[1])


def _pnp_both(p_w, uv, valid, seed):
    key = jax.random.PRNGKey(seed)
    rj = pnp_j.pnp_ransac(jnp.asarray(p_w), jnp.asarray(uv),
                          jnp.asarray(valid), FX, FY, CX, CY, key)
    rt = pnp_t.pnp_ransac(_t(p_w), _t(uv), _t(valid), FX, FY, CX, CY,
                          sample_idx=_t(_jax_sample_idx(valid, key)))
    return rj, rt


# ----------------------------------------------------------------------
# ops/pnp.py
# ----------------------------------------------------------------------

def test_pnp_exact_matches():
    rng = np.random.default_rng(0)
    p_w, uv, valid, T_true = make_scene(rng)
    rj, rt = _pnp_both(p_w, uv, valid, 0)
    assert bool(rt.ok) and bool(rj.ok)
    assert pose_err(rt.T_cw.numpy(), T_true) < 1e-3     # tests/test_pnp.py's
    assert _twist_err(rt.T_cw.numpy(), np.asarray(rj.T_cw)) < PNP_POSE_TOL
    np.testing.assert_array_equal(rt.inlier.numpy(), np.asarray(rj.inlier))
    assert int(rt.n_inliers) == int(rj.n_inliers)


def test_pnp_outliers_matches():
    rng = np.random.default_rng(7)
    p_w, uv, valid, T_true = make_scene(rng, n=120)
    uv_n = uv + rng.normal(0, 0.5, uv.shape).astype(np.float32)
    out_idx = rng.choice(len(uv), 40, replace=False)
    uv_n[out_idx] += rng.uniform(25, 120, (40, 2)).astype(np.float32)
    rj, rt = _pnp_both(p_w, uv_n, valid, 1)
    assert bool(rt.ok) and bool(rj.ok)
    assert pose_err(rt.T_cw.numpy(), T_true) < 0.02     # tests/test_pnp.py's
    assert _twist_err(rt.T_cw.numpy(), np.asarray(rj.T_cw)) < PNP_POSE_TOL
    np.testing.assert_array_equal(rt.inlier.numpy(), np.asarray(rj.inlier))
    assert rt.inlier.numpy()[out_idx].mean() < 0.2


def test_pnp_too_few_points_matches():
    p_w = np.zeros((20, 3), np.float32)
    uv = np.zeros((20, 2), np.float32)
    valid = np.zeros(20, bool)
    valid[:4] = True                                    # < min_inliers
    rj, rt = _pnp_both(p_w, uv, valid, 2)
    assert not bool(rt.ok) and not bool(rj.ok)
    assert bool(torch.all(torch.isfinite(rt.T_cw)))
    np.testing.assert_array_equal(rt.inlier.numpy(), np.asarray(rj.inlier))


def test_pnp_own_generator():
    """Without sample_idx the port draws its own samples from a
    torch.Generator: distinct valid points per hypothesis, the same result
    from the same seed, and the pose of tests/test_pnp.py's exact case."""
    rng = np.random.default_rng(3)
    p_w, uv, valid, T_true = make_scene(rng)
    valid[::7] = False
    g = torch.Generator().manual_seed(5)
    idx = pnp_t.sample_indices(_t(valid), 128, 6, g).numpy()
    assert idx.shape == (128, 6) and valid[idx].all()
    assert all(len(set(row)) == 6 for row in idx.tolist())
    assert len({tuple(sorted(r)) for r in idx.tolist()}) > 100
    res = [pnp_t.pnp_ransac(_t(p_w), _t(uv), _t(valid), FX, FY, CX, CY,
                            torch.Generator().manual_seed(9))
           for _ in range(2)]
    assert bool(res[0].ok) and pose_err(res[0].T_cw.numpy(), T_true) < 1e-3
    assert torch.equal(res[0].T_cw, res[1].T_cw)


def test_dlt_pose_batched_matches():
    """The batched DLT against the JAX package's per-problem one on
    well-conditioned (12-point, weighted) problems, where the smallest
    eigenvector is stable: twist within 2e-3 of each other (float32 eigh
    and svd from two LAPACK front ends; measured 2.8e-4), and of the truth
    on exact data."""
    rng = np.random.default_rng(4)
    p_w, uv, valid, T_true = make_scene(rng, n=200)
    xn = np.stack([(uv[:, 0] - CX) / FX, (uv[:, 1] - CY) / FY], -1)
    good = np.flatnonzero(valid)
    idx = np.stack([rng.choice(good, 12, replace=False) for _ in range(16)])
    w = rng.uniform(0.5, 1.5, idx.shape).astype(np.float32)
    T_j = jax.vmap(pnp_j._dlt_pose)(jnp.asarray(p_w[idx]),
                                    jnp.asarray(xn[idx]), jnp.asarray(w))
    T_t = pnp_t._dlt_pose(_t(p_w[idx]), _t(xn[idx]), _t(w))
    assert T_t.shape == (16, 3, 4)
    assert _twist_err(T_t.numpy(), np.asarray(T_j)).max() < 2e-3
    assert _twist_err(T_t.numpy(), T_true[None]).max() < 1e-2
    # shared points, per-problem weights (the LO re-fit's call)
    w_all = (rng.uniform(size=(4, 200)) > 0.3).astype(np.float32) * valid
    T_j2 = jax.vmap(pnp_j._dlt_pose, in_axes=(None, None, 0))(
        jnp.asarray(p_w), jnp.asarray(xn), jnp.asarray(w_all))
    T_t2 = pnp_t._dlt_pose(_t(p_w), _t(xn), _t(w_all))
    assert _twist_err(T_t2.numpy(), np.asarray(T_j2)).max() < 2e-3


def test_lm_loop_6dof_batched_matches_vmap():
    """The batched 5-step polish against jax.vmap of the JAX package's
    while_loop LM: poses within 1e-4 (test_torch_ba.py's pose tolerance;
    measured 1.0e-5).
    Some problems start at their optimum and stall at once, so the frozen
    state is exercised; and each batched pose equals the port's single-pose
    loop on the same problem within the same tolerance."""
    rng = np.random.default_rng(5)
    p_w, uv, valid, T_true = make_scene(rng, n=200)
    good = np.flatnonzero(valid)
    idx = np.stack([rng.choice(good, 6, replace=False) for _ in range(24)])
    xi = rng.normal(0, 0.03, (24, 6)).astype(np.float32)
    xi[:6] = 0.0                                   # already converged
    T0 = np.asarray(se3_j.compose(se3_j.exp(jnp.asarray(xi)),
                                  jnp.asarray(T_true)[None]))
    ones = np.ones((24, 6), np.float32)
    T_j = jax.vmap(lambda T, pw, puv, w: ba_j._lm_loop_6dof(
        T, pw, puv, w, FX, FY, CX, CY, 5))(
        jnp.asarray(T0), jnp.asarray(p_w[idx]), jnp.asarray(uv[idx]),
        jnp.asarray(ones))
    T_t = ba_t._lm_loop_6dof_batched(_t(T0), _t(p_w[idx]), _t(uv[idx]),
                                     _t(ones), FX, FY, CX, CY, 5)
    assert _twist_err(T_t.numpy(), np.asarray(T_j)).max() < 1e-4
    for b in (0, 7, 23):
        T_1 = ba_t._lm_loop_6dof(_t(T0[b]), _t(p_w[idx[b]]), _t(uv[idx[b]]),
                                 _t(ones[b]), FX, FY, CX, CY, 5)
        assert _twist_err(T_t[b].numpy(), T_1.numpy()) < 1e-4


def test_pnp_batched_parts_have_no_host_read(monkeypatch):
    """The batched DLT and the batched 5-step polish read nothing on the
    host (counted through Tensor.__bool__ / .item() and their kin), and
    neither does pnp_ransac as a whole: its final ba.pose_only_optimize
    runs the LM as a fixed trip with no host read."""
    rng = np.random.default_rng(6)
    p_w, uv, valid, _ = make_scene(rng)
    xn = np.stack([(uv[:, 0] - CX) / FX, (uv[:, 1] - CY) / FY], -1)
    idx = _jax_sample_idx(valid, jax.random.PRNGKey(3))
    args = [_t(a) for a in (p_w[idx], xn[idx], uv[idx],
                            np.ones(idx.shape, np.float32))]
    reads = []
    for name in ("__bool__", "item", "tolist", "__int__", "__float__"):
        orig = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda self, *a, _o=orig, _n=name, **k:
                            (reads.append(_n), _o(self, *a, **k))[1])
    T = pnp_t._dlt_pose(args[0], args[1], args[3])
    ba_t._lm_loop_6dof_batched(T, args[0], args[2], args[3], FX, FY, CX, CY,
                               5)
    assert reads == []
    pnp_t.pnp_ransac(_t(p_w), _t(uv), _t(valid), FX, FY, CX, CY,
                     sample_idx=_t(idx))
    assert reads == []


def _pnp_ransac_one_function(p_w, uv, valid, fx, fy, cx, cy, generator=None,
                             n_hypotheses=128, sample_size=6,
                             reproj_threshold=5.991, min_inliers=10,
                             sample_idx=None):
    """pnp_ransac written as one function, the best picked by indexing:
    the bits its stages (ops/pnp.py) must give."""
    xn = torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], dim=-1)
    if sample_idx is None:
        idx = pnp_t.sample_indices(valid, n_hypotheses, sample_size,
                                   generator)
    else:
        idx = sample_idx.long()
        n_hypotheses, sample_size = idx.shape
    samp_pw, samp_xn = p_w[idx], xn[idx]
    samp_w = torch.ones((n_hypotheses, sample_size))
    T_hyp = pnp_t._dlt_pose(samp_pw, samp_xn, samp_w)
    T_hyp = ba_t._lm_loop_6dof_batched(T_hyp, samp_pw, uv[idx], samp_w,
                                       fx, fy, cx, cy, 5)

    def score(T):
        r, _, z_ok = ba_t.reproject_residual(T[:, None], p_w[None],
                                             uv[None], fx, fy, cx, cy)
        inl = ((torch.sum(r * r, dim=-1) < reproj_threshold ** 2) & z_ok
               & valid[None])
        finite = torch.all(torch.isfinite(T.reshape(T.shape[0], -1)), dim=1)
        n = torch.sum(inl, dim=1)
        return inl, torch.where(finite, n, torch.full_like(n, -1))

    inl, scores = score(T_hyp)
    w_lo = inl.to(p_w.dtype) * (scores >= sample_size)[:, None]
    T_lo = pnp_t._dlt_pose(p_w, xn, w_lo)
    inl_lo, scores_lo = score(T_lo)
    better = scores_lo > scores
    T_all = torch.where(better[:, None, None], T_lo, T_hyp)
    inl = torch.where(better[:, None], inl_lo, inl)
    scores = torch.maximum(scores, scores_lo)
    best = torch.argmax(scores)
    res = ba_t.pose_only_optimize(T_all[best], p_w, uv, inl[best],
                                  fx, fy, cx, cy)
    ok = (res.n_inliers >= min_inliers) & (scores[best] >= sample_size)
    return pnp_t.PnPResult(res.T_cw, res.inlier, res.n_inliers, ok)


@pytest.mark.parametrize("case", ["exact", "outliers", "few_valid",
                                  "generator"])
def test_pnp_stages_give_the_one_functions_bits(case):
    """pnp_ransac, composed of its stages (the best taken by
    index_select), equals the one-function RANSAC bit for bit: pose,
    inliers, count and ok, with JAX's samples or the generator's."""
    rng = np.random.default_rng(21)
    p_w, uv, valid, _ = make_scene(rng, n=120)
    if case == "outliers":
        out = rng.choice(len(uv), 40, replace=False)
        uv[out] += rng.uniform(25, 120, (40, 2)).astype(np.float32)
    elif case == "few_valid":
        valid[8:] = False
    args = (_t(p_w), _t(uv), _t(valid), FX, FY, CX, CY)
    if case == "generator":
        got = pnp_t.pnp_ransac(*args, torch.Generator().manual_seed(4))
        want = _pnp_ransac_one_function(*args,
                                        torch.Generator().manual_seed(4))
    else:
        idx = _t(_jax_sample_idx(valid, jax.random.PRNGKey(8)))
        got = pnp_t.pnp_ransac(*args, sample_idx=idx)
        want = _pnp_ransac_one_function(*args, sample_idx=idx)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(got.ok) == (case != "few_valid")


@pytest.mark.parametrize("n_valid", [120, 40, 4])
def test_sample_indices_from_drawn_uniforms(n_valid):
    """sample_indices given the uniforms draw_uniforms drew equals its own
    draw from a generator in the same state, and leaves the generator
    where its own draw does; fewer valid points than a sample fill the
    rest with invalid ones, as before."""
    valid = torch.zeros(120, dtype=torch.bool)
    valid[torch.randperm(120, generator=torch.Generator().manual_seed(1))
          [:n_valid]] = True
    g_own, g_drawn = (torch.Generator().manual_seed(6) for _ in range(2))
    own = pnp_t.sample_indices(valid, 128, 6, g_own)
    u = pnp_t.draw_uniforms(128, 120, g_drawn)
    assert u.shape == (128, 120) and u.dtype == torch.float32
    assert torch.equal(pnp_t.sample_indices(valid, 128, 6, uniforms=u), own)
    assert torch.equal(g_own.get_state(), g_drawn.get_state())
    assert int(valid[own].sum(dim=1).min()) == min(n_valid, 6)


# ----------------------------------------------------------------------
# ops/pgo.py
# ----------------------------------------------------------------------

def _rng(seed):
    return np.random.default_rng(seed)


def _both(prob_j, fn="optimize", **kw):
    out_j = np.asarray(getattr(pgo_j, fn)(prob_j, **kw))
    out_t = getattr(pgo_t, fn)(interop.pgo_problem(prob_j), **kw).numpy()
    return out_j, out_t


def test_pgo_se3_helpers_match():
    """se3_ad and the series Jacobians: elementwise 1e-6 (a few float32
    products); make_odometry_edges: indices and mask equal, Z 1e-6."""
    rng = _rng(40)
    xi = rng.normal(0, 0.5, (32, 6)).astype(np.float32)
    for name in ("se3_ad", "_jl_inv", "_jr_inv"):
        np.testing.assert_allclose(
            getattr(pgo_t, name)(_t(xi)).numpy(),
            np.asarray(getattr(pgo_j, name)(jnp.asarray(xi))), atol=1e-6)
    T_true, est, _ = make_circle_graph(rng, n=12, drift=0.02)
    ej = pgo_j.make_odometry_edges(jnp.asarray(est), 9, 16)
    et = pgo_t.make_odometry_edges(_t(est), 9, 16)
    for a, b in zip(et, ej):
        if a.dtype == torch.float32:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_pgo_zero_residual_fixed_point():
    T_true, est, Zs = make_circle_graph(_rng(41), n=20, drift=0.0)
    out_j, out_t = _both(build_problem(T_true, est, Zs, [(0, 19)]), iters=5)
    assert ate(out_t[:20], T_true) < 1e-4
    np.testing.assert_allclose(out_t, out_j, atol=PGO_DENSE_TOL)


def test_pgo_closes_the_loop():
    T_true, est, Zs = make_circle_graph(_rng(42), n=40, drift=0.02)
    before = ate(est, T_true)
    out_j, out_t = _both(build_problem(T_true, est, Zs, [(39, 0), (20, 19)]),
                         iters=20)
    assert before > 0.15
    assert ate(out_t[:40], T_true) < before * 0.35
    np.testing.assert_allclose(out_t, out_j, atol=PGO_DENSE_TOL)


def test_pgo_respects_fixed_and_padding():
    T_true, est, Zs = make_circle_graph(_rng(43), n=16, drift=0.02)
    out_j, out_t = _both(build_problem(T_true, est, Zs, [(15, 0)], P=32),
                         iters=15)
    np.testing.assert_allclose(out_t[0], est[0], atol=1e-6)   # fixed vertex
    assert np.all(np.isfinite(out_t))
    np.testing.assert_allclose(out_t, out_j, atol=PGO_DENSE_TOL)


def test_pgo_all_fixed_is_identity():
    T_true, est, Zs = make_circle_graph(_rng(44), n=8, drift=0.05)
    prob = build_problem(T_true, est, Zs, [])
    prob = prob._replace(pose_fixed=prob.pose_valid)
    for fn in ("optimize", "_optimize_cg"):
        out_j, out_t = _both(prob, fn, iters=5)
        np.testing.assert_allclose(out_t[:8], est, atol=1e-6)
        np.testing.assert_allclose(out_t, out_j, atol=1e-6)


def test_pgo_cg_matches_dense_and_jax():
    T_true, est, Zs = make_circle_graph(_rng(45), n=40, drift=0.02)
    prob = build_problem(T_true, est, Zs, [(39, 0), (20, 19)])
    out_cj, out_ct = _both(prob, "_optimize_cg", iters=20)
    out_dt = pgo_t._optimize_dense(interop.pgo_problem(prob),
                                   iters=20).numpy()
    np.testing.assert_allclose(out_ct, out_cj, atol=PGO_CG_TOL)
    # tests/test_pgo.py:109's bounds, on the port's two solvers
    assert ate(out_ct[:40], T_true) < ate(est, T_true) * 0.35
    assert abs(ate(out_ct[:40], T_true) - ate(out_dt[:40], T_true)) < 0.02


def test_pgo_dispatches_on_pose_count(monkeypatch):
    """optimize() takes the CG solver above DENSE_MAX_POSES and the dense
    one up to it (tests/test_pgo.py's large-P case, with the limit lowered
    on both sides instead of 2048 slots), and still closes the loop."""
    assert pgo_t.DENSE_MAX_POSES == pgo_j.DENSE_MAX_POSES == 512
    n = 48
    T_true, est, Zs = make_circle_graph(_rng(46), n=n, drift=0.01)
    prob = build_problem(T_true, est, Zs,
                         [(n - 1, 0), (n // 2, n // 2 - 1)], P=64)
    calls = []
    for name in ("_optimize_dense", "_optimize_cg"):
        orig = getattr(pgo_t, name)
        monkeypatch.setattr(pgo_t, name,
                            lambda p, iters, _o=orig, _n=name:
                            (calls.append(_n), _o(p, iters=iters))[1])
    monkeypatch.setattr(pgo_t, "DENSE_MAX_POSES", 32)
    monkeypatch.setattr(pgo_j, "DENSE_MAX_POSES", 32)
    out_j, out_t = _both(prob, iters=15)
    assert calls == ["_optimize_cg"]
    assert np.all(np.isfinite(out_t))
    before = ate(est, T_true)
    assert ate(out_t[:n], T_true) < before * 0.35
    np.testing.assert_allclose(out_t, out_j, atol=PGO_CG_TOL)
    monkeypatch.setattr(pgo_t, "DENSE_MAX_POSES", 64)
    pgo_t.optimize(interop.pgo_problem(prob), iters=1)
    assert calls == ["_optimize_cg", "_optimize_dense"]


@pytest.mark.parametrize("fn", ["_optimize_dense", "_optimize_cg"])
def test_pgo_nan_residual_edge_is_ignored(fn):
    """An edge whose residual is not finite must not poison the solve
    (ssvio_tpu/ops/pgo.py:84-91): here a valid edge that reaches into a
    slot holding NaN. The graph still closes on both solvers, and the
    poses match the JAX package's."""
    n = 24
    T_true, est, Zs = make_circle_graph(_rng(47), n=n, drift=0.02)
    prob = build_problem(T_true, est, Zs, [(n - 1, 0), (12, 11)], P=n + 1)
    poses = np.array(prob.poses)
    poses[n] = np.nan                              # an unused slot
    eye = np.eye(3, 4, dtype=np.float32)
    prob = prob._replace(
        poses=jnp.asarray(poses),
        edge_i=jnp.concatenate([prob.edge_i, jnp.asarray([n], jnp.int32)]),
        edge_j=jnp.concatenate([prob.edge_j, jnp.asarray([3], jnp.int32)]),
        edge_Z=jnp.concatenate([prob.edge_Z, jnp.asarray(eye)[None]]),
        edge_valid=jnp.ones(n + 2, bool),
        edge_weight=jnp.ones(n + 2, jnp.float32))
    out_j, out_t = _both(prob, fn, iters=20)
    assert np.all(np.isfinite(out_t[:n])) and np.all(np.isnan(out_t[n]))
    assert ate(out_t[:n], T_true) < ate(est, T_true) * 0.5
    np.testing.assert_allclose(
        out_t[:n], out_j[:n], atol=PGO_DENSE_TOL if fn == "_optimize_dense"
        else PGO_CG_TOL)


def test_pgo_failed_cholesky_rejects_the_step(monkeypatch):
    """jax.scipy's cho_factor gives NaN on a matrix that is not positive
    definite and the step is rejected by isfinite(dx); torch's cholesky_ex
    reports it in `info`, and the port rejects the step from that. With
    every factorisation reported as failed, the poses do not move."""
    T_true, est, Zs = make_circle_graph(_rng(48), n=12, drift=0.02)
    prob = interop.pgo_problem(build_problem(T_true, est, Zs, [(11, 0)]))
    real = torch.linalg.cholesky_ex

    def failing(a, **kw):
        L, info = real(a, **kw)
        return L, torch.ones_like(info)

    monkeypatch.setattr(torch.linalg, "cholesky_ex", failing)
    out = pgo_t._optimize_dense(prob, iters=4)
    assert torch.equal(out, prob.poses)


def test_pgo_has_no_host_read_in_its_loops(monkeypatch):
    """The LM loops read nothing on the host, and the CG reads its stop
    flag at most once per CG_CHECK_EVERY iterations: counted through
    Tensor.__bool__ / .item() while both solvers run."""
    T_true, est, Zs = make_circle_graph(_rng(49), n=40, drift=0.02)
    prob = interop.pgo_problem(build_problem(T_true, est, Zs, [(39, 0)]))
    reads = []
    for name in ("__bool__", "item", "tolist", "__int__", "__float__"):
        orig = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda self, *a, _o=orig, _n=name, **k:
                            (reads.append(_n), _o(self, *a, **k))[1])
    pgo_t._optimize_dense(prob, iters=3)
    assert reads == []
    iters, cg_iters = 3, 80
    pgo_t._optimize_cg(prob, iters=iters, cg_iters=cg_iters)
    assert 0 < len(reads) <= iters * (cg_iters // pgo_t.CG_CHECK_EVERY)
