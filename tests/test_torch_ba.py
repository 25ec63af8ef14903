"""Parity of the port's optimizers (ops/ba.py) with ssvio_tpu.

Same scenes as tests/test_ba.py, each from its own seed, fed to both
sides. Both solve in float32; the normal equations are summed in other
orders (einsum vs broadcast-reduce), so iterates differ by float32 noise
that LM damping keeps from growing. Tolerances: poses 1e-4 (twist norm of
T_port T_jax^-1), landmarks 1e-3 m, equal inlier / outlier decisions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssvio_tpu.ops import ba as ba_j
from ssvio_tpu.ops import se3 as se3_j
from ssvio_tpu_torch import interop
from ssvio_tpu_torch.ops import ba as ba_t
from ssvio_tpu_torch.ops import se3 as se3_t
from test_ba import BASELINE, CX, CY, FX, FY, build_ba_problem, project, synth_scene
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

POSE_TOL = 1e-4
LM_TOL_M = 1e-3


def _twist_err(A, B):
    """|log(A B^-1)| per pose, A and B numpy [..., 3, 4]."""
    d = se3_t.compose(torch.from_numpy(np.array(A, np.float32)),
                      se3_t.inverse(torch.from_numpy(np.array(B, np.float32))))
    return np.abs(se3_t.log(d).numpy()).max(axis=-1)


@pytest.mark.parametrize("outliers", [0, 40])
def test_pose_only_optimize_matches(outliers):
    rng = np.random.default_rng(301 + outliers)
    p_w, T = synth_scene(rng, n_points=200)
    uv, z = project(T[2], p_w)
    uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)
    if outliers:
        idx = rng.choice(len(uv), outliers, replace=False)
        uv[idx] += rng.uniform(15, 60, (outliers, 2)).astype(np.float32)
    valid = z > 0
    valid[:5] = False
    xi = np.array([0.1, 0.05, -0.1, -0.01, 0.02, 0.005], np.float32)
    T_init = np.array(se3_j.compose(se3_j.exp(jnp.asarray(xi)),
                                    jnp.asarray(T[2])))
    rj = ba_j.pose_only_optimize(jnp.asarray(T_init), jnp.asarray(p_w),
                                 jnp.asarray(uv), jnp.asarray(valid),
                                 FX, FY, CX, CY)
    rt = ba_t.pose_only_optimize(*[torch.from_numpy(a) for a in
                                   (T_init, p_w, uv, valid)], FX, FY, CX, CY)
    assert _twist_err(rt.T_cw.numpy(), np.asarray(rj.T_cw)) < POSE_TOL
    np.testing.assert_array_equal(rt.inlier.numpy(), np.asarray(rj.inlier))
    assert int(rt.n_inliers) == int(rj.n_inliers)
    # chi2 in px^2: float32 reprojection of equal poses
    np.testing.assert_allclose(rt.chi2.numpy(), np.asarray(rj.chi2),
                               rtol=1e-3, atol=1e-3)


def test_pose_only_all_invalid_stays_finite():
    z = np.zeros((16, 3), np.float32)
    res = ba_t.pose_only_optimize(se3_t.identity(), torch.from_numpy(z),
                                  torch.zeros((16, 2)),
                                  torch.zeros(16, dtype=torch.bool),
                                  FX, FY, CX, CY)
    assert bool(torch.all(torch.isfinite(res.T_cw)))
    assert int(res.n_inliers) == 0


def test_pose_only_gate_counts_knife_edge_tracks_as_float64_does():
    """Tracks whose chi2 lies within ~3e-4 px^2 of the 5.991 gate, near the
    edges of RobotCar's 1280x960 image (the settings' intrinsics as Python
    floats, as the Frontend passes them): the returned inliers and their
    count are those of the gate taken in float64 at the returned pose, as
    the benchmark's judge takes it. The same gate in float32 (the float32
    intrinsics) miscounts some of these tracks, so the case is a knife
    edge. rounds=0: the gate alone, at the starting pose."""
    fx, fy, cx, cy = 983.044, 983.044, 643.646, 493.378
    rng = np.random.default_rng(29)
    N = 2000
    z = rng.uniform(4.0, 30.0, N)
    left = rng.integers(0, 2, N) == 0
    u = np.where(left, rng.uniform(5, 60, N), rng.uniform(1220, 1275, N))
    v = rng.uniform(5, 955, N)
    p_w = np.stack([(u - cx) * z / fx, (v - cy) * z / fy, z], -1)
    p_w = p_w.astype(np.float32)
    T = se3_t.exp(torch.tensor([0.02, -0.01, 0.03, 0.004, -0.006, 0.002]))
    T64, p64 = T.double(), torch.from_numpy(p_w).double()
    pc = se3_t.transform(T64, p64)
    proj = torch.stack([fx * pc[:, 0] / pc[:, 2] + cx,
                        fy * pc[:, 1] / pc[:, 2] + cy], -1)
    ang = rng.uniform(0, 2 * np.pi, N)
    rad = np.sqrt(ba_t.CHI2_TH + rng.uniform(-3e-4, 3e-4, N))
    uv = (proj + torch.from_numpy(np.stack([np.cos(ang), np.sin(ang)], -1)
                                  * rad[:, None])).float()
    valid = torch.ones(N, dtype=torch.bool)
    res = ba_t.pose_only_optimize(T, torch.from_numpy(p_w), uv, valid,
                                  fx, fy, cx, cy, rounds=0)

    # the judge: float64 at the returned pose, the settings' intrinsics
    pc = se3_t.transform(res.T_cw.double(), p64)
    r = uv.double() - torch.stack([fx * pc[:, 0] / pc[:, 2] + cx,
                                   fy * pc[:, 1] / pc[:, 2] + cy], -1)
    chi2_64 = (r * r).sum(-1)
    near = (chi2_64 - ba_t.CHI2_TH).abs() < 3e-4
    assert int(near.sum()) > N // 2
    judged = chi2_64 < ba_t.CHI2_TH
    assert torch.equal(res.inlier, judged)
    assert int(res.n_inliers) == int(judged.sum())

    # the float32 gate on the float32 intrinsics disagrees somewhere
    cam32 = [torch.tensor(c, dtype=torch.float32) for c in (fx, fy, cx, cy)]
    r32, _, _ = ba_t.reproject_residual(res.T_cw, torch.from_numpy(p_w), uv,
                                        *cam32)
    gate32 = (r32 * r32).sum(-1) < ba_t.CHI2_TH
    assert int((gate32 != judged).sum()) > 0


def _problems(seed, **kw):
    prob_j, T_true, lm_true, n_kf, n_lm = build_ba_problem(
        np.random.default_rng(seed), W=4, M=256, n_kf=4, **kw)
    return prob_j, interop.to_torch(prob_j, ba_t.LocalBAProblem), n_kf, n_lm


@pytest.mark.parametrize("case", [
    dict(perturb_pose=0.1, perturb_lm=0.3),
    dict(noise=0.5, outlier_frac=0.1, perturb_pose=0.05, perturb_lm=0.2),
])
def test_local_ba_matches(case):
    prob_j, prob_t, n_kf, n_lm = _problems(302, **case)
    rj = ba_j.local_ba(prob_j, FX, FY, CX, CY, BASELINE)
    rt = ba_t.local_ba(prob_t, FX, FY, CX, CY, BASELINE)
    assert _twist_err(rt.kf_T_cw.numpy(), np.asarray(rj.kf_T_cw)).max() \
        < POSE_TOL
    np.testing.assert_allclose(rt.lm_pos.numpy()[:n_lm],
                               np.asarray(rj.lm_pos)[:n_lm], atol=LM_TOL_M)
    np.testing.assert_array_equal(rt.obs_valid.numpy(),
                                  np.asarray(rj.obs_valid))
    assert float(rt.inlier_ratio) == pytest.approx(float(rj.inlier_ratio))
    # the gauge anchor stays put
    np.testing.assert_array_equal(rt.kf_T_cw.numpy()[0],
                                  np.asarray(prob_j.kf_T_cw)[0])


def test_local_ba_hold_runs_every_round():
    """`hold` set: the inlier ratio stops no round and all max_rounds run;
    unset, the BA is the one without it, bit for bit."""
    _, prob, _, _ = _problems(302, perturb_pose=0.1, perturb_lm=0.3)
    free = ba_t.local_ba(prob, FX, FY, CX, CY, BASELINE)
    off = ba_t.local_ba(prob, FX, FY, CX, CY, BASELINE,
                        hold=torch.tensor(False))
    on = ba_t.local_ba(prob, FX, FY, CX, CY, BASELINE,
                       hold=torch.tensor(True))
    assert int(free.rounds) < ba_t.LOCAL_BA_ROUNDS
    for a, b in zip(free, off):
        assert torch.equal(a, b)
    assert int(on.rounds) == ba_t.LOCAL_BA_ROUNDS
    assert int(on.iterations) > int(free.iterations)


def test_local_ba_empty_window_no_nans():
    W, M = 4, 32
    prob = ba_t.LocalBAProblem(
        kf_T_cw=se3_t.identity((W,)), kf_valid=torch.zeros(W, dtype=torch.bool),
        kf_fixed=torch.zeros(W, dtype=torch.bool), lm_pos=torch.zeros((M, 3)),
        lm_valid=torch.zeros(M, dtype=torch.bool),
        lm_fixed=torch.zeros(M, dtype=torch.bool),
        obs_uv=torch.zeros((M, W, 2, 2)),
        obs_valid=torch.zeros((M, W, 2), dtype=torch.bool))
    res = ba_t.local_ba(prob, FX, FY, CX, CY, BASELINE, max_rounds=2, iters=3)
    assert bool(torch.all(torch.isfinite(res.kf_T_cw)))
    assert bool(torch.all(torch.isfinite(res.lm_pos)))
