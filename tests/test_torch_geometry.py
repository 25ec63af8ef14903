"""The geometry that no engine step calls, held against the JAX package:
`ops/triangulation.py::triangulate_dlt` and `ops/se3.py`'s
`normalize_rotation`, `rotmat_to_quat`, `quat_to_rotmat`.

Same float32 inputs from numpy seeds on both sides; outputs within 1e-5
(the formulas are the same; eigh/SVD and sums differ in order); DLT
positions within 1e-5 of their distance from the origin. The DLT
quality gate is computed in float32 from the eigenvalues of A^T A, whose
rounding is ~sqrt(eps) of the largest singular value: the two sides are
held to one gate decision and one position on the landmarks whose
second-smallest singular value (float64) is at least GATE_CLEAR of the
largest, where that rounding stays far below the gate and the solution's
eigenvector is well separated, and to one decision on those with no view.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssvio_tpu.ops import se3 as se3_j
from ssvio_tpu.ops import triangulation as tri_j
from ssvio_tpu_torch.ops import se3 as se3_t
from ssvio_tpu_torch.ops import triangulation as tri_t
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5
GATE_CLEAR = 0.1


def _rotations(seed, n=64):
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(n, 6)).astype(np.float32)
    xi[:, 3:] *= 1.2
    R = np.array(se3_j.exp(jnp.asarray(xi)))[:, :, :3]
    # every Shepperd branch: near-identity and half turns about each axis
    R[0] = np.eye(3)
    R[1:4] = np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]), \
        np.diag([-1.0, -1.0, 1.0])
    return R.astype(np.float32)


def test_quaternions_match():
    R = _rotations(301)
    q_j = np.array(se3_j.rotmat_to_quat(jnp.asarray(R)))
    q_t = se3_t.rotmat_to_quat(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(q_t, q_j, atol=TOL)
    np.testing.assert_allclose(
        se3_t.quat_to_rotmat(torch.from_numpy(q_j)).numpy(),
        np.asarray(se3_j.quat_to_rotmat(jnp.asarray(q_j))), atol=TOL)
    np.testing.assert_allclose(
        se3_t.quat_to_rotmat(torch.from_numpy(q_t)).numpy(), R, atol=1e-5)


def test_normalize_rotation_matches():
    rng = np.random.default_rng(302)
    T = np.concatenate([_rotations(303), rng.normal(size=(64, 3, 1))],
                       axis=2).astype(np.float32)
    T[:, :, :3] += 1e-3 * rng.normal(size=(64, 3, 3)).astype(np.float32)
    n_j = np.asarray(se3_j.normalize_rotation(jnp.asarray(T)))
    n_t = se3_t.normalize_rotation(torch.from_numpy(T)).numpy()
    np.testing.assert_allclose(n_t, n_j, atol=TOL)
    Rt = n_t[:, :, :3]
    np.testing.assert_allclose(Rt @ Rt.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), Rt.shape),
                               atol=1e-5)


@pytest.mark.parametrize("views", [2, 4])
def test_triangulate_dlt_matches(views):
    rng = np.random.default_rng(304 + views)
    B = 48
    p_w = rng.uniform([-1, -1, 2], [1, 1, 4], size=(B, 3))
    xi = np.zeros((B, views, 6), np.float32)
    xi[..., :2] = rng.uniform([-1, -0.5], [1, 0.5], (B, views, 2))
    xi[..., 3:] = 0.02 * rng.normal(size=(B, views, 3))
    T = np.array(se3_j.exp(jnp.asarray(xi)))                 # [B, V, 3, 4]
    pc = np.einsum("bvij,bj->bvi", T[..., :3], p_w) + T[..., 3]
    uv = (pc[..., :2] / pc[..., 2:]).astype(np.float32)
    valid = np.ones((B, views), bool)
    if views > 2:
        valid[:4, 0] = False                   # a view masked out
    valid[4:8] = False                         # no view: gated
    p_j, ok_j = tri_j.triangulate_dlt(jnp.asarray(T), jnp.asarray(uv),
                                      jnp.asarray(valid))
    p_t, ok_t = tri_t.triangulate_dlt(torch.from_numpy(T),
                                      torch.from_numpy(uv),
                                      torch.from_numpy(valid))
    ok_j, ok_t = np.asarray(ok_j), ok_t.numpy()
    A = np.concatenate([uv[..., :1, None] * T[..., 2:3, :] - T[..., 0:1, :],
                        uv[..., 1:2, None] * T[..., 2:3, :] - T[..., 1:2, :]],
                       axis=-2).astype(np.float64)       # [B, V, 2, 4]
    A = (A * valid[..., None, None]).reshape(B, 2 * views, 4)
    sv = np.linalg.svd(A, compute_uv=False)                   # descending
    clear = (sv[:, -2] >= GATE_CLEAR * sv[:, 0]) | ~valid.any(axis=1)
    assert clear.sum() >= B // 2
    np.testing.assert_array_equal(ok_t[clear], ok_j[clear])
    assert not ok_t[4:8].any() and ok_t[clear & valid.any(axis=1)].all()
    both = ok_t & ok_j & clear
    pt, pj = p_t.numpy()[both], np.asarray(p_j)[both]
    rel = np.linalg.norm(pt - pj, axis=-1) / np.linalg.norm(pj, axis=-1)
    assert rel.max() <= TOL, rel.max()
