"""Parity of the port's map (map.py) and front end (frontend.py) with
ssvio_tpu.

The map ops take small hand-made inputs from a seeded numpy generator and
must agree exactly (they are index bookkeeping; positions are copied, not
computed). The front-end steps start from a real JAX state: a JAX System
initializes and tracks a few frames, its state is carried into the port
through `interop`, and one tracking step and one keyframe step run on
both sides from that same state.

Front-end tolerances: tracked positions 0.02 px (LK, see
tests/test_torch_lk.py), poses 1e-4 (twist norm), new landmarks 0.5% of
their depth (a 0.02 px disparity difference at the 0.5 px minimum
disparity the triangulation accepts is far more; at the disparities the
scene produces it is under 0.5%).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssvio_tpu import frontend as fe_j
from ssvio_tpu import map as map_j
from ssvio_tpu.dataio import synthetic
from ssvio_tpu.ops import se3 as se3_j
from ssvio_tpu.system import System as SystemJ
from ssvio_tpu_torch import frontend as fe_t
from ssvio_tpu_torch import interop
from ssvio_tpu_torch import map as map_t
from ssvio_tpu_torch.ops import se3 as se3_t
from test_system_e2e import BASELINE, CX, CY, FX, FY, H, W, small_settings
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

PX_TOL = 0.02
POSE_TOL = 1e-4


def _twist_err(A, B):
    d = se3_t.compose(torch.from_numpy(np.array(A, np.float32)),
                      se3_t.inverse(torch.from_numpy(np.array(B, np.float32))))
    return float(np.abs(se3_t.log(d).numpy()).max())


def _np_dict(nt):
    return {f: np.array(v) for f, v in zip(nt._fields, nt)}


def _assert_maps_equal(mt, mj):
    a, b = interop.to_numpy(mt), _np_dict(mj)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def _random_map_inputs(seed, W_=4, M=64, N=40, fill=3):
    """A map with `fill` keyframes and some landmarks, plus a feature set
    linking to distinct live landmarks."""
    rng = np.random.default_rng(seed)
    m = _np_dict(map_j.empty_map(W_, M))
    for w in range(fill):
        xi = np.zeros(6, np.float32)
        xi[2] = -0.3 * w
        m["kf_pose"][w] = np.array(se3_j.exp(jnp.asarray(xi)))
        m["kf_gid"][w] = w
        m["kf_valid"][w] = True
    n_lm = 30
    m["lm_pos"][:n_lm] = rng.uniform(-5, 5, (n_lm, 3))
    m["lm_valid"][:n_lm] = True
    m["lm_valid"][[3, 7]] = False                 # freed slots get reused
    m["lm_gid"][:n_lm] = np.arange(n_lm)
    m["lm_first_kf"][:n_lm] = rng.integers(-1, fill, n_lm)
    m["obs_valid"][:n_lm, :fill, 0] = rng.uniform(size=(n_lm, fill)) < 0.7
    m["obs_uv"][:n_lm, :fill] = rng.uniform(0, 300, (n_lm, fill, 2, 2))
    m["next_lm_gid"] = np.int32(n_lm)
    m["next_kf_gid"] = np.int32(fill)
    lm_slot = np.full(N, -1, np.int32)
    lm_slot[:20] = rng.permutation(n_lm)[:20]
    feat = dict(lm_slot=lm_slot,
                uv_l=rng.uniform(0, 300, (N, 2)).astype(np.float32),
                uv_r=rng.uniform(0, 300, (N, 2)).astype(np.float32),
                has_r=rng.uniform(size=N) < 0.8,
                valid=rng.uniform(size=N) < 0.9)
    T_new = np.array(se3_j.exp(jnp.asarray(
        np.float32([0.1, 0.0, -0.1 * fill, 0.0, 0.01, 0.0]))))
    return m, feat, T_new


@pytest.mark.parametrize("fill", [2, 4])        # free slot / full: eviction
def test_insert_keyframe_add_landmarks_ba_problem_match(fill):
    m, f, T_new = _random_map_inputs(401 + fill, fill=fill)
    mj = map_j.MapState(**{k: jnp.asarray(v) for k, v in m.items()})
    mt = interop.map_state(m)
    args = (T_new, f["lm_slot"], f["uv_l"], f["uv_r"], f["has_r"], f["valid"])
    mj2, slot_j, gid_j = map_j.insert_keyframe(mj, *[jnp.asarray(a) for a in args])
    mt2, slot_t, gid_t = map_t.insert_keyframe_device(
        mt, *[torch.from_numpy(a) for a in args])
    assert (int(slot_t), int(gid_t)) == (int(slot_j), int(gid_j))
    _assert_maps_equal(mt2, mj2)
    # the input map is left untouched (a rejected init drops the result)
    _assert_maps_equal(mt, mj)

    rng = np.random.default_rng(410 + fill)
    K = 40
    p_w = rng.uniform(-5, 5, (K, 3)).astype(np.float32)
    new_valid = rng.uniform(size=K) < 0.5
    add = (p_w, f["uv_l"], f["uv_r"], f["has_r"], new_valid)
    mj3, slots_j = map_j.add_landmarks(mj2, slot_j, gid_j,
                                       *[jnp.asarray(a) for a in add])
    mt3, slots_t = map_t.add_landmarks(mt2, slot_t, gid_t,
                                       *[torch.from_numpy(a) for a in add])
    np.testing.assert_array_equal(slots_t.numpy(), np.asarray(slots_j))
    _assert_maps_equal(mt3, mj3)

    pj = map_j.ba_problem_from_map(mj3)
    pt = map_t.ba_problem_from_map(mt3)
    for f_, a, b in zip(pt._fields, pt, pj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f_)

    obs = np.array(mj3.obs_valid)
    obs[:5] = False
    aj = map_j.apply_ba_result(mj3, mj3.kf_pose, mj3.lm_pos, jnp.asarray(obs))
    at = map_t.apply_ba_result(mt3, mt3.kf_pose, mt3.lm_pos,
                               torch.from_numpy(obs))
    _assert_maps_equal(at, aj)


@pytest.fixture(scope="module")
def jax_state():
    """A JAX System initialized on frame 0 and tracked through frame 3;
    frame 4 is the step under test."""
    world = synthetic.SyntheticWorld(seed=9)
    poses = synthetic.straight_trajectory(5, speed=0.35, yaw_rate=0.004)
    L, R = synthetic.render_stereo_sequence(world, poses, FX, FY, CX, CY,
                                            BASELINE, W, H)
    s = small_settings(backend_open=False, max_landmarks=2048)
    sj = SystemJ(s, enable_loop_closing=False)
    for i in range(4):
        sj.run_step(L[i], R[i], 0.1 * i)
    assert sj.status == fe_j.TRACKING_GOOD
    front_t = fe_t.Frontend(interop.settings(s), sj.w, sj.h, W, H,
                            device="cpu")
    pyr_l = sj.frontend.build_pyramid(sj._pad(L[4]))
    pyr_r = sj.frontend.build_pyramid(sj._pad(R[4]))
    return sj, front_t, pyr_l, pyr_r


def _pyr_t(pyr):
    return fe_t.Pyr(*[tuple(torch.from_numpy(np.array(a)) for a in part)
                      for part in pyr])


def test_track_step_from_jax_state_matches(jax_state):
    sj, front_t, pyr_l, _ = jax_state
    out_j = sj.frontend.track_step(sj.last_pyr, pyr_l, sj.feat, sj.T_cw,
                                   sj.rel_motion, sj.map.lm_pos,
                                   sj.map.lm_valid, sj.map.lm_gid)
    m = interop.map_state(sj.map)
    out_t = front_t._track_step(_pyr_t(sj.last_pyr), _pyr_t(pyr_l),
                                interop.feat_state(sj.feat),
                                interop.pose(sj.T_cw),
                                interop.pose(sj.rel_motion),
                                m.lm_pos, m.lm_valid, m.lm_gid)
    assert int(out_t.n_inliers) == int(out_j.n_inliers) > 50
    fj, ft = _np_dict(out_j.feat), interop.to_numpy(out_t.feat)
    np.testing.assert_array_equal(ft["valid"], fj["valid"])
    v = fj["valid"]
    np.testing.assert_allclose(ft["xy"][v], fj["xy"][v], atol=PX_TOL)
    for f in ("lm_slot", "lm_gid", "octave"):
        np.testing.assert_array_equal(ft[f], fj[f])
    assert _twist_err(out_t.T_cw.numpy(), np.asarray(out_j.T_cw)) < POSE_TOL
    assert _twist_err(out_t.rel_motion.numpy(),
                      np.asarray(out_j.rel_motion)) < POSE_TOL


def test_keyframe_step_from_jax_state_matches(jax_state):
    sj, front_t, pyr_l, pyr_r = jax_state
    budget = sj.s.n_new_features
    feat_j, m_j, slot_j, gid_j, nc_j, ns_j = sj.frontend.keyframe_step(
        pyr_l, pyr_r, sj.feat, sj.T_cw, sj.map, budget=budget)
    feat_t, m_t, *counts = front_t._keyframe_core(
        _pyr_t(pyr_l), _pyr_t(pyr_r), interop.feat_state(sj.feat),
        interop.pose(sj.T_cw), interop.map_state(sj.map), budget=budget)
    slot_t, gid_t, nc_t, ns_t = map(int, counts)
    assert (slot_t, gid_t, nc_t, ns_t) == (int(slot_j), int(gid_j),
                                           int(nc_j), int(ns_j))
    assert nc_t > 20
    fj, ft = _np_dict(feat_j), interop.to_numpy(feat_t)
    for f in ("valid", "lm_slot", "lm_gid", "octave"):
        np.testing.assert_array_equal(ft[f], fj[f], err_msg=f)
    np.testing.assert_allclose(ft["xy"], fj["xy"], atol=PX_TOL)
    mj, mt = _np_dict(m_j), interop.to_numpy(m_t)
    for f in ("kf_pose", "kf_gid", "kf_valid", "lm_valid", "lm_gid",
              "lm_first_kf", "obs_valid", "next_lm_gid", "next_kf_gid"):
        np.testing.assert_array_equal(mt[f], mj[f], err_msg=f)
    live = mj["lm_valid"]
    depth = np.linalg.norm(mj["lm_pos"][live], axis=1)
    err = np.linalg.norm(mt["lm_pos"][live] - mj["lm_pos"][live], axis=1)
    assert np.all(err <= 5e-3 * depth + 1e-5), (err / depth).max()
    ov = mj["obs_valid"]
    np.testing.assert_allclose(mt["obs_uv"][ov], mj["obs_uv"][ov], atol=PX_TOL)
