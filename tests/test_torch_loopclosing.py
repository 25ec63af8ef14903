"""Parity of the port's LoopClosing class (ssvio_tpu_torch/loopclosing.py)
with ssvio_tpu/loopclosing.py, method by method, on the CPU.

Inputs come from numpy seeds: random uint32 descriptors (the JAX package's
own type; `interop.descriptors` carries them as int32 bits), and a loop
scene built here with known geometry: a loop keyframe's landmarks, a
revisiting keyframe that sees them (descriptors equal up to a few flipped
bits, keypoints at the true projections), its drifted pose estimate, an
active map holding duplicates of the loop landmarks, and host keyframe
records. Both classes are brought to one state by `interop.loop_closing`.

PnP-RANSAC's hypotheses come from JAX's key chain (`PRNGKey(17)`, one
split per verification), handed to the port through its `sample_idx_fn`.

Tolerances, each where it is used: exact for integer and boolean results
(matches, database rows, fusion, gates); 1e-6 for BoW vectors and scores
(float32 sums in another order); 1e-5 for the rigid updates (a few float32
products); 1e-3 for PnP poses and the correction magnitude (two LM solves
to one minimum, tests/test_torch_loop_geom.py); 1e-4 for what PGO writes
(dense PGO, tests/test_torch_loop_geom.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssvio_tpu import frontend as fe_j
from ssvio_tpu import map as map_j
from ssvio_tpu.loopclosing import LoopClosing as LCJ
from ssvio_tpu.ops import bow as bow_j
from ssvio_tpu.ops import se3 as se3_j
from ssvio_tpu.system import System as SystemJ
from ssvio_tpu_torch import frontend as fe_t
from ssvio_tpu_torch import interop
from ssvio_tpu_torch import loopclosing as lc_mod
from ssvio_tpu_torch.loopclosing import LoopClosing as LCT
from ssvio_tpu_torch.loopclosing import transform_rows
from ssvio_tpu_torch.map import MapState
from ssvio_tpu_torch.ops import pnp as pnp_t
from ssvio_tpu_torch.ops import se3 as se3_t
from ssvio_tpu_torch.system import System as SystemT
from ssvio_tpu_torch.utils import profiling
from test_loopclosing import _small_settings
from test_torch_keyframe_graph import no_syncs
from test_torch_loop_geom import _jax_sample_idx
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

FX = FY = 320.0
CX, CY = 160.0, 64.0
RIGID_TOL = 1e-5
BOW_TOL = 1e-6
POSE_TOL = 1e-3
PGO_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _u32(rng, shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint32)


def _scene_settings():
    s = _small_settings()
    s.max_features = 48
    s.max_window = 4
    s.max_landmarks = 128
    s.max_keyframes_db = 16
    s.loop_desc_scales = 2
    s.vocab_k = 4
    s.vocab_levels = 2
    return s


def _pair(s):
    return (LCJ(s, FX, FY, CX, CY),
            LCT(interop.settings(s), FX, FY, CX, CY, device="cpu"))


def _jax_chain(seed=17):
    """The port's sample_idx_fn that draws what JAX's key chain draws:
    PRNGKey(seed), one split per call (ssvio_tpu/loopclosing.py:879,
    :1042), gumbel + top_k (ssvio_tpu/ops/pnp.py:108-110)."""
    state = {"key": jax.random.PRNGKey(seed)}

    def fn(valid, n_hypotheses):
        state["key"], sub = jax.random.split(state["key"])
        return _t(_jax_sample_idx(valid.numpy(), sub, n_hypotheses))
    return fn


def _same(a_t, a_j, atol=None, what=""):
    a, b = a_t.detach().cpu().numpy(), np.asarray(a_j)
    if b.dtype == np.uint32:
        a = a.view(np.uint32)
    if atol is None or not np.issubdtype(b.dtype, np.floating):
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=what)


def _same_map(m_t, m_j, atol):
    for f in MapState._fields:
        _same(getattr(m_t, f), getattr(m_j, f), atol, f)


def _same_feat(f_t, f_j):
    for f in fe_t.FeatState._fields:
        _same(getattr(f_t, f), getattr(f_j, f), 0.0, f)


# ----------------------------------------------------------------------
# matching, rigid updates, fusion, growth, refresh
# ----------------------------------------------------------------------

@pytest.mark.parametrize("gate", [0, 64])
def test_match_parity(gate):
    """The multi-scale match with the adaptive gate (0) and the fixed
    Hamming-64 gate, on descriptors with many equal distances: exact."""
    s = _small_settings()
    lc_j, lc_t = _pair(s)
    F, S = s.max_features, s.loop_desc_scales
    rng = np.random.default_rng(11)
    cur = _u32(rng, (S, F, 8))
    perm = rng.permutation(F)
    loop = cur[:, perm].copy()
    flip = (rng.random(loop.shape) < 0.15) \
        * (np.uint32(1) << rng.integers(0, 32, loop.shape).astype(np.uint32))
    loop ^= flip.astype(np.uint32)
    loop[:, :F // 4] = _u32(rng, (S, F // 4, 8))       # unmatched rows
    cur, loop = cur.reshape(S * F, 8), loop.reshape(S * F, 8)
    vc = rng.random(S * F) < 0.85
    vl = rng.random(S * F) < 0.85
    out_j = lc_j._match(jnp.asarray(cur), jnp.asarray(vc), jnp.asarray(loop),
                        jnp.asarray(vl), jnp.int32(gate))
    out_t = lc_t._match_impl(interop.descriptors(cur), _t(vc),
                             interop.descriptors(loop), _t(vl), gate)
    for a, b, name in zip(out_t, out_j, ("best_j", "dist", "ok")):
        _same(a, b, what=name)
    assert 20 < int(out_t[2].sum()) < F


def _random_poses(rng, n, scale=0.3):
    return np.stack([np.asarray(se3_j.exp(jnp.asarray(
        rng.normal(0, scale, 6), jnp.float32))) for _ in range(n)])


@pytest.mark.parametrize("op", ["correct_active", "move_rows",
                                "apply_row_deltas"])
def test_rigid_updates(op):
    """_correct_active, _move_rows and _apply_row_deltas (rows -1
    skipped) within 1e-5."""
    rng = np.random.default_rng(21)
    C = np.asarray(se3_j.exp(jnp.asarray([0.5, -0.2, 1.0, 0.1, 0.2, -0.05],
                                         jnp.float32)))
    if op == "correct_active":
        kf = _random_poses(rng, 8)
        lm = rng.normal(0, 5, (64, 3)).astype(np.float32)
        valid = rng.random(64) < 0.7
        out_j = LCJ._correct_active_impl(jnp.asarray(kf), jnp.asarray(lm),
                                         jnp.asarray(valid), jnp.asarray(C))
        out_t = LCT._correct_active_impl(_t(kf), _t(lm), _t(valid), _t(C))
        for a, b in zip(out_t, out_j):
            _same(a, b, RIGID_TOL)
        return
    db = rng.normal(0, 5, (16, 24, 3)).astype(np.float32)
    rows = np.array([3, -1, 7, 0, -1, 15, 9, -1], np.int32)
    if op == "move_rows":
        out_j = LCJ._move_rows_impl(jnp.asarray(db), jnp.asarray(rows),
                                    jnp.asarray(C))
        out_t = LCT._move_rows_impl(_t(db), _t(rows), _t(C))
    else:
        T = _random_poses(rng, len(rows))
        out_j = LCJ._apply_row_deltas_impl(jnp.asarray(db),
                                           jnp.asarray(rows), jnp.asarray(T))
        out_t = LCT._apply_row_deltas_impl(_t(db), _t(rows), _t(T))
    _same(out_t, out_j, RIGID_TOL)
    untouched = np.setdiff1d(np.arange(16), rows)
    np.testing.assert_array_equal(out_t.numpy()[untouched], db[untouched])


def _fusion_fixture():
    """tests/test_loopclosing.py::test_mappoint_fusion_merge_and_adopt's
    map: one merge, one adopt."""
    W, M, F = 4, 16, 8
    m = map_j.empty_map(W, M)
    m = m._replace(
        lm_pos=m.lm_pos.at[0].set(jnp.array([1.0, 2.0, 3.0]))
                       .at[1].set(jnp.array([1.1, 2.1, 3.1]))
                       .at[2].set(jnp.array([5.0, 5.0, 5.0])),
        lm_valid=m.lm_valid.at[:3].set(True),
        lm_gid=m.lm_gid.at[0].set(0).at[1].set(5).at[2].set(7),
        lm_first_kf=m.lm_first_kf.at[:3].set(3),
        obs_valid=m.obs_valid.at[0, 0, 0].set(True)
                             .at[1, 1, 0].set(True)
                             .at[2, 1, 0].set(True),
        obs_uv=m.obs_uv.at[1, 1, 0].set(jnp.array([10.0, 20.0])))
    feat = fe_j.empty_feat_state(F)
    feat = feat._replace(
        lm_slot=feat.lm_slot.at[0].set(1).at[1].set(2),
        lm_gid=feat.lm_gid.at[0].set(5).at[1].set(7),
        valid=feat.valid.at[:2].set(True))
    loop_pos = jnp.zeros((F, 3)).at[1].set(jnp.array([4.0, 4.0, 4.0]))
    loop_gid = jnp.full((F,), -1, jnp.int32).at[0].set(0).at[1].set(99)
    loop_has = jnp.zeros((F,), bool).at[:2].set(True)
    best_j = jnp.arange(F, dtype=jnp.int32)
    ok = jnp.zeros((F,), bool).at[:2].set(True)
    return m, feat, best_j, ok, loop_pos, loop_gid, loop_has


def _fusion_random(seed=31):
    """A random map: unique landmark gids, features linked to distinct
    slots (some links stale), loop features carrying gids that are in the
    map (merge), not in it (adopt) or none, one-to-one matches."""
    rng = np.random.default_rng(seed)
    W, M, F = 8, 64, 32
    gids = rng.permutation(1000)[:M].astype(np.int32)
    valid = rng.random(M) < 0.75
    m = map_j.empty_map(W, M)._replace(
        lm_pos=jnp.asarray(rng.normal(0, 5, (M, 3)).astype(np.float32)),
        lm_valid=jnp.asarray(valid), lm_gid=jnp.asarray(gids),
        lm_first_kf=jnp.asarray(rng.integers(0, 20, M).astype(np.int32)),
        obs_uv=jnp.asarray(rng.uniform(0, 300, (M, W, 2, 2))
                           .astype(np.float32)),
        obs_valid=jnp.asarray(rng.random((M, W, 2)) < 0.3))
    slots = rng.permutation(M)[:F].astype(np.int32)
    slots[rng.random(F) < 0.1] = -1
    f_gid = np.where(slots >= 0, gids[np.clip(slots, 0, M - 1)], -1)
    f_gid[rng.random(F) < 0.1] += 1                       # stale links
    feat = fe_j.empty_feat_state(F)._replace(
        xy=jnp.asarray(rng.uniform(0, 300, (F, 2)).astype(np.float32)),
        lm_slot=jnp.asarray(slots), lm_gid=jnp.asarray(f_gid.astype(np.int32)),
        valid=jnp.asarray(rng.random(F) < 0.9))
    in_map = rng.permutation(gids[valid])[:F]
    kind = rng.integers(0, 3, F)                   # 0 merge, 1 adopt, 2 none
    loop_gid = np.where(kind == 0, in_map, np.where(kind == 1,
                                                    2000 + np.arange(F), -1))
    return (m, feat, jnp.asarray(rng.permutation(F).astype(np.int32)),
            jnp.asarray(rng.random(F) < 0.8),
            jnp.asarray(rng.normal(0, 5, (F, 3)).astype(np.float32)),
            jnp.asarray(loop_gid.astype(np.int32)),
            jnp.asarray(rng.random(F) < 0.9))


@pytest.mark.parametrize("which", ["fixture", "random"])
def test_fuse_and_remap_feat(which):
    """_fuse (merge and adopt) and remap_feat: integer and boolean fields
    exact, positions within 1e-6; the port's map is a new one, and the
    map it was given is unchanged."""
    m_j, feat_j, best_j, ok, loop_pos, loop_gid, loop_has = (
        _fusion_fixture() if which == "fixture" else _fusion_random())
    out_j = LCJ._fuse_impl(m_j, feat_j, best_j, ok, loop_pos, loop_gid,
                           loop_has, jnp.int32(42))
    m_t = interop.map_state(m_j)
    before = interop.to_numpy(m_t)
    out_t = LCT._fuse_impl(m_t, interop.feat_state(feat_j), _t(best_j),
                           _t(ok), _t(loop_pos), _t(loop_gid), _t(loop_has),
                           42)
    _same_map(out_t[0], out_j[0], 1e-6)
    for a, b in zip(out_t[1:], out_j[1:]):
        _same(a, b)
    for f, v in interop.to_numpy(m_t).items():
        np.testing.assert_array_equal(v, before[f], err_msg=f)
    if which == "random":
        assert int(out_t[3]) >= 3 and int(out_t[4]) >= 3    # both cases ran
    f2_j = LCJ.remap_feat(feat_j, out_j[1], out_j[2], out_j[0].lm_gid)
    f2_t = LCT.remap_feat(interop.feat_state(feat_j), out_t[1], out_t[2],
                          out_t[0].lm_gid)
    _same_feat(f2_t, f2_j)


class _Warnings:
    def __init__(self):
        self.msgs = []

    def _warn(self, msg):
        self.msgs.append(msg)


def _clustered(rng, rows, n):
    """[rows, n, 8] uint32 descriptors, each row's spread around a centre
    of its own (10% of the bits flipped), so that BoW tells rows apart."""
    bits = (rng.random((rows, n, 8, 32)) < 0.1).astype(np.uint32)
    return _u32(rng, (rows, 1, 8)) ^ (
        bits << np.arange(32, dtype=np.uint32)).sum(-1, dtype=np.uint32)


def _fill_db(lc_j, rng, n):
    """Random database rows 0..n-1 in a JAX LoopClosing."""
    cap, FS = lc_j.desc_db.shape[:2]
    F = lc_j.F
    lc_j.desc_db = jnp.asarray(_clustered(rng, cap, FS))
    lc_j.desc_valid = jnp.asarray(rng.random((cap, FS)) < 0.6)
    lc_j.kp_xy = jnp.asarray(rng.normal(0, 50, (cap, F, 2)).astype(np.float32))
    lc_j.lm_pos = jnp.asarray(rng.normal(0, 5, (cap, F, 3)).astype(np.float32))
    lc_j.lm_has = jnp.asarray(rng.random((cap, F)) < 0.5)
    lc_j.lm_gid_db = jnp.asarray(rng.integers(-1, 300, (cap, F))
                                 .astype(np.int32))
    lc_j.bow_db = jnp.asarray(rng.random(lc_j.bow_db.shape, np.float32))
    gids = np.full(cap, -1, np.int64)
    gids[:n] = 3 * np.arange(n) + 1
    lc_j.db_gid = gids
    lc_j.db_gid_dev = jnp.asarray(gids.astype(np.int32))
    lc_j.row_of_gid = {int(g): r for r, g in enumerate(gids[:n])}
    lc_j.n = n
    lc_j.n_dev = jnp.int32(n)


def test_grow_keeps_rows_bit_identical():
    """_grow doubles the capacity: every stored row bit-identical to JAX's
    grown database, the new rows empty, the warning through _warn."""
    s = _scene_settings()
    s.max_keyframes_db = 4
    lc_j, _ = _pair(s)
    _fill_db(lc_j, np.random.default_rng(3), 4)
    lc_t = interop.loop_closing(lc_j, device="cpu")
    w_j, w_t = _Warnings(), _Warnings()
    lc_j._grow(w_j)
    lc_t._grow(w_t)
    assert lc_t.cap == lc_j.cap == 8 and w_t.msgs == w_j.msgs
    for f in ("bow_db", "desc_db", "desc_valid", "kp_xy", "lm_pos",
              "lm_has", "lm_gid_db", "db_gid_dev"):
        _same(getattr(lc_t, f), getattr(lc_j, f), what=f)
    np.testing.assert_array_equal(lc_t.db_gid, lc_j.db_gid)


def test_refresh_rows_exact():
    """_refresh_rows: snapshot positions of the given rows (-1 skipped)
    replaced by the live positions of their landmarks found in the map,
    the first slot where a gid is held twice: exact."""
    rng = np.random.default_rng(41)
    cap, F, M = 12, 24, 96
    db_pos = rng.normal(0, 5, (cap, F, 3)).astype(np.float32)
    db_gid = rng.integers(-1, 60, (cap, F)).astype(np.int32)
    m_pos = rng.normal(0, 5, (M, 3)).astype(np.float32)
    m_gid = rng.integers(0, 60, M).astype(np.int32)       # duplicates
    m_valid = rng.random(M) < 0.7
    rows = np.array([2, -1, 5, 11, -1, 0], np.int32)
    out_j = LCJ._refresh_rows_impl(jnp.asarray(db_pos), jnp.asarray(db_gid),
                                   jnp.asarray(rows), jnp.asarray(m_pos),
                                   jnp.asarray(m_gid), jnp.asarray(m_valid))
    out_t = LCT._refresh_rows_impl(_t(db_pos), _t(db_gid), _t(rows),
                                   _t(m_pos), _t(m_gid), _t(m_valid))
    _same(out_t, out_j)
    assert not np.array_equal(out_t.numpy()[rows[0]], db_pos[rows[0]])


# ----------------------------------------------------------------------
# ingest and vocabulary
# ----------------------------------------------------------------------

def _ingest_inputs(seed=51):
    s = _scene_settings()
    rng = np.random.default_rng(seed)
    lc_j, _ = _pair(s)
    n0 = 5
    _fill_db(lc_j, rng, n0)
    F, M, B = s.max_features, s.max_landmarks, 3
    FS = F * s.loop_desc_scales
    m_pos = rng.normal(0, 5, (M, 3)).astype(np.float32)
    m_gid = rng.integers(0, 300, M).astype(np.int32)
    m_valid = rng.random(M) < 0.8
    slot = rng.integers(-1, M, (B, F)).astype(np.int32)
    f_gid = np.where(slot >= 0, m_gid[np.clip(slot, 0, M - 1)], -1)
    f_gid[rng.random((B, F)) < 0.2] += 1
    group = dict(
        gids=np.array([20, 21, 25], np.int32),
        descs=_clustered(rng, B, FS), dvals=rng.random((B, FS)) < 0.6,
        xys=rng.uniform(0, 300, (B, F, 2)).astype(np.float32),
        valids=rng.random((B, F)) < 0.8, f_lm_slot=slot,
        f_lm_gid=f_gid.astype(np.int32), m_lm_pos=m_pos, m_lm_gid=m_gid,
        m_lm_valid=m_valid, refresh_rows=np.array([1, 3, 4, -1], np.int32))
    # the group's descriptors close to stored rows, so the scores mean
    # something; a vocabulary trained on the stored rows
    group["descs"][0] = np.asarray(lc_j.desc_db[2])
    group["dvals"][0] = np.asarray(lc_j.desc_valid[2])
    group["descs"][2] = np.asarray(lc_j.desc_db[4]) ^ np.uint32(1)
    docs = [np.asarray(lc_j.desc_db[i])[np.asarray(lc_j.desc_valid[i])]
            for i in range(n0)]
    vocab = bow_j.train(docs, k=s.vocab_k, levels=s.vocab_levels, seed=7)
    bow_rows = jax.vmap(lambda d, v: bow_j.transform(vocab, d, v, 2))(
        lc_j.desc_db, lc_j.desc_valid)
    lc_j.bow_db = jnp.where((jnp.arange(lc_j.cap) < n0)[:, None], bow_rows,
                            0.0)
    return lc_j, n0, group, vocab


DB = ("desc_db", "desc_valid", "kp_xy", "lm_pos", "lm_has", "lm_gid_db")


@pytest.mark.parametrize("kind", ["warm_up", "scoring"])
def test_ingest_parity(kind):
    """Both ingests on JAX's descriptors and vocabulary: the database
    tensors (with the snapshot refresh) exact; with scoring, the BoW rows,
    best_row and best_score (age gate 3, in-group pairs included) within
    1e-6."""
    lc_j, n0, g, vocab = _ingest_inputs()
    lc_t = interop.loop_closing(lc_j, device="cpu")
    gj = {k: jnp.asarray(v) for k, v in g.items()}
    gt = {k: _t(v) for k, v in g.items()}
    gt["descs"] = interop.descriptors(g["descs"])
    db_j = [jnp.array(getattr(lc_j, f)) for f in DB]
    db_t = [getattr(lc_t, f) for f in DB]
    args = ("descs", "dvals", "xys", "valids", "f_lm_slot", "f_lm_gid",
            "m_lm_pos", "m_lm_gid", "m_lm_valid")
    if kind == "warm_up":
        out_j = lc_j._ingest_nv(*db_j, jnp.array(lc_j.db_gid_dev),
                                jnp.int32(n0), gj["gids"],
                                *[gj[a] for a in args], gj["refresh_rows"])
        out_t = LCT._ingest_impl_nv(*db_t, lc_t.db_gid_dev, n0, gt["gids"],
                                    *[gt[a] for a in args],
                                    gt["refresh_rows"])
    else:
        out_j = lc_j._ingest_v(*db_j, jnp.array(lc_j.bow_db),
                               jnp.array(lc_j.db_gid_dev), jnp.int32(n0),
                               *[gj[a] for a in args], vocab, gj["gids"],
                               gj["refresh_rows"], min_age=3, levels=2)
        out_t = LCT._ingest_impl_v(*db_t, lc_t.bow_db, lc_t.db_gid_dev, n0,
                                   *[gt[a] for a in args],
                                   interop.vocabulary(vocab), gt["gids"],
                                   gt["refresh_rows"], min_age=3, levels=2)
    for a, b, name in zip(out_t[:6], out_j[:6], DB):
        _same(a, b, what=name)
    assert int(out_t[-2 if kind == "scoring" else -1]) == n0 + 3 \
        == int(out_j[-2 if kind == "scoring" else -1])
    if kind == "warm_up":
        _same(out_t[6], out_j[6], what="db_gid_dev")
        return
    _same(out_t[6], out_j[6], BOW_TOL, "bow_db")
    _same(out_t[7], out_j[7], what="db_gid_dev")
    pack_t, pack_j = out_t[9].numpy(), np.asarray(out_j[9])
    np.testing.assert_array_equal(pack_t[0], pack_j[0])       # best rows
    np.testing.assert_allclose(pack_t[1], pack_j[1], atol=BOW_TOL, rtol=0)
    # query 0 is a stored row's copy; query 2 (gid 25) sees the in-group
    # rows of gids 20 and 21 as well as the stored ones
    assert pack_t[0, 0] == 2 and pack_t[1, 0] > 0.99


def test_train_vocab_and_backfill():
    """_train_vocab from equal stored rows gives an equal vocabulary (tree,
    words, IDF weights) and back-filled BoW rows within 1e-6; the port's
    batched transform equals bow.transform row by row."""
    s = _scene_settings()
    lc_j, _ = _pair(s)
    _fill_db(lc_j, np.random.default_rng(61), 14)
    lc_t = interop.loop_closing(lc_j, device="cpu")
    lc_j._train_vocab(2)
    lc_t._train_vocab(2)
    v_j = interop.vocabulary(lc_j.vocab)
    for a, b, name in zip(lc_t.vocab, v_j, v_j._fields):
        _same(a, b, what=name)
    assert lc_t._vocab_levels == lc_j._vocab_levels == 2
    _same(lc_t.bow_db, lc_j.bow_db, BOW_TOL, "bow_db")
    rows = transform_rows(lc_t.vocab, lc_t.desc_db[:3], lc_t.desc_valid[:3],
                          2)
    from ssvio_tpu_torch.ops import bow as bow_t
    for i in range(3):
        np.testing.assert_allclose(
            rows[i].numpy(), bow_t.transform(lc_t.vocab, lc_t.desc_db[i],
                                             lc_t.desc_valid[i], 2).numpy(),
            atol=BOW_TOL, rtol=0)


# ----------------------------------------------------------------------
# the loop scene: verification, relocalization, _complete_loop
# ----------------------------------------------------------------------

DRIFT_DIR = np.array([0.6, -0.2, 0.7, 0.05, 0.1, -0.05])
LOOP_GID, CUR_GID = 1, 9
WINDOW_GIDS = [6, 7, 8, 9]
N_MERGE = 12


def _exp(xi):
    return se3_t.exp(torch.as_tensor(np.asarray(xi, np.float32))).numpy()


def _project(T_cw, P):
    pc = P @ T_cw[:, :3].T + T_cw[:, 3]
    return np.stack([FX * pc[:, 0] / pc[:, 2] + CX,
                     FY * pc[:, 1] / pc[:, 2] + CY], -1), pc


def _loop_scene(drift: float, seed=5):
    """numpy state of a revisit: keyframe gid 9 sees the landmarks of
    keyframe gid 1 (its database row 1) from 0.2 m aside; its estimate
    T_est is the truth moved by a twist of norm `drift`. See the module
    docstring."""
    s = _scene_settings()
    F, S, W, M = s.max_features, s.loop_desc_scales, s.max_window, \
        s.max_landmarks
    cap = s.max_keyframes_db
    rng = np.random.default_rng(seed)
    T_loop = _exp([1.0, 0.0, 2.0, 0.0, 0.3, 0.0])
    T_true = se3_t.compose_np(_exp([0.2, 0.0, 0.1, 0.0, 0.03, 0.0]), T_loop)
    T_est = se3_t.compose_np(
        _exp(drift * DRIFT_DIR / np.linalg.norm(DRIFT_DIR)), T_true)
    z = rng.uniform(4.0, 9.0, F)
    P_cam = np.stack([z * rng.uniform(-0.35, 0.35, F),
                      z * rng.uniform(-0.12, 0.12, F), z], -1)
    P = ((P_cam - T_loop[:, 3]) @ T_loop[:, :3]).astype(np.float32)
    perm = rng.permutation(F)
    xy, pc = _project(T_true, P[perm])
    assert (xy[:, 0] > 5).all() and (xy[:, 0] < 315).all() \
        and (xy[:, 1] > 5).all() and (xy[:, 1] < 123).all()
    xy = (xy + rng.normal(0, 0.3, xy.shape)).astype(np.float32)
    # the duplicates, where the drifted estimate put them
    p_dup = ((pc - T_est[:, 3]) @ T_est[:, :3]).astype(np.float32)

    desc = _clustered(rng, cap, S * F).reshape(cap, S, F, 8)
    desc[CUR_GID] = desc[LOOP_GID][:, perm]
    for _ in range(3):
        bits = rng.integers(0, 32, (S, F, 8)).astype(np.uint32)
        mask = (rng.random((S, F, 8)) < 0.05).astype(np.uint32)
        desc[CUR_GID] ^= (np.uint32(1) << bits) * mask
    lm_pos = rng.normal(0, 5, (cap, F, 3)).astype(np.float32)
    lm_pos[LOOP_GID], lm_pos[CUR_GID] = P, p_dup
    lm_gid = rng.integers(-1, 500, (cap, F)).astype(np.int32)
    lm_gid[LOOP_GID] = np.arange(F)
    lm_gid[CUR_GID] = 1000 + np.arange(F)
    lm_has = rng.random((cap, F)) < 0.7
    lm_has[LOOP_GID] = lm_has[CUR_GID] = True
    n = 10
    db_gid = np.full(cap, -1, np.int64)
    db_gid[:n] = np.arange(n)
    db = dict(desc_db=desc.reshape(cap, S * F, 8),
              desc_valid=np.arange(cap)[:, None] < n + np.zeros(S * F, int),
              kp_xy=rng.uniform(0, 300, (cap, F, 2)).astype(np.float32),
              lm_pos=lm_pos, lm_has=lm_has & (np.arange(cap) < n)[:, None],
              lm_gid_db=lm_gid, db_gid=db_gid, n=n)

    # host records: gids 0..9 on a circle of 5 m, gid 1 the loop keyframe,
    # gid 9 the drifted estimate; odometry edges between consecutive ones
    recs = []
    for g in range(n):
        a = 2 * np.pi * g / 12
        T_wc = np.array([[np.cos(a), 0, np.sin(a), 5 * np.sin(a)],
                         [0, 1, 0, 0],
                         [-np.sin(a), 0, np.cos(a), 5 * (1 - np.cos(a))]],
                        np.float32)
        recs.append(se3_t.inverse_np(T_wc))
    recs[LOOP_GID], recs[CUR_GID] = T_loop, T_est

    # the live window: gids 6-9; landmark slots 0..F-1 the current
    # features' duplicates, slots F.. the first N_MERGE loop landmarks
    # still resident (fusion merges those and adopts the rest)
    lm_valid = np.zeros(M, bool)
    lm_valid[:F + N_MERGE] = True
    m_gid = np.full(M, -1, np.int32)
    m_gid[:F] = 1000 + np.arange(F)
    m_gid[F:F + N_MERGE] = np.arange(N_MERGE)
    m_pos = np.zeros((M, 3), np.float32)
    m_pos[:F], m_pos[F:F + N_MERGE] = p_dup, P[:N_MERGE]
    obs_valid = np.zeros((M, W, 2), bool)
    obs_uv = np.zeros((M, W, 2, 2), np.float32)
    obs_valid[:F, 3, 0] = True
    obs_uv[:F, 3, 0] = xy
    obs_valid[F:F + N_MERGE, 0, 0] = True
    obs_uv[F:F + N_MERGE, 0, 0] = 100.0
    first = np.full(M, -1, np.int32)
    first[:F], first[F:F + N_MERGE] = CUR_GID, 6
    m = dict(kf_pose=np.stack([recs[g] for g in WINDOW_GIDS]),
             kf_gid=np.array(WINDOW_GIDS, np.int32),
             kf_valid=np.ones(W, bool), lm_pos=m_pos, lm_valid=lm_valid,
             lm_gid=m_gid, lm_first_kf=first, obs_uv=obs_uv,
             obs_valid=obs_valid, next_lm_gid=np.int32(2000),
             next_kf_gid=np.int32(10))
    feat = dict(xy=xy, lm_slot=np.arange(F, dtype=np.int32),
                lm_gid=(1000 + np.arange(F)).astype(np.int32),
                valid=np.ones(F, bool), octave=np.zeros(F, np.int32))
    return dict(s=s, db=db, recs=recs, m=m, feat=feat, T_est=T_est,
                T_true=T_true)


@pytest.fixture(scope="module")
def jax_pair():
    """One JAX LoopClosing and System for every scene test (their jitted
    programs compile once); each test resets their state."""
    s = _scene_settings()
    return LCJ(s, FX, FY, CX, CY), SystemJ(s, enable_backend=True,
                                           enable_loop_closing=False)


def _load(lc_j, sc):
    """A JAX LoopClosing in the scene's state, gates reset, key at 17."""
    db = sc["db"]
    for f in DB:
        setattr(lc_j, f, jnp.asarray(db[f]))
    lc_j.db_gid = db["db_gid"].copy()
    lc_j.db_gid_dev = jnp.asarray(db["db_gid"].astype(np.int32))
    lc_j.row_of_gid = {g: g for g in range(db["n"])}
    lc_j.n, lc_j.n_dev = db["n"], jnp.int32(db["n"])
    lc_j.vocab = None
    lc_j._vocab_levels = lc_j.s.vocab_levels
    lc_j.bow_db = jnp.zeros((lc_j.cap,
                             lc_j.s.vocab_k ** lc_j.s.vocab_levels))
    lc_j.last_closed_gid = -(10 ** 9)
    lc_j._residual_anchor = (0, 0.0)
    lc_j._large_hist, lc_j.loop_edges, lc_j.events = [], [], []
    lc_j._rng_key = jax.random.PRNGKey(17)
    if hasattr(lc_j, "last_loop_gid"):
        del lc_j.last_loop_gid
    lc_t = interop.loop_closing(lc_j, device="cpu")
    lc_t.sample_idx_fn = _jax_chain()
    return lc_t


def test_verify_parity(jax_pair):
    """_verify on the scene with JAX's samples: n_matches, PnP ok and the
    inlier mask equal; T_corr and the correction magnitude within 1e-3;
    T_corr is the true pose."""
    lc_j, _ = jax_pair
    sc = _loop_scene(0.3)
    lc_t = _load(lc_j, sc)
    _, sub = jax.random.split(jax.random.PRNGKey(17))
    pack_j, bj_j, inl_j = lc_j._verify(
        lc_j.desc_db, lc_j.desc_valid, lc_j.lm_has, lc_j.lm_pos,
        jnp.int32(CUR_GID), jnp.int32(LOOP_GID), jnp.asarray(sc["feat"]["xy"]),
        sub, jnp.asarray(sc["T_est"]))
    pack_t, bj_t, inl_t = lc_t._verify_impl(
        lc_t.desc_db, lc_t.desc_valid, lc_t.lm_has, lc_t.lm_pos, CUR_GID,
        LOOP_GID, _t(sc["feat"]["xy"]), _t(sc["T_est"]))
    pj, pt = np.asarray(pack_j), pack_t.numpy()
    np.testing.assert_array_equal(pt[:3], pj[:3])
    assert abs(pt[3] - pj[3]) < POSE_TOL
    np.testing.assert_allclose(pt[4:], pj[4:], atol=POSE_TOL, rtol=0)
    _same(bj_t, bj_j)
    _same(inl_t, inl_j)
    assert pt[1] == 1.0 and pt[0] >= 40
    np.testing.assert_allclose(pt[4:].reshape(3, 4), sc["T_true"], atol=0.02)


@pytest.mark.parametrize("case", ["hit", "low_score", "few_matches"])
def test_relocalize_parity(jax_pair, case):
    """relocalize with the same descriptors on both sides (its _describe
    replaced) and JAX's samples: the same answer (a pose within 1e-3 and
    the inlier count, or None), the true pose on a hit."""
    lc_j, _ = jax_pair
    sc = _loop_scene(0.3)
    s = lc_j.s
    saved = (s.loop_threshold_lower, s.reloc_min_inliers, lc_j._describe)
    try:
        if case == "low_score":
            s.loop_threshold_lower = 1.01
        elif case == "few_matches":
            s.reloc_min_inliers = 1000
        lc_t = _load(lc_j, sc)
        lc_j._train_vocab(2)
        lc_t._train_vocab(2)
        # the revisiting keyframe is not in the database: retrieval has
        # to find the loop keyframe
        lc_j.db_gid[CUR_GID] = lc_t.db_gid[CUR_GID] = -1
        d = sc["db"]["desc_db"][CUR_GID]
        v = sc["db"]["desc_valid"][CUR_GID]
        lc_j._describe = lambda img, xy, valid: (jnp.asarray(d),
                                                 jnp.asarray(v))
        lc_t._describe = lambda img, xy, valid: (interop.descriptors(d),
                                                 _t(v))
        xy, valid = sc["feat"]["xy"], sc["feat"]["valid"]
        img = np.zeros((128, 320), np.float32)
        out_j = lc_j.relocalize(jnp.asarray(img), jnp.asarray(xy),
                                jnp.asarray(valid))
        out_t = lc_t.relocalize(_t(img), _t(xy), _t(valid))
    finally:
        s.loop_threshold_lower, s.reloc_min_inliers, lc_j._describe = saved
    if case != "hit":
        assert out_j is None and out_t is None
        return
    assert out_j is not None and out_t is not None
    assert out_t[1] == out_j[1] >= 40
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]),
                               atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(out_t[0].numpy(), sc["T_true"], atol=0.02)


def _systems(sj, sc, events, health):
    """The JAX System `sj` and a port System in the scene's state."""
    m_j = map_j.empty_map(sc["s"].max_window, sc["s"].max_landmarks)._replace(
        **{k: jnp.asarray(v) for k, v in sc["m"].items()})
    feat_j = fe_j.FeatState(**{k: jnp.asarray(v)
                               for k, v in sc["feat"].items()})
    st = SystemT(interop.settings(sc["s"]), enable_backend=True,
                 enable_loop_closing=False, device="cpu")
    for sys_, m, feat, T in ((sj, m_j, feat_j, jnp.asarray(sc["T_est"])),
                             (st, interop.map_state(m_j),
                              interop.feat_state(feat_j), _t(sc["T_est"]))):
        sys_.map, sys_.feat, sys_.T_cw = m, feat, T
        sys_.track_health, sys_.track_health_typical = health
    # the same records in both: the JAX System's fields, the port's
    # KeyframeRecords
    for g, T_g in enumerate(sc["recs"]):
        st.records.add(g, 0.1 * g, T_g.copy(), g)
    for C in events:
        st.records.add_gauge_event(C.copy())
    sj.keyframes = [dict(gid=g, frame_id=g, timestamp=0.1 * g,
                         T_cw=T_g.copy()) for g, T_g in enumerate(sc["recs"])]
    sj._rec_by_gid = {r["gid"]: r for r in sj.keyframes}
    sj.kf_rel_edges = [(a, b, Z.copy())
                       for a, b, Z in st.records.odometry_edges]
    sj._gauge_events = [C.copy() for C in events]
    sj._kf_cache = None
    return st, feat_j


# case -> (drift, health, gauge events, gauge_idx, kf_gids, settings,
#          the outcome of each call)
C0 = _exp([0.01, 0.0, -0.02, 0.0, 0.004, 0.0])
CASES = {
    "accept": (0.3, (100.0, 100.0), [], 0, [CUR_GID], {}, [True]),
    "accept_discounted": (0.3, (100.0, 100.0), [C0], 0, [CUR_GID], {},
                          [True]),
    "health": (0.3, (50.0, 100.0), [], 0, [CUR_GID], {}, [False]),
    "below_min": (0.02, (100.0, 100.0), [], 0, [CUR_GID], {}, [False]),
    "drift_rate_3_twists": (1.0, (100.0, 100.0), [], 0, [9, 10, 11], {},
                            [False, False, True]),
    "above_max": (12.0, (100.0, 100.0), [], 0, [CUR_GID],
                  dict(loop_drift_per_kf=0.0), [False]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_complete_loop_parity(jax_pair, case):
    """_complete_loop on both classes from one state (interop.loop_closing
    and a System in the scene's state), through each gate: equal events
    (error within 1e-3), loop edges and gate state; after a correction the
    fused map's integers equal and its poses and positions within 1e-4,
    the host records after PGO, the database snapshots, the current pose
    and the gauge events within 1e-4."""
    lc_j, sj = jax_pair
    drift, health, events, gauge_idx, kf_gids, over, outcome = CASES[case]
    sc = _loop_scene(drift)
    s = lc_j.s
    saved = {k: getattr(s, k) for k in over}
    try:
        for k, v in over.items():
            setattr(s, k, v)
        lc_t = _load(lc_j, sc)
        st, feat_j = _systems(sj, sc, events, health)
        feat_t = interop.feat_state(feat_j)
        for g in kf_gids:
            ev_j = lc_j._complete_loop(sj, g, CUR_GID, feat_j,
                                       jnp.asarray(sc["T_est"]), LOOP_GID,
                                       0.5, gauge_idx)
            ev_t = lc_t._complete_loop(st, g, CUR_GID, feat_t, sc["T_est"],
                                       LOOP_GID, 0.5, gauge_idx)
            assert ev_t[:5] == tuple(ev_j[:5]) and ev_t[6:] == ev_j[6:]
            assert abs(ev_t.error - ev_j.error) < POSE_TOL
    finally:
        for k, v in saved.items():
            setattr(s, k, v)
    assert [e.corrected for e in lc_t.events] == outcome
    assert len(lc_t.loop_edges) == len(lc_j.loop_edges)
    for (a, b, Z), (aj, bj, Zj) in zip(lc_t.loop_edges, lc_j.loop_edges):
        assert (a, b) == (aj, bj)
        np.testing.assert_allclose(Z, Zj, atol=PGO_TOL, rtol=0)
    assert lc_t.last_closed_gid == lc_j.last_closed_gid
    assert lc_t._residual_anchor[0] == lc_j._residual_anchor[0]
    assert abs(lc_t._residual_anchor[1] - lc_j._residual_anchor[1]) \
        < POSE_TOL
    assert [g for g, _ in lc_t._large_hist] == \
        [g for g, _ in lc_j._large_hist]
    assert lc_t.last_loop_gid == getattr(lc_j, "last_loop_gid", None)
    if case == "below_min":            # a consistent verification
        assert len(lc_t.loop_edges) == 1
    if not outcome[-1]:
        return
    ev = lc_t.events[-1]
    assert ev.n_fused == ev.n_inliers >= 40
    _same_map(st.map, sj.map, PGO_TOL)
    _same_feat(st.feat, sj.feat)
    _same(st.T_cw, sj.T_cw, PGO_TOL)
    for r_t, r_j in zip(st.records.keyframes, sj.keyframes):
        np.testing.assert_allclose(r_t["T_cw"], r_j["T_cw"], atol=PGO_TOL,
                                   rtol=0, err_msg=str(r_t["gid"]))
    _same(lc_t.lm_pos, lc_j.lm_pos, PGO_TOL)
    for C_t, C_j in zip(st.records.gauge_events, sj._gauge_events):
        np.testing.assert_allclose(C_t, C_j, atol=PGO_TOL, rtol=0)
    if not events:       # the correction moved the pose onto the truth
        assert np.linalg.norm(se3_t.inverse_np(st.T_cw.numpy())[:, 3]
                              - se3_t.inverse_np(sc["T_true"])[:, 3]) < 0.05


# ----------------------------------------------------------------------
# the verification in stages (VerifyGraphs)
# ----------------------------------------------------------------------

class _Warns:
    def _warn(self, msg):
        pass


def _candidates(sc, seed=9):
    """Four verifications of the scene's database: the revisit against
    its loop keyframe, against an unrelated row, with another estimate
    and noisier keypoints, and the revisit again after the database grew
    (None: _grow first)."""
    rng = np.random.default_rng(seed)
    xy, T = _t(sc["feat"]["xy"]), _t(sc["T_est"])
    xy2 = xy + _t(rng.normal(0, 1.5, xy.shape).astype(np.float32))
    T2 = _t(se3_t.compose_np(_exp([0.3, -0.2, 0.4, 0.02, 0.0, 0.05]),
                             sc["T_true"]))
    return [(CUR_GID, LOOP_GID, xy, T), (CUR_GID, 4, xy, T),
            (CUR_GID, LOOP_GID, xy2, T2), None, (CUR_GID, LOOP_GID, xy, T)]


def _verify_each(lc, cands, staged):
    out = []
    for c in cands:
        if c is None:
            lc._grow(_Warns())
        elif staged:
            out.append(lc._verify(*c))
        else:
            out.append(lc._verify_impl(lc.desc_db, lc.desc_valid, lc.lm_has,
                                       lc.lm_pos, *c))
    return out


@pytest.mark.parametrize("draws", ["generator", "jax_samples"])
def test_staged_verify_equals_eager(jax_pair, draws):
    """Several candidates one after another, once op by op
    (_verify_impl) and once as _complete_loop verifies them (_verify:
    the stages' VerifyGraphs, run on their buffers on the CPU), the last
    after _grow, with the generator's draws or JAX's samples
    (sample_idx_fn): equal pack, best_j and inlier mask, the same
    generator state after; an accepted and a rejected PnP among them."""
    lc_j, _ = jax_pair
    sc = _loop_scene(0.3)
    cands = _candidates(sc)
    runs = []
    for staged in (False, True):
        lc = _load(lc_j, sc)
        if draws == "generator":
            lc.sample_idx_fn = None
        runs.append((lc, _verify_each(lc, cands, staged)))
    (lc_e, eager), (lc_g, staged) = runs
    assert lc_e._graphs is None
    vg = lc_g._graphs
    assert not vg.captured
    assert [g.calls for g in vg.stages] == [len(eager)] * 3
    assert lc_g.cap == 2 * sc["s"].max_keyframes_db
    for (p_e, bj_e, in_e), (p_g, bj_g, in_g) in zip(eager, staged):
        assert torch.equal(p_g, p_e)
        assert torch.equal(bj_g, bj_e) and bj_g.dtype == torch.int32
        assert torch.equal(in_g, in_e)
    assert torch.equal(lc_g._gen.get_state(), lc_e._gen.get_state())
    packs = [p.numpy() for p, _, _ in eager]
    assert packs[0][1] == 1.0 and packs[0][0] >= 40
    assert packs[1][1] == 0.0 and packs[1][0] < 10
    assert packs[3][1] == 1.0 and packs[3][0] == packs[0][0]


def test_verify_stages_read_no_host_value(jax_pair, monkeypatch):
    """The three stages (the stretches a CUDA graph holds) read nothing
    from the host, under the dispatch guard of the keyframe graph's
    tests; the two DLT fits between them run outside it."""
    lc_j, _ = jax_pair
    sc = _loop_scene(0.3)
    lc = _load(lc_j, sc)
    st = lc_mod.verify_stages(lc.F, lc.S, FX, FY, CX, CY)
    u = pnp_t.draw_uniforms(lc_mod.N_HYP, lc.F, lc._gen)
    db = (lc.desc_db[CUR_GID], lc.desc_valid[CUR_GID], lc.desc_db[LOOP_GID],
          lc.desc_valid[LOOP_GID], lc.lm_has[LOOP_GID], lc.lm_pos[LOOP_GID])
    xy, T = _t(sc["feat"]["xy"]), _t(sc["T_est"])
    with no_syncs(monkeypatch):
        best_j, ok, p_w, xn, idx = st.match(*db, xy, u)
    T_dlt = pnp_t.minimal_fit(p_w, xn, idx)
    with no_syncs(monkeypatch):
        T_hyp, inl, scores, w_lo = st.polish(T_dlt, p_w, xy, ok, idx)
    T_lo = pnp_t.refit(p_w, xn, w_lo)
    with no_syncs(monkeypatch):
        pack, inlier = st.finish(T_lo, T_hyp, inl, scores, p_w, xy, ok, T)
    assert idx.shape == (lc_mod.N_HYP, lc_mod.SAMPLE)
    assert pack[1] == 1.0 and int(inlier.sum()) == int(pack[2]) >= 40


def test_system_hands_the_verify_graphs_over():
    """A System's loop closer builds its VerifyGraphs with the vocabulary
    (none on the CPU is captured, and none counts a capture); a reset,
    with or without the vocabulary, hands the same graphs to the new loop
    closer; close() releases them. An eager System verifies op by op and
    builds none."""
    s = interop.settings(_scene_settings())
    st = SystemT(s, enable_backend=True, enable_loop_closing=True,
                 device="cpu")
    lc = st.loopclosing
    assert lc._graphs is None and not lc.eager
    n = lc.F * lc.S
    counters = profiling.TRACE.counters
    lc.desc_db[:4] = torch.randint(-2 ** 31, 2 ** 31 - 1, (4, n, 8),
                                   dtype=torch.int32,
                                   generator=torch.Generator().manual_seed(3))
    lc.desc_valid[:4] = True
    lc.n = 4
    before = counters.get(lc_mod.VERIFY_CAPTURES, 0)
    lc._train_vocab(s.vocab_levels)
    vg = lc._graphs
    assert vg is not None and not vg.captured
    assert counters.get(lc_mod.VERIFY_CAPTURES, 0) == before
    st.reset(keep_vocab=True)
    assert st.loopclosing is not lc and st.loopclosing._graphs is vg
    st.reset()
    assert st.loopclosing._graphs is vg
    st.close()
    assert st.loopclosing._graphs is None
    assert all(g._in is None for g in vg.stages)
    eager = SystemT(s, enable_backend=True, enable_loop_closing=True,
                    device="cpu", eager=True)
    lc_e = eager.loopclosing
    assert lc_e.eager
    lc_e.desc_db, lc_e.desc_valid, lc_e.n = lc.desc_db, lc.desc_valid, 4
    lc_e._train_vocab(s.vocab_levels)
    assert lc_e._graphs is None


def test_interop_carries_deferred_state():
    """interop.loop_closing carries the deferred candidates, the loop edges
    and the drift-rate history."""
    s = _scene_settings()
    lc_j, _ = _pair(s)
    _fill_db(lc_j, np.random.default_rng(71), 6)
    rng = np.random.default_rng(72)
    F = s.max_features
    feats = (jnp.asarray(rng.normal(size=(2, F, 2)).astype(np.float32)),
             jnp.ones((2, F), bool), jnp.zeros((2, F), jnp.int32),
             jnp.zeros((2, F), jnp.int32))
    lc_j._pending = [(jnp.asarray([[1.0, 2.0], [0.5, 0.25]]), [4, 5], [9, 12],
                      feats, [np.eye(3, 4, dtype=np.float32)] * 2, 3)]
    lc_j.loop_edges = [(1, 9, np.eye(3, 4, dtype=np.float32))]
    lc_j._large_hist = [(9, np.arange(6.0))]
    lc_j._residual_anchor = (9, 0.25)
    lc_j.last_loop_gid = 1
    lc_t = interop.loop_closing(lc_j, device="cpu")
    (pack, rows, gids, f_t, Ts, gi), = lc_t._pending
    assert rows == [4, 5] and gids == [9, 12] and gi == 3
    np.testing.assert_array_equal(pack.numpy(), [[1.0, 2.0], [0.5, 0.25]])
    for a, b in zip(f_t, feats):
        _same(a, b)
    assert lc_t.loop_edges[0][:2] == (1, 9)
    assert lc_t._large_hist[0][0] == 9 and lc_t._residual_anchor == (9, 0.25)
    assert lc_t.last_loop_gid == 1 and lc_t.n == 6 and lc_t.cap == 16
    assert lc_t.row_of_gid == lc_j.row_of_gid
