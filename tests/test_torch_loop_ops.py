"""Parity of the port's loop-closing ops with ssvio_tpu: ORB descriptors
and Hamming matching (ops/orb.py), the sparse FAST re-screen
(ops/fast.py::fast_check_sparse), the descriptor ladder
(loopclosing.py::loop_describe) and the vocabulary tree (ops/bow.py).
PnP-RANSAC and the pose graph are in test_torch_loop_geom.py.

Each test makes its inputs with numpy from its own seed, feeds the same
arrays to the JAX function (on the CPU) and to its port, and states its
tolerance at the assertion. Integer results (popcounts, distances, matches,
word ids, the trained tree, the FAST booleans) are held exactly. The port
carries descriptors as int32 holding the bits of the JAX package's uint32
(`interop.descriptors` / `descriptors_numpy`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssvio_tpu import loopclosing as lc_j
from ssvio_tpu.config import Settings as SettingsJ
from ssvio_tpu.ops import bow as bow_j
from ssvio_tpu.ops import fast as fast_j
from ssvio_tpu.ops import orb as orb_j
from ssvio_tpu.ops import pyramid as pyramid_j
from ssvio_tpu_torch import interop
from ssvio_tpu_torch import loopclosing as lc_t
from ssvio_tpu_torch.config import Settings as SettingsT
from ssvio_tpu_torch.ops import bow as bow_t
from ssvio_tpu_torch.ops import fast as fast_t
from ssvio_tpu_torch.ops import orb as orb_t
from ssvio_tpu_torch.ops import pyramid as pyramid_t
from test_bow import _perturb, _random_desc
from test_fast_orb import isolated_squares
from test_torch_ops import _texture, one_torch_thread  # noqa: F401 (autouse)

# ic_angle_integral subtracts float32 prefix sums of up to ~4e8 (the
# first-moment prefix at KITTI width), so each moment carries an absolute
# error of a few ulps of the prefix whatever its own size, and the angle of
# a keypoint with weak moments moves by up to ~0.2 rad. That is so in both
# packages: the order of `cumsum` differs between XLA:CPU and torch, and
# the JAX package's own integral angle is as far from its order-free
# ic_angle as the port's is. Measured on the 1241-wide textures below
# (port against JAX / port against ic_angle / JAX against its ic_angle):
# median 3.3e-4 / 2.0e-4 / 2.8e-4 rad, 99th percentile 1.3e-2 / 1.0e-2 /
# 1.2e-2, largest 0.24 / 0.09 / 0.15. Held by the median, by the share
# within 2e-2 rad, and tightly on a narrow image where the prefixes are
# small (128x320: largest 2.4e-3 / 1.3e-3).
INTEGRAL_MEDIAN_TOL = 1e-3
INTEGRAL_WIDE_TOL = 2e-2
INTEGRAL_WIDE_MIN_SHARE = 0.98
INTEGRAL_NARROW_TOL = 5e-3
# ic_angle and ic_angle_conv sum ~709 products in float32 in another order
# than XLA does: measured 8e-6 and 3e-5 rad
ANGLE_TOL = 1e-4
# descriptors from one angle array on both sides: cos / sin may differ by
# an ulp and flip a rounded tap at a .5 boundary, which changes the bits
# that tap feeds. Measured: every descriptor equal; held at >= 0.99 equal
# and at most 8 bits apart.
DESC_MIN_EQUAL_SHARE = 0.99
DESC_MAX_HAMMING = 8


def _ang_diff(a, b):
    return np.abs(np.angle(np.exp(1j * (np.asarray(a) - np.asarray(b)))))


def _t(a):
    return torch.from_numpy(np.array(a))


def _interior_xy(rng, n, h, w, border=24):
    return np.stack([rng.uniform(border, w - 1 - border, n),
                     rng.uniform(border, h - 1 - border, n)],
                    -1).astype(np.float32)


def _bits(desc_u32):
    """[..., 8] uint32 -> [..., 256] bits, by numpy alone."""
    return np.unpackbits(np.ascontiguousarray(desc_u32).view(np.uint8),
                         axis=-1)


# ----------------------------------------------------------------------
# ops/orb.py
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["brief_pattern", "brief_pool_pattern",
                                  "_ic_angle_offsets", "_circle_rows",
                                  "_moment_kernel"])
def test_orb_tables_equal(name):
    """The seeded numpy tables are the JAX package's, exactly."""
    a, b = getattr(orb_j, name)(), getattr(orb_t, name)()
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_load_pattern_file_equal(tmp_path):
    rng = np.random.default_rng(11)
    pat = np.clip(rng.normal(0, 6.2, (256, 4)).round(), -13, 13).astype(int)
    p = tmp_path / "pattern.txt"
    p.write_text("# dump\n" + "\n".join(
        " ".join(str(v) for v in row) + "," for row in pat))
    np.testing.assert_array_equal(orb_t.load_pattern_file(str(p)),
                                  orb_j.load_pattern_file(str(p)))
    bad = tmp_path / "bad.txt"
    bad.write_text("1 2 3")
    with pytest.raises(ValueError):
        orb_t.load_pattern_file(str(bad))
    # the settings plumb-through
    sj, st = SettingsJ(), SettingsT()
    sj.brief_pattern_path = st.brief_pattern_path = str(p)
    np.testing.assert_array_equal(lc_t.pattern_from_settings(st),
                                  lc_j.pattern_from_settings(sj))
    assert lc_t.pattern_from_settings(SettingsT()) is None


def test_popcount_exact():
    """int32 shifts are arithmetic: the sign bit and all-ones words are
    the cases a missing mask breaks. Exact against np.unpackbits."""
    rng = np.random.default_rng(12)
    x = np.concatenate([
        np.array([0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0, 1, 0xAAAAAAAA,
                  0x55555555, 0xF0F0F0F0, 0x80000001], np.uint32),
        rng.integers(0, 2 ** 32, 4096, dtype=np.uint32)])
    want = np.unpackbits(x.view(np.uint8).reshape(-1, 4), axis=1).sum(1)
    got = orb_t._popcount32(interop.descriptors(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(orb_j._popcount32(jnp.asarray(x))))


def test_interop_descriptors_roundtrip():
    rng = np.random.default_rng(13)
    d = rng.integers(0, 2 ** 32, (9, 8), dtype=np.uint32)
    d[0] = 0xFFFFFFFF
    t = interop.descriptors(d)
    assert t.dtype == torch.int32 and t.shape == (9, 8)
    np.testing.assert_array_equal(interop.descriptors_numpy(t), d)


def test_hamming_distance_exact():
    """Pairwise and broadcast [Na, 1, 8] x [1, Nb, 8] distances, exact
    against the JAX package and against numpy's bit count."""
    rng = np.random.default_rng(14)
    a = rng.integers(0, 2 ** 32, (37, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (53, 8), dtype=np.uint32)
    a[0], b[0] = 0xFFFFFFFF, 0
    a[1], b[1] = 0x80000000, 0
    ta, tb = interop.descriptors(a), interop.descriptors(b)
    want = (_bits(a)[:, None] != _bits(b)[None]).sum(-1)
    got = orb_t.hamming_distance(ta[:, None, :], tb[None, :, :])
    assert got.dtype == torch.int32 and got.shape == (37, 53)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        orb_j.hamming_distance(jnp.asarray(a)[:, None], jnp.asarray(b)[None])))
    np.testing.assert_array_equal(
        orb_t.hamming_distance(ta[:30], tb[:30]).numpy(),
        np.diagonal(want)[:30])
    assert int(got[0, 0]) == 256 and int(got[1, 1]) == 8


def test_ic_angle_matches():
    rng = np.random.default_rng(15)
    img = _texture(15, 96, 160)
    xy = _interior_xy(rng, 64, 96, 160, border=16)
    xy[:4] = [[2.0, 3.0], [158.0, 94.0], [80.0, 1.0], [0.0, 50.0]]  # clamped
    a_j = orb_j.ic_angle(jnp.asarray(img), jnp.asarray(xy))
    a_t = orb_t.ic_angle(_t(img), _t(xy))
    assert _ang_diff(a_t.numpy(), a_j).max() < ANGLE_TOL


def test_ic_angle_conv_matches():
    """conv2d is a cross-correlation as XLA's conv is: no kernel flip (a
    flipped kernel would turn every angle by pi)."""
    rng = np.random.default_rng(16)
    img = _texture(16, 96, 160)
    xy = _interior_xy(rng, 64, 96, 160, border=22)
    a_j = orb_j.ic_angle_conv(jnp.asarray(img), jnp.asarray(xy))
    a_t = orb_t.ic_angle_conv(_t(img), _t(xy))
    assert _ang_diff(a_t.numpy(), a_j).max() < ANGLE_TOL
    # and the port's own order-free version on interior keypoints
    assert _ang_diff(a_t.numpy(),
                     orb_t.ic_angle(_t(img), _t(xy)).numpy()).max() < 1e-3


@pytest.mark.parametrize("h,w", [(96, 1241), (128, 320)])
def test_ic_angle_integral_matches(h, w):
    """At KITTI width, where the first-moment prefix sums are largest, and
    on a narrow image; interior keypoints; against the JAX package and
    against the order-free ic_angle (INTEGRAL_* above)."""
    rng = np.random.default_rng(17)
    img = _texture(17, h, w)
    xy = _interior_xy(rng, 512, h, w)
    xy[:32, 0] = rng.uniform(w - 60, w - 25, 32)      # the largest prefixes
    a_t = orb_t.ic_angle_integral(_t(img), _t(xy)).numpy()
    a_j = orb_j.ic_angle_integral(jnp.asarray(img), jnp.asarray(xy))
    a_ref = orb_t.ic_angle(_t(img), _t(xy)).numpy()
    for d in (_ang_diff(a_t, a_j), _ang_diff(a_t, a_ref)):
        assert np.median(d) < INTEGRAL_MEDIAN_TOL, np.median(d)
        if w > 1000:
            share = (d < INTEGRAL_WIDE_TOL).mean()
            assert share >= INTEGRAL_WIDE_MIN_SHARE, share
        else:
            assert d.max() < INTEGRAL_NARROW_TOL, d.max()


@pytest.mark.parametrize("kind", ["pool", "classic", "external"])
def test_descriptors_same_angles(kind, tmp_path):
    """One angle array fed to both sides; see DESC_* above."""
    rng = np.random.default_rng(18)
    img = np.asarray(pyramid_j.blur(jnp.asarray(_texture(18, 128, 192)),
                                    2.0, 3))
    xy = _interior_xy(rng, 300, 128, 192)
    ang = rng.uniform(-np.pi, np.pi, 300).astype(np.float32)
    ang[:8] = [0.0, np.pi / 2, -np.pi / 2, np.pi, np.pi / 4, 1e-7, -3.0, 3.0]
    args_j = (jnp.asarray(img), jnp.asarray(xy), jnp.asarray(ang))
    args_t = (_t(img), _t(xy), _t(ang))
    if kind == "pool":
        d_j = orb_j.compute_descriptors_pool(*args_j)
        d_t = orb_t.compute_descriptors_pool(*args_t)
    else:
        pat = None
        if kind == "external":
            pat = np.clip(rng.normal(0, 6.2, (256, 4)).round(), -13,
                          13).astype(np.int8)
        d_j = orb_j.compute_descriptors(*args_j, pattern=pat)
        d_t = orb_t.compute_descriptors(*args_t, pattern=pat)
    assert d_t.dtype == torch.int32 and d_t.shape == (300, 8)
    d_j = np.asarray(d_j)
    ham = (_bits(interop.descriptors_numpy(d_t)) != _bits(d_j)).sum(-1)
    assert (ham == 0).mean() >= DESC_MIN_EQUAL_SHARE, (ham == 0).mean()
    assert ham.max() <= DESC_MAX_HAMMING, ham.max()
    # not a trivial agreement: the descriptors carry ~half their bits
    assert 64 < _bits(d_j).sum(-1).mean() < 192


def _match_both(a, b, va, vb, **kw):
    got = orb_t.match_brute_force(interop.descriptors(a),
                                  interop.descriptors(b), _t(va), _t(vb), **kw)
    want = orb_j.match_brute_force(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(va), jnp.asarray(vb), **kw)
    assert got[0].dtype == got[1].dtype == torch.int32
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    return [g.numpy() for g in got]


def test_match_brute_force_exact():
    """Noisy copies, distractors and invalid rows: indices, distances and
    the accept mask equal the JAX package's."""
    rng = np.random.default_rng(19)
    a = _random_desc(rng, 96)
    b = np.concatenate([_perturb(rng, a[:64], 6), _random_desc(rng, 40)])
    b = b[rng.permutation(len(b))]
    va = rng.uniform(size=96) > 0.1
    vb = rng.uniform(size=len(b)) > 0.1
    idx, dist, ok = _match_both(a, b, va, vb)
    assert 30 < ok.sum() <= 64
    _match_both(a, b, va, vb, max_dist_abs=10, ratio_vs_min=1.5)
    _, _, ok0 = _match_both(a, b, va, np.zeros(len(b), bool))
    assert not ok0.any()


def test_match_brute_force_ties():
    """Hamming distances tie often. The first minimum wins on both axes
    (`idx_b` over b, the mutual check's argmin over a), as jnp.argmin has
    it: duplicated rows on either side make ties at distance 0 and 3."""
    rng = np.random.default_rng(20)
    base = _random_desc(rng, 8)
    near = base.copy()
    near[:, 0] ^= np.uint32(0b111)                   # 3 bits off
    a = np.concatenate([base, base[:4], near[4:]])   # a rows 8-11 = rows 0-3
    b = np.concatenate([base[::-1], base, near])     # every row three times
    v = np.ones(len(a), bool), np.ones(len(b), bool)
    idx, dist, ok = _match_both(a, b, *v)
    # first of the tied columns: the reversed copy comes first in b
    np.testing.assert_array_equal(idx[:8], 7 - np.arange(8))
    np.testing.assert_array_equal(dist[:12], 0)
    # the duplicated a rows lose the mutual check to the first copy
    assert ok[:8].all() and not ok[8:12].any()


# ----------------------------------------------------------------------
# ops/fast.py::fast_check_sparse
# ----------------------------------------------------------------------

def test_fast_check_sparse_exact():
    """The booleans equal the JAX package's on detector keypoints, random
    sub-pixel positions and border points, and agree with the port's dense
    detector as tests/test_fast_orb.py holds the JAX one."""
    rng = np.random.default_rng(21)
    for img in (isolated_squares(), _texture(21, 128, 192, sigma=1.0)):
        xy_d, _, val = fast_t.detect_grid(_t(img), max_kps=64, cell=16,
                                          ini_threshold=20.0,
                                          min_threshold=20.0)
        xy = np.concatenate([
            xy_d[val].numpy(),
            np.stack([rng.uniform(-2, 194, 400), rng.uniform(-2, 130, 400)],
                     -1).astype(np.float32),
            np.array([[11.0, 11.0], [27.0, 11.0], [1.0, 1.0], [190.0, 126.0],
                      [2.5, 64.0], [3.5, 64.0], [188.5, 64.0]], np.float32)])
        for th in (7.0, 20.0):
            ok_t = fast_t.fast_check_sparse(_t(img), _t(xy), th).numpy()
            ok_j = np.asarray(fast_j.fast_check_sparse(
                jnp.asarray(img), jnp.asarray(xy), th))
            np.testing.assert_array_equal(ok_t, ok_j)
        n_det = int(val.sum())
        ok_det = fast_t.fast_check_sparse(_t(img), xy_d[val], 20.0).numpy()
        assert n_det >= 20 and ok_det.mean() > 0.9, (n_det, ok_det.mean())
    flat = _t(np.array([[11.0, 11.0], [27.0, 11.0], [1.0, 1.0],
                        [190.0, 126.0]], np.float32))
    assert not fast_t.fast_check_sparse(_t(isolated_squares()), flat,
                                        20.0).any()


# ----------------------------------------------------------------------
# loopclosing.py::loop_describe
# ----------------------------------------------------------------------

def _describe_both(img, xy, valid, S, sf, **kw):
    d_j, v_j = lc_j.loop_describe(jnp.asarray(img), jnp.asarray(xy),
                                  jnp.asarray(valid), S, sf, **kw)
    d_t, v_t = lc_t.loop_describe(_t(img), _t(xy), _t(valid), S, sf, **kw)
    assert d_t.shape == (S * len(xy), 8) and d_t.dtype == torch.int32
    return (np.asarray(d_j), np.asarray(v_j),
            interop.descriptors_numpy(d_t), v_t.numpy())


@pytest.mark.parametrize("screen", [0.0, 7.0])
def test_loop_describe_matches(screen):
    """The ladder end to end: the validity mask equals the JAX package's;
    on valid rows the descriptors are held as the descriptor tests hold
    them, with the angles now each side's own (ic_angle_integral, INTEGRAL_*
    above): measured 0.948 of the valid rows equal and at most 2 bits
    apart; held at >= 0.9 and 8 bits."""
    rng = np.random.default_rng(22)
    img = _texture(22, 160, 320, sigma=1.5)
    xy_d, _, val = fast_t.detect_grid(_t(img), max_kps=96, cell=32)
    xy = xy_d.numpy() + rng.uniform(-0.4, 0.4, (96, 2)).astype(np.float32)
    valid = val.numpy() & (rng.uniform(size=96) > 0.1)
    d_j, v_j, d_t, v_t = _describe_both(img, xy, valid, 4, 1.2,
                                        screen_threshold=screen)
    np.testing.assert_array_equal(v_t, v_j)
    assert v_j.sum() > 60
    ham = (_bits(d_t) != _bits(d_j)).sum(-1)[v_j]
    assert (ham == 0).mean() >= 0.9, (ham == 0).mean()
    assert ham.max() <= DESC_MAX_HAMMING, ham.max()


def test_loop_describe_screen_invalidates_flat_rows():
    """tests/test_fast_orb.py's screen test on the port: corner keypoints
    stay valid at octave 0; screening only removes rows; masks equal."""
    img = isolated_squares()
    xy = np.array([[40.0, 40.0], [56.0, 40.0], [44.0, 44.0], [100.0, 60.0]],
                  np.float32)
    valid = np.ones(4, bool)
    _, vj_off, _, vt_off = _describe_both(img, xy, valid, 2, 1.2,
                                          screen_threshold=0.0)
    _, vj_on, _, vt_on = _describe_both(img, xy, valid, 2, 1.2,
                                        screen_threshold=7.0)
    np.testing.assert_array_equal(vt_off, vj_off)
    np.testing.assert_array_equal(vt_on, vj_on)
    on, off = vt_on.reshape(2, 4), vt_off.reshape(2, 4)
    assert on.sum() <= off.sum()
    assert on[0, 0] and on[0, 1]


def test_loop_describe_external_pattern():
    rng = np.random.default_rng(23)
    pat = np.clip(rng.normal(0, 6.2, (256, 4)).round(), -13, 13) \
        .astype(np.int8)
    img = _texture(23, 128, 192)
    xy = _interior_xy(rng, 40, 128, 192, border=30)
    valid = np.ones(40, bool)
    d_j, v_j, d_t, v_t = _describe_both(img, xy, valid, 2, 1.2, pattern=pat)
    np.testing.assert_array_equal(v_t, v_j)
    ham = (_bits(d_t) != _bits(d_j)).sum(-1)[v_j]
    assert (ham == 0).mean() >= 0.9 and ham.max() <= DESC_MAX_HAMMING
    _, _, d_pool, _ = _describe_both(img, xy, valid, 2, 1.2)
    assert (d_pool != d_t).any()


# ----------------------------------------------------------------------
# ops/bow.py
# ----------------------------------------------------------------------

def _assert_vocab_equal(vt, vj):
    np.testing.assert_array_equal(interop.descriptors_numpy(vt.node_desc),
                                  np.asarray(vj.node_desc))
    np.testing.assert_array_equal(vt.children.numpy(), np.asarray(vj.children))
    np.testing.assert_array_equal(vt.word_id.numpy(), np.asarray(vj.word_id))
    # IDF weights: one float64 log each, rounded to float32 on both sides
    np.testing.assert_allclose(vt.word_weight.numpy(),
                               np.asarray(vj.word_weight), atol=1e-6)
    assert vt.n_words == vj.n_words and vt.k == vj.k


@pytest.mark.parametrize("k,levels,seed", [(5, 2, 1), (4, 3, 2)])
def test_bow_train_same_tree(k, levels, seed):
    """The port's own copy of the numpy training code, descending with the
    port's words_of for the IDF pass: the same documents and seed give the
    same tree."""
    rng = np.random.default_rng(24 + seed)
    protos = _random_desc(rng, 40)
    docs = [_perturb(rng, protos, 8) for _ in range(6)] \
        + [np.zeros((0, 8), np.uint32)]
    vj = bow_j.train(docs, k=k, levels=levels, seed=seed)
    vt = bow_t.train(docs, k=k, levels=levels, seed=seed)
    _assert_vocab_equal(vt, vj)
    # the subsampling branch
    vj2 = bow_j.train(docs, k=k, levels=levels, seed=seed,
                      max_train_descriptors=100)
    vt2 = bow_t.train(docs, k=k, levels=levels, seed=seed,
                      max_train_descriptors=100)
    _assert_vocab_equal(vt2, vj2)
    _assert_vocab_equal(interop.vocabulary(vj), vj)


def test_bow_numpy_helpers_equal():
    rng = np.random.default_rng(26)
    d = _random_desc(rng, 17)
    np.testing.assert_array_equal(bow_t._unpack_bits(d), bow_j._unpack_bits(d))
    np.testing.assert_array_equal(bow_t._pack_bits(bow_t._unpack_bits(d)), d)
    a, b = bow_t._unpack_bits(d[:5]), bow_t._unpack_bits(d[5:12])
    np.testing.assert_array_equal(bow_t._hamming_np(a, b),
                                  bow_j._hamming_np(a, b))
    np.testing.assert_array_equal(
        bow_t._hamming_np(a, b),
        orb_t.hamming_distance(interop.descriptors(d[:5])[:, None],
                               interop.descriptors(d[5:12])[None]).numpy())


def test_bow_words_transform_scores():
    """words_of exact; transform and the scores within 1e-6 (the term
    counts are whole numbers, the rest is one float32 product, sum and
    division in either package)."""
    rng = np.random.default_rng(27)
    protos = [_random_desc(rng, 50) for _ in range(3)]
    docs = [_perturb(rng, p, 8) for p in protos for _ in range(3)]
    vj = bow_j.train(docs, k=6, levels=2, seed=3)
    vt = interop.vocabulary(vj)
    q = _perturb(rng, protos[1], 5)
    valid = rng.uniform(size=50) > 0.2
    w_j = np.asarray(bow_j.words_of(vj, jnp.asarray(q), jnp.asarray(valid), 2))
    w_t = bow_t.words_of(vt, interop.descriptors(q), _t(valid), 2)
    assert w_t.dtype == torch.int32
    np.testing.assert_array_equal(w_t.numpy(), w_j)
    assert (w_j[~valid] == -1).all() and (w_j[valid] >= 0).all()

    def bv_j(d):
        return bow_j.transform(vj, jnp.asarray(d), jnp.ones(len(d), bool), 2)

    def bv_t(d):
        return bow_t.transform(vt, interop.descriptors(d),
                               torch.ones(len(d), dtype=torch.bool), 2)

    np.testing.assert_allclose(
        bow_t.transform(vt, interop.descriptors(q), _t(valid), 2).numpy(),
        np.asarray(bow_j.transform(vj, jnp.asarray(q), jnp.asarray(valid),
                                   2)), atol=1e-6)
    db_docs = [_perturb(rng, p, 5) for p in protos]
    db_j = jnp.stack([bv_j(d) for d in db_docs])
    db_t = torch.stack([bv_t(d) for d in db_docs])
    np.testing.assert_allclose(db_t.numpy(), np.asarray(db_j), atol=1e-6)
    assert abs(float(db_t[0].abs().sum()) - 1.0) < 1e-5
    ok = np.array([True, False, True])
    s_j = np.asarray(bow_j.score_l1_database(bv_j(q), db_j, jnp.asarray(ok)))
    s_t = bow_t.score_l1_database(bv_t(q), db_t, _t(ok)).numpy()
    np.testing.assert_allclose(s_t, s_j, atol=1e-6)
    assert s_t[1] == -1.0
    np.testing.assert_allclose(
        bow_t.score_l1(bv_t(q), db_t[1]).numpy(),
        np.asarray(bow_j.score_l1(bv_j(q), db_j[1])), atol=1e-6)
    assert int(np.argmax(np.asarray(bow_t.score_l1(bv_t(q)[None], db_t)))) == 1


def test_bow_orbvoc_variable_depth(tmp_path):
    """A text vocabulary whose leaves sit at depths 1 and 2: the loaders
    agree, tree_depth agrees, and the descent (exact) lets a descriptor
    that reaches its leaf early stay there."""
    rng = np.random.default_rng(28)
    zeros = np.zeros(8, np.uint32)
    ones = np.full(8, 0xFFFFFFFF, np.uint32)
    half = np.array([0xFFFFFFFF] * 4 + [0] * 4, np.uint32)

    def flip(d, n):
        out = d.copy()
        out[0] ^= np.uint32((1 << n) - 1)
        return out

    # node ids: 1 inner (zeros), 2 inner (ones), 3 LEAF at depth 1 (half),
    # 4-5 leaves under 1, 6-7 leaves under 2
    descs = [zeros, ones, half, flip(zeros, 0), flip(zeros, 6),
             flip(ones, 0), flip(ones, 6)]
    parents = [0, 0, 0, 1, 1, 2, 2]
    leaves = [0, 0, 1, 1, 1, 1, 1]
    lines = ["3 2 0 0"]
    for d, p, lf in zip(descs, parents, leaves):
        lines.append(f"{p} {lf} " + " ".join(
            str(x) for x in np.frombuffer(d.tobytes(), np.uint8)) + " 0.5")
    path = tmp_path / "voc.txt"
    path.write_text("\n".join(lines) + "\n")
    vj = bow_j.load_orbvoc_text(str(path))
    vt = bow_t.load_orbvoc_text(str(path))
    _assert_vocab_equal(vt, vj)
    assert vt.n_words == 5 and vt.k == 3
    assert bow_t.tree_depth(vt) == bow_j.tree_depth(vj) == 2
    q = np.stack(descs[2:] + [flip(half, 9)]
                 + list(_random_desc(rng, 64)))
    ok = np.ones(len(q), bool)
    for levels in (2, 4):                  # extra rounds idle at the leaves
        w_j = np.asarray(bow_j.words_of(vj, jnp.asarray(q), jnp.asarray(ok),
                                        levels))
        w_t = bow_t.words_of(vt, interop.descriptors(q), _t(ok), levels)
        np.testing.assert_array_equal(w_t.numpy(), w_j)
    assert len(set(w_j[:5].tolist())) == 5 and w_j[5] == w_j[0]
