"""Parity of the PyTorch port's geometry and image ops with ssvio_tpu.

Each test makes its inputs with numpy from its own seed, feeds the same
arrays to the JAX function (on the CPU) and to its port, and compares with
the tolerance stated at the assertion. Both sides compute in float32; the
tolerances cover different summation and fusion orders, not algorithmic
differences.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssvio_tpu.dataio import synthetic as syn_j
from ssvio_tpu.dataio import synthetic_jax
from ssvio_tpu.ops import camera as camera_j
from ssvio_tpu.ops import fast as fast_j
from ssvio_tpu.ops import pyramid as pyramid_j
from ssvio_tpu.ops import sampling as sampling_j
from ssvio_tpu.ops import se3 as se3_j
from ssvio_tpu.ops import triangulation as tri_j
from ssvio_tpu_torch.dataio import synthetic as syn_t
from ssvio_tpu_torch.dataio import synthetic_torch
from ssvio_tpu_torch.ops import camera as camera_t
from ssvio_tpu_torch.ops import fast as fast_t
from ssvio_tpu_torch.ops import pyramid as pyramid_t
from ssvio_tpu_torch.ops import sampling as sampling_t
from ssvio_tpu_torch.ops import se3 as se3_t


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _twists(seed, n=64):
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(n, 6)).astype(np.float32)
    xi[:, :3] *= 2.0
    xi[:, 3:] *= 0.8
    xi[:4, 3:] *= 1e-6                      # the small-angle series branch
    return xi


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread per test process (the port's test files
    import this fixture). The suite runs under xdist with a worker per
    core, and the port's eager ops are small: with torch's default of one
    thread per core in every worker, the threads contend for the cores and
    the port's tests run about ten times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _texture(seed, h, w, sigma=2.0):
    """Smooth random texture in [0, 255] (separable Gaussian of noise)."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h, w))
    r = int(3 * sigma)
    k = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma) ** 2)
    k /= k.sum()
    img = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), 0, img)
    img = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), 1, img)
    return (img / img.max() * 255.0).astype(np.float32)


def test_se3_ops_match():
    xi = _twists(101)
    T_j = se3_j.exp(jnp.asarray(xi))
    T_t = se3_t.exp(torch.from_numpy(xi))
    # exp: float32 series + trig, same formula on both sides
    np.testing.assert_allclose(_np(T_t), _np(T_j), atol=2e-6)
    # log(exp) is held against log on the same matrices (log's own
    # conditioning near |w| = pi is not the port's business)
    T = np.array(T_j)
    np.testing.assert_allclose(_np(se3_t.log(torch.from_numpy(T))),
                               _np(se3_j.log(jnp.asarray(T))), atol=1e-4)
    A, B = T[:32], T[32:]
    np.testing.assert_allclose(
        _np(se3_t.compose(torch.from_numpy(A), torch.from_numpy(B))),
        _np(se3_j.compose(jnp.asarray(A), jnp.asarray(B))), atol=1e-5)
    np.testing.assert_allclose(_np(se3_t.inverse(torch.from_numpy(T))),
                               _np(se3_j.inverse(jnp.asarray(T))), atol=1e-5)
    p = np.random.default_rng(102).normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        _np(se3_t.transform(torch.from_numpy(T), torch.from_numpy(p))),
        _np(se3_j.transform(jnp.asarray(T), jnp.asarray(p))), atol=1e-5)
    np.testing.assert_allclose(_np(se3_t.adjoint(torch.from_numpy(T))),
                               _np(se3_j.adjoint(jnp.asarray(T))), atol=1e-5)
    # exp(log(T)) returns T on both sides (the well-posed round trip)
    back = se3_t.exp(se3_t.log(torch.from_numpy(T)))
    np.testing.assert_allclose(_np(back), T, atol=1e-4)
    np.testing.assert_array_equal(se3_t.compose_np(A, B), se3_j.compose_np(A, B))
    np.testing.assert_array_equal(se3_t.inverse_np(T), se3_j.inverse_np(T))


def test_camera_with_distortion_matches():
    rng = np.random.default_rng(103)
    s_kw = dict(fx=360.0, fy=355.0, cx=160.0, cy=62.0)
    dist = (-0.28, 0.07, 0.001, -0.002)
    intr_j = camera_j.Intrinsics(*[jnp.float32(s_kw[k])
                                   for k in ("fx", "fy", "cx", "cy")])
    intr_t = camera_t.Intrinsics(*[torch.tensor(s_kw[k])
                                   for k in ("fx", "fy", "cx", "cy")])
    p = rng.uniform([-3, -2, 2], [3, 2, 30], (128, 3)).astype(np.float32)
    T = np.asarray(se3_j.exp(jnp.asarray(_twists(104, 1)[0] * 0.1)))
    np.testing.assert_allclose(
        _np(camera_t.world2pixel(intr_t, torch.from_numpy(T), torch.from_numpy(p))),
        _np(camera_j.world2pixel(intr_j, jnp.asarray(T), jnp.asarray(p))),
        rtol=1e-5, atol=1e-3)                   # pixels, float32 projection
    uv = rng.uniform([0, 0], [320, 124], (128, 2)).astype(np.float32)
    np.testing.assert_allclose(
        _np(camera_t.undistort_points(intr_t, dist, torch.from_numpy(uv))),
        _np(camera_j.undistort_points(intr_j, dist, jnp.asarray(uv))),
        atol=1e-3)
    img = _texture(105, 124, 320)
    # one bilinear gather pass: float32 rounding of the remap only
    np.testing.assert_allclose(
        _np(camera_t.undistort_image(intr_t, dist, torch.from_numpy(img))),
        _np(camera_j.undistort_image(intr_j, dist, jnp.asarray(img))),
        atol=2e-3)


def test_sampling_and_triangulation_match():
    rng = np.random.default_rng(106)
    img = _texture(107, 64, 96)
    pts = rng.uniform(-2, 98, (200, 2)).astype(np.float32)
    for fn_t, fn_j in ((sampling_t.gather_bilinear, sampling_j.gather_bilinear),
                       (sampling_t.gather_nn, sampling_j.gather_nn)):
        np.testing.assert_allclose(
            _np(fn_t(torch.from_numpy(img), torch.from_numpy(pts))),
            _np(fn_j(jnp.asarray(img), jnp.asarray(pts))), atol=1e-4)
    np.testing.assert_array_equal(
        _np(sampling_t.in_bounds(torch.from_numpy(pts), 64, 96, 3.0)),
        _np(sampling_j.in_bounds(jnp.asarray(pts), 64, 96, 3.0)))
    from ssvio_tpu_torch.ops import triangulation as tri_t
    uv_l = rng.uniform(20, 300, (100, 2)).astype(np.float32)
    uv_r = uv_l - np.stack([rng.uniform(-1, 40, 100), rng.normal(0, .3, 100)],
                           -1).astype(np.float32)
    args = (360.0, 355.0, 160.0, 62.0, 0.54)
    p_t, ok_t = tri_t.triangulate_stereo_rectified(
        torch.from_numpy(uv_l), torch.from_numpy(uv_r), *args, min_disparity=0.5)
    p_j, ok_j = tri_j.triangulate_stereo_rectified(
        jnp.asarray(uv_l), jnp.asarray(uv_r), *args, min_disparity=0.5)
    np.testing.assert_array_equal(_np(ok_t), _np(ok_j))
    np.testing.assert_allclose(_np(p_t), _np(p_j), rtol=1e-5)


def test_pyramids_and_gradients_match():
    img = _texture(108, 96, 160)
    lk_t = pyramid_t.build_lk_pyramid(torch.from_numpy(img), 4)
    lk_j = jax.jit(lambda im: pyramid_j.build_lk_pyramid(im, 4))(
        jnp.asarray(img))
    for a, b in zip(lk_t, lk_j):
        # shift-add blur in the same order on both sides
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-3)
        for g_t, g_j in zip(pyramid_t.sobel_gradients(a),
                            pyramid_j.sobel_gradients(jnp.asarray(_np(a)))):
            np.testing.assert_allclose(_np(g_t), _np(g_j), atol=1e-4)
    orb_t = pyramid_t.build_orb_pyramid(torch.from_numpy(img), 8, 1.2)
    orb_j = jax.jit(lambda im: pyramid_j.build_orb_pyramid(im, 8, 1.2))(
        jnp.asarray(img))
    for a, b in zip(orb_t, orb_j):
        assert a.shape == b.shape
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-3)
    np.testing.assert_allclose(
        _np(pyramid_t.resize_bilinear(torch.from_numpy(img), 37, 71)),
        _np(pyramid_j.resize_bilinear(jnp.asarray(img), 37, 71)), atol=1e-3)


@pytest.mark.parametrize("octaves", [1, 8])
def test_fast_detection_identical(octaves):
    """FAST detections must be identical (positions, octaves, validity),
    including the tie order of the top-k selections."""
    world = syn_j.SyntheticWorld(seed=9)
    pose = syn_j.straight_trajectory(1, speed=0.0)[0]
    img = syn_j.render_stereo_sequence_numpy(world, pose[None], 180.0, 180.0,
                                             96.0, 40.0, 0.54, 192, 80)[0][0]
    img = np.round(img).astype(np.float32)     # integer intensities: exact
    rng = np.random.default_rng(109)
    feat_xy = rng.uniform(0, [192, 80], (24, 2)).astype(np.float32)
    feat_valid = rng.uniform(size=24) < 0.7
    occ_t = fast_t.build_occupancy(80, 192, torch.from_numpy(feat_xy),
                                   torch.from_numpy(feat_valid), radius=10)
    occ_j = fast_j.build_occupancy(80, 192, jnp.asarray(feat_xy),
                                   jnp.asarray(feat_valid), radius=10)
    np.testing.assert_array_equal(_np(occ_t), _np(occ_j))
    if octaves == 1:
        out_t = fast_t.detect_grid(torch.from_numpy(img), max_kps=64, cell=16,
                                   occupancy=occ_t)
        out_j = fast_j.detect_grid(jnp.asarray(img), max_kps=64, cell=16,
                                   occupancy=occ_j)
    else:
        out_t = fast_t.detect_multiscale(
            pyramid_t.build_orb_pyramid(torch.from_numpy(img), octaves, 1.2),
            1.2, max_kps=64, cell=16, occupancy=occ_t)
        out_j = jax.jit(lambda im, oc: fast_j.detect_multiscale(
            pyramid_j.build_orb_pyramid(im, octaves, 1.2),
            1.2, max_kps=64, cell=16, occupancy=oc))(jnp.asarray(img), occ_j)
    assert int(_np(out_t[-1]).sum()) > 10
    resp = 1
    for i, (a, b) in enumerate(zip(out_t, out_j)):
        if i == resp and octaves > 1:
            # the jitted JAX pyramid fuses blur + resample and rounds the
            # octave images differently in the last bit; the responses
            # move by ~1e-6 relative and the selection stays identical
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5)
        else:
            np.testing.assert_array_equal(_np(a), _np(b))
    score_t = fast_t.fast_score_maps(torch.from_numpy(img), [20.0, 7.0])
    score_j = fast_j.fast_score_maps(jnp.asarray(img), [20.0, 7.0])
    for a, b in zip(score_t, score_j):
        np.testing.assert_array_equal(_np(a), _np(b))
        np.testing.assert_array_equal(_np(fast_t.nms3x3(a)),
                                      _np(fast_j.nms3x3(jnp.asarray(_np(a)))))


def test_device_renderer_matches_jax_renderer():
    world_j = syn_j.SyntheticWorld(seed=4)
    world_t = syn_t.SyntheticWorld(seed=4)
    np.testing.assert_array_equal(world_t.tex_ground.blocks,
                                  world_j.tex_ground.blocks)
    poses = syn_t.straight_trajectory(2, speed=0.6, yaw_rate=0.01)
    np.testing.assert_array_equal(poses,
                                  syn_j.straight_trajectory(2, 0.6, 0.01))
    args = (180.0, 180.0, 80.0, 30.0, 0.54, 160, 64)
    L_t, R_t = synthetic_torch.render_stereo_sequence_device(
        world_t, poses, *args, pad_w=176, pad_h=64, u8=False)
    L_j, R_j = synthetic_jax.render_stereo_sequence_device(
        world_j, poses, *args, pad_w=176, pad_h=64, u8=False)
    for a, b in ((L_t, L_j), (R_t, R_j)):
        d = np.abs(_np(a) - _np(b))
        assert a.shape == b.shape
        # float32 raycasts on both sides: a texel boundary may land one
        # texel off for a few supersamples, nothing else differs
        assert np.mean(d > 0.5) < 0.01, np.mean(d > 0.5)
        assert np.median(d) < 1e-3


def test_device_renderer_end_walls_match_numpy_renderer():
    """The port's closed room (end_z): the device renderer against the port's
    f64 numpy raycaster, looking at the front wall and back at the back
    wall; without end_z the same rays run down the corridor."""
    room = syn_t.SyntheticWorld(seed=11, wall_x=24.0, ceiling_y=-8.0,
                                end_z=(-10.0, 30.0))
    open_ = syn_t.SyntheticWorld(seed=11, wall_x=24.0, ceiling_y=-8.0)
    poses = syn_t.loop_trajectory(4, radius=10.0)[[0, 2]]
    args = (180.0, 180.0, 80.0, 30.0, 0.54, 160, 64)
    L_t, R_t = synthetic_torch.render_stereo_sequence_device(
        room, poses, *args, u8=False)
    L_n, R_n = syn_t.render_stereo_sequence_numpy(room, poses, *args)
    L_o, _ = synthetic_torch.render_stereo_sequence_device(
        open_, poses, *args, u8=False)
    for a, b in ((L_t, L_n), (R_t, R_n)):
        d = np.abs(_np(a) - np.stack(b))
        assert np.mean(d > 0.5) < 0.01, np.mean(d > 0.5)
        assert np.median(d) < 1e-3
    centre = (slice(26, 34), slice(76, 84))   # rays along the z axis
    for i in range(2):
        assert np.all(_np(L_t[i])[centre] != _np(L_o[i])[centre])


def test_settings_copy_parses_without_yaml_at_import():
    from ssvio_tpu.config import Settings as SJ
    from ssvio_tpu_torch import interop
    from ssvio_tpu_torch.config import Settings as ST
    s = SJ()
    s.cam_left = dataclasses.replace(s.cam_left, fx=111.0)
    s.max_features = 77
    t = interop.settings(s)
    assert isinstance(t, ST)
    assert dataclasses.asdict(t) == dataclasses.asdict(s)
    assert t.baseline == s.baseline and t.padded_width == s.padded_width
