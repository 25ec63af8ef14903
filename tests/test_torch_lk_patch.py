"""Parity of the port's kernel #2 path (ops/lk_patch_cuda.py, the patch
branch of ops/lk.py) with the JAX package's HBM-patch Pallas kernel.

`lk_pallas.lk_level_pallas` is reached as the JAX package reaches it:
through `lk._track_level(backend="pallas_interpret")` at a level whose
padded planes exceed `lk_pallas.VMEM_PLANE_BUDGET`. The tests lower that
budget (and the port's `PLANE_BUDGET_BYTES`) to 0 with monkeypatch, so a
128x512 level takes the patch kernel on both sides; nothing in the JAX
package changes.

Tolerance on positions: 0.02 px on tracks whose flag is good, and flags
equal, for the reason `tests/test_torch_lk.py` gives (same float32 steps,
window sums in another order, one extra sub-0.01 px step possible at the
convergence edge).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssvio_tpu.ops import lk as lk_j
from ssvio_tpu.ops import lk_pallas
from ssvio_tpu.ops import pyramid as pyramid_j
from ssvio_tpu_torch.ops import lk as lk_t
from ssvio_tpu_torch.ops import lk_patch_cuda
from test_torch_lk import _shift
from test_torch_ops import _texture, one_torch_thread  # noqa: F401

POS_ATOL = 0.02          # px, see module docstring
H, W, N = 128, 512, 32


@pytest.fixture
def patch_everywhere(monkeypatch):
    """Both packages take the HBM-patch kernel at every level."""
    monkeypatch.setattr(lk_pallas, "VMEM_PLANE_BUDGET", 0)
    monkeypatch.setattr(lk_t, "PLANE_BUDGET_BYTES", 0)


def _scene(shift, seed=301):
    img = _texture(seed, H, W, sigma=5.0)
    img2 = _shift(img, *shift)
    rng = np.random.default_rng(seed + 1)
    pts = rng.uniform([20, 20], [W - 20, H - 20], (N, 2)).astype(np.float32)
    gx, gy = [np.array(a) for a in pyramid_j.sobel_gradients(jnp.asarray(img))]
    valid = np.ones(N, bool)
    valid[:2] = False
    return img, img2, gx, gy, pts, valid


def _levels(scene):
    img, img2, gx, gy, pts, valid = scene
    p_j = lk_j.LKParams(backend="pallas_interpret")
    out_j, ok_j = lk_j._track_level(
        *[jnp.asarray(a) for a in (img, img2, gx, gy, pts, pts, valid)], p_j)
    out_t, ok_t = lk_t._track_level(
        *[torch.from_numpy(a) for a in (img, img2, gx, gy, pts, pts, valid)],
        lk_t.LKParams(backend="ref"))
    return (np.asarray(out_j), np.asarray(ok_j)), (out_t.numpy(), ok_t.numpy())


def _hits(out, ok, pts, shift):
    return ok & np.all(np.abs(out - pts - np.asarray(shift)) < 0.1, axis=1)


@pytest.mark.parametrize("shift", [(3, 2), (8, 6), (11, 0), (0, 11)])
def test_patch_ref_matches_jax_hbm_patch_kernel(patch_everywhere, shift):
    scene = _scene(shift)
    pts = scene[4]
    (out_j, ok_j), (out_t, ok_t) = _levels(scene)
    np.testing.assert_array_equal(ok_t, ok_j)
    assert ok_t.sum() >= 0.8 * N
    np.testing.assert_allclose(out_t[ok_t], out_j[ok_t], atol=POS_ATOL)
    # the patch function tracks most small shifts and some large ones
    assert _hits(out_t, ok_t, pts, shift).mean() > (0.8 if shift == (3, 2)
                                                    else 0.4)


def test_patch_box_binds_where_kernel1_bounds_do_not(patch_everywhere,
                                                     monkeypatch):
    """16 px down is more than the 13-20 px of slack below the search box:
    the patch function freezes many tracks there. The port's patch path
    follows the JAX kernel, and kernel #1's bounds (the padded level) give
    a different answer, so a port with kernel #1's bounds fails above."""
    shift = (0, 16)
    scene = _scene(shift)
    img, img2, gx, gy, pts, valid = scene
    (out_j, ok_j), (out_t, ok_t) = _levels(scene)
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_allclose(out_t[ok_t], out_j[ok_t], atol=POS_ATOL)
    monkeypatch.setattr(lk_t, "PLANE_BUDGET_BYTES", 1 << 40)   # kernel #1
    out_1, ok_1 = lk_t._track_level(
        *[torch.from_numpy(a) for a in (img, img2, gx, gy, pts, pts, valid)],
        lk_t.LKParams(backend="ref"))
    out_1, ok_1 = out_1.numpy(), ok_1.numpy()
    differ = np.any(np.abs(out_1 - out_j) > 0.1, axis=1) | (ok_1 != ok_j)
    assert differ.sum() >= 5, differ.sum()
    assert _hits(out_1, ok_1, pts, shift).sum() > _hits(out_j, ok_j, pts,
                                                         shift).sum()


def test_patch_inputs_give_the_asymmetric_box():
    """The search origin is aligned down to 128 in x and 8 in y: an
    interior window starts 0-127 px from the box's left edge and 117-244 px
    from its right edge, 8-15 px below its top and 13-20 px above its
    bottom (win 11, margin 8)."""
    rng = np.random.default_rng(303)
    # interior: away from the last 256 lanes and 40 rows, where the origin
    # is clipped into the padded plane and the box widens on the left / top
    pts = torch.from_numpy(rng.uniform([40, 40], [1000, 900], (400, 2))
                           .astype(np.float32))
    p = lk_t.LKParams()
    args, kw, org_C = lk_t.patch_inputs(960, 1280, pts, pts,
                                        torch.ones(400, dtype=torch.bool), p)
    tl_prev, tl_cur, localT, local0, frozen0 = args
    assert (kw["pty"], kw["pcy"], kw["padded_hw"]) == (32, 40, (960, 1280))
    assert torch.all(tl_cur[:, 0] % 128 == 0) and torch.all(tl_cur[:, 1] % 8 == 0)
    lim_x = lk_patch_cuda.LANES - p.window - 1
    lim_y = kw["pcy"] - p.window - 1
    left, up = local0[:, 0], local0[:, 1]
    # (+-0.5: the search origin comes from the rounded guess)
    assert float(left.min()) >= -0.5 and float(left.max()) < 128
    assert float((lim_x - left).min()) > 116 and float((lim_x - left).max()) <= 244.5
    assert float(up.min()) >= 7.5 and float(up.max()) < 16.5
    assert float((lim_y - up).min()) > 11.5 and float((lim_y - up).max()) <= 20.5
    # the template window sits inside its [pty, 256] patch, unclipped
    assert float(localT.min()) >= 0
    assert float(localT[:, 1].max()) < kw["pty"] - p.window - 1
    assert int(frozen0.sum()) == 0
    torch.testing.assert_close(org_C + p.window // 2 + local0, pts)


def test_track_above_budget_matches_jax(patch_everywhere):
    """A whole pyramidal track with every level on the patch kernel (the
    small coarse levels padded up to the patch footprint)."""
    img, img2, gx, gy, pts, valid = _scene((3.2, -2.1), seed=305)
    pj = [pyramid_j.build_lk_pyramid(jnp.asarray(a), 3) for a in (img, img2)]
    pt = [[torch.from_numpy(np.array(l)) for l in p] for p in pj]
    guess = pts + np.float32([1.0, -0.5])
    out_j, ok_j, err_j = lk_j.track(
        pj[0], pj[1], jnp.asarray(pts), jnp.asarray(guess), jnp.asarray(valid),
        lk_j.LKParams(backend="pallas_interpret"))
    out_t, ok_t, err_t = lk_t.track(
        pt[0], pt[1], torch.from_numpy(pts), torch.from_numpy(guess),
        torch.from_numpy(valid), lk_t.LKParams(backend="ref"))
    ok = ok_t.numpy()
    np.testing.assert_array_equal(ok, np.asarray(ok_j))
    assert ok.sum() >= 0.8 * valid.sum()
    np.testing.assert_allclose(out_t.numpy()[ok], np.asarray(out_j)[ok],
                               atol=POS_ATOL)
    np.testing.assert_allclose(err_t.numpy()[ok], np.asarray(err_j)[ok],
                               atol=0.05)
    flow = out_t.numpy()[ok] - pts[ok]
    np.testing.assert_allclose(np.median(flow, axis=0), [3.2, -2.1], atol=0.1)


def test_patch_ref_matches_jax_hbm_patch_kernel_at_win_16(patch_everywhere):
    """Kernel #2's function at win 16, 8 pixels a lane on the card (the
    patches grow with the window: pty 32, pcy 48), against the JAX
    HBM-patch kernel in interpret mode, with the rules of
    test_patch_ref_matches_jax_hbm_patch_kernel."""
    shift = (3, 2)
    scene = _scene(shift, seed=309)
    img, img2, gx, gy, pts, valid = scene
    out_j, ok_j = lk_j._track_level(
        *[jnp.asarray(a) for a in (img, img2, gx, gy, pts, pts, valid)],
        lk_j.LKParams(backend="pallas_interpret", window=16))
    out_t, ok_t = lk_t._track_level(
        *[torch.from_numpy(a) for a in (img, img2, gx, gy, pts, pts, valid)],
        lk_t.LKParams(backend="ref", window=16))
    out_j, ok_j, out_t, ok_t = (np.asarray(out_j), np.asarray(ok_j),
                                out_t.numpy(), ok_t.numpy())
    np.testing.assert_array_equal(ok_t, ok_j)
    assert ok_t.sum() >= 0.8 * N
    np.testing.assert_allclose(out_t[ok_t], out_j[ok_t], atol=POS_ATOL)
    assert _hits(out_t, ok_t, pts, shift).mean() > 0.8


def test_patch_wrapper_takes_windows_up_to_its_kernels_limit():
    """The wrapper raises one past kernel #2's window limit (24, 18 pixels
    a lane; the JAX kernel's 32-row slab holds no wider window at every row
    offset), on the CPU too, and at the limit runs its plain version
    there."""
    img, img2, gx, gy, pts, valid = _scene((2.0, 1.0), seed=311)
    t = [torch.from_numpy(a) for a in (img, gx, gy, img2)]
    p = torch.from_numpy(pts)
    for win in (24, 25):
        args, kw, _ = lk_t.patch_inputs(H, W, p, p, torch.from_numpy(valid),
                                        lk_t.LKParams(window=win))
        if win == 25:
            with pytest.raises(ValueError, match="outside 1..24"):
                lk_patch_cuda.lk_patch(*t, *args, **kw)
            continue
        out, flag = lk_patch_cuda.lk_patch(*t, *args, **kw)
        assert bool(flag.any()) and bool(torch.isfinite(out).all())


def test_patch_wrapper_on_cpu_is_the_plain_version():
    img, img2, gx, gy, pts, valid = _scene((2.0, 1.0), seed=307)
    t = [torch.from_numpy(a) for a in (img, gx, gy, img2)]
    p = torch.from_numpy(pts)
    args, kw, _ = lk_t.patch_inputs(H, W, p, p, torch.from_numpy(valid),
                                    lk_t.LKParams())
    before = lk_patch_cuda.LAUNCHES
    a = lk_patch_cuda.lk_patch(*t, *args, **kw)
    b = lk_patch_cuda.lk_patch_ref(*t, *args, **kw)
    assert lk_patch_cuda.LAUNCHES == before     # no kernel launch on CPU
    for x, y in zip(a, b):
        assert torch.equal(x, y)
