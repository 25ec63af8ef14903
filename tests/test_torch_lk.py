"""Parity of the port's LK (ops/lk.py, ops/lk_cuda.py) with ssvio_tpu.

The JAX package has two LK level functions that differ at large shifts
(ROADMAP Queue 3): the XLA path freezes a track at its search-patch edge,
the VMEM Pallas kernel only at the padded level edge. Each port path is
held against its own counterpart, never against the other:
- the patch-bounded torch path against `backend="xla"`;
- `lk_cuda.lk_level_ref` (the CUDA kernel's plain version) against
  `lk_pallas.lk_level_vmem(..., interpret=True)`.

Tolerance on positions: both sides run the same float32 steps, summing the
121-pixel windows in different orders (~1e-6 px per step). A track whose
last step sits at the |delta| < 0.01 convergence edge can take one more
sub-0.01 px step on one side only, so positions agree to 0.02 px; flags
must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssvio_tpu.ops import lk as lk_j
from ssvio_tpu.ops import lk_pallas
from ssvio_tpu.ops import pyramid as pyramid_j
from ssvio_tpu_torch.ops import lk as lk_t
from ssvio_tpu_torch.ops import (_nvcc, lk_cuda, lk_patch_cuda,
                                 lk_variants_cuda)
from test_torch_ops import _texture, one_torch_thread  # noqa: F401

POS_ATOL = 0.02          # px, see module docstring
H, W, N = 192, 256, 24


def _shift(img, dx, dy):
    """img2(x, y) = img(x - dx, y - dy): content moves by (+dx, +dy);
    bilinear, edge-clamped (float64)."""
    h, w = img.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    sx = np.clip(xx - dx, 0, w - 1)
    sy = np.clip(yy - dy, 0, h - 1)
    x0 = np.minimum(np.floor(sx).astype(int), w - 2)
    y0 = np.minimum(np.floor(sy).astype(int), h - 2)
    fx, fy = sx - x0, sy - y0
    im = img.astype(np.float64)
    return ((1 - fy) * ((1 - fx) * im[y0, x0] + fx * im[y0, x0 + 1])
            + fy * ((1 - fx) * im[y0 + 1, x0] + fx * im[y0 + 1, x0 + 1])
            ).astype(np.float32)


def _scene(seed, shift, sigma):
    rng = np.random.default_rng(seed)
    img = _texture(seed, H, W, sigma=sigma)
    img2 = _shift(img, *shift)
    pts = rng.uniform([30, 30], [W - 30, H - 30], (N, 2)).astype(np.float32)
    return img, img2, pts


def _level_inputs(img, img2, pts):
    gx, gy = pyramid_j.sobel_gradients(jnp.asarray(img))
    return np.array(gx), np.array(gy)


SHIFTS = {"3.8px": ((3.1, -2.2), 2.0), "10px": ((8.0, 6.0), 7.0)}


@pytest.mark.parametrize("case", list(SHIFTS))
def test_level_ref_matches_pallas_vmem_interpret(case):
    shift, sigma = SHIFTS[case]
    img, img2, pts = _scene(201, shift, sigma)
    gx, gy = _level_inputs(img, img2, pts)
    rng = np.random.default_rng(202)
    frozen0 = (rng.uniform(size=(N, 1)) < 0.1).astype(np.int32)
    kw = dict(win=11, iters=30, eps=0.01, min_eig=1e-4)
    out_j, flag_j = lk_pallas.lk_level_vmem(
        *[jnp.asarray(a) for a in (img, gx, gy, img2, pts, pts, frozen0)],
        interpret=True, **kw)
    out_t, flag_t = lk_cuda.lk_level_ref(
        *[torch.from_numpy(a) for a in (img, gx, gy, img2, pts, pts, frozen0)],
        padded_hw=(H, W), **kw)
    np.testing.assert_array_equal(flag_t.numpy(), np.asarray(flag_j))
    good = flag_t.numpy()[:, 0] > 0
    assert good.sum() >= 0.8 * N
    np.testing.assert_allclose(out_t.numpy()[good], np.asarray(out_j)[good],
                               atol=POS_ATOL)
    # the kernel semantics actually track the shift on most live keypoints
    moved = out_t.numpy() - pts
    live = good & (frozen0[:, 0] == 0)
    hit = np.all(np.abs(moved[live] - np.asarray(shift)) < 0.1, axis=1)
    assert hit.mean() > 0.6, hit.mean()
    if case == "10px":
        # here the patch-bounded path (search margin 8) loses most of the
        # tracks the kernel semantics keep: the two rules part
        out_x, _ = lk_t._track_level(
            *[torch.from_numpy(a) for a in (img, img2, gx, gy, pts, pts)],
            torch.from_numpy(frozen0[:, 0] == 0), lk_t.LKParams(backend="xla"))
        hit_x = np.all(np.abs(out_x.numpy()[live] - pts[live]
                              - np.asarray(shift)) < 0.1, axis=1)
        assert hit.mean() > hit_x.mean() + 0.2, (hit.mean(), hit_x.mean())


@pytest.mark.parametrize("case", list(SHIFTS))
def test_level_xla_path_matches_jax_xla(case):
    shift, sigma = SHIFTS[case]
    img, img2, pts = _scene(203, shift, sigma)
    gx, gy = _level_inputs(img, img2, pts)
    valid = np.random.default_rng(204).uniform(size=N) < 0.9
    p_j = lk_j.LKParams(backend="xla")
    p_t = lk_t.LKParams(backend="xla")
    out_j, ok_j = lk_j._track_level(
        *[jnp.asarray(a) for a in (img, img2, gx, gy, pts, pts, valid)], p_j)
    out_t, ok_t = lk_t._track_level(
        *[torch.from_numpy(a) for a in (img, img2, gx, gy, pts, pts, valid)],
        p_t)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=POS_ATOL)


def _pyramids(img, img2, levels):
    pj = [pyramid_j.build_lk_pyramid(jnp.asarray(a), levels) for a in (img, img2)]
    pt = [[torch.from_numpy(np.array(l)) for l in p] for p in pj]
    return pj, pt


@pytest.mark.parametrize("backends", [("xla", "xla"),
                                      ("ref", "pallas_interpret")])
def test_track_matches_jax(backends):
    """Whole pyramidal track through the backend dispatch: the patch-bounded
    path, and the kernel semantics (which pad the small coarse levels)."""
    b_t, b_j = backends
    img, img2, pts = _scene(205, (3.2, -2.1), 2.0)
    (pj1, pj2), (pt1, pt2) = _pyramids(img, img2, 3)
    valid = np.ones(N, bool)
    valid[:3] = False
    guess = pts + np.float32([1.0, -0.5])
    out_j, ok_j, err_j = lk_j.track(pj1, pj2, jnp.asarray(pts),
                                    jnp.asarray(guess), jnp.asarray(valid),
                                    lk_j.LKParams(backend=b_j))
    out_t, ok_t, err_t = lk_t.track(pt1, pt2, torch.from_numpy(pts),
                                    torch.from_numpy(guess),
                                    torch.from_numpy(valid),
                                    lk_t.LKParams(backend=b_t))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    ok = ok_t.numpy()
    assert ok.sum() >= 0.8 * valid.sum()
    np.testing.assert_allclose(out_t.numpy()[ok], np.asarray(out_j)[ok],
                               atol=POS_ATOL)
    # err: mean |T - I| over the window, intensity units
    np.testing.assert_allclose(err_t.numpy()[ok], np.asarray(err_j)[ok],
                               atol=0.05)
    flow = out_t.numpy()[ok] - pts[ok]
    np.testing.assert_allclose(np.median(flow, axis=0), [3.2, -2.1], atol=0.2)


def test_cuda_dispatch_raises_and_never_falls_back(monkeypatch, tmp_path):
    img, img2, pts = _scene(206, (1.0, 1.0), 2.0)
    (_, _), (pt1, pt2) = _pyramids(img, img2, 3)
    p = torch.from_numpy(pts)
    v = torch.ones(N, dtype=torch.bool)
    # "cuda" demands the kernel: CPU tensors raise instead of taking a
    # plain version, whatever the flavour
    for kern in lk_t.FLAVOURS:
        with pytest.raises(RuntimeError, match="needs CUDA tensors"):
            lk_t.track(pt1, pt2, p, p, v,
                       lk_t.LKParams(backend="cuda", kernel=kern))
    # a flavour the port does not know raises (the JAX package would run
    # 'serial' for it)
    with pytest.raises(ValueError, match="not in"):
        lk_t.track(pt1, pt2, p, p, v, lk_t.LKParams(kernel="roll"))
    # no nvcc reachable: building any kernel library raises
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_nvcc, "_CUDA_ROOTS", ())
    monkeypatch.setattr(_nvcc, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(lk_cuda, "_lib", None)
    monkeypatch.setattr(lk_variants_cuda, "_fns", {})
    for src in (lk_cuda.SRC, *lk_variants_cuda.SRC.values()):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _nvcc.build(src)


def test_wrapper_on_cpu_is_the_plain_version():
    img, img2, pts = _scene(207, (2.0, 1.0), 2.0)
    gx, gy = _level_inputs(img, img2, pts)
    args = [torch.from_numpy(a) for a in (img, gx, gy, img2, pts, pts)]
    frozen0 = torch.zeros((N, 1), dtype=torch.int32)
    kw = dict(win=11, iters=30, eps=0.01, min_eig=1e-4, padded_hw=(H, W))
    before = lk_cuda.LAUNCHES
    a = lk_cuda.lk_level(*args, frozen0, **kw)
    b = lk_cuda.lk_level_ref(*args, frozen0, **kw)
    assert lk_cuda.LAUNCHES == before           # no kernel launch on CPU
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_oversized_level_takes_patch_path(monkeypatch):
    """Above the 12 MiB plane budget the kernel backends take kernel #2's
    function (lk_patch_cuda; JAX: the HBM-patch kernel lk_level_pallas):
    level 0 of a 1280x960 camera does, its level 1 and a KITTI level 0 do
    not. The plain-version backend "ref" reaches lk_patch_ref there."""
    assert lk_t.uses_patch_kernel(960, 1280)
    assert not lk_t.uses_patch_kernel(480, 640)
    assert not lk_t.uses_patch_kernel(384, 1248)
    calls = []
    real = lk_patch_cuda.lk_patch_ref

    def spy(*a, **k):
        calls.append(k["padded_hw"])
        return real(*a, **k)

    monkeypatch.setattr(lk_patch_cuda, "lk_patch_ref", spy)
    big = torch.zeros((1088, 1024))
    p = torch.full((4, 2), 100.0)
    out, ok = lk_t._track_level(big, big, big, big, p, p,
                                torch.ones(4, dtype=torch.bool),
                                lk_t.LKParams(backend="ref"))
    assert calls == [(1088, 1024)]
    assert out.shape == (4, 2) and not bool(ok.any())     # flat: gate fails
    # CPU tensors under "cuda" still raise rather than take a plain version
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        lk_t._track_level(big, big, big, big, p, p,
                          torch.ones(4, dtype=torch.bool),
                          lk_t.LKParams(backend="cuda"))
