"""Parity of the port's LK flavours (`LKParams.kernel` = sw, ymm, pkmm, mm,
mm_f32: ops/lk_variants_cuda.py, the dispatch of ops/lk.py) with the JAX
package's Pallas variants (ssvio_tpu/ops/lk_pallas_variants.py).

The JAX variants are reached as the JAX package reaches them, through
`lk._track_level(backend="pallas_interpret", kernel=k)` (interpret mode on
the CPU); the port's through `_track_level(backend="ref", kernel=k)`, the
CUDA kernels' plain versions. Both pad a 60x250 level to 64x256 and a
190x250 level to 192x256; the scenes move by 8-9 px, more than the search
margin of the patch-bounded path, and hold keypoints whose windows reach
the zero padding.

Tolerances, on tracks that converged before the 30-iteration cap (the
port's answer with 29 iterations equals its answer with 30):
- sw, ymm, pkmm, mm_f32: 1e-4 px. The two sides run the same float32
  steps; they sum the 121-pixel windows in other orders and may contract
  other FMAs, ~1e-6 px per step.
- mm: 1e-3 px. The same, and each bf16-rounded intermediate (R) turns a
  float32 ulp of difference upstream into a bf16 ulp (2^-8 relative) of
  one window value.
Tracks still stepping at the cap amplify that noise without bound: as in
chip_smoke.py they are left out of the position check and must stay under
5% of the live tracks. Not for mm: its bf16 windows carry about half an
intensity unit of rounding noise, which keeps the step above eps = 0.01 px
on most tracks of these smooth textures, so about three quarters of them
run to the cap, still stepping by 0.1-0.6 px (CPU measurement: 29 of 40
live tracks at 192x256). Each step is a deterministic function of the
position, so the two sides still take the same steps unless one ulp flips
a bf16 rounding; for mm at least 75% of all live tracks, capped or not,
must agree within 1e-3 px. Flags must be equal.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssvio_tpu.ops import lk as lk_j
from ssvio_tpu.ops import pyramid as pyramid_j
from ssvio_tpu_torch.ops import lk as lk_t
from ssvio_tpu_torch.ops import lk_cuda, lk_patch_cuda
from ssvio_tpu_torch.ops import lk_variants_cuda as lkv
from test_torch_lk import _shift
from test_torch_ops import _texture, one_torch_thread  # noqa: F401

NEW = ("sw", "ymm", "pkmm", "mm", "mm_f32")
POS_ATOL = {"serial": 1e-4, "sw": 1e-4, "ymm": 1e-4, "pkmm": 1e-4,
            "mm_f32": 1e-4, "mm": 1e-3}
MAX_CAPPED_SHARE = 0.05
MM_MIN_AGREE_SHARE = 0.75
# true level dims (padded to 64x256 and 192x256), keypoints, shift (px)
SCENES = {"64x256": ((60, 250), 16, (8.0, 3.0)),
          "192x256": ((190, 250), 48, (8.0, -2.0))}
KW = dict(win=11, iters=30, eps=0.01, min_eig=1e-4)


def _scene(name, seed=521):
    """Level planes (numpy float32), keypoints and validity. Three
    keypoints sit 7-12 px from the right or bottom edge, where the window
    reaches the zero padding after the shift."""
    (h, w), n, shift = SCENES[name]
    img = _texture(seed, h, w, sigma=7.0)
    img2 = _shift(img, *shift)
    rng = np.random.default_rng(seed + 1)
    pts = rng.uniform([20, 16], [w - 30, h - 16], (n, 2))
    pts[:2, 0] = w - rng.uniform(7, 12, 2)
    pts[2, 1] = h - rng.uniform(7, 12)
    valid = rng.uniform(size=n) < 0.9
    gx, gy = [np.array(a) for a in pyramid_j.sobel_gradients(jnp.asarray(img))]
    return img, img2, gx, gy, pts.astype(np.float32), valid


def _port_level(scene, kernel, **params):
    img, img2, gx, gy, pts, valid = scene
    out, ok = lk_t._track_level(
        *[torch.from_numpy(a) for a in (img, img2, gx, gy, pts, pts, valid)],
        lk_t.LKParams(backend="ref", kernel=kernel, **params))
    return out.numpy(), ok.numpy()


@pytest.mark.parametrize("scene_name", list(SCENES))
@pytest.mark.parametrize("kernel", NEW)
def test_level_plain_version_matches_jax_variant(kernel, scene_name):
    scene = _scene(scene_name)
    img, img2, gx, gy, pts, valid = scene
    out_j, ok_j = lk_j._track_level(
        *[jnp.asarray(a) for a in (img, img2, gx, gy, pts, pts, valid)],
        lk_j.LKParams(backend="pallas_interpret", kernel=kernel))
    out_j, ok_j = np.asarray(out_j), np.asarray(ok_j)
    out_t, ok_t = _port_level(scene, kernel)
    np.testing.assert_array_equal(ok_t, ok_j)
    live = ok_t & valid
    assert live.sum() >= 0.6 * valid.sum(), live.sum()
    capped = np.any(_port_level(scene, kernel, iters=29)[0] != out_t, axis=1)
    d = np.max(np.abs(out_t - out_j), axis=1)
    tol = POS_ATOL[kernel]
    assert np.all(d[live & ~capped] <= tol), d[live & ~capped].max()
    if kernel == "mm":
        assert (d[live] <= tol).mean() >= MM_MIN_AGREE_SHARE, d[live]
        return
    assert (live & capped).sum() <= MAX_CAPPED_SHARE * live.sum()
    # the flavour tracks the shift, as kernel #1's function does
    hit = np.all(np.abs(out_t[live] - pts[live]
                        - np.asarray(SCENES[scene_name][2])) < 0.1, axis=1)
    assert hit.mean() > 0.8, hit.mean()


@pytest.mark.parametrize("win", [13, 16])
@pytest.mark.parametrize("kernel", ["ymm", "mm", "mm_f32"])
def test_level_plain_version_matches_jax_variant_at_wide_windows(kernel, win):
    """The flavours whose kernels take windows up to 16 (#4: ymm, #5: mm,
    mm_f32; the JAX `pk` kernel's limit and the 16-row blocks of JAX's
    `mm`) at win 13 and 16, on the 64x256 scene (16 keypoints), with the
    rules of test_level_plain_version_matches_jax_variant. For mm, the
    share rule alone, as chip_smoke.py's phase 3b holds it: at win 16 one
    track of this scene converges 0.16 px from the JAX one, inside the bf16
    noise floor, after an ulp flipped a rounding."""
    _check_wide_window(kernel, win)


@pytest.mark.parametrize("kernel,win", [("serial", 16), ("serial", 24),
                                        ("sw", 16), ("sw", 23)])
def test_level_plain_version_matches_jax_kernel1_at_wide_windows(kernel,
                                                                  win):
    """Kernel #1's function (serial, and sw, which is #1's kernel) at the
    pixel classes above the path's: 8 pixels a lane (win 16) and 18 (the
    kernels' limits: 24 for serial, where JAX's 32-row slab last holds the
    window at every row offset, 23 for sw, JAX's assert), against
    lk_level_vmem and lk_level_vmem_sw in interpret mode, with the rules of
    test_level_plain_version_matches_jax_variant."""
    _check_wide_window(kernel, win)


def _check_wide_window(kernel, win):
    scene = _scene("64x256")
    img, img2, gx, gy, pts, valid = scene
    out_j, ok_j = lk_j._track_level(
        *[jnp.asarray(a) for a in (img, img2, gx, gy, pts, pts, valid)],
        lk_j.LKParams(backend="pallas_interpret", kernel=kernel, window=win))
    out_j, ok_j = np.asarray(out_j), np.asarray(ok_j)
    out_t, ok_t = _port_level(scene, kernel, window=win)
    np.testing.assert_array_equal(ok_t, ok_j)
    live = ok_t & valid
    assert live.sum() >= 0.6 * valid.sum(), live.sum()
    d = np.max(np.abs(out_t - out_j), axis=1)
    tol = POS_ATOL[kernel]
    if kernel == "mm":
        assert (d[live] <= tol).mean() >= MM_MIN_AGREE_SHARE, d[live]
        return
    capped = np.any(_port_level(scene, kernel, window=win, iters=29)[0]
                    != out_t, axis=1)
    assert np.all(d[live & ~capped] <= tol), d[live & ~capped].max()
    assert (live & capped).sum() <= MAX_CAPPED_SHARE * live.sum()
    hit = np.all(np.abs(out_t[live] - pts[live]
                        - np.asarray(SCENES["64x256"][2])) < 0.1, axis=1)
    assert hit.mean() > 0.8, hit.mean()


@pytest.mark.parametrize("kernel", ["sw", "mm"])
def test_track_matches_jax_variant(kernel):
    """The whole 3-level pyramidal track (coarse levels padded to 32x256).
    Tolerance: 1e-3 px on tracks whose flag is good; the coarse levels'
    float-order noise reseeds the finer ones, but every level converges."""
    img = _texture(503, 192, 256, sigma=2.0)
    img2 = _shift(img, 3.2, -2.1)
    rng = np.random.default_rng(504)
    pts = rng.uniform([30, 30], [226, 162], (24, 2)).astype(np.float32)
    guess = pts + np.float32([1.0, -0.5])
    valid = np.ones(24, bool)
    valid[:2] = False
    pj = [pyramid_j.build_lk_pyramid(jnp.asarray(a), 3) for a in (img, img2)]
    pt = [[torch.from_numpy(np.array(l)) for l in p] for p in pj]
    out_j, ok_j, err_j = lk_j.track(
        pj[0], pj[1], jnp.asarray(pts), jnp.asarray(guess), jnp.asarray(valid),
        lk_j.LKParams(backend="pallas_interpret", kernel=kernel))
    out_t, ok_t, err_t = lk_t.track(
        pt[0], pt[1], torch.from_numpy(pts), torch.from_numpy(guess),
        torch.from_numpy(valid), lk_t.LKParams(backend="ref", kernel=kernel))
    ok = ok_t.numpy()
    np.testing.assert_array_equal(ok, np.asarray(ok_j))
    assert ok.sum() >= 0.8 * valid.sum()
    np.testing.assert_allclose(out_t.numpy()[ok], np.asarray(out_j)[ok],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(err_t.numpy()[ok], np.asarray(err_j)[ok],
                               atol=1e-3)
    flow = out_t.numpy()[ok] - pts[ok]
    np.testing.assert_allclose(np.median(flow, axis=0), [3.2, -2.1], atol=0.1)


def _bf16_np(x):
    """float32 rounded to bf16 (nearest, ties to even), as float32."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def test_mm_window_is_by_s_bxt_with_three_bf16_roundings(monkeypatch):
    """The "mm" plain version's template windows equal a direct numpy
    By @ S @ Bx^T, bit for bit, with S the window of the plane rounded to
    bf16, the weights bf16(1-f) and bf16(f) rounded separately, and R =
    By @ S rounded to bf16. Every product of two bf16 values is exact in
    float32 and each output sums two of them, so any summation order gives
    the same float32."""
    win, r = 11, 5
    rng = np.random.default_rng(505)
    plane = rng.uniform(0, 255, (64, 256)).astype(np.float32)
    n = 8
    pts = np.stack([rng.uniform(20, 230, n), rng.uniform(10, 50, n)],
                   axis=1).astype(np.float32)
    seen = []
    blend = lkv.blend_mm_bf16

    def spy(s, fx, fy):
        out = blend(s, fx, fy)
        seen.append(out)
        return out

    monkeypatch.setattr(lkv, "blend_mm_bf16", spy)
    t = torch.from_numpy(plane)
    p = torch.from_numpy(pts)
    frozen0 = torch.zeros((n, 1), dtype=torch.int32)
    lkv.lk_level_mm_ref(t, t, t, t, p, p, frozen0, padded_hw=(64, 256),
                        use_bf16=True, **dict(KW, iters=0))
    port = seen[0].numpy()                 # the template window of `prev`
    rounded_apart = 0
    for i in range(n):
        tx, ty = pts[i] - np.float32(r)
        bx, by = int(np.floor(tx)), int(np.floor(ty))
        fx, fy = np.float32(tx - bx), np.float32(ty - by)
        S32 = plane[by:by + win + 1, bx:bx + win + 1]

        def two_hot(f, cast):
            B = np.zeros((win, win + 1), np.float32)
            B[np.arange(win), np.arange(win)] = cast(np.float32(1) - f)
            B[np.arange(win), np.arange(win) + 1] = cast(f)
            return B

        R = _bf16_np(two_hot(fy, _bf16_np) @ _bf16_np(S32))
        W = R @ two_hot(fx, _bf16_np).T
        np.testing.assert_array_equal(port[i], W)
        ident = lambda a: a      # noqa: E731
        W32 = two_hot(fy, ident) @ S32 @ two_hot(fx, ident).T
        rounded_apart += not np.array_equal(W, W32)
    assert rounded_apart == n        # the roundings change every window


def _two_hot(f, win, cast):
    B = np.zeros((win, win + 1), np.float32)
    B[np.arange(win), np.arange(win)] = cast(np.float32(1) - f)
    B[np.arange(win), np.arange(win) + 1] = cast(f)
    return B


@pytest.mark.parametrize("use_bf16", [True, False])
def test_mm_windows_is_the_two_hot_product(use_bf16):
    """mm_windows, the check of kernel #5's sampler alone, takes its plain
    version on the CPU: By @ S @ Bx^T of the integer window S (0 beyond
    the plane), with mm's three bf16 roundings bit for bit, or in float32
    (mm_f32) within float32 rounding (numpy sums zero products too)."""
    _check_mm_windows(use_bf16, win=11)


@pytest.mark.parametrize("use_bf16", [True, False])
def test_mm_windows_is_the_two_hot_product_at_win_16(use_bf16):
    """The same at win 16, the widest window kernel #5 takes (S and R are
    17 wide: two k-steps of its tensor-core products)."""
    _check_mm_windows(use_bf16, win=16)


def _check_mm_windows(use_bf16, win):
    rng = np.random.default_rng(509)
    plane = rng.uniform(0, 255, (40, 100)).astype(np.float32)
    tl = np.stack([rng.uniform(0, 99, 12), rng.uniform(0, 39, 12)],
                  axis=1).astype(np.float32)
    tl[0] = (95.5, 35.25)                   # reaches past both edges
    got = lkv.mm_windows(torch.from_numpy(plane), torch.from_numpy(tl),
                         win=win, use_bf16=use_bf16).numpy()
    padded = np.zeros((40 + win + 1, 100 + win + 1), np.float32)
    padded[:40, :100] = plane
    cast = _bf16_np if use_bf16 else (lambda a: a)
    for i, (x, y) in enumerate(tl):
        bx, by = int(np.floor(x)), int(np.floor(y))
        S = cast(padded[by:by + win + 1, bx:bx + win + 1])
        R = cast(_two_hot(np.float32(y - by), win, cast) @ S)
        want = R @ _two_hot(np.float32(x - bx), win, cast).T
        if use_bf16:
            np.testing.assert_array_equal(got[i], want)
        else:
            np.testing.assert_allclose(got[i], want, rtol=1e-6, atol=1e-4)


def test_plain_version_counts_the_pixels_the_level_needs():
    """counts= of the plain versions (lk_cuda.klt_solve_ref), which
    chip_smoke.py's bounds read: with no iteration, the needed pixels are
    the union of the (win+1)^2 template windows inside the true level dims,
    on gx and gy for every keypoint and on prev for those live at the
    start (not frozen0, inside the bounds, through the gate), and none of
    cur."""
    win, H, W = 11, 60, 250
    img, img2, gx, gy, pts = _small_level(n=12)
    p = pts.clone()
    p[0] = torch.tensor([246.3, 57.8])     # its window passes both edges
    p[1] = p[2] + torch.tensor([3.5, 2.0])  # overlaps keypoint 2's
    frozen0 = torch.zeros((12, 1), dtype=torch.int32)
    frozen0[3] = 1
    counts = {}
    out, flag = lk_cuda.lk_level_ref(img, gx, gy, img2, p, p, frozen0,
                                     **dict(KW, iters=0), padded_hw=(64, 256),
                                     counts=counts)
    assert "kp_iters" not in counts          # no iteration ran

    def union(rows):
        m = np.zeros((64 + win + 1, 256 + win + 1), bool)
        for x, y in p.numpy()[rows] - win // 2:
            bx = int(np.clip(np.floor(x), 0, 256 - win - 2))
            by = int(np.clip(np.floor(y), 0, 64 - win - 2))
            m[by:by + win + 1, bx:bx + win + 1] = True
        return int(m[:H, :W].sum())

    tl = p.numpy() - win // 2
    inside = (np.all(tl >= 0, axis=1) & (tl[:, 0] <= 256 - win - 2)
              & (tl[:, 1] <= 64 - win - 2))
    live0 = (flag[:, 0] > 0).numpy() & (frozen0[:, 0] == 0).numpy() & inside
    assert not live0[0] and not live0[3] and live0.sum() >= 8
    assert int(counts["live0"]) == live0.sum()
    assert lk_cuda.touched_pixels(counts, (64, 256), (H, W)) == \
        2 * union(np.arange(12)) + union(live0)
    assert union(np.arange(12)) < 12 * (win + 1) ** 2   # overlap, edges


def test_plain_version_counts_the_longest_chain():
    """counts["max_iters"], which chip_smoke.py divides a kernel's device
    time by: the most iterations any keypoint runs, which is the fewest
    iterations after which no keypoint moves any more."""
    img, img2, gx, gy, pts = _small_level(n=12)
    frozen0 = torch.zeros((12, 1), dtype=torch.int32)
    kw = dict(KW, padded_hw=(64, 256))
    counts = {}
    final, _ = lk_cuda.lk_level_ref(img, gx, gy, img2, pts, pts + 1.5,
                                    frozen0, **kw, counts=counts)
    n = int(counts["max_iters"])
    assert 1 < n < KW["iters"]
    short = [lk_cuda.lk_level_ref(img, gx, gy, img2, pts, pts + 1.5, frozen0,
                                  **dict(kw, iters=i))[0] for i in (n - 1, n)]
    assert not torch.equal(short[0], final) and torch.equal(short[1], final)


def _small_level(n=8):
    img = _texture(507, 64, 256, sigma=3.0)
    img2 = _shift(img, 2.0, 1.0)
    rng = np.random.default_rng(508)
    pts = rng.uniform([30, 20], [220, 44], (n, 2)).astype(np.float32)
    gx, gy = [np.array(a) for a in pyramid_j.sobel_gradients(jnp.asarray(img))]
    return [torch.from_numpy(a) for a in (img, img2, gx, gy, pts)]


# each flavour's plain version in lk_variants_cuda, and its bound keywords
PLAIN = {"sw": ("lk_level_sw_ref", {}),
         "ymm": ("lk_level_pk_ref", {}),
         "pkmm": ("lk_level_pk_ref", {}),
         "mm": ("lk_level_mm_ref", {"use_bf16": True}),
         "mm_f32": ("lk_level_mm_ref", {"use_bf16": False})}


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    @functools.wraps(real)
    def spy(*a, **k):
        calls.append((name, {key: k[key] for key in ("use_bf16",)
                             if key in k}))
        return real(*a, **k)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("kernel", NEW)
def test_ref_backend_reaches_the_flavours_plain_version(kernel, monkeypatch):
    """backend="ref" takes the flavour's plain version once per level, with
    its keywords, and never kernel #1's; above the plane budget every
    flavour takes kernel #2's plain version, as the JAX package takes its
    HBM-patch kernel whatever the flavour."""
    calls = []
    for name in ("lk_level_sw_ref", "lk_level_pk_ref", "lk_level_mm_ref"):
        _spy(monkeypatch, lkv, name, calls)
    _spy(monkeypatch, lk_cuda, "lk_level_ref", calls)
    _spy(monkeypatch, lk_patch_cuda, "lk_patch_ref", calls)
    img, img2, gx, gy, pts = _small_level()
    valid = torch.ones(len(pts), dtype=torch.bool)
    params = lk_t.LKParams(backend="ref", kernel=kernel)
    out, ok = lk_t._track_level(img, img2, gx, gy, pts, pts, valid, params)
    assert calls == [PLAIN[kernel]]
    assert bool(ok.all())
    # the CPU wrapper of the flavour's kernel is its plain version
    calls.clear()
    monkeypatch.setattr(lk_t, "PLANE_BUDGET_BYTES", 0)
    lk_t._track_level(img, img2, gx, gy, pts, pts, valid, params)
    assert calls == [("lk_patch_ref", {})]


@pytest.mark.parametrize("kernel", NEW)
def test_cpu_backends_take_no_kernel_and_cuda_raises(kernel, monkeypatch):
    """On CPU tensors "auto" and "xla" take the patch-bounded path whatever
    the flavour (JAX's "auto" takes XLA off the TPU); "cuda" raises."""
    calls = []
    for name in ("lk_level_sw_ref", "lk_level_pk_ref", "lk_level_mm_ref"):
        _spy(monkeypatch, lkv, name, calls)
    _spy(monkeypatch, lk_cuda, "lk_level_ref", calls)
    img, img2, gx, gy, pts = _small_level()
    valid = torch.ones(len(pts), dtype=torch.bool)
    outs = [lk_t._track_level(img, img2, gx, gy, pts, pts, valid,
                              lk_t.LKParams(backend=b, kernel=kernel))[0]
            for b in ("auto", "xla")]
    assert calls == []
    assert torch.equal(outs[0], outs[1])
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        lk_t._track_level(img, img2, gx, gy, pts, pts, valid,
                          lk_t.LKParams(backend="cuda", kernel=kernel))


@pytest.mark.parametrize("wrapper", ["lk_level_sw", "lk_level_pk",
                                     "lk_level_mm", "lk_level_mm_f32"])
def test_variant_wrapper_on_cpu_is_the_plain_version(wrapper):
    img, img2, gx, gy, pts = _small_level()
    frozen0 = torch.zeros((len(pts), 1), dtype=torch.int32)
    kw = dict(KW, padded_hw=(64, 256))
    if wrapper.startswith("lk_level_mm"):
        kw["use_bf16"] = wrapper == "lk_level_mm"
        fn, ref = lkv.lk_level_mm, lkv.lk_level_mm_ref
    else:
        fn, ref = getattr(lkv, wrapper), getattr(lkv, wrapper + "_ref")
    before = dict(lkv.LAUNCHES)
    a = fn(img, gx, gy, img2, pts, pts, frozen0, **kw)
    b = ref(img, gx, gy, img2, pts, pts, frozen0, **kw)
    assert lkv.LAUNCHES == before              # no kernel launch on CPU
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_sw_plain_version_is_kernel1s_function():
    """Kernel #3 samples the window kernel #1 samples, with its arithmetic:
    the two plain versions agree bit for bit; the separable flavours agree
    to float rounding."""
    img, img2, gx, gy, pts = _small_level(16)
    frozen0 = torch.zeros((16, 1), dtype=torch.int32)
    kw = dict(KW, padded_hw=(64, 256))
    a = lk_cuda.lk_level_ref(img, gx, gy, img2, pts, pts, frozen0, **kw)
    b = lkv.lk_level_sw_ref(img, gx, gy, img2, pts, pts, frozen0, **kw)
    c = lkv.lk_level_pk_ref(img, gx, gy, img2, pts, pts, frozen0, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(a[1], c[1])
    assert float(torch.max(torch.abs(a[0] - c[0]))) < 1e-3


# each level wrapper, its keywords and the largest window its kernel takes
# (the JAX kernels'): 24 for kernel #1 (JAX's serial kernel has no guard
# and wraps above it), 23 for #3 (JAX's `sw` assert), 16 for #4 and #5
# (JAX's `pk` limit; JAX's `mm` has no guard and silently drops window
# rows past 16)
WIN_LIMITS = {"lk_level": (lk_cuda.lk_level, {}, 24),
              "lk_level_sw": (lkv.lk_level_sw, {}, 23),
              "lk_level_pk": (lkv.lk_level_pk, {}, 16),
              "lk_level_mm": (lkv.lk_level_mm, {"use_bf16": True}, 16),
              "lk_level_mm_f32": (lkv.lk_level_mm, {"use_bf16": False}, 16)}


@pytest.mark.parametrize("wrapper", list(WIN_LIMITS))
def test_wrapper_takes_windows_up_to_its_kernels_limit(wrapper):
    """Each wrapper raises one past its kernel's window limit, on the CPU
    too (its plain version would take any window), and at the limit runs
    its plain version there; mm_windows shares kernel #5's limit."""
    fn, extra, limit = WIN_LIMITS[wrapper]
    img, img2, gx, gy, pts = _small_level()
    frozen0 = torch.zeros((len(pts), 1), dtype=torch.int32)
    args = (img, gx, gy, img2, pts, pts, frozen0)
    kw = dict(KW, padded_hw=(64, 256), **extra)
    with pytest.raises(ValueError, match=f"outside 1..{limit}"):
        fn(*args, **dict(kw, win=limit + 1))
    out, flag = fn(*args, **dict(kw, win=limit))
    assert bool(flag.any()) and bool(torch.isfinite(out).all())
    if wrapper == "lk_level_mm":
        with pytest.raises(ValueError, match="outside 1..16"):
            lkv.mm_windows(img, pts - 8.0, win=17)
