"""The CUDA LK kernels, the chunk path, the graphs (the local BA's
rounds skipped by IF nodes included), the loop-closing ops' integer
results and the PGO of a loop drive against the benchmark's plain
reference on the card: tests that need a CUDA device and nvcc.

Every test here is marked `gpu` and skips, with its reason, where there is no
CUDA device. This file imports neither jax nor the JAX package (the GPU's
host has neither), so it runs there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_gpu.py

Each kernel is held against its plain torch version (`lk_cuda.lk_level_ref`,
`lk_patch_cuda.lk_patch_ref`, `lk_variants_cuda.*_ref`) on the same
device. Tolerance on positions: 0.02 px on every track that
converged before the iteration cap (the two sum the 121 window products in
different orders and contract different FMAs, ~1e-6 px per step; a track
at the |delta| < 0.01 px convergence edge can take one more sub-0.01 px
step on one side only). A track still stepping at the cap amplifies that
noise without bound, so it is left out of the position check. Flags must
be equal. The bf16 kernel ("mm") keeps most tracks stepping to the cap
(its windows carry about half an intensity unit of rounding noise,
tests/test_torch_lk_variants.py), so after 30 iterations it is held on the
tracks that agree with the plain version, at least 75% of the live tracks,
and tightly where that noise cannot build up: its sampled windows and one
step (test_mm_tight_checks_and_their_control_on_gpu).
"""

import dataclasses

import numpy as np
import pytest
import torch

from ssvio_tpu_torch import frontend as fe
from ssvio_tpu_torch import graphs
from ssvio_tpu_torch.config import Settings
from ssvio_tpu_torch.dataio import synthetic, synthetic_torch
from ssvio_tpu_torch.ops import (_nvcc, ba, bow, lk, lk_cuda, lk_patch_cuda,
                                 orb, pyramid, sampling)
from ssvio_tpu_torch.ops import lk_variants_cuda as lkv
from ssvio_tpu_torch.system import System
from ssvio_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu

POS_ATOL = 0.02          # px, see module docstring
MM_MIN_AGREE_SHARE = 0.75
H, W, N = 192, 256, 48
KW = dict(win=11, iters=30, eps=0.01, min_eig=1e-4)


def _device() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _scene(seed, shift, sigma=2.0, stretch=False):
    """Smooth random texture, a copy moved by `shift` (bilinear), and N
    keypoints away from the border; float32 numpy. The texture is scaled to
    a largest value of 255, or with `stretch` to the range 0..255."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (H, W))
    r = int(3 * sigma)
    k = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma) ** 2)
    k /= k.sum()
    for ax in (0, 1):
        img = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), ax, img)
    if stretch:
        img = img - img.min()
    img = img / img.max() * 255.0
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    sx = np.clip(xx - shift[0], 0, W - 1)
    sy = np.clip(yy - shift[1], 0, H - 1)
    x0 = np.minimum(np.floor(sx).astype(int), W - 2)
    y0 = np.minimum(np.floor(sy).astype(int), H - 2)
    fx, fy = sx - x0, sy - y0
    img2 = ((1 - fy) * ((1 - fx) * img[y0, x0] + fx * img[y0, x0 + 1])
            + fy * ((1 - fx) * img[y0 + 1, x0] + fx * img[y0 + 1, x0 + 1]))
    pts = rng.uniform([30, 30], [W - 30, H - 30], (N, 2))
    return img.astype(np.float32), img2.astype(np.float32), \
        pts.astype(np.float32)


def _converged(args, kw):
    """Tracks whose plain-version answer no longer moves at the last step."""
    out = lk_cuda.lk_level_ref(*args, **kw)[0]
    out_short = lk_cuda.lk_level_ref(*args, **dict(kw, iters=kw["iters"] - 1))[0]
    return torch.all(out == out_short, dim=-1)


def test_cuda_kernel_matches_plain_version_on_gpu():
    """One level, zero-padded bounds included: a 190x250 level with the
    192x256 bounds of the padded plane."""
    dev = _device()
    img, img2, pts = _scene(208, (3.1, -2.2))
    img_t = torch.from_numpy(img)
    gx, gy = pyramid.sobel_gradients(img_t)
    planes = [t[:190, :250].contiguous().to(dev)
              for t in (img_t, gx, gy, torch.from_numpy(img2))]
    p = torch.from_numpy(pts).to(dev)
    frozen0 = torch.zeros((N, 1), dtype=torch.int32, device=dev)
    frozen0[:4] = 1
    args = (*planes, p, p, frozen0)
    kw = dict(KW, padded_hw=(192, 256))
    before = lk_cuda.LAUNCHES
    out_k, flag_k = lk_cuda.lk_level(*args, **kw)
    torch.cuda.synchronize()
    assert lk_cuda.LAUNCHES == before + 1
    out_r, flag_r = lk_cuda.lk_level_ref(*args, **kw)
    assert torch.equal(flag_k, flag_r)
    assert torch.isfinite(out_k).all()
    check = (flag_k[:, 0] > 0) & _converged(args, kw)
    assert int(check.sum()) >= N // 2
    assert torch.max(torch.abs(out_k[check] - out_r[check])).item() < POS_ATOL
    # frozen keypoints keep their guess (less r, plus r: an ulp or so)
    assert torch.allclose(out_k[:4], p[:4], rtol=0, atol=1e-4)
    # the live keypoints found the shift
    moved = (out_k - p)[check & (frozen0[:, 0] == 0)].cpu().numpy()
    np.testing.assert_allclose(np.median(moved, axis=0), [3.1, -2.2],
                               atol=0.05)


def test_track_dispatch_launches_the_kernel_once_per_level():
    """lk.track on CUDA tensors ("auto") goes through the kernel on every
    level and agrees with the kernel semantics' plain version ("ref")."""
    dev = _device()
    img, img2, pts = _scene(209, (4.0, 1.5))
    pyr = [[t.to(dev) for t in pyramid.build_lk_pyramid(torch.from_numpy(a), 3)]
           for a in (img, img2)]
    p = torch.from_numpy(pts).to(dev)
    valid = torch.ones(N, dtype=torch.bool, device=dev)
    before = lk_cuda.LAUNCHES
    out_k, ok_k, _ = lk.track(pyr[0], pyr[1], p, p, valid, lk.LKParams())
    torch.cuda.synchronize()
    assert lk_cuda.LAUNCHES == before + 3
    out_r, ok_r, _ = lk.track(pyr[0], pyr[1], p, p, valid,
                              lk.LKParams(backend="ref"))
    assert lk_cuda.LAUNCHES == before + 3      # the plain version never counts
    assert torch.equal(ok_k, ok_r)
    assert int(ok_k.sum()) >= 0.8 * N
    flow = (out_k - p)[ok_k].cpu().numpy()
    np.testing.assert_allclose(np.median(flow, axis=0), [4.0, 1.5], atol=0.1)
    # coarse-level noise reseeds the finer levels, so compare the typical
    # track: the median disagreement stays at float-order size
    d = torch.max(torch.abs(out_k - out_r), dim=-1).values[ok_k]
    assert float(d.median()) < POS_ATOL


def test_wrapper_rejects_what_the_kernel_does_not_take():
    dev = _device()
    img, img2, pts = _scene(210, (1.0, 1.0))
    img_t = torch.from_numpy(img)
    gx, gy = pyramid.sobel_gradients(img_t)
    planes = [t.to(dev) for t in (img_t, gx, gy, torch.from_numpy(img2))]
    p = torch.from_numpy(pts).to(dev)
    frozen0 = torch.zeros((N, 1), dtype=torch.int32, device=dev)
    kw = dict(KW, padded_hw=(H, W))
    before = lk_cuda.LAUNCHES
    bad = [
        ((planes[0].double(), *planes[1:], p, p, frozen0), kw),
        ((planes[0].t().contiguous().t(), *planes[1:], p, p, frozen0),
         kw),                                                  # strided
        ((*planes, p[:-1], p, frozen0), kw),                    # shape
        ((*planes, p.cpu(), p, frozen0), kw),                   # device
        ((*planes, p, p, frozen0), dict(kw, win=25)),           # past 24
        ((*planes, p, p, frozen0), dict(kw, padded_hw=(H - 8, W))),
    ]
    for args, k in bad:
        with pytest.raises(ValueError):
            lk_cuda.lk_level(*args, **k)
    assert lk_cuda.LAUNCHES == before


def _patch_args(seed, shift, dev, sigma=2.0):
    img, img2, pts = _scene(seed, shift, sigma)
    img_t = torch.from_numpy(img)
    gx, gy = pyramid.sobel_gradients(img_t)
    planes = [t.to(dev) for t in (img_t, gx, gy, torch.from_numpy(img2))]
    p = torch.from_numpy(pts).to(dev)
    valid = torch.ones(N, dtype=torch.bool, device=dev)
    valid[:4] = False
    args, kw, org_C = lk.patch_inputs(H, W, p, p, valid, lk.LKParams())
    return planes, args, kw, org_C, p


def test_patch_kernel_matches_plain_version_on_gpu():
    """Kernel #2 (the patch box at a (128, 8)-aligned origin) against
    lk_patch_ref on one 192x256 level of a smooth texture, shifted 8 px
    right and 6 px down."""
    dev = _device()
    planes, args, kw, org_C, p = _patch_args(211, (8.0, 6.0), dev, sigma=5.0)
    before = lk_patch_cuda.LAUNCHES
    out_k, flag_k = lk_patch_cuda.lk_patch(*planes, *args, **kw)
    torch.cuda.synchronize()
    assert lk_patch_cuda.LAUNCHES == before + 1
    out_r, flag_r = lk_patch_cuda.lk_patch_ref(*planes, *args, **kw)
    assert torch.equal(flag_k, flag_r)
    assert torch.isfinite(out_k).all()
    conv = torch.all(out_r == lk_patch_cuda.lk_patch_ref(
        *planes, *args, **dict(kw, iters=kw["iters"] - 1))[0], dim=-1)
    check = (flag_k[:, 0] > 0) & conv
    assert int(check.sum()) >= N // 2
    assert torch.max(torch.abs(out_k[check] - out_r[check])).item() < POS_ATOL
    # pre-frozen keypoints keep their guess
    assert torch.equal(out_k[:4], args[3][:4])
    r = lk.LKParams().window // 2
    moved = (org_C + r + out_k - p)[check & (args[4][:, 0] == 0)]
    assert float((torch.abs(moved - torch.tensor([8.0, 6.0], device=dev))
                  < 0.1).all(dim=-1).float().mean()) > 0.5


@pytest.mark.parametrize("win", [16, 24])
def test_patch_kernel_matches_plain_version_at_wide_windows_on_gpu(win):
    """Kernel #2 at its wider pixel classes (8 pixels a lane at win 16, 18
    at 24, its limit) against lk_patch_ref, with the checks of
    test_patch_kernel_matches_plain_version_on_gpu."""
    dev = _device()
    img, img2, pts = _scene(218, (5.0, 3.0), sigma=5.0)
    img_t = torch.from_numpy(img)
    gx, gy = pyramid.sobel_gradients(img_t)
    planes = [t.to(dev) for t in (img_t, gx, gy, torch.from_numpy(img2))]
    p = torch.from_numpy(pts).to(dev)
    valid = torch.ones(N, dtype=torch.bool, device=dev)
    args, kw, _ = lk.patch_inputs(H, W, p, p, valid,
                                  lk.LKParams(window=win))
    before = lk_patch_cuda.LAUNCHES
    out_k, flag_k = lk_patch_cuda.lk_patch(*planes, *args, **kw)
    torch.cuda.synchronize()
    assert lk_patch_cuda.LAUNCHES == before + 1
    out_r, flag_r = lk_patch_cuda.lk_patch_ref(*planes, *args, **kw)
    assert torch.equal(flag_k, flag_r)
    assert torch.isfinite(out_k).all()
    conv = torch.all(out_r == lk_patch_cuda.lk_patch_ref(
        *planes, *args, **dict(kw, iters=kw["iters"] - 1))[0], dim=-1)
    check = (flag_k[:, 0] > 0) & conv
    assert int(check.sum()) >= N // 2
    assert torch.max(torch.abs(out_k[check] - out_r[check])).item() < POS_ATOL


def test_track_dispatch_takes_the_patch_kernel_above_budget(monkeypatch):
    """With the plane budget at 0 every level takes kernel #2 on CUDA
    tensors ("auto"), and agrees with its plain version ("ref")."""
    dev = _device()
    monkeypatch.setattr(lk, "PLANE_BUDGET_BYTES", 0)
    img, img2, pts = _scene(212, (3.0, -2.0))
    pyr = [[t.to(dev) for t in pyramid.build_lk_pyramid(torch.from_numpy(a), 3)]
           for a in (img, img2)]
    p = torch.from_numpy(pts).to(dev)
    valid = torch.ones(N, dtype=torch.bool, device=dev)
    b1, b2 = lk_cuda.LAUNCHES, lk_patch_cuda.LAUNCHES
    out_k, ok_k, _ = lk.track(pyr[0], pyr[1], p, p, valid, lk.LKParams())
    torch.cuda.synchronize()
    assert (lk_cuda.LAUNCHES, lk_patch_cuda.LAUNCHES) == (b1, b2 + 3)
    out_r, ok_r, _ = lk.track(pyr[0], pyr[1], p, p, valid,
                              lk.LKParams(backend="ref"))
    assert lk_patch_cuda.LAUNCHES == b2 + 3   # the plain version never counts
    assert torch.equal(ok_k, ok_r)
    assert int(ok_k.sum()) >= 0.8 * N
    flow = (out_k - p)[ok_k].cpu().numpy()
    np.testing.assert_allclose(np.median(flow, axis=0), [3.0, -2.0], atol=0.1)
    d = torch.max(torch.abs(out_k - out_r), dim=-1).values[ok_k]
    assert float(d.median()) < POS_ATOL


def test_patch_wrapper_rejects_what_the_kernel_does_not_take():
    dev = _device()
    planes, args, kw, _, _ = _patch_args(213, (1.0, 1.0), dev)
    tl_prev, tl_cur, localT, local0, frozen0 = args
    before = lk_patch_cuda.LAUNCHES
    bad = [
        ((*planes, tl_prev.long(), tl_cur, localT, local0, frozen0), kw),
        ((*planes, tl_prev, tl_cur, localT[:-1], local0, frozen0), kw),
        ((*planes, tl_prev, tl_cur.cpu(), localT, local0, frozen0), kw),
        ((planes[0].double(), *planes[1:], *args), kw),
        ((*planes, *args), dict(kw, pty=36)),                 # not 8-aligned
        ((*planes, *args), dict(kw, padded_hw=(H, 128))),     # < 256 lanes
        ((*planes, *args), dict(kw, win=25)),                 # past 24
    ]
    for a, k in bad:
        with pytest.raises(ValueError):
            lk_patch_cuda.lk_patch(*a, **k)
    assert lk_patch_cuda.LAUNCHES == before


def _small_sequence(dev):
    """tests/test_engine_chunked.py's 620x188 setup, 24 frames rendered on
    the card, on the host: (settings, left, right) uint8 numpy."""
    fx = 360.0
    s = Settings()
    cam = dataclasses.replace(s.cam_left, fx=fx, fy=fx, cx=310.0, cy=94.0)
    s.cam_left, s.cam_right = cam, dataclasses.replace(cam)
    s.image_width, s.image_height = 620, 188
    s.baseline_fx = 0.54 * fx
    s.max_features, s.max_landmarks, s.min_init_landmarks = 256, 4096, 100
    s.loop_closing_open = False
    poses = synthetic.straight_trajectory(24, speed=0.8)
    L, R = synthetic_torch.render_stereo_sequence_device(
        synthetic.SyntheticWorld(seed=3), poses, fx, fx, cam.cx, cam.cy,
        s.baseline, s.image_width, s.image_height, device=dev)
    return s, L.cpu().numpy(), R.cpu().numpy()


def _run_steps(sys_, L, R):
    """Every frame through run_step: the statuses after each."""
    statuses = []
    for i in range(len(L)):
        sys_.run_step(L[i], R[i], 0.1 * i)
        statuses.append(sys_.status)
    return statuses


def test_chunk_path_on_gpu_matches_run_step():
    """The chunk API on the card (pinned host buffers, the upload stream,
    the prefetcher, pipelined dispatch/collect) gives what run_step gives,
    on 24 frames of tests/test_engine_chunked.py's 620x188 setup."""
    dev = _device()
    s, L, R = _small_sequence(dev)
    a = System(s, enable_backend=True, device=dev)
    st_a = _run_steps(a, L, R)
    b = System(s, enable_backend=True, device=dev)
    pf = b.prefetcher(depth=2)
    chunks = [slice(k, k + 6) for k in range(0, 24, 6)]
    for sl in chunks[:2]:
        pf.submit(L[sl], R[sl])
    handles, prev = [], None
    for k, sl in enumerate(chunks):
        h = b.dispatch_chunk(*pf.get(), [0.1 * i for i in range(24)][sl])
        if k + 2 < len(chunks):
            pf.submit(L[chunks[k + 2]], R[chunks[k + 2]])
        if prev is not None:
            b.collect_chunk(prev)
        handles.append(h)
        prev = h
    b.collect_chunk(prev)
    pf.close()
    st_b = [int(v) for h in handles for v in h.outs.status]
    assert st_b == st_a
    assert st_a[0] == fe.TRACKING_GOOD and fe.LOST not in st_a
    assert b.stats == a.stats and b.stats["n_ba"] >= 1
    _, ta = a.frame_trajectory()
    _, tb = b.frame_trajectory()
    np.testing.assert_allclose(tb[:, :, 3], ta[:, :, 3], atol=1e-3)


def test_chunk_device_timing_on_gpu():
    """With the recorder's device timing on, pipelined chunks time their
    frames by CUDA events and read them at collect: a period for every
    frame, a tracking time for every tracked frame and a keyframe time for
    every frame that ran the keyframe branch, both inside the frame's
    period (one stream: the events are in order); the LM steps read match
    Engine.ba_trips, and the events go back to the pool."""
    dev = _device()
    s, L, R = _small_sequence(dev)
    sys_ = System(s, enable_backend=True, device=dev)
    t0 = profiling.CLOCK()
    profiling.enable()
    try:
        prev = None
        for k in range(0, 24, 6):
            h = sys_.dispatch_chunk(L[k:k + 6], R[k:k + 6])
            assert h.timing is not None
            if prev is not None:
                sys_.collect_chunk(prev)
            prev = h
        sys_.collect_chunk(prev)
    finally:
        profiling.enable(False)
    tr = profiling.TRACE

    def by_frame(name):
        return {c.frame: c.value for c in tr.counts(name, t0)}

    period, track, kf = (by_frame(n) for n in (
        "engine.period_ms", "engine.track_ms", "engine.keyframe_ms"))
    frames = tr.spans("engine.frame", t0)
    assert sorted(period) == [f.frame for f in frames] == list(range(24))
    for f in frames:
        n = f.frame
        assert (n in track) == (f.tag in ("track", "track+keyframe")), f
        assert (n in kf) == (f.tag in ("init", "track+keyframe")), f
        assert 0 < track.get(n, 0) + kf.get(n, 0) <= period[n] + 1e-3, f
    assert any(f.tag == "track+keyframe" for f in frames)
    trips = torch.stack(list(sys_._engine.ba_trips)).cpu()
    needed = sum(c.value for c in tr.counts("ba.lm_steps_needed", t0))
    assert needed == int(trips[:, 1].sum()) and len(trips) >= 1
    # every BA ran in the keyframe graph: the rounds it took, 10 steps each
    assert sys_._engine.ba_mode == "graph"
    ran = sum(c.value for c in tr.counts("ba.lm_steps_run", t0))
    skipped = sum(c.value for c in tr.counts("ba.rounds_skipped", t0))
    rounds = int(trips[:, 0].sum())
    assert ran == rounds * ba.LOCAL_BA_ITERS
    assert skipped == len(trips) * ba.LOCAL_BA_ROUNDS - rounds
    assert len(profiling._EVENTS[dev]) >= 5
    sys_.close()


GRAPH_VS_EAGER_M = 1e-5   # the same kernels in the same order on one stream


def test_tracking_graph_capture_on_gpu():
    """A TrackGraph captures the tracking branch of a tracking System: its
    replay equals the direct call bit for bit, holds one kernel #1 launch
    a level of the forward and the backward track, and counts them on
    every replay (its warm-up's are counted where they ran)."""
    dev = _device()
    s, L, R = _small_sequence(dev)
    sys_ = System(s, enable_backend=True, device=dev, eager=True)
    i = 0
    while sys_.status not in (fe.TRACKING_GOOD, fe.TRACKING_BAD):
        sys_.run_step(L[i], R[i], 0.1 * i)
        i += 1
    c = sys_._carry()
    img = sys_._pad(L[i])
    args = (c.pyr_last, c.feat, c.T_cw, c.rel_motion, c.m.lm_pos,
            c.m.lm_valid, c.m.lm_gid)
    ref = sys_.frontend.track_frame(img, *args)
    n0 = lk_cuda.LAUNCHES
    graph = graphs.TrackGraph(sys_.frontend, img, *args)
    assert graph._graph is not None
    want = dict(dict.fromkeys(graph.launches, 0), lk_level=2 * s.lk_levels)
    assert graph.launches == want and graph.warmup_launches == want
    assert lk_cuda.LAUNCHES - n0 == 2 * s.lk_levels        # the warm-up's
    for _ in range(2):
        got = graph(img, *args)
    torch.cuda.synchronize()
    assert lk_cuda.LAUNCHES - n0 == 3 * 2 * s.lk_levels
    leaves = torch.utils._pytree.tree_leaves
    for a, b in zip(leaves(got), leaves(ref)):
        assert torch.equal(a, b)
    graph.close()


def test_tracking_graph_replays_like_eager_on_gpu(monkeypatch):
    """24 frames through run_step: the graph path (every replay of the
    tracking and the keyframe graph under
    torch.cuda.set_sync_debug_mode("error"), so a synchronising call on
    its way raises) against the eager path on the card: equal statuses and
    keyframes, positions within GRAPH_VS_EAGER_M, the tracking graph
    replayed on every tracked frame and the keyframe graph on every steady
    keyframe, kernel #1 launched as the statuses imply plus the warm-ups'
    launches."""
    dev = _device()
    s, L, R = _small_sequence(dev)
    call = graphs.StaticGraph.__call__

    def replay_sync_free(self, *a):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return call(self, *a)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    a = System(s, enable_backend=True, device=dev, eager=True)
    st_a = _run_steps(a, L, R)
    monkeypatch.setattr(graphs.StaticGraph, "__call__", replay_sync_free)
    b = System(s, enable_backend=True, device=dev)
    graphs.zero_counts()
    st_b = _run_steps(b, L, R)
    assert st_b == st_a and fe.LOST not in st_a
    assert b.stats == a.stats and b.stats["n_keyframes"] >= 2
    _, ta = a.frame_trajectory()
    _, tb = b.frame_trajectory()
    assert float(np.abs(tb[:, :, 3] - ta[:, :, 3]).max()) <= GRAPH_VS_EAGER_M
    assert not a._engine.graphs
    (graph,) = b._engine.graphs.values()
    before = [fe.INITING] + st_b[:-1]
    n_tracked = sum(x in (fe.TRACKING_GOOD, fe.TRACKING_BAD) for x in before)
    n_stereo = sum(x == fe.INITING for x in before) + sum(
        x in (fe.TRACKING_GOOD, fe.TRACKING_BAD) and y == fe.TRACKING_BAD
        for x, y in zip(before, st_b))
    assert graph.calls == n_tracked > 10
    (kf_graph,) = b._engine.kf_graphs.values()
    n_steady = n_stereo - sum(x == fe.INITING for x in before)
    assert kf_graph.calls == graphs.replays()[1] == n_steady >= 1
    assert graphs.replays()[0] == n_tracked
    levels = s.lk_levels
    assert lk_cuda.LAUNCHES == (2 * levels * n_tracked
                                + 2 * (levels + 1) * n_stereo
                                + graphs.WARMUP_LAUNCHES["lk_level"])
    b.close()
    assert not b._engine.graphs and not b._engine.kf_graphs


def test_keyframe_graph_capture_on_gpu():
    """A KeyframeGraph captures the keyframe branch of a steady keyframe:
    its replay equals the eager branch bit for bit (the fixed-trip BA
    included), holds one kernel #1 launch a level of both stereo tracks,
    counts them on every replay, and no replay waits for the device. A
    map with most observations moved 20-80 px makes its BA take all five
    rounds, which the same graph replays bit for bit as well."""
    dev = _device()
    s, L, R = _small_sequence(dev)
    sys_ = System(s, enable_backend=True, device=dev, eager=True)
    i = 0
    while sys_.status not in (fe.TRACKING_GOOD, fe.TRACKING_BAD):
        sys_.run_step(L[i], R[i], 0.1 * i)
        i += 1
    eng = sys_._engine
    c = sys_._carry()
    pyr_l, out = eng._track(c, sys_._pad(L[i]))
    args = (sys_._pad(R[i]), pyr_l, out.feat, out.T_cw, out.rel_motion, c.m)
    ref = eng.keyframe_branch(*args, is_init=False)
    graphs.zero_counts()
    n0 = lk_cuda.LAUNCHES
    graph = graphs.KeyframeGraph(eng.keyframe_branch, *args)
    assert graph._graph is not None
    want = dict(dict.fromkeys(graph.launches, 0),
                lk_level=2 * (s.lk_levels + 1))
    assert graph.launches == want and graph.warmup_launches == want
    for _ in range(2):
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = graph(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert lk_cuda.LAUNCHES - n0 == 3 * 2 * (s.lk_levels + 1)
    assert graphs.replays()[1] == 2 and graphs.replays()[0] == 0
    lg, lr = (torch.utils._pytree.tree_leaves(r) for r in (got, ref))
    assert [x is None for x in lg] == [x is None for x in lr]
    for a, b in zip(lg, lr):
        assert a is None or torch.equal(a, b)
    assert int(ref.kf_slot) >= 0 and 1 <= int(ref.ba_trip[0]) <= 5
    m = c.m
    moved = (torch.rand(m.obs_valid.shape, generator=torch.Generator(
        dev).manual_seed(5), device=dev) < 0.7) & m.obs_valid
    m = m._replace(obs_uv=m.obs_uv + 50.0 * moved[..., None])
    args = args[:-1] + (m,)
    ref = eng.keyframe_branch(*args, is_init=False)
    got = graph(*args)
    assert int(ref.ba_trip[0]) == ba.LOCAL_BA_ROUNDS
    for a, b in zip(*(torch.utils._pytree.tree_leaves(r) for r in (got, ref))):
        assert a is None or torch.equal(a, b)
    graph.close()


# the local BA at the bench's size (8192 landmarks, a window of 16,
# scripts/torch_profile_scaling.py's problem) with a share of its edges
# moved 20-80 px: rounds the BA takes -> (seed, share)
BA_ROUNDS = {1: (0, 0.0), 3: (0, 0.293), 5: (0, 0.4)}


def _ba_problem(dev, seed, share, M=8192, W=16):
    prob, cam = _tool("torch_profile_scaling").build_problem(M, W, seed)
    rng = np.random.default_rng(seed + 1)
    uv = prob.obs_uv.numpy()
    moved = rng.uniform(size=uv.shape[:3]) < share
    uv = np.where(moved[..., None],
                  uv + rng.uniform(20, 80, uv.shape).astype(np.float32), uv)
    prob = prob._replace(obs_uv=torch.from_numpy(uv))
    return ba.LocalBAProblem(*(t.to(dev) for t in prob)), cam


def test_ba_rounds_replay_like_eager_on_gpu():
    """One capture of the local BA replays the problems that take 1, 3
    and 5 rounds: each bit for bit the eager fixed trip (every round run,
    the state frozen after the ratio flag), rounds and LM steps included;
    the conditional nodes skip the rounds after the flag, so the 1-round
    replay takes under 40% of the 5-round replay's device time."""
    dev = _device()
    probs = {n: _ba_problem(dev, *v) for n, v in BA_ROUNDS.items()}
    cam = probs[1][1]

    def bundle(prob):
        return ba.local_ba(prob, *cam)

    graph = graphs.StaticGraph(bundle, probs[1][0])
    assert graph._bodies.nodes == ba.LOCAL_BA_ROUNDS - 1
    ms = {}
    for n, (prob, _) in probs.items():
        ref = bundle(prob)
        got = graph(prob)
        assert (int(ref.rounds), int(got.rounds)) == (n, n)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(5):
            graph(prob)
        end.record()
        torch.cuda.synchronize()
        ms[n] = start.elapsed_time(end) / 5
    assert ms[1] < 0.4 * ms[5], ms
    graph.close()


# the staged level kernels: (counter, wrapper, plain version, keywords);
# serial is kernel #1, ymm and pkmm name one function, lk_level_pk
VARIANTS = {
    "serial": ("lk_level", lk_cuda.lk_level, lk_cuda.lk_level_ref, {}),
    "sw": ("lk_level_sw", lkv.lk_level_sw, lkv.lk_level_sw_ref, {}),
    "pk": ("lk_level_pk", lkv.lk_level_pk, lkv.lk_level_pk_ref, {}),
    "mm": ("lk_level_mm", lkv.lk_level_mm, lkv.lk_level_mm_ref,
           {"use_bf16": True}),
    "mm_f32": ("lk_level_mm_f32", lkv.lk_level_mm, lkv.lk_level_mm_ref,
               {"use_bf16": False}),
}
COUNTER = {"sw": "lk_level_sw", "ymm": "lk_level_pk", "pkmm": "lk_level_pk",
           "mm": "lk_level_mm", "mm_f32": "lk_level_mm_f32"}
# mm where rounding noise cannot build up (chip_smoke.py, MM_*): window
# values within this many float32 ulps of the window's largest magnitude
# of the plain blend's (one bf16 rounding the other way is ~2^15 of them),
# one step within this many px on every live track
MM_WINDOW_ULPS = 2.0
MM_STEP_TOL_PX = 1e-4


def _launches(counter):
    """The launch count of the kernel behind `counter`."""
    return lk_cuda.LAUNCHES if counter == "lk_level" else lkv.LAUNCHES[counter]


def _window_ulps(got, want):
    """chip_smoke.py::window_ulps."""
    scale = want.abs().amax(dim=(1, 2), keepdim=True).clamp_min(2.0 ** -126)
    return float(((got - want).abs() / (scale * 2.0 ** -23)).max())


def _variant_level(dev, hw=(190, 250), seed=214, stretch=False):
    """One level of true dims hw with the 192x256 bounds of the padded
    plane, N = 45 (not a multiple of the 4 warps a block), 4 keypoints
    frozen."""
    img, img2, pts = _scene(seed, (3.1, -2.2), stretch=stretch)
    img_t = torch.from_numpy(img)
    gx, gy = pyramid.sobel_gradients(img_t)
    planes = [t[:hw[0], :hw[1]].contiguous().to(dev)
              for t in (img_t, gx, gy, torch.from_numpy(img2))]
    p = torch.from_numpy(pts[:45]).to(dev)
    frozen0 = torch.zeros((45, 1), dtype=torch.int32, device=dev)
    frozen0[:4] = 1
    return (*planes, p, p, frozen0)


@pytest.mark.parametrize("flavour,win", [
    ("sw", 11), ("sw", 16), ("sw", 23), ("serial", 16), ("serial", 24),
    ("pk", 11), ("pk", 16), ("mm", 11), ("mm", 16), ("mm_f32", 11),
    ("mm_f32", 16)])
def test_variant_kernel_matches_plain_version_on_gpu(flavour, win):
    """The staged kernels on _variant_level against their plain versions
    at each pixel class they take: 4 a lane (win 11), 8 (16; two k-steps
    for mm) and 18 (#1 at its limit 24, #3 at 23); sw also against kernel
    #1, whose kernel it launches, bit for bit."""
    dev = _device()
    counter, fn, ref, extra = VARIANTS[flavour]
    args = _variant_level(dev)
    p, frozen0 = args[4], args[6]
    kw = dict(KW, win=win, padded_hw=(192, 256), **extra)
    before = _launches(counter)
    out_k, flag_k = fn(*args, **kw)
    torch.cuda.synchronize()
    assert _launches(counter) == before + 1
    out_r, flag_r = ref(*args, **kw)
    assert _launches(counter) == before + 1   # the plain version: no count
    assert torch.equal(flag_k, flag_r)
    assert torch.isfinite(out_k).all()
    # frozen keypoints keep their guess (less r, plus r: an ulp or so)
    assert torch.allclose(out_k[:4], p[:4], rtol=0, atol=1e-4)
    live = (flag_k[:, 0] > 0) & (frozen0[:, 0] == 0)
    d = torch.max(torch.abs(out_k - out_r), dim=-1).values
    if flavour == "mm":
        assert float((d[live] <= POS_ATOL).float().mean()) >= MM_MIN_AGREE_SHARE
        return
    conv = torch.all(out_r == ref(*args, **dict(kw, iters=KW["iters"] - 1))[0],
                     dim=-1)
    assert int((live & conv).sum()) >= 45 // 2
    assert float(d[live & conv].max()) < POS_ATOL
    if flavour == "sw":
        out_1, flag_1 = lk_cuda.lk_level(*args, **dict(kw))
        assert torch.equal(out_k, out_1) and torch.equal(flag_k, flag_1)


@pytest.mark.parametrize("win", [11, 16])
def test_mm_tight_checks_and_their_control_on_gpu(win):
    """mm's kernel against its plain version where noise cannot build up:
    the sampled windows (template top-lefts on the three previous planes,
    read from L2; search top-lefts on the current one, read from a staged
    region, as the solve reads them) within MM_WINDOW_ULPS, and one step
    within MM_STEP_TOL_PX on every live track. Control: the mm_f32
    kernel, which leaves out the bf16 roundings, held against mm's plain
    version, fails both and the share rule."""
    dev = _device()
    args = _variant_level(dev)
    planes, p, frozen0 = args[:4], args[4], args[6]
    r = win // 2
    tl = torch.clamp(p - r, min=0.0).contiguous()
    kw = dict(KW, win=win, padded_hw=(192, 256))
    one = dict(kw, iters=1)
    step_r, flag_r = lkv.lk_level_mm_ref(*args, **one, use_bf16=True)
    out_r, _ = lkv.lk_level_mm_ref(*args, **kw, use_bf16=True)
    live = (flag_r[:, 0] > 0) & (frozen0[:, 0] == 0)
    got = {}
    for tag, use_bf16 in (("mm", True), ("control", False)):
        ulps = [_window_ulps(
            lkv.mm_windows(pl, tl, win=win, use_bf16=use_bf16,
                           staged=k == 3),
            lkv.mm_windows_ref(pl, tl, win=win))
            for k, pl in enumerate(planes)]
        step_k, _ = lkv.lk_level_mm(*args, **one, use_bf16=use_bf16)
        out_k, _ = lkv.lk_level_mm(*args, **kw, use_bf16=use_bf16)
        d = torch.max(torch.abs(out_k - out_r), dim=-1).values[live]
        got[tag] = (max(ulps),
                    float(torch.abs(step_k - step_r)[live].max()),
                    float((d <= POS_ATOL).float().mean()))
    mm, ctl = got["mm"], got["control"]
    assert mm[0] <= MM_WINDOW_ULPS and mm[1] <= MM_STEP_TOL_PX \
        and mm[2] >= MM_MIN_AGREE_SHARE, got
    assert ctl[0] > MM_WINDOW_ULPS and ctl[1] > MM_STEP_TOL_PX \
        and ctl[2] < MM_MIN_AGREE_SHARE, got
    with pytest.raises(ValueError):          # a top-left off the plane
        lkv.mm_windows(planes[0], tl - 40.0, win=win)
    with pytest.raises(ValueError):          # past the kernel's limit
        lkv.mm_windows(planes[0], tl, win=17)


@pytest.mark.parametrize("flavour", list(COUNTER))
def test_track_launches_the_flavours_kernel_once_per_level(flavour):
    """lk.track on CUDA tensors ("auto") with the flavour goes through the
    flavour's kernel at every level and never through kernel #1."""
    dev = _device()
    counter = COUNTER[flavour]
    img, img2, pts = _scene(215, (4.0, 1.5))
    pyr = [[t.to(dev) for t in pyramid.build_lk_pyramid(torch.from_numpy(a), 3)]
           for a in (img, img2)]
    p = torch.from_numpy(pts).to(dev)
    valid = torch.ones(N, dtype=torch.bool, device=dev)
    b1, bv = lk_cuda.LAUNCHES, lkv.LAUNCHES[counter]
    out_k, ok_k, _ = lk.track(pyr[0], pyr[1], p, p, valid,
                              lk.LKParams(kernel=flavour))
    torch.cuda.synchronize()
    assert (lk_cuda.LAUNCHES, lkv.LAUNCHES[counter]) == (b1, bv + 3)
    assert int(ok_k.sum()) >= 0.8 * N
    flow = (out_k - p)[ok_k].cpu().numpy()
    np.testing.assert_allclose(np.median(flow, axis=0), [4.0, 1.5], atol=0.2)


@pytest.mark.parametrize("flavour", list(VARIANTS))
def test_variant_wrapper_rejects_what_the_kernel_does_not_take(flavour):
    dev = _device()
    counter, fn, _, extra = VARIANTS[flavour]
    img, img2, pts = _scene(216, (1.0, 1.0))
    img_t = torch.from_numpy(img)
    gx, gy = pyramid.sobel_gradients(img_t)
    planes = [t.to(dev) for t in (img_t, gx, gy, torch.from_numpy(img2))]
    p = torch.from_numpy(pts).to(dev)
    frozen0 = torch.zeros((N, 1), dtype=torch.int32, device=dev)
    kw = dict(KW, padded_hw=(H, W), **extra)
    before = _launches(counter)
    stats = torch.zeros(3, dtype=torch.int32, device=dev)
    bad = [
        ((planes[0].double(), *planes[1:], p, p, frozen0), kw),
        ((planes[0].to(torch.bfloat16), *planes[1:], p, p, frozen0), kw),
        ((planes[0].t().contiguous().t(), *planes[1:], p, p, frozen0),
         kw),                                                  # strided
        ((*planes, p[:-1], p, frozen0), kw),                    # shape
        ((*planes, p.cpu(), p, frozen0), kw),                   # device
        ((*planes, p, p, frozen0.long()), kw),                  # dtype
        # one past the kernel's window limit: 25 for serial, 24 for sw, 17
        # for pk and mm
        ((*planes, p, p, frozen0), dict(kw, win=_nvcc.MAX_WIN[counter] + 1)),
        ((*planes, p, p, frozen0), dict(kw, padded_hw=(H - 8, W))),
        ((*planes, p, p, frozen0), dict(kw, stats=stats.long())),
        ((*planes, p, p, frozen0), dict(kw, stats=stats[:2])),
    ]
    for args, k in bad:
        with pytest.raises(ValueError):
            fn(*args, **k)
    assert _launches(counter) == before


# phase 3b's share of the live tracks that must agree within POS_ATOL
# (chip_smoke.py: MM_MIN_AGREE_SHARE)
PHASE_3B_AGREE_SHARE = 0.95


@pytest.mark.parametrize("hw", [(188, 248), (190, 250), (189, 249)])
@pytest.mark.parametrize("flavour", ["serial", "sw", "pk", "mm", "mm_f32"])
def test_search_leaves_the_staged_region_on_gpu(flavour, hw):
    """#1, #3, #4 and #5 with guesses 12 px off the true motion in x and in
    y, so that searches walk past the region staged around their first
    window and read L2, and 6 keypoints within 8 px of the true-dims edge of a
    level whose padded dims (192x256) exceed them, so that the region and
    the windows reach past (H, W) and read 0. The widths take each copy
    path: 248 rows are 16-byte aligned, 250 float32 rows 4-byte (bf16
    4-byte too), 249 bf16 rows element by element. The kernel reports
    windows read outside the region (> 0), and is held as chip_smoke.py's
    region fallback check holds it: flags equal, tracks that converged
    within POS_ATOL (not mm), and at least PHASE_3B_AGREE_SHARE of all live
    tracks within POS_ATOL. Starting 12 px off, a quarter of the tracks
    still step at the 30-iteration cap, so phase 3's bound on that share
    does not apply; the agree share holds them instead."""
    dev = _device()
    counter, fn, ref, extra = VARIANTS[flavour]
    args = list(_variant_level(dev, hw, seed=217, stretch=True))
    h, w = hw
    p = args[4].clone()
    p[4:7, 0] = w - 8.0 + torch.arange(3, device=dev) * 1.3
    p[7:10, 1] = h - 8.0 + torch.arange(3, device=dev) * 1.3
    guess = p + torch.tensor([3.1 + 12.0, -2.2 - 12.0], device=dev)
    guess[4:10] = p[4:10]                    # the edge keypoints start there
    args[4], args[5] = p.contiguous(), guess.contiguous()
    frozen0 = args[6]
    kw = dict(KW, padded_hw=(192, 256), **extra)
    stats = torch.zeros(3, dtype=torch.int32, device=dev)
    before = _launches(counter)
    out_k, flag_k = fn(*args, **kw, stats=stats)
    torch.cuda.synchronize()
    assert _launches(counter) == before + 1
    out_r, flag_r = ref(*args, **kw)
    n_out, kp_iters, max_iters = (int(v) for v in stats.cpu())
    assert n_out > 0 and kp_iters >= n_out and 1 <= max_iters <= KW["iters"]
    assert torch.equal(flag_k, flag_r)
    assert torch.isfinite(out_k).all()
    live = (flag_k[:, 0] > 0) & (frozen0[:, 0] == 0) \
        & sampling.in_bounds(out_r, h, w, 1.0)        # as chip_smoke.py's
    assert int(live.sum()) >= 30
    d = torch.max(torch.abs(out_k - out_r), dim=-1).values
    assert float((d[live] <= POS_ATOL).float().mean()) \
        >= PHASE_3B_AGREE_SHARE, d[live]
    if flavour != "mm":
        conv = torch.all(ref(*args, **dict(kw, iters=KW["iters"] - 1))[0]
                         == out_r, dim=-1)
        assert int((live & conv).sum()) >= 15
        assert float(d[live & conv].max()) < POS_ATOL


def _patch_level(dev, win, guess_off=(0.0, 0.0), seed=217):
    """Kernel #2's inputs on one 192x256 level moved by (3.1, -2.2) px,
    the guesses `guess_off` off the keypoints, 4 keypoints frozen."""
    img, img2, pts = _scene(seed, (3.1, -2.2), stretch=True)
    img_t = torch.from_numpy(img)
    gx, gy = pyramid.sobel_gradients(img_t)
    planes = [t.to(dev) for t in (img_t, gx, gy, torch.from_numpy(img2))]
    p = torch.from_numpy(pts).to(dev)
    guess = (p + torch.tensor(guess_off, device=dev)).contiguous()
    valid = torch.ones(N, dtype=torch.bool, device=dev)
    valid[:4] = False
    args, kw, _ = lk.patch_inputs(H, W, p, guess, valid,
                                  lk.LKParams(window=win))
    return planes, args, kw


@pytest.mark.parametrize("win", [11, 16, 24])
def test_patch_kernel_stats_on_gpu(win):
    """Kernel #2 with `stats` at each pixel class (4, 8 and 18 pixels a
    lane; 18 KB and 39 KB of shared memory a block): the outputs are those
    of a launch without stats bit for bit, the counts are consistent and
    equal the plain version's, and a wrong stats tensor raises."""
    dev = _device()
    planes, args, kw = _patch_level(dev, win)
    stats = torch.zeros(3, dtype=torch.int32, device=dev)
    before = lk_patch_cuda.LAUNCHES
    out_s, flag_s = lk_patch_cuda.lk_patch(*planes, *args, **kw, stats=stats)
    out_k, flag_k = lk_patch_cuda.lk_patch(*planes, *args, **kw)
    torch.cuda.synchronize()
    assert lk_patch_cuda.LAUNCHES == before + 2
    assert torch.equal(out_s, out_k) and torch.equal(flag_s, flag_k)
    n_out, kp_iters, max_iters = (int(v) for v in stats.cpu())
    assert 0 <= n_out <= kp_iters and 1 <= max_iters <= kw["iters"]
    assert kp_iters >= N - 4                  # every live keypoint steps
    counts = {}
    out_r, flag_r = lk_patch_cuda.lk_patch_ref(*planes, *args, **kw,
                                               counts=counts)
    assert torch.equal(flag_k, flag_r)
    # a track at the convergence edge may take one step more on one side
    assert abs(int(counts["kp_iters"]) - kp_iters) <= N
    conv = torch.all(out_r == lk_patch_cuda.lk_patch_ref(
        *planes, *args, **dict(kw, iters=kw["iters"] - 1))[0], dim=-1)
    check = (flag_k[:, 0] > 0) & conv
    assert int(check.sum()) >= N // 2
    assert torch.max(torch.abs(out_k[check] - out_r[check])).item() < POS_ATOL
    for bad in (stats.long(), stats[:2], stats.cpu()):
        with pytest.raises(ValueError):
            lk_patch_cuda.lk_patch(*planes, *args, **kw, stats=bad)
    assert lk_patch_cuda.LAUNCHES == before + 2


def test_patch_search_leaves_the_staged_region_on_gpu():
    """Kernel #2 with guesses 12 px off the true motion in x (its search
    box has 0-127 px of slack there, 8-20 px in y), so that searches walk
    past the region staged around their first window and read L2: windows
    outside the region are reported (> 0), and the kernel is held against
    lk_patch_ref as test_search_leaves_the_staged_region_on_gpu holds the
    others."""
    dev = _device()
    planes, args, kw = _patch_level(dev, 11, guess_off=(3.1 + 12.0, -2.2))
    frozen0 = args[4]
    stats = torch.zeros(3, dtype=torch.int32, device=dev)
    out_k, flag_k = lk_patch_cuda.lk_patch(*planes, *args, **kw, stats=stats)
    torch.cuda.synchronize()
    out_r, flag_r = lk_patch_cuda.lk_patch_ref(*planes, *args, **kw)
    n_out, kp_iters, max_iters = (int(v) for v in stats.cpu())
    assert n_out > 0 and kp_iters >= n_out and 1 <= max_iters <= kw["iters"]
    assert torch.equal(flag_k, flag_r)
    assert torch.isfinite(out_k).all()
    live = (flag_k[:, 0] > 0) & (frozen0[:, 0] == 0)
    assert int(live.sum()) >= 30
    d = torch.max(torch.abs(out_k - out_r), dim=-1).values
    assert float((d[live] <= POS_ATOL).float().mean()) \
        >= PHASE_3B_AGREE_SHARE, d[live]
    conv = torch.all(lk_patch_cuda.lk_patch_ref(
        *planes, *args, **dict(kw, iters=kw["iters"] - 1))[0] == out_r,
        dim=-1)
    assert int((live & conv).sum()) >= 15
    assert float(d[live & conv].max()) < POS_ATOL


def test_popcount_and_words_of_card_against_cpu():
    """The integer ops of loop closing give the CPU's results on the card,
    exactly: the int32 popcount (sign bit, all ones, random words), a
    [Na, Nb] Hamming matrix, a match with ties, and the vocabulary
    descent."""
    dev = _device()
    rng = np.random.default_rng(219)
    words = np.concatenate([
        np.array([0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0, 1], np.uint32),
        rng.integers(0, 2 ** 32, 8187, dtype=np.uint32)]).view(np.int32)
    x = torch.from_numpy(words)
    want = np.unpackbits(words.view(np.uint8).reshape(-1, 4), axis=1).sum(1)
    assert np.array_equal(orb._popcount32(x.to(dev)).cpu().numpy(), want)
    a = torch.from_numpy(rng.integers(0, 2 ** 32, (300, 8), dtype=np.uint32)
                         .view(np.int32))
    b = torch.cat([a[:100], a[:100], torch.from_numpy(
        rng.integers(0, 2 ** 32, (150, 8), dtype=np.uint32).view(np.int32))])
    assert torch.equal(
        orb.hamming_distance(a.to(dev)[:, None], b.to(dev)[None]).cpu(),
        orb.hamming_distance(a[:, None], b[None]))
    va, vb = torch.ones(300, dtype=torch.bool), torch.ones(350,
                                                           dtype=torch.bool)
    vb[::9] = False
    for g, c in zip(orb.match_brute_force(a.to(dev), b.to(dev), va.to(dev),
                                          vb.to(dev)),
                    orb.match_brute_force(a, b, va, vb)):
        assert torch.equal(g.cpu(), c)        # ties: the first index wins
    docs = [rng.integers(0, 2 ** 32, (200, 8), dtype=np.uint32)
            for _ in range(5)]
    vocab = bow.train(docs, k=6, levels=3, seed=4)
    valid = torch.from_numpy(rng.uniform(size=300) > 0.1)
    w_cpu = bow.words_of(vocab, a, valid, 3)
    w_gpu = bow.words_of(vocab.to(dev), a.to(dev), valid.to(dev), 3)
    assert torch.equal(w_gpu.cpu(), w_cpu)
    assert len(set(w_cpu.tolist())) > 20
    torch.testing.assert_close(
        bow.transform(vocab.to(dev), a.to(dev), valid.to(dev), 3).cpu(),
        bow.transform(vocab, a, valid, 3), atol=1e-6, rtol=0)


# ----------------------------------------------------------------------
# the LoopClosing class: match, fusion and ingest, card against CPU
# ----------------------------------------------------------------------

def _lc_settings():
    s = Settings()
    s.max_features, s.loop_desc_scales, s.max_keyframes_db = 96, 2, 16
    s.max_landmarks, s.max_window, s.vocab_k, s.vocab_levels = 256, 4, 4, 2
    return s


def _lc_pair(dev):
    from ssvio_tpu_torch.loopclosing import LoopClosing
    s = _lc_settings()
    return (LoopClosing(s, 320.0, 320.0, 160.0, 64.0, device=dev),
            LoopClosing(s, 320.0, 320.0, 160.0, 64.0, device="cpu"))


def _i32(rng, shape):
    return torch.from_numpy(rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
                            .view(np.int32))


def _clustered(rng, rows, n):
    """[rows, n, 8] int32 descriptors, each row's spread around a centre
    of its own (10% of the bits flipped): BoW tells the rows apart."""
    bits = (rng.random((rows, n, 8, 32)) < 0.1).astype(np.uint32)
    d = rng.integers(0, 2 ** 32, (rows, 1, 8), dtype=np.uint32) ^ (
        bits << np.arange(32, dtype=np.uint32)).sum(-1, dtype=np.uint32)
    return torch.from_numpy(d.view(np.int32))


@pytest.mark.parametrize("gate", [0, 64])
def test_loopclosing_match_card_against_cpu(gate):
    """LoopClosing._match_impl on the card equals the CPU's (best match,
    distance, mutual/threshold mask), with many equal distances."""
    dev = _device()
    lc_g, lc_c = _lc_pair(dev)
    S, F = lc_c.S, lc_c.F
    rng = np.random.default_rng(231)
    cur = _i32(rng, (S * F, 8))
    loop = cur.reshape(S, F, 8)[:, torch.from_numpy(rng.permutation(F))]
    loop = loop.reshape(S * F, 8) ^ (_i32(rng, (S * F, 8))
                                     & _i32(rng, (S * F, 8))
                                     & _i32(rng, (S * F, 8)))
    vc = torch.from_numpy(rng.random(S * F) < 0.85)
    vl = torch.from_numpy(rng.random(S * F) < 0.85)
    out_c = lc_c._match_impl(cur, vc, loop, vl, gate)
    out_g = lc_g._match_impl(cur.to(dev), vc.to(dev), loop.to(dev),
                             vl.to(dev), gate)
    for g, c in zip(out_g, out_c):
        assert torch.equal(g.cpu(), c)
    assert int(out_c[2].sum()) > 10


def test_loopclosing_fuse_card_against_cpu():
    """_fuse_impl (merges and adoptions) and remap_feat on the card equal
    the CPU's exactly (they only gather, select and copy)."""
    from ssvio_tpu_torch import map as mapmod
    from ssvio_tpu_torch.loopclosing import LoopClosing
    dev = _device()
    rng = np.random.default_rng(233)
    W, M, F = 8, 64, 32
    gids = rng.permutation(1000)[:M].astype(np.int32)
    valid = rng.random(M) < 0.75
    m = mapmod.empty_map(W, M)._replace(
        lm_pos=torch.from_numpy(rng.normal(0, 5, (M, 3)).astype(np.float32)),
        lm_valid=torch.from_numpy(valid), lm_gid=torch.from_numpy(gids),
        lm_first_kf=torch.from_numpy(rng.integers(0, 20, M)
                                     .astype(np.int32)),
        obs_uv=torch.from_numpy(rng.uniform(0, 300, (M, W, 2, 2))
                                .astype(np.float32)),
        obs_valid=torch.from_numpy(rng.random((M, W, 2)) < 0.3))
    slots = rng.permutation(M)[:F].astype(np.int32)
    f_gid = gids[slots].copy()
    f_gid[rng.random(F) < 0.1] += 1                     # stale links
    feat = fe.empty_feat_state(F)._replace(
        lm_slot=torch.from_numpy(slots), lm_gid=torch.from_numpy(f_gid),
        valid=torch.from_numpy(rng.random(F) < 0.9))
    kind = rng.integers(0, 3, F)
    loop_gid = np.where(kind == 0, rng.permutation(gids[valid])[:F],
                        np.where(kind == 1, 2000 + np.arange(F), -1))
    args = (torch.from_numpy(rng.permutation(F).astype(np.int32)),
            torch.from_numpy(rng.random(F) < 0.8),
            torch.from_numpy(rng.normal(0, 5, (F, 3)).astype(np.float32)),
            torch.from_numpy(loop_gid.astype(np.int32)),
            torch.from_numpy(rng.random(F) < 0.9))
    out_c = LoopClosing._fuse_impl(m, feat, *args, 42)
    out_g = LoopClosing._fuse_impl(
        mapmod.MapState(*[t.to(dev) for t in m]),
        fe.FeatState(*[t.to(dev) for t in feat]),
        *[a.to(dev) for a in args], 42)
    for g, c in zip(out_g[0], out_c[0]):
        assert torch.equal(g.cpu(), c)
    for g, c in zip(out_g[1:], out_c[1:]):
        assert torch.equal(g.cpu(), c)
    assert int(out_c[3]) >= 3 and int(out_c[4]) >= 3
    f_c = LoopClosing.remap_feat(feat, out_c[1], out_c[2], out_c[0].lm_gid)
    f_g = LoopClosing.remap_feat(fe.FeatState(*[t.to(dev) for t in feat]),
                                 out_g[1], out_g[2], out_g[0].lm_gid)
    for g, c in zip(f_g, f_c):
        assert torch.equal(g.cpu(), c)


def test_loopclosing_ingest_card_against_cpu():
    """The scoring ingest of a group of 3 keyframes (store, snapshot
    refresh, BoW transform, scores under the age gate) on the card: the
    database rows and the best rows equal the CPU's, BoW vectors and
    scores within 1e-6."""
    from ssvio_tpu_torch.loopclosing import LoopClosing
    dev = _device()
    lc_g, lc_c = _lc_pair(dev)
    rng = np.random.default_rng(237)
    cap, FS, F, M, B, n0 = lc_c.cap, lc_c.S * lc_c.F, lc_c.F, 256, 3, 5
    db = [_clustered(rng, cap, FS),
          torch.from_numpy(rng.random((cap, FS)) < 0.6),
          torch.from_numpy(rng.normal(0, 50, (cap, F, 2)).astype(np.float32)),
          torch.from_numpy(rng.normal(0, 5, (cap, F, 3)).astype(np.float32)),
          torch.from_numpy(rng.random((cap, F)) < 0.5),
          torch.from_numpy(rng.integers(-1, 300, (cap, F)).astype(np.int32))]
    docs = [db[0][i][db[1][i]].numpy().view(np.uint32) for i in range(n0)]
    vocab = bow.train(docs, k=4, levels=2, seed=7)
    bow_db = torch.zeros((cap, vocab.n_words))
    for i in range(n0):
        bow_db[i] = bow.transform(vocab, db[0][i], db[1][i], 2)
    gid_dev = torch.full((cap,), -1, dtype=torch.int32)
    gid_dev[:n0] = torch.arange(n0, dtype=torch.int32) * 3 + 1
    m_gid = rng.integers(0, 300, M).astype(np.int32)
    slot = rng.integers(-1, M, (B, F)).astype(np.int32)
    group = [_clustered(rng, B, FS),
             torch.from_numpy(rng.random((B, FS)) < 0.6),
             torch.from_numpy(rng.uniform(0, 300, (B, F, 2))
                              .astype(np.float32)),
             torch.from_numpy(rng.random((B, F)) < 0.8),
             torch.from_numpy(slot),
             torch.from_numpy(np.where(slot >= 0, m_gid[np.clip(slot, 0,
                                                                M - 1)], -1)
                              .astype(np.int32)),
             torch.from_numpy(rng.normal(0, 5, (M, 3)).astype(np.float32)),
             torch.from_numpy(m_gid), torch.from_numpy(rng.random(M) < 0.8)]
    group[0][0], group[1][0] = db[0][2], db[1][2]       # a stored row's copy
    gids = torch.tensor([20, 21, 25], dtype=torch.int32)
    rr = torch.tensor([1, 3, 4, -1], dtype=torch.int32)

    def run(d):
        return LoopClosing._ingest_impl_v(      # it writes into the db
            *[t.clone().to(d) for t in db], bow_db.clone().to(d),
            gid_dev.clone().to(d), n0,
            *[t.to(d) for t in group], vocab.to(d), gids.to(d), rr.to(d),
            min_age=3, levels=2)

    out_c, out_g = run("cpu"), run(dev)
    for g, c in zip(out_g[:6] + (out_g[7],), out_c[:6] + (out_c[7],)):
        assert torch.equal(g.cpu(), c)
    torch.testing.assert_close(out_g[6].cpu(), out_c[6], atol=1e-6, rtol=0)
    assert out_g[8] == out_c[8] == n0 + B
    assert torch.equal(out_g[9][0].cpu(), out_c[9][0])
    torch.testing.assert_close(out_g[9][1].cpu(), out_c[9][1], atol=1e-6,
                               rtol=0)
    assert int(out_c[9][0, 0]) == 2 and float(out_c[9][1, 0]) > 0.99


# --------------------------------------------- the profiling tools (card)
def _tool(name):
    """A scripts/torch_*.py tool as a module (the tools import no jax)."""
    import importlib
    import os
    import sys
    scripts = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    return importlib.import_module(name)


def test_transfer_tool_on_gpu():
    """scripts/torch_profile_transfer.py on the card: every copy has a rate,
    pinned memory is measured, and side-stream copies of the chunk the
    prefetcher uploads (CHUNK pairs) overlap the port's step (a serialised
    copy gives a share near 0)."""
    _device()
    r = _tool("torch_profile_transfer").main(["--reps", "3"])
    assert r["card"] and r["device"].startswith("cuda")
    for v in r["host_to_device"].values():
        for way in ("pageable", "pinned"):
            assert v[way]["ms"] > 0 and v[way]["gb_per_s"] > 0
    assert r["readback"]["cpu_ms"] > 0 and r["readback"]["pinned_event_ms"] > 0
    ov = r["overlap"]
    assert ov["copy_ms"] > 0 and ov["step_ms"] > 0
    assert len(ov["shares"]) == 3 and ov["share"] > 0.5


def test_lk_kernels_tool_on_gpu(monkeypatch):
    """scripts/torch_profile_lk_kernels.py on the card, its sweeps cut: the
    profiler's device time of every launch is positive, more iterations of
    the chain cost more, the hard flow steps to the cap."""
    _device()
    m = _tool("torch_profile_lk_kernels")
    monkeypatch.setattr(m, "ITERS", (1, 30))
    monkeypatch.setattr(m, "LIVE", (64, 512))
    monkeypatch.setattr(m, "KERNELS", ("serial", "mm_f32", "patch"))
    r = m.main(["--reps", "8"])
    assert r["timer"].startswith("torch.profiler")
    for k in r["kernels"].values():
        assert all(x["ms"] > 0 for x in k["iters"] + k["live"]
                   + k["per_level"])
        assert k["iters"][1]["chain"] > k["iters"][0]["chain"] == 1
        assert k["iters"][1]["ms"] > k["iters"][0]["ms"]
        assert k["us_per_iter"] > 0
        assert k["flow"]["hard"]["chain"] == 30
    assert len(r["kernels"]["serial"]["per_level"]) == 4


LOOP_CUT = 384           # frames: two laps of the ring
LOOP_SEED = 2147483651


def test_loop_pgo_matches_the_reference_on_gpu():
    """The `robotcar-loop-offline` cell's drive (`benchmark/traffic/
    ring-offline.json`) cut at two laps, run through `System.run_chunk` in
    chunks of 32 with loop closing on: at least one correction, and every
    PGO the port solves is within `benchmark/loop_check.py::GAP_LIMIT` of
    the float64 optimum of `benchmark/reference_loop.py`, which the
    reference's own solve in TF32 is not (gap = (cost - optimum) /
    optimum)."""
    dev = _device()
    from benchmark import cells, loop_check, traffic
    cell = cells.load("robotcar-loop-offline")
    s = cells.settings_from(cell.config)
    drive = dict(cell.traffic["drive"], frames=LOOP_CUT)
    problems = []
    with torch.no_grad(), loop_check.captured_pgo(problems):
        sys_ = System(s, enable_backend=True, enable_loop_closing=True,
                      device=dev)
        d = traffic.make_drive(drive, LOOP_SEED, s, sys_.w, sys_.h, dev)
        for c in range(0, LOOP_CUT, 32):
            sys_.run_chunk(d.left[c:c + 32], d.right[c:c + 32],
                           [(c + j) / s.fps for j in range(32)])
        sys_.finish()
        n_loops = sys_.stats["n_loops"]
        sys_.close()
    assert n_loops >= 1 and len(problems) == n_loops
    for prob, port in problems:
        g = loop_check.judge_problem(prob, port, dev)
        assert g["port_gap"] < loop_check.GAP_LIMIT <= g["control_gap"], g


# ----------------------------------------------------------------------
# the loop verification's graphs (loopclosing.VerifyGraphs)
# ----------------------------------------------------------------------

class _Warns:
    def _warn(self, msg):
        pass


def _sync_free_calls(monkeypatch):
    """Every StaticGraph call under set_sync_debug_mode("error"): a call
    that waits for the device raises."""
    call = graphs.StaticGraph.__call__

    def sync_free(self, *a):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return call(self, *a)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    monkeypatch.setattr(graphs.StaticGraph, "__call__", sync_free)


def test_verify_graphs_replay_like_eager_on_gpu(monkeypatch):
    """A verification at the cells' sizes (512 features, 8 octaves, 128
    hypotheses: scripts/torch_profile_verify.py's scene) on several
    candidates, the last after the database grew: replayed through
    VerifyGraphs (no replay waits for the device) and op by op
    (_verify_impl) from the same generator state, equal pack, matches and
    inliers (the same kernels on the same data: capture changes no
    cuBLAS or cuSOLVER choice here, as the tracking graph's tests find
    too). One capture, counted once; one VERIFY_REPLAYS a verification;
    the revisit verified and the unrelated row's PnP rejected (its
    random descriptors pass the adaptive Hamming gate in numbers)."""
    from ssvio_tpu_torch import loopclosing as lcm
    dev = _device()
    tool = _tool("torch_profile_verify")
    s = tool.settings()
    cam = s.cam_left
    lc = lcm.LoopClosing(s, cam.fx, cam.fy, cam.cx, cam.cy, device=dev)
    sc = tool.scene(lc)
    row, brow, xy, T = sc["row"], sc["brow"], sc["xy"], sc["T_est"]
    xy2 = xy + 1.5 * torch.randn(xy.shape, device=dev, generator=torch.
                                 Generator(dev).manual_seed(3))
    cands = [(row, brow, xy, T), (row, 4, xy, T), (row, brow, xy2, T), None,
             (row, brow, xy, T)]
    profiling.TRACE.reset(lcm.VERIFY_REPLAYS, lcm.VERIFY_CAPTURES)
    _sync_free_calls(monkeypatch)
    packs = []
    with torch.no_grad():
        for i, c in enumerate(cands):
            if c is None:
                lc._grow(_Warns())
                continue
            lc._gen.manual_seed(100 + i)
            want = lc._verify_impl(lc.desc_db, lc.desc_valid, lc.lm_has,
                                   lc.lm_pos, *c)
            lc._gen.manual_seed(100 + i)
            got = lc._verify(*c)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
            packs.append(got[0].cpu().numpy())
    counters = profiling.TRACE.counters
    assert lc._graphs.captured and lc.cap == 2 * s.max_keyframes_db
    assert counters[lcm.VERIFY_CAPTURES] == 1
    assert counters[lcm.VERIFY_REPLAYS] == len(packs) == 4
    assert [g.calls for g in lc._graphs.stages] == [4] * 3
    assert packs[0][1] == 1.0 and packs[0][2] >= 300
    assert packs[1][1] == 0.0
    assert packs[3][1] == 1.0
    lc.close()
    assert lc._graphs is None


VERIFY_CUT = 384         # frames of the straight drive: verifies from ~220
VERIFY_SEED = 2147483659


def test_verify_replays_count_every_verification_on_gpu():
    """`kitti-straight-offline`'s drive cut to VERIFY_CUT frames, twice,
    through System.run_chunk in chunks of 32 with reset(keep_vocab=True)
    between, as the benchmark drives it: the verification graphs are
    captured once, with the vocabulary, and handed over to the second
    drive's loop closer; both drives verify, and every verification
    replays them (loopclosing.verify_replays equals
    loopclosing.verify_attempted)."""
    from benchmark import cells, traffic
    from ssvio_tpu_torch import loopclosing as lcm
    dev = _device()
    cell = cells.load("kitti-straight-offline")
    s = cells.settings_from(cell.config)
    drive = dict(cell.traffic["drive"], frames=VERIFY_CUT)
    attempted = "loopclosing.verify_attempted"
    names = (lcm.VERIFY_REPLAYS, lcm.VERIFY_CAPTURES, attempted)
    profiling.TRACE.reset(*names)
    counters = profiling.TRACE.counters
    held, tried = [], []
    with torch.no_grad():
        sys_ = System(s, enable_backend=True, enable_loop_closing=True,
                      device=dev)
        d = traffic.make_drive(drive, VERIFY_SEED, s, sys_.w, sys_.h, dev)
        for _ in range(2):
            for c in range(0, VERIFY_CUT, 32):
                sys_.run_chunk(d.left[c:c + 32], d.right[c:c + 32],
                               [(c + j) / s.fps for j in range(32)])
            sys_.finish()
            held.append(sys_.loopclosing._graphs)
            tried.append(counters.get(attempted, 0))
            sys_.reset(keep_vocab=True)
        assert sys_.loopclosing._graphs is held[0]
        sys_.close()
    assert held[0] is held[1] and held[0].captured
    assert counters[lcm.VERIFY_CAPTURES] == 1
    assert 0 < tried[0] < tried[1]
    assert counters[lcm.VERIFY_REPLAYS] == counters[attempted] == tried[1]

