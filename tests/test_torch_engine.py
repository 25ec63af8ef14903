"""The port's chunked engine (engine.py) and chunk API (system.py).

run_step and the chunk path run the engine's one per-frame step
(`Engine._step`), so on one device the two give the same statuses,
keyframes and poses; what these tests hold is the chunk path's own part
(the carry between chunks, pack_readback, the host records of
collect_chunk). The trajectories differ only in how T_wc is inverted (numpy
on the readback vs torch per frame), a few float32 ulps, hence 1e-4 m. The sequence is
tests/test_engine_chunked.py's 24 frames at 620x188, rendered by the port's
renderer as camera-native uint8, on the CPU (the LK levels take the
patch-bounded path, as the JAX package's do off the TPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssvio_tpu import engine as eng_j
from ssvio_tpu import frontend as fe_j
from ssvio_tpu import map as map_j
from ssvio_tpu.ops import se3 as se3_j
from ssvio_tpu_torch import engine as eng_t
from ssvio_tpu_torch import frontend as fe_t
from ssvio_tpu_torch import interop
from ssvio_tpu_torch.dataio import synthetic, synthetic_torch
from ssvio_tpu_torch.parallel import dist_ba
from ssvio_tpu_torch.system import System
from test_engine_chunked import _settings
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

N_FRAMES = 24
POS_ATOL_M = 1e-4        # see module docstring


def render_sequence():
    """(settings, gt poses [24, 3, 4], L, R uint8 numpy [24, 188, 620])."""
    s = interop.settings(_settings())
    s.loop_closing_open = False
    poses = synthetic.straight_trajectory(N_FRAMES, speed=0.8)
    cam = s.cam_left
    L, R = synthetic_torch.render_stereo_sequence_device(
        synthetic.SyntheticWorld(seed=3), poses, cam.fx, cam.fy, cam.cx,
        cam.cy, s.baseline, s.image_width, s.image_height, u8=True)
    return s, poses, L.numpy(), R.numpy()


def run_steps(s, L, R):
    """The port's per-frame run: (system, statuses after each frame)."""
    sys_ = System(s, enable_backend=True, device="cpu")
    statuses = []
    for i in range(len(L)):
        sys_.run_step(L[i], R[i], 0.1 * i)
        statuses.append(sys_.status)
    return sys_, statuses


def run_chunks(s, L, R, sizes, pipelined=False):
    """The port's chunked run over consecutive chunks of `sizes` frames:
    (system, statuses after each frame, from the chunks' FrameOut). With
    `pipelined`, uploads go through the prefetcher and chunk k+1 is
    dispatched before chunk k is collected, as bench.py drives it."""
    sys_ = System(s, enable_backend=True, device="cpu")
    bounds = np.cumsum([0] + list(sizes))
    chunks = [(slice(a, b), [0.1 * i for i in range(a, b)])
              for a, b in zip(bounds[:-1], bounds[1:])]
    handles = []
    if pipelined:
        pf = sys_.prefetcher(depth=2)
        for sl, _ in chunks[:2]:
            pf.submit(L[sl], R[sl])
        prev = None
        for k, (sl, ts) in enumerate(chunks):
            h = sys_.dispatch_chunk(*pf.get(), ts)
            if k + 2 < len(chunks):
                pf.submit(L[chunks[k + 2][0]], R[chunks[k + 2][0]])
            if prev is not None:
                sys_.collect_chunk(prev)
            handles.append(h)
            prev = h
        sys_.collect_chunk(prev)
        pf.close()
    else:
        for sl, ts in chunks:
            h = sys_.dispatch_chunk(L[sl], R[sl], ts)
            out = sys_.collect_chunk(h)
            assert out.shape == (sl.stop - sl.start, 3, 4)
            handles.append(h)
    sys_.finish()
    statuses = [int(v) for h in handles for v in h.outs.status]
    return sys_, statuses


@pytest.fixture(scope="module")
def seq():
    return render_sequence()


@pytest.fixture(scope="module")
def per_frame(seq):
    s, poses, L, R = seq
    return run_steps(s, L, R)


def _same_run(a, st_a, b, st_b):
    assert st_b == st_a
    assert b.status == a.status
    assert b.stats == a.stats
    assert [k["frame_id"] for k in b.records.keyframes] == \
        [k["frame_id"] for k in a.records.keyframes]
    _, ta = a.frame_trajectory()
    _, tb = b.frame_trajectory()
    assert len(tb) == len(ta)
    np.testing.assert_allclose(tb, ta, atol=POS_ATOL_M)
    kb = np.stack(b.records.poses())
    ka = np.stack(a.records.poses())
    np.testing.assert_allclose(kb, ka, atol=POS_ATOL_M)
    assert len(b.records.odometry_edges) == len(b.records.keyframes) - 1


def test_run_chunk_matches_run_step(seq, per_frame):
    s, poses, L, R = seq
    a, st_a = per_frame
    b, st_b = run_chunks(s, L, R, [8, 8, 8])
    _same_run(a, st_a, b, st_b)
    # the run itself: init, steady keyframes with BA, never LOST
    assert st_a[0] == fe_t.TRACKING_GOOD and fe_t.LOST not in st_a
    assert fe_t.TRACKING_BAD in st_a and b.stats["n_ba"] >= 1
    assert b.track_health is not None and b.track_health > s.tracking_bad


def test_partial_odd_and_mixed_chunks(seq, per_frame):
    """Odd and partial chunk sizes, and run_step frames between chunks,
    give the per-frame run."""
    s, poses, L, R = seq
    a, st_a = per_frame
    b, st_b = run_chunks(s, L[:13], R[:13], [5, 5, 3])
    for i in range(13, 15):
        b.run_step(L[i], R[i], 0.1 * i)
        st_b.append(b.status)
    out = b.run_chunk(*b.upload_chunk(L[15:16], R[15:16]), [1.5])
    st_b.append(b.status)
    assert out.shape == (1, 3, 4)
    # a [K, H, W] tensor stack (made on the device) goes in as it is
    h = b.dispatch_chunk(torch.from_numpy(L[16:]), torch.from_numpy(R[16:]),
                         [0.1 * i for i in range(16, N_FRAMES)])
    b.collect_chunk(h)
    st_b += [int(v) for v in h.outs.status]
    _same_run(a, st_a, b, st_b)
    with pytest.raises(ValueError, match="empty"):
        b.dispatch_chunk([], [])


def test_pipelined_dispatch_through_the_prefetcher(seq, per_frame):
    s, poses, L, R = seq
    a, st_a = per_frame
    b, st_b = run_chunks(s, L, R, [6, 6, 6, 6], pipelined=True)
    _same_run(a, st_a, b, st_b)


def test_engine_from_fresh_carry(seq, per_frame):
    """The engine driven directly from fresh_carry, as the JAX package's
    profiling scripts drive theirs, gives the per-frame run's first frames
    (u8 stacks promoted on the device)."""
    s, poses, L, R = seq
    a, st_a = per_frame
    sys_ = System(s, enable_backend=True, device="cpu")
    engine = eng_t.Engine(sys_.frontend, enable_backend=True)
    carry = eng_t.fresh_carry(s, sys_.frontend, sys_.map)
    assert carry.status == fe_t.INITING
    carry, outs, packed, n_ba, n_dist_ba = engine.run_chunk(
        carry, *sys_.upload_chunk(L[:3], R[:3]))
    assert outs.status.tolist() == st_a[:3] and carry.status == st_a[2]
    assert outs.kf_flag.tolist() == [True, False, False]
    assert n_ba == n_dist_ba == 0
    assert packed.shape == (3 * eng_t.PER_FRAME_PACK + 1 + 14 * s.max_window,)
    T_wc = np.stack([t for _, _, t in a.trajectory[:3]])
    R_cw = outs.T_cw[:, :, :3].numpy()
    t_wc = -np.einsum("kji,kj->ki", R_cw, outs.T_cw[:, :, 3].numpy())
    np.testing.assert_allclose(t_wc, T_wc[:, :, 3], atol=POS_ATOL_M)
    # with a mesh the engine's BA goes through a PrimaryBA (run over two
    # ranks in tests/test_torch_multihost.py); the engine must be rank 0
    # and on the mesh's device
    cpu = torch.device("cpu")
    assert eng_t.Engine(sys_.frontend, enable_backend=True,
                        mesh=dist_ba.Mesh(None, 0, 2, cpu)).dist.n_solves == 0
    with pytest.raises(ValueError, match="rank 0"):
        eng_t.Engine(sys_.frontend, enable_backend=True,
                     mesh=dist_ba.Mesh(None, 1, 2, cpu))
    with pytest.raises(ValueError, match="device"):
        eng_t.Engine(sys_.frontend, enable_backend=True,
                     mesh=dist_ba.Mesh(None, 0, 2, torch.device("meta")))
    with pytest.raises(ValueError, match="not divisible"):
        eng_t.Engine(sys_.frontend, enable_backend=True,
                     mesh=dist_ba.Mesh(None, 0, s.max_landmarks + 1, cpu))


def test_pack_readback_matches_jax_layout():
    """pack_readback element by element against the JAX package's, on a
    seeded state carried across with interop (4 frames, window 16)."""
    rng = np.random.default_rng(401)
    K, N, W, M = 4, 32, 16, 64
    feat = fe_j.FeatState(
        xy=jnp.asarray(rng.uniform(0, 600, (K, N, 2)).astype(np.float32)),
        lm_slot=jnp.asarray(rng.integers(-1, M, (K, N)).astype(np.int32)),
        lm_gid=jnp.asarray(rng.integers(-1, 999, (K, N)).astype(np.int32)),
        valid=jnp.asarray(rng.uniform(size=(K, N)) < 0.7),
        octave=jnp.asarray(rng.integers(0, 8, (K, N)).astype(np.int32)))
    kf = rng.uniform(size=K) < 0.5
    outs_j = eng_j.FrameOut(
        T_cw=jnp.asarray(rng.normal(size=(K, 3, 4)).astype(np.float32)),
        status=jnp.asarray(rng.integers(0, 4, K).astype(np.int32)),
        n_inliers=jnp.asarray(rng.integers(0, 512, K).astype(np.int32)),
        kf_flag=jnp.asarray(kf),
        kf_slot=jnp.asarray(np.where(kf, rng.integers(0, W, K), -1)
                            .astype(np.int32)),
        kf_gid=jnp.asarray(np.where(kf, rng.integers(0, 5000, K), -1)
                           .astype(np.int32)),
        feat=feat, desc=jnp.zeros((0, 8), jnp.uint32),
        dval=jnp.zeros((0,), bool))
    m = map_j.empty_map(W, M)
    m = m._replace(
        kf_pose=jnp.asarray(rng.normal(size=(W, 3, 4)).astype(np.float32)),
        kf_gid=jnp.asarray(rng.integers(-1, 5000, W).astype(np.int32)),
        kf_valid=jnp.asarray(rng.uniform(size=W) < 0.6))
    zero = jnp.zeros((32, 64), jnp.float32)
    carry_j = eng_j.EngineCarry(
        pyr_last=fe_j.Pyr((zero,), (zero,), (zero,)),
        feat=fe_j.FeatState(*[x[0] for x in feat]), T_cw=se3_j.identity(),
        rel_motion=se3_j.identity(), m=m, status=jnp.int32(2))
    packed_j = np.asarray(eng_j.pack_readback(carry_j, outs_j))
    packed_t = eng_t.pack_readback(interop.engine_carry(carry_j),
                                   interop.frame_out(outs_j)).numpy()
    assert eng_t.PER_FRAME_PACK == eng_j.PER_FRAME_PACK
    assert packed_t.dtype == packed_j.dtype == np.float32
    np.testing.assert_array_equal(packed_t, packed_j)


def test_prefetcher_contract(seq):
    """Mirrors tests/test_engine_chunked.py::test_prefetcher_contract: the
    depth bound, ValueError on an empty chunk, worker exceptions re-raised
    at close(); uploads keep uint8."""
    s, poses, L, R = seq
    sys_ = System(s, enable_backend=True, device="cpu")
    pf = sys_.prefetcher(depth=2)
    pf.submit(L[:4], R[:4])
    pf.submit(L[4:8], R[4:8])
    with pytest.raises(RuntimeError, match="depth"):
        pf.submit(L[8:12], R[8:12])
    a = pf.get()
    b = pf.get()
    assert a[0].shape == b[0].shape == (4, sys_.h, sys_.w)
    assert a[0].dtype == torch.uint8 and len(pf) == 0
    np.testing.assert_array_equal(a[0][:, :s.image_height, :s.image_width]
                                  .numpy(), L[:4])
    with pytest.raises(ValueError, match="empty"):
        pf.submit([], [])
    pf.close()

    # a worker-side failure (image larger than the engine canvas) must
    # surface at close() even if get() is never called
    pf2 = sys_.prefetcher(depth=2)
    big = np.zeros((s.image_height * 4, s.image_width * 4), np.uint8)
    pf2.submit([big], [big])
    with pytest.raises(ValueError, match="canvas"):
        pf2.close()
