"""The slice as a whole with loop closing on: the port's System against the
JAX System on tests/test_relocalization.py's 20-frame straight scene
(320x128, a keyframe nearly every frame, the database warm at 12
keyframes, loop_min_age 100 so no closure fires), on the CPU.

The JAX side runs `run_step`; the port runs `run_step` and the pipelined
chunk API (prefetcher, chunk k+1 dispatched before chunk k is collected,
`finish()`), in chunks of 4 frames, so that each chunk's keyframes are one
ingest group and the vocabulary is trained at the keyframe run_step trains
it at. Statuses, keyframe gids, the database rows and gids and that
training point must be equal; per-frame positions within 1e-3 m (the two
packages differ in float32 summation order, ~1e-4 m a frame here).

Then tests/test_relocalization.py's two tests on the port's per-frame run,
with their thresholds: featureless frames drive it LOST, a first-pass view
relocalizes within 0.5 m and tracking resumes; with relocalization_open
off, LOST dead-ends. The chunk path's loop corrections are in
tests/test_torch_loop_chunked.py.
"""

import numpy as np
import pytest
import torch

from ssvio_tpu.system import System as SystemJ
from ssvio_tpu_torch import frontend as fe_t
from ssvio_tpu_torch import interop
from ssvio_tpu_torch.config import Settings
from ssvio_tpu_torch.ops import bow as bow_t
from ssvio_tpu_torch.parallel import dist_ba
from ssvio_tpu_torch.system import System as SystemT
from test_relocalization import _sequence, _small_settings
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

POS_ATOL_M = 1e-3
CHUNK = 4


def _trained_at(lc):
    """Record the database size at each vocabulary training."""
    lc.trained_at = []
    train = lc._train_vocab

    def wrapped(levels):
        lc.trained_at.append(lc.n)
        return train(levels)
    lc._train_vocab = wrapped


def _summary(sys_, statuses):
    """The run's outcome, of a port System or the JAX package's (whose
    records are its `keyframes`)."""
    lc = sys_.loopclosing
    _, est = sys_.frame_trajectory()
    kfs = (sys_.records.keyframes if hasattr(sys_, "records")
           else sys_.keyframes)
    return dict(status=list(statuses), est=est,
                kf_gids=[k["gid"] for k in kfs],
                kf_frames=[k["frame_id"] for k in kfs],
                n=lc.n, db_gid=lc.db_gid[:lc.n].copy(),
                trained_at=list(lc.trained_at),
                vocab=lc.vocab is not None, events=list(lc.events))


@pytest.fixture(scope="module")
def scene():
    s = _small_settings()
    poses, L, R = _sequence(s)
    return s, poses, L, R


@pytest.fixture(scope="module")
def port_step(scene):
    """The port's per-frame run, and its summary taken right after it (the
    relocalization tests go on driving the same System)."""
    s, poses, L, R = scene
    sys_ = SystemT(interop.settings(s), enable_backend=True,
                   enable_loop_closing=True, device="cpu")
    _trained_at(sys_.loopclosing)
    statuses = []
    for i in range(len(L)):
        sys_.run_step(L[i], R[i], 0.1 * i)
        statuses.append(sys_.status)
    return sys_, _summary(sys_, statuses)


def test_loop_on_matches_jax_through_run_step_and_chunks(scene, port_step):
    s, poses, L, R = scene
    sys_j = SystemJ(s, enable_backend=True, enable_loop_closing=True)
    _trained_at(sys_j.loopclosing)
    st_j = []
    for i in range(len(L)):
        sys_j.run_step(L[i], R[i], 0.1 * i)
        st_j.append(sys_j.status)
    j = _summary(sys_j, st_j)

    sys_c = SystemT(interop.settings(s), enable_backend=True,
                    enable_loop_closing=True, device="cpu")
    _trained_at(sys_c.loopclosing)
    sl = [slice(a, a + CHUNK) for a in range(0, len(L), CHUNK)]
    pf = sys_c.prefetcher(depth=2)
    for k in sl[:2]:
        pf.submit(L[k], R[k])
    handles, prev = [], None
    for i, k in enumerate(sl):
        h = sys_c.dispatch_chunk(*pf.get(), [0.1 * f for f in
                                             range(k.start, k.stop)])
        if i + 2 < len(sl):
            pf.submit(L[sl[i + 2]], R[sl[i + 2]])
        if prev is not None:
            sys_c.collect_chunk(prev)
        handles.append(h)
        prev = h
    sys_c.collect_chunk(prev)
    sys_c.finish()
    pf.close()
    c = _summary(sys_c, [int(v) for h in handles for v in h.outs.status])

    t = port_step[1]
    assert j["vocab"] and j["trained_at"] == [s.loop_db_min_size]
    for run in (t, c):
        for key in ("status", "kf_gids", "kf_frames", "n", "trained_at",
                    "vocab"):
            assert run[key] == j[key], key
        np.testing.assert_array_equal(run["db_gid"], j["db_gid"])
        np.testing.assert_allclose(run["est"][:, :, 3], j["est"][:, :, 3],
                                   atol=POS_ATOL_M)
        assert run["events"] == j["events"] == []      # loop_min_age 100
    assert fe_t.LOST not in t["status"] and t["n"] >= s.loop_db_min_size
    # the chunk path read the engine's descriptors: the stored rows equal
    # the per-frame path's
    lc_t, lc_c = port_step[0].loopclosing, sys_c.loopclosing
    n = lc_c.n
    assert torch.equal(lc_c.desc_db[:n], lc_t.desc_db[:n])
    assert torch.equal(lc_c.desc_valid[:n], lc_t.desc_valid[:n])


def test_relocalization_recovers_from_lost(scene, port_step):
    """tests/test_relocalization.py's test on the port: three blank frames
    drive it LOST without a relocalization; a first-pass view relocalizes
    within 0.5 m and tracking resumes, within 0.5 m 4 frames on."""
    s, poses, L, R = scene
    sys_ = port_step[0]
    assert sys_.loopclosing.vocab is not None, "database never warmed up"
    blank = np.full((s.image_height, s.image_width), 128.0, np.float32)
    n0 = sys_.stats.get("n_relocalizations", 0)
    for j in range(3):
        sys_.run_step(blank, blank, 10.0 + j * 0.1)
    assert sys_.status == fe_t.LOST
    assert sys_.stats.get("n_relocalizations", 0) == n0   # blank: no fix
    k = 10
    sys_.run_step(L[k], R[k], 20.0)
    assert sys_.stats.get("n_relocalizations", 0) == n0 + 1
    assert sys_.status == fe_t.TRACKING_GOOD
    err = np.linalg.norm(sys_.trajectory[-1][2][:, 3] - poses[k][:, 3])
    assert err < 0.5, f"relocalized pose off by {err:.3f} m"
    # the relocalized keyframe has no odometry edge to the lost one
    g = sys_.records.gids()[-1]
    assert all(b != g for _, b, _ in sys_.records.odometry_edges)
    for i in range(k + 1, k + 5):
        sys_.run_step(L[i], R[i], 21.0 + i * 0.1)
    assert sys_.status != fe_t.LOST
    err = np.linalg.norm(sys_.trajectory[-1][2][:, 3] - poses[k + 4][:, 3])
    assert err < 0.5, f"post-recovery drift {err:.3f} m"


def test_lost_dead_end_parity_when_disabled(scene, port_step):
    """relocalization_open off: LOST dead-ends on a relocalizable view."""
    s, poses, L, R = scene
    sys_ = port_step[0]
    blank = np.full((s.image_height, s.image_width), 128.0, np.float32)
    n0 = sys_.stats.get("n_relocalizations", 0)
    sys_.s.relocalization_open = False
    try:
        for j in range(2):
            sys_.run_step(blank, blank, 30.0 + j * 0.1)
        assert sys_.status == fe_t.LOST
        sys_.run_step(L[8], R[8], 40.0)    # a perfectly relocalizable view
        assert sys_.status == fe_t.LOST
        assert sys_.stats.get("n_relocalizations", 0) == n0
    finally:
        sys_.s.relocalization_open = True


def test_reset_keeps_or_drops_the_vocabulary(scene):
    """reset(keep_vocab=True) starts an empty database with the trained
    vocabulary (its BoW rows sized for its words); reset() drops it, and
    both clear the loop state and the health history."""
    s = interop.settings(scene[0])
    sys_ = SystemT(s, enable_backend=True, enable_loop_closing=True,
                   device="cpu")
    rng = np.random.default_rng(5)
    docs = [rng.integers(0, 2 ** 32, size=(200, 8), dtype=np.uint64)
            .astype(np.uint32) for _ in range(3)]
    vocab = bow_t.train(docs, k=s.vocab_k, levels=2, seed=7)
    sys_.loopclosing.vocab, sys_.loopclosing._vocab_levels = vocab, 2
    sys_.records.add_gauge_event(np.eye(3, 4, dtype=np.float32))
    sys_._add_health(50.0)
    sys_.reset(keep_vocab=True)
    lc = sys_.loopclosing
    assert lc.vocab is vocab and lc._vocab_levels == 2 and lc.n == 0
    assert tuple(lc.bow_db.shape) == (lc.cap, vocab.n_words)
    assert sys_.records.gauge_events == [] and sys_._health_history == []
    assert sys_.track_health_typical is None
    sys_.reset()
    assert sys_.loopclosing.vocab is None


def test_default_settings_construct_with_loop_closing(monkeypatch):
    """System(Settings()) has loop closing on (Settings.loop_closing_open)
    and constructs, on the CPU when asked and on the CUDA device by
    default (none here: it raises naming device="cpu"); with a mesh its
    steady keyframes' BA goes through the mesh's PrimaryBA."""
    sys_ = SystemT(Settings(), device="cpu")
    lc = sys_.loopclosing
    assert lc is not None and lc.device == torch.device("cpu")
    assert sys_._engine.loop_desc and lc.cap == Settings().max_keyframes_db
    assert sys_.stats["warnings"] == [] and sys_.records.gauge_events == []
    sys_.finish()                                  # nothing deferred
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        SystemT(Settings())
    cpu = torch.device("cpu")
    meshed = SystemT(Settings(), mesh=dist_ba.Mesh(None, 0, 2, cpu),
                     device="cpu")
    assert meshed.loopclosing is not None and meshed._engine.loop_desc
    assert meshed._engine.dist.n_solves == meshed.stats["n_dist_ba"] == 0
