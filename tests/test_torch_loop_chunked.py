"""Loop corrections through the port's chunk path: the metric-level checks
of tests/test_loopclosing.py::test_loop_correction_through_chunked_path on
`ssvio_tpu_torch`, on the CPU.

The scene is that test's: a 6 m circle at 320x128 driven once and 20
frames more, in chunks of 10 through run_chunk (each chunk's keyframes are
verified at the next collect). The settings are its own, cut so that the
file runs in about 120 s on one worker: tracking_good 120 instead of 10^6
(a keyframe on about half the frames instead of every one) and 1024
landmark slots instead of 4096. The checks are the JAX test's, with its
thresholds: at least one accepted correction, landmarks fused, real drift
(peak > 2 m) and an end error below max(2.5 m, half the peak). Each
correction is a span `loopclosing.correct` of the recorder inside its
`loopclosing.verify`, with its PGO `loopclosing.pgo` inside it, and the
counters `pgo.keyframes` / `pgo.edges` are the sizes of the graphs the
PGOs solved.
"""

from types import SimpleNamespace

import numpy as np

from ssvio_tpu_torch import interop
from ssvio_tpu_torch.dataio import synthetic, synthetic_torch
from ssvio_tpu_torch.ops import ba, pgo, se3
from ssvio_tpu_torch.system import System
from ssvio_tpu_torch.utils import profiling
from test_loopclosing import _small_settings
from test_relocalization import _sequence
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)


def test_loop_correction_through_chunked_path(monkeypatch):
    sizes = []
    optimize = pgo.optimize

    def sized(prob, *a, **k):
        sizes.append((int(prob.pose_valid.sum()), int(prob.edge_valid.sum())))
        return optimize(prob, *a, **k)

    monkeypatch.setattr(pgo, "optimize", sized)
    profiling.TRACE.reset()
    s = _small_settings()
    s.tracking_good = 120
    s.max_landmarks = 1024
    s = interop.settings(s)
    cam = s.cam_left
    n, CH = 140, 10
    world = synthetic.SyntheticWorld(seed=11, wall_x=16.0, ceiling_y=-5.0)
    circ = synthetic.loop_trajectory(120, radius=6.0)
    poses = np.concatenate([circ, circ[:20]], axis=0)
    L, R = synthetic_torch.render_stereo_sequence_device(
        world, poses, cam.fx, cam.fy, cam.cx, cam.cy, s.baseline,
        s.image_width, s.image_height, u8=False, device="cpu")

    sys_ = System(s, enable_backend=True, enable_loop_closing=True,
                  device="cpu")
    peak = 0.0
    for c in range(0, n, CH):
        sys_.run_chunk(L[c:c + CH], R[c:c + CH],
                       [0.1 * (c + j) for j in range(CH)])
        T_wc = se3.inverse_np(sys_.T_cw.numpy())
        peak = max(peak, float(np.linalg.norm(
            T_wc[:, 3] - poses[c + CH - 1][:, 3])))

    corrected = [e for e in sys_.loopclosing.events if e.corrected]
    assert corrected, (
        f"no correction through the chunked path: "
        f"{sys_.loopclosing.events[-8:]}")
    assert sys_.stats["n_loops"] >= 1
    assert sys_.stats.get("n_fused", 0) > 0
    ts, est = sys_.keyframe_trajectory()
    gids = [k["frame_id"] for k in sys_.records.keyframes]
    err_end = float(np.linalg.norm(est[-1][:, 3] - poses[gids][-1][:, 3]))
    assert peak > 2.0, peak
    assert err_end < max(2.5, 0.5 * peak), (err_end, peak)
    # every correction was recorded as a gauge event, and the records of
    # the re-gauged chunks stay consistent with their odometry edges
    assert sys_.records.gauge_index() == len(corrected)
    assert np.all(np.isfinite(est))
    # the recorder: a correction inside its verification, its PGO inside it
    tr = profiling.TRACE
    verify = {sp.id for sp in tr.spans("loopclosing.verify")}
    correct = tr.spans("loopclosing.correct")
    assert len(correct) == len(corrected)
    assert all(sp.parent in verify for sp in correct)
    pgos = tr.spans("loopclosing.pgo")
    assert len(pgos) == len(corrected)
    assert {sp.parent for sp in pgos} == {sp.id for sp in correct}
    assert len(tr.counts("loopclosing.verify_attempted")) == len(verify) \
        == len(sys_.loopclosing.events)
    assert len(tr.counts("loopclosing.verify_accepted")) == len(corrected)
    assert [(c.value, e.value) for c, e in zip(
        tr.counts("pgo.keyframes"), tr.counts("pgo.edges"))] == sizes


def test_the_ba_after_a_correction_runs_every_round(monkeypatch):
    """A correction sets Engine.after_correction: the next steady
    keyframe's local BA runs with it, all its rounds, and clears it; the
    BAs before and after it run without it. The chunk path, on the
    20-frame straight scene, a keyframe on nearly every frame."""
    calls = []
    local_ba = ba.local_ba

    def logged(*a, hold=None, **k):
        res = local_ba(*a, hold=hold, **k)
        calls.append((hold is not None and bool(hold), int(res.rounds)))
        return res

    monkeypatch.setattr(ba, "local_ba", logged)
    s = _small_settings()
    _, L, R = _sequence(s, n=12)
    sys_ = System(interop.settings(s), enable_backend=True,
                  enable_loop_closing=False, device="cpu")
    sys_.run_chunk(L[:6], R[:6], [0.1 * i for i in range(6)])
    n0 = len(calls)
    assert n0 >= 2 and not any(h for h, _ in calls)
    sys_._count_event(SimpleNamespace(corrected=True, n_fused=0))
    assert bool(sys_._engine.after_correction)
    sys_.run_chunk(L[6:], R[6:], [0.1 * i for i in range(6, 12)])
    assert len(calls) >= n0 + 2
    assert calls[n0] == (True, ba.LOCAL_BA_ROUNDS)
    assert not any(h for h, _ in calls[n0 + 1:])
    assert not bool(sys_._engine.after_correction)
