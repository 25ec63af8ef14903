"""The slice as a whole: the port's System against the JAX System.

Both run `run_step` with the backend (local BA) on and loop closing off, on
the same 12 frames of tests/test_system_e2e.py's straight sequence, on the
CPU (the LK level takes the patch-bounded path on both sides). The
tracking_good threshold is raised so that a steady keyframe, and so a
local BA, falls inside the 12 frames; the inlier counts stay at least 4
away from it on every frame, so float-order noise cannot flip a status.

Tolerance on per-frame camera positions: 5 mm. The two sides differ only
in float32 summation order (LK windows, LM normal equations, BA blocks),
which moves a pose by ~1e-4 m per frame here; 12 frames stay far inside
5 mm, while a real divergence (a different inlier set or keyframe) moves
it by centimetres.
"""

import numpy as np
import pytest

from ssvio_tpu.dataio import synthetic
from ssvio_tpu.eval import ate
from ssvio_tpu.system import System as SystemJ
from ssvio_tpu_torch import frontend as fe_t
from ssvio_tpu_torch import interop
from ssvio_tpu_torch.system import System as SystemT
from test_system_e2e import BASELINE, CX, CY, FX, FY, H, W, small_settings

N_FRAMES = 12
POS_ATOL_M = 5e-3


@pytest.fixture(scope="module")
def runs():
    world = synthetic.SyntheticWorld(seed=9)
    poses = synthetic.straight_trajectory(30, speed=0.35,
                                          yaw_rate=0.004)[:N_FRAMES]
    L, R = synthetic.render_stereo_sequence(world, poses, FX, FY, CX, CY,
                                            BASELINE, W, H)
    s = small_settings(backend_open=True, max_landmarks=2048,
                       tracking_good=70)
    out = {"gt": poses}
    for tag, sys_ in (("jax", SystemJ(s, enable_loop_closing=False)),
                      ("torch", SystemT(interop.settings(s),
                                        enable_loop_closing=False))):
        est, status, kfs = [], [], []
        for i in range(N_FRAMES):
            est.append(sys_.run_step(np.array(L[i]), np.array(R[i]), 0.1 * i))
            status.append(sys_.status)
            kfs.append(sys_.stats["n_keyframes"])
        out[tag] = dict(sys=sys_, est=np.stack(est), status=status,
                        kf=np.diff([0] + kfs))
    return out


def test_slice_statuses_and_keyframes_match(runs):
    j, t = runs["jax"], runs["torch"]
    assert t["status"] == j["status"]
    np.testing.assert_array_equal(t["kf"], j["kf"])
    # a steady keyframe (TRACKING_BAD) and its local BA fall inside the run
    assert fe_t.TRACKING_BAD in t["status"]
    assert t["sys"].stats["n_keyframes"] >= 2
    assert t["sys"].stats["n_ba"] >= 1
    assert fe_t.LOST not in t["status"]


def test_slice_trajectory_matches(runs):
    j, t = runs["jax"], runs["torch"]
    np.testing.assert_allclose(t["est"][:, :, 3], j["est"][:, :, 3],
                               atol=POS_ATOL_M)
    for tag in ("jax", "torch"):
        stats = ate.ape_translation(runs[tag]["est"][:, :, 3],
                                    runs["gt"][:, :, 3])
        assert stats["rmse"] < 0.5, (tag, stats)
    # keyframe records (BA-refreshed) agree too
    kj = np.stack([k["T_cw"] for k in j["sys"].keyframes])
    kt = np.stack([k["T_cw"] for k in t["sys"].keyframes])
    np.testing.assert_allclose(kt[:, :, 3], kj[:, :, 3], atol=POS_ATOL_M)


def test_slice_tum_export_and_unported_entry_points(runs, tmp_path):
    t = runs["torch"]["sys"]
    p = str(tmp_path / "kf.txt")
    t.save_trajectory_tum(p)
    from ssvio_tpu_torch.dataio import tum
    ts, poses = tum.load_tum(p)
    assert len(ts) == t.stats["n_keyframes"]
    for name in ("run_chunk", "dispatch_chunk", "collect_chunk"):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 #10"):
            getattr(t, name)([], [])
    s = interop.settings(small_settings())
    with pytest.raises(NotImplementedError, match="#12"):
        SystemT(s, enable_loop_closing=True)
    with pytest.raises(NotImplementedError, match="#14"):
        SystemT(s, enable_loop_closing=False, mesh=object())
