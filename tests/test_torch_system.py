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
import torch

from ssvio_tpu.dataio import synthetic
from ssvio_tpu.eval import ate
from ssvio_tpu.system import System as SystemJ
from ssvio_tpu_torch import frontend as fe_t
from ssvio_tpu_torch import interop
from ssvio_tpu_torch.parallel import dist_ba
from ssvio_tpu_torch.system import System as SystemT
from test_system_e2e import BASELINE, CX, CY, FX, FY, H, W, small_settings
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

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
                                        enable_loop_closing=False,
                                        device="cpu"))):
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
    kt = np.stack(t["sys"].records.poses())
    np.testing.assert_allclose(kt[:, :, 3], kj[:, :, 3], atol=POS_ATOL_M)


def test_slice_odometry_edges_match(runs):
    """The keyframe odometry edges (PGO's input) of run_step: each edge's
    Z is taken at the pose the keyframe was inserted at, before its local
    BA, as the JAX System's run_step takes it (the BA in this run moves
    the steady keyframe by more than the tolerances)."""
    ej = runs["jax"]["sys"].kf_rel_edges
    et = runs["torch"]["sys"].records.odometry_edges
    assert len(et) == len(ej) >= 1
    assert [(a, b) for a, b, _ in et] == [(int(a), int(b)) for a, b, _ in ej]
    for (_, _, zt), (_, _, zj) in zip(et, ej):
        zt, zj = np.asarray(zt), np.asarray(zj)
        np.testing.assert_allclose(zt[:, 3], zj[:, 3], atol=POS_ATOL_M)
        np.testing.assert_allclose(zt[:, :3], zj[:, :3], atol=1e-4)


def test_slice_tum_export_and_unported_entry_points(runs, tmp_path):
    t = runs["torch"]["sys"]
    p = str(tmp_path / "kf.txt")
    t.save_trajectory_tum(p)
    from ssvio_tpu_torch.dataio import tum
    ts, poses = tum.load_tum(p)
    assert len(ts) == t.stats["n_keyframes"]
    # the chunk API is ported (tests/test_torch_engine.py): an empty chunk
    # is refused as a bad argument, not as an unported entry point
    for name in ("run_chunk", "dispatch_chunk"):
        with pytest.raises(ValueError, match="empty chunk"):
            getattr(t, name)([], [])
    s = interop.settings(small_settings())
    # loop closing is ported (tests/test_torch_loop_system.py): it builds
    assert SystemT(s, enable_loop_closing=True,
                   device="cpu").loopclosing is not None
    # so is the mesh (tests/test_torch_multihost.py): it must be on the
    # System's device
    with pytest.raises(ValueError, match="device"):
        SystemT(s, enable_loop_closing=False, device="cpu",
                mesh=dist_ba.Mesh(None, 0, 2, torch.device("meta")))


def test_system_runs_on_the_gpu_unless_asked_for_the_cpu(monkeypatch):
    """No device means the CUDA device; without one, System and Frontend
    raise and name the fix instead of running on the CPU."""
    s = interop.settings(small_settings())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: SystemT(s, enable_loop_closing=False),
                  lambda: fe_t.Frontend(s, W, H)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build()
    sys_ = SystemT(s, enable_loop_closing=False, device="cpu")
    assert sys_.device == torch.device("cpu")
    assert sys_.frontend.device == torch.device("cpu")
