"""The port's KITTI driver (scripts/torch_run_kitti.py) against the JAX
package's (scripts/run_kitti.py), on the CPU.

The 32-frame KITTI-layout dump of tests/test_run_kitti_driver.py (its
world, trajectory, camera and config), written with the port's
`kitti.write_sequence`, with the capacities cut (TPU.Max.Features 256,
TPU.Max.Landmarks 2048) so the local BAs stay small on the CPU. The JAX
driver runs it per frame; the port's driver per frame and with --chunk 12
(two chunks and an 8-frame tail through run_step).

Tolerances on the TUM positions: port against JAX 5 mm (float32
summation order, as tests/test_torch_system.py); the port's chunk loop
against its per-frame loop 1e-3 m (the same ops in the same order).
"""

import os
import sys

import numpy as np
import pytest
import torch

from ssvio_tpu.dataio import synthetic
from ssvio_tpu_torch.dataio import kitti
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")
sys.path.insert(0, SCRIPTS)

import run_kitti  # noqa: E402
import torch_run_kitti  # noqa: E402

N = 32
POS_ATOL_M = 5e-3
CHUNK_VS_STEP_M = 1e-3


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    fx = 320.0
    W, H, b = 320, 128, 0.5
    world = synthetic.SyntheticWorld(seed=3)
    poses = synthetic.straight_trajectory(N, speed=0.6)
    L, R = synthetic.render_stereo_sequence(world, poses, fx, fx, 160.0,
                                            64.0, b, W, H)
    seq = tmp_path_factory.mktemp("kitti") / "seq00"
    u8 = [np.clip(x, 0, 255).astype(np.uint8) for x in (*L, *R)]
    kitti.write_sequence(str(seq), u8[:N], u8[N:],
                         [0.1 * i for i in range(N)], poses)
    (seq / "config.yaml").write_text(
        "Camera1.fx: 320.0\nCamera1.fy: 320.0\n"
        "Camera1.cx: 160.0\nCamera1.cy: 64.0\n"
        "Camera2.fx: 320.0\nCamera2.fy: 320.0\n"
        "Camera2.cx: 160.0\nCamera2.cy: 64.0\n"
        "Camera.width: 320\nCamera.height: 128\n"
        f"Camera.Base.Line: {0.5 * fx}\n"
        "Min.Init.Landmark.Num: 60\n"
        "numFeatures.trackingGood: 50\nnumFeatures.trackingBad: 10\n"
        "Loop.Closing.Open: 0\n"
        "TPU.Max.Features: 256\nTPU.Max.Landmarks: 2048\n")
    return seq, poses


def _argv(seq, traj, *extra):
    return ["--kitti_dataset_path", str(seq),
            "--config_yaml_path", str(seq / "config.yaml"),
            "--gt_poses", str(seq / "poses.txt"),
            "--save_traj", str(traj), "--frames_only_traj", *extra]


def test_driver_matches_the_jax_driver(seq, tmp_path, capsys):
    seq, poses = seq
    tj, ta, tb = (tmp_path / f"{k}.tum" for k in "jab")
    assert run_kitti.main(_argv(seq, tj)) == 0
    out_j = capsys.readouterr().out
    assert torch_run_kitti.main(_argv(seq, ta, "--device", "cpu")) == 0
    out_a = capsys.readouterr().out
    assert torch_run_kitti.main(_argv(seq, tb, "--device", "cpu",
                                      "--chunk", "12")) == 0
    j, a, b = (np.loadtxt(t) for t in (tj, ta, tb))
    assert j.shape == a.shape == b.shape == (N, 8)
    np.testing.assert_array_equal(a[:, 0], j[:, 0])
    np.testing.assert_allclose(a[:, 1:4], j[:, 1:4], atol=POS_ATOL_M)
    np.testing.assert_allclose(b[:, 1:4], a[:, 1:4], atol=CHUNK_VS_STEP_M)
    assert np.linalg.norm(a[:, 1:4] - poses[:, :, 3], axis=1).max() < 0.5

    # the same report: keyframes and closures equal, the ATE within the
    # positions' tolerance
    def report(out):
        done = [ln for ln in out.splitlines() if "done:" in ln]
        rmse = [float(ln.split("rmse=")[1].split()[0])
                for ln in out.splitlines() if "ATE (SE3 Umeyama)" in ln]
        assert len(done) == len(rmse) == 1, out
        return done[0].split("), ")[1], rmse[0]
    (kf_a, ate_a), (kf_j, ate_j) = report(out_a), report(out_j)
    assert kf_a == kf_j
    assert abs(ate_a - ate_j) <= POS_ATOL_M


def test_driver_refuses_what_it_cannot_run(seq, tmp_path, monkeypatch):
    """Without a CUDA device and without --device the driver raises and
    names the fix, with --distributed too (before it joins a process
    group: none is left behind). --distributed itself runs:
    tests/test_torch_multihost.py."""
    seq, _ = seq
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ((), ("--distributed",)):
        with pytest.raises(RuntimeError, match="--device cpu"):
            torch_run_kitti.main(_argv(seq, tmp_path / "x.tum", *extra))
    assert not torch.distributed.is_initialized()
