"""The port's host scripts and viewer at small cuts, on the CPU:
scripts/torch_longrun.py, torch_repro_loop5.py, torch_run_viewer_demo.py
and `ssvio_tpu_torch.viz`, each against what the JAX package's
counterpart gives where the two can be held to one answer (the long run's
settings, the viewer demo's trajectory, the snapshot's panes).

The long run and the loop stress run at cuts (image size, frame count)
that take seconds; their results are checked for shape and sanity, not
accuracy, which is the card's to measure at full size.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from ssvio_tpu.dataio import synthetic as synthetic_j
from ssvio_tpu_torch import interop, viz
from ssvio_tpu_torch.config import Settings
from ssvio_tpu_torch.system import System
from test_system_e2e import BASELINE, CX, CY, FX, FY, H, W, small_settings
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")
sys.path.insert(0, SCRIPTS)

import longrun  # noqa: E402
import run_viewer_demo  # noqa: E402
import torch_longrun  # noqa: E402
import torch_repro_loop5  # noqa: E402
import torch_run_viewer_demo  # noqa: E402


def test_longrun_settings_are_the_jax_scripts_yaml(tmp_path):
    cfg = longrun.write_config(str(tmp_path))
    assert torch_longrun.longrun_settings() == Settings.from_yaml(cfg)


def test_longrun_at_a_cut(tmp_path, monkeypatch):
    """One lap's first 24 frames (the full run's 0.33 m a frame) at
    320x128, the intrinsics scaled with the width, chunks of 8, loop
    closing on and off; the report is written where --json-out says."""
    k = 320 / torch_longrun.W_IMG
    for name in ("FX", "FY", "CX", "CY"):
        monkeypatch.setattr(torch_longrun, name,
                            getattr(torch_longrun, name) * k)
    monkeypatch.setattr(torch_longrun, "W_IMG", 320)
    monkeypatch.setattr(torch_longrun, "H_IMG", 128)
    full = torch_longrun.longrun_poses
    monkeypatch.setattr(torch_longrun, "longrun_poses",
                        lambda n, laps: full(1152 * laps, laps)[:n])
    base = torch_longrun.longrun_settings

    def small():
        s = base()
        s.max_features, s.max_landmarks = 256, 2048
        s.n_init_features = s.n_new_features = 256
        s.min_init_landmarks, s.tracking_good = 60, 80
        return s
    monkeypatch.setattr(torch_longrun, "longrun_settings", small)
    out = tmp_path / "seq"
    js = tmp_path / "report.json"
    report = torch_longrun.main(["--out", str(out), "--frames", "24",
                                 "--laps", "1", "--chunk", "8",
                                 "--json-out", str(js), "--device", "cpu"])
    assert len(os.listdir(out / "image_0")) == 24
    assert np.loadtxt(out / "poses.txt").shape == (24, 12)
    with open(js) as f:
        assert json.load(f) == json.loads(json.dumps(report))
    assert report["device"] == "cpu"
    assert report["dataset"]["resolution"] == "320x128"
    for tag in ("loop_on", "loop_off"):
        r = report[tag]
        assert r["frames"] == 24 and r["n_keyframes"] >= 2
        assert np.isfinite(r["ate_rmse_m"]) and r["ate_rmse_m"] < 0.5


def test_repro_loop5_at_a_cut(capsys):
    """The quarter lap alone (--laps 0: 30 frames, 20 of them in one
    chunk), with the loop closer probed."""
    res = torch_repro_loop5.main(["--laps", "0", "--chunk", "20",
                                  "--probe", "--device", "cpu"])
    out = capsys.readouterr().out
    assert res["n_frames"] == 20 and res["n_keyframes"] >= 10
    assert res["ate_rmse_m"] < 0.5 and np.isfinite(res["end_drift_m"])
    for tag in ("timeline", "ate_rmse=", "frame_err_profile", "events="):
        assert tag in out


@pytest.mark.parametrize("main", [torch_longrun.main, torch_repro_loop5.main],
                         ids=["longrun", "repro_loop5"])
def test_scripts_refuse_a_missing_gpu(main, tmp_path, monkeypatch):
    """With no --device they take the current CUDA device; without one they
    raise naming --device cpu and never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--out", str(tmp_path / "seq")] if main is torch_longrun.main
             else [])


def test_viewer_demo_matches_the_jax_demo(tmp_path):
    pytest.importorskip("matplotlib")
    a = [str(tmp_path / n) for n in ("t.png", "t.tum")]
    b = [str(tmp_path / n) for n in ("j.png", "j.tum")]
    for mod, (png, tum) in ((torch_run_viewer_demo, a), (run_viewer_demo, b)):
        assert mod.main(["--n_frames", "30", "--out", png,
                         "--save_traj", tum]) == 0
        assert os.path.getsize(png) > 10000
    with open(a[1]) as fa, open(b[1]) as fb:
        assert fa.read() == fb.read()


def test_snapshot_includes_the_stereo_pane(tmp_path):
    """tests/test_viz.py on the port's System: the per-frame path and the
    chunk path both feed the stereo pane."""
    pytest.importorskip("matplotlib")
    world = synthetic_j.SyntheticWorld(seed=9)
    poses = synthetic_j.straight_trajectory(4, speed=0.35)
    L, R = synthetic_j.render_stereo_sequence(world, poses, FX, FY, CX, CY,
                                              BASELINE, W, H)
    s = interop.settings(small_settings(backend_open=False))
    sys_ = System(s, enable_backend=False, enable_loop_closing=False,
                  device="cpu")
    assert sys_.last_stereo is None
    for i in range(4):
        sys_.run_step(L[i], R[i], 0.1 * i)
    img_l, img_r = sys_.last_stereo
    assert tuple(img_l.shape) == (sys_.h, sys_.w)
    p = str(tmp_path / "snap.png")
    assert viz.snapshot(sys_, p) == p and os.path.getsize(p) > 20000
    assert viz.cloud_of(sys_).shape[1] == 3 and len(viz.cloud_of(sys_))

    sys2 = System(s, enable_backend=False, enable_loop_closing=False,
                  device="cpu")
    sys2.run_chunk(L[:4], R[:4], [0.1 * i for i in range(4)])
    assert sys2.last_stereo is not None and sys2.last_stereo[1] is not None
    p2 = str(tmp_path / "snap2.png")
    viz.snapshot(sys2, p2)
    assert os.path.getsize(p2) > 20000
    T = np.eye(4)[:3]
    np.testing.assert_array_equal(viz.euler_of(T), np.zeros(3))


def test_live_driver_exits_cleanly_without_a_camera(tmp_path):
    import torch_run_live
    cfg = tmp_path / "rig.yaml"
    cfg.write_text("Camera.width: 320\nCamera.height: 128\n")
    assert torch_run_live.main(["--config_yaml_path", str(cfg),
                                "--left", "97", "--right", "98"]) == 0
    assert torch_run_live.main(["--config_yaml_path", str(cfg)]) == 2

