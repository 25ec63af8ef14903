"""The port's multi-process runs on the CPU: `parallel/multihost.py` over
tcp:// with the SSVIO_* variables, the System with its local BA sharded
over a mesh of two processes, and `scripts/torch_run_kitti.py
--distributed` (a world of 1, and a primary with a server), with
`scripts/torch_profile_scaling.py` at a cut size.

The ranks are processes on gloo (tests/torch_dist_worker.py, or the
driver itself). Checks of the multihost problem are tests/test_multihost.py's
(the ranks' poses equal, inlier ratio > 0.9, keyframes 0.8 m apart along
-z) with the poses within tests/test_dist_ba.py's 5e-4 of JAX's
single-device local_ba. The System through the mesh is held to the
single-process port on tests/test_torch_system.py's 12 frames: equal
statuses and keyframe ids, positions within 1e-3 m (the sharded sums are
summed in another order; the chunk-against-step tolerance of
chip_smoke.py), and every local BA through the mesh.
"""

import json
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from ssvio_tpu.dataio import synthetic
from ssvio_tpu.ops import ba as ba_j
from ssvio_tpu_torch import interop
from ssvio_tpu_torch.dataio import kitti
from ssvio_tpu_torch.ops import camera
from ssvio_tpu_torch.parallel import multihost
from test_system_e2e import BASELINE, CX, CY, FX, FY, H, W, small_settings
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)
from torch_dist_worker import REPO, launch, run_system

SCRIPTS = os.path.join(REPO, "scripts")
sys.path.insert(0, SCRIPTS)

import torch_profile_scaling  # noqa: E402
import torch_run_kitti  # noqa: E402

POSE_ATOL = 5e-4
MESH_VS_SINGLE_M = 1e-3
N_FRAMES = 12
CHUNK = 6
ENV_KEYS = (multihost.ENV_COORD, multihost.ENV_NPROC, multihost.ENV_PID,
            *multihost.TORCHRUN_ENV, "LOCAL_RANK")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rank_envs(world: int) -> list:
    """Each rank's environment: the SSVIO_* variables for a tcp://
    coordinator on a free port, no torchrun variables, and one torch
    thread (OMP_NUM_THREADS; beside the suite's xdist workers a rank with
    a thread per core ran ten times slower)."""
    coord = f"127.0.0.1:{_free_port()}"
    base = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    base["OMP_NUM_THREADS"] = "1"
    return [dict(base, SSVIO_COORDINATOR=coord,
                 SSVIO_NUM_PROCESSES=str(world), SSVIO_PROCESS_ID=str(r))
            for r in range(world)]


def test_multihost_two_processes_over_tcp(tmp_path):
    """tests/multihost_worker.py's problem (M 512, W 8, 1 round x 5
    iterations) through multihost.initialize() in two processes."""
    outs = launch(dict(mode="multihost"), 2, tmp_path, envs=_rank_envs(2))
    assert [(o["rank"], o["size"]) for o in outs] == [(0, 2), (1, 2)]
    np.testing.assert_array_equal(outs[0]["kf"], outs[1]["kf"])
    assert outs[0]["inlier_ratio"] == outs[1]["inlier_ratio"] > 0.9
    kf = outs[0]["kf"]
    np.testing.assert_allclose(np.diff(kf[:, 2, 3]), -0.8, atol=0.05)
    prob, cam = torch_profile_scaling.build_problem(512, W=8, seed=0)
    want = ba_j.local_ba(ba_j.LocalBAProblem(
        *[jnp.asarray(x.numpy()) for x in prob]), *cam, max_rounds=1,
        iters=5)
    np.testing.assert_allclose(kf, np.asarray(want.kf_T_cw), atol=POSE_ATOL)


def test_initialize_without_variables_is_single_process(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize() is False
    assert not dist.is_initialized()
    assert multihost.process_index() == 0 and multihost.is_primary()
    with pytest.raises(ValueError, match="SSVIO_PROCESS_ID"):
        multihost.initialize("127.0.0.1:1", num_processes=2)


@pytest.fixture(scope="module")
def frames():
    world = synthetic.SyntheticWorld(seed=9)
    poses = synthetic.straight_trajectory(30, speed=0.35,
                                          yaw_rate=0.004)[:N_FRAMES]
    L, R = synthetic.render_stereo_sequence(world, poses, FX, FY, CX, CY,
                                            BASELINE, W, H)
    s = interop.settings(small_settings(backend_open=True,
                                        max_landmarks=2048,
                                        tracking_good=70))
    return s, [np.array(x) for x in L], [np.array(x) for x in R]


@pytest.fixture(scope="module")
def mesh_runs(frames, tmp_path_factory):
    """Rank 0 runs the System through run_step, then another through
    run_chunk, over a 2-rank mesh; rank 1 serves each one's BAs. Beside
    them, the single-process port on the same frames."""
    s, L, R = frames
    rig = camera.StereoRig.from_settings(s)
    cam = (rig.intr_left.fx, rig.intr_left.fy, rig.intr_left.cx,
           rig.intr_left.cy, rig.baseline)
    job = dict(mode="system", settings=s, L=L, R=R, cam=cam,
               chunks=[0, CHUNK])
    rank0, rank1 = launch(job, 2, tmp_path_factory.mktemp("system"))
    single = [run_system(s, L, R, c) for c in job["chunks"]]
    return rank0, rank1, single


@pytest.mark.parametrize("path", ["run_step", "run_chunk"])
def test_system_through_a_two_rank_mesh(mesh_runs, path):
    rank0, rank1, single = mesh_runs
    i = ["run_step", "run_chunk"].index(path)
    got, want = rank0[i], single[i]
    assert got["status"] == want["status"]
    assert got["kf_gids"] == want["kf_gids"]
    np.testing.assert_allclose(got["pos"], want["pos"],
                               atol=MESH_VS_SINGLE_M)
    st = got["stats"]
    # a steady keyframe and its local BA fall inside the 12 frames, and
    # every BA of the run went through the mesh
    assert st["n_ba"] >= 1 and st["n_keyframes"] >= 2
    assert st["n_dist_ba"] == st["n_ba"] == want["stats"]["n_ba"]
    assert want["stats"]["n_dist_ba"] == 0
    assert rank1[i] == st["n_ba"]
    assert {k: v for k, v in st.items() if k != "n_dist_ba"} == \
        {k: v for k, v in want["stats"].items() if k != "n_dist_ba"}
    # a mesh BA runs the fixed trip: 5 x 10 LM steps, no round skipped
    assert got["ba_work"] == [(50, 0)] * st["n_ba"]
    if path == "run_chunk":
        assert got["counted"] == {"ba.lm_steps_run": 50.0 * st["n_ba"],
                                  "ba.rounds_skipped": 0.0}


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    """tests/test_torch_driver.py's KITTI-layout sequence, cut to 12 frames,
    at trackingGood 70 so that a steady keyframe and its BA fall inside."""
    fx, w, h, b = 320.0, 320, 128, 0.5
    n = 12
    world = synthetic.SyntheticWorld(seed=3)
    poses = synthetic.straight_trajectory(n, speed=0.6)
    L, R = synthetic.render_stereo_sequence(world, poses, fx, fx, 160.0,
                                            64.0, b, w, h)
    seq = tmp_path_factory.mktemp("kitti") / "seq00"
    u8 = [np.clip(x, 0, 255).astype(np.uint8) for x in (*L, *R)]
    kitti.write_sequence(str(seq), u8[:n], u8[n:],
                         [0.1 * i for i in range(n)], poses)
    (seq / "config.yaml").write_text(
        "Camera1.fx: 320.0\nCamera1.fy: 320.0\n"
        "Camera1.cx: 160.0\nCamera1.cy: 64.0\n"
        "Camera2.fx: 320.0\nCamera2.fy: 320.0\n"
        "Camera2.cx: 160.0\nCamera2.cy: 64.0\n"
        "Camera.width: 320\nCamera.height: 128\n"
        f"Camera.Base.Line: {b * fx}\n"
        "Min.Init.Landmark.Num: 60\n"
        "numFeatures.trackingGood: 70\nnumFeatures.trackingBad: 10\n"
        "Loop.Closing.Open: 0\n"
        "TPU.Max.Features: 256\nTPU.Max.Landmarks: 2048\n")
    return seq


def _argv(seq, traj, *extra):
    return ["--kitti_dataset_path", str(seq),
            "--config_yaml_path", str(seq / "config.yaml"),
            "--save_traj", str(traj), "--frames_only_traj",
            "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def single(seq, tmp_path_factory):
    """The driver's trajectory without --distributed."""
    traj = tmp_path_factory.mktemp("single") / "single.tum"
    assert torch_run_kitti.main(_argv(seq, traj)) == 0
    return np.loadtxt(traj)


def test_driver_distributed_world_of_one(seq, single, tmp_path, capsys,
                                         monkeypatch):
    """--distributed with no variables: the JAX driver's line, then a
    world of 1 in this process, the same trajectory as without the flag,
    and no process group left behind."""
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    b = tmp_path / "b.tum"
    capsys.readouterr()
    assert torch_run_kitti.main(_argv(seq, b, "--distributed")) == 0
    out = capsys.readouterr().out
    assert ("[run_kitti] --distributed: no coordinator configured" in out
            and "continuing single-process" in out), out
    assert ("[run_kitti] distributed: process 0/1, 1 global devices, mesh "
            "axes {'lm': 1}") in out, out
    assert not dist.is_initialized()
    np.testing.assert_allclose(np.loadtxt(b)[:, 1:4], single[:, 1:4],
                               atol=MESH_VS_SINGLE_M)


def test_driver_primary_and_server_over_ssvio_variables(seq, single,
                                                       tmp_path):
    """Two driver processes under SSVIO_*: rank 0 drives and writes the
    trajectory, rank 1 serves every local BA until rank 0 has finished.
    The trajectory is the single-process driver's within 1e-3 m."""
    envs = _rank_envs(2)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(SCRIPTS, "torch_run_kitti.py"),
         *_argv(seq, tmp_path / f"r{r}.tum", "--distributed")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=envs[r]) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    assert "distributed: process 0/2, 2 global devices" in outs[0], outs[0]
    done = [ln for ln in outs[0].splitlines() if "done:" in ln]
    served = [ln for ln in outs[1].splitlines() if "served" in ln]
    assert len(done) == 1 and len(served) == 1, outs
    n_served = int(served[0].split("served ")[1].split()[0])
    n_kf = int(done[0].split("), ")[1].split()[0])
    assert n_served >= 1 and n_served == n_kf - 1, (served, done)
    assert not (tmp_path / "r1.tum").exists()
    np.testing.assert_allclose(np.loadtxt(tmp_path / "r0.tum")[:, 1:4],
                               single[:, 1:4], atol=MESH_VS_SINGLE_M)


def test_profile_scaling_script_on_the_cpu():
    """scripts/torch_profile_scaling.py cut to M 256: one SCALING line,
    every world (1, 2, 4 ranks) timed at the script's window, gloo, no
    shared device."""
    out = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, "torch_profile_scaling.py"),
         "--device", "cpu", "--json", "256"], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("SCALING ")]
    rep = json.loads(line[0][len("SCALING "):])
    assert rep["device"] == "CPU" and rep["M"] == 256
    assert rep["W"] == torch_profile_scaling.WINDOW
    worlds = {str(n) for n in torch_profile_scaling.WORLDS}
    assert set(rep["solve_ms"]) == worlds == {"1", "2", "4"}
    assert all(v > 0 for v in rep["solve_ms"].values())
    assert rep["backend"] == dict.fromkeys(worlds, "gloo")
    assert rep["shared_devices"] == dict.fromkeys(worlds, False)
