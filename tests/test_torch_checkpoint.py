"""Checkpoints and profiling of the port (`ssvio_tpu_torch/utils/`) against
the JAX package's (`ssvio_tpu/utils/`).

A checkpoint has the JAX package's keys, so a session saved by one package
continues in the other. The port resumed from its own checkpoint holds the
exact state it saved (the pyramid is rebuilt from its level 0 by the same
ops), so on the CPU it continues as the uninterrupted run does, bit for
bit. Across packages the two sides differ in float32 summation order, as
in tests/test_torch_system.py: positions within POS_ATOL_M = 5 mm.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from ssvio_tpu.dataio import synthetic
from ssvio_tpu.system import System as SystemJ
from ssvio_tpu.utils import checkpoint as checkpoint_j
from ssvio_tpu.utils import profiling as profiling_j
from ssvio_tpu_torch import interop
from ssvio_tpu_torch.system import System as SystemT
from ssvio_tpu_torch.utils import checkpoint, profiling
from test_system_e2e import BASELINE, CX, CY, FX, FY, H, W, small_settings
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

N_FRAMES = 12
SAVE_AT = 6                 # frames run before the checkpoint
POS_ATOL_M = 5e-3


@pytest.fixture(scope="module")
def seq():
    world = synthetic.SyntheticWorld(seed=9)
    poses = synthetic.straight_trajectory(30, speed=0.35,
                                          yaw_rate=0.004)[:N_FRAMES]
    L, R = synthetic.render_stereo_sequence(world, poses, FX, FY, CX, CY,
                                            BASELINE, W, H)
    s = small_settings(backend_open=True, max_landmarks=2048,
                       tracking_good=70)
    return np.asarray(L), np.asarray(R), s


def _steps(sys_, L, R, frames):
    return [sys_.run_step(L[i], R[i], 0.1 * i) for i in frames]


def _port(s):
    return SystemT(interop.settings(s), enable_loop_closing=False,
                   device="cpu")


def _records(sys_):
    recs = sys_.records
    return ([(k["gid"], k["frame_id"], k["timestamp"])
             for k in recs.keyframes],
            np.stack([np.asarray(k["T_cw"]) for k in recs.keyframes]),
            [(a, b) for a, b, _ in recs.odometry_edges],
            np.stack([np.asarray(z) for _, _, z in recs.odometry_edges]))


def test_port_resume_is_the_continuous_run(seq, tmp_path):
    L, R, s = seq
    cont = _port(s)
    _steps(cont, L, R, range(N_FRAMES))
    first = _port(s)
    _steps(first, L, R, range(SAVE_AT))
    p = str(tmp_path / "state.npz")
    checkpoint.save_checkpoint(first, p)
    resumed = _port(s)
    checkpoint.load_checkpoint(resumed, p)
    assert resumed.frame_id == first.frame_id
    assert resumed.stats["n_keyframes"] == first.stats["n_keyframes"]
    assert resumed.records.by_gid.keys() == first.records.by_gid.keys()
    _steps(resumed, L, R, range(SAVE_AT, N_FRAMES))
    assert resumed.status == cont.status
    assert resumed.stats == cont.stats
    _, ta = cont.frame_trajectory()
    _, tb = resumed.frame_trajectory()
    np.testing.assert_array_equal(tb, ta)
    for a, b in zip(_records(resumed), _records(cont)):
        np.testing.assert_array_equal(a, b)


def test_port_resume_through_chunks(seq, tmp_path):
    L, R, s = seq
    first = _port(s)
    first.run_chunk(L[:SAVE_AT], R[:SAVE_AT])
    p = str(tmp_path / "chunk.npz")
    checkpoint.save_checkpoint(first, p)
    resumed = _port(s)
    checkpoint.load_checkpoint(resumed, p)
    out = resumed.run_chunk(L[SAVE_AT:], R[SAVE_AT:])
    cont = _port(s)
    want = cont.run_chunk(L, R)
    assert out.shape == (N_FRAMES - SAVE_AT, 3, 4)
    assert len(resumed.trajectory) == N_FRAMES
    np.testing.assert_array_equal(out, want[SAVE_AT:])


@pytest.fixture(scope="module")
def jax_run(seq, tmp_path_factory):
    """The JAX System over the frames, checkpointed at SAVE_AT."""
    L, R, s = seq
    sys_ = SystemJ(s, enable_loop_closing=False)
    est = _steps(sys_, L, R, range(SAVE_AT))
    p = str(tmp_path_factory.mktemp("jax") / "jax.npz")
    checkpoint_j.save_checkpoint(sys_, p)
    est += _steps(sys_, L, R, range(SAVE_AT, N_FRAMES))
    return dict(sys=sys_, est=np.stack(est), ckpt=p)


def test_jax_checkpoint_continues_in_the_port(seq, jax_run):
    L, R, s = seq
    port = _port(s)
    checkpoint.load_checkpoint(port, jax_run["ckpt"])
    assert port.frame_id == SAVE_AT - 1
    est = np.stack(_steps(port, L, R, range(SAVE_AT, N_FRAMES)))
    np.testing.assert_allclose(est[:, :, 3], jax_run["est"][SAVE_AT:, :, 3],
                               atol=POS_ATOL_M)
    assert port.status == jax_run["sys"].status
    assert port.stats["n_keyframes"] == jax_run["sys"].stats["n_keyframes"]
    _, traj = port.frame_trajectory()
    assert len(traj) == N_FRAMES


def test_port_checkpoint_continues_in_jax(seq, jax_run, tmp_path):
    L, R, s = seq
    port = _port(s)
    est_t = _steps(port, L, R, range(SAVE_AT))
    p = str(tmp_path / "port.npz")
    checkpoint.save_checkpoint(port, p)
    saved = (port.frame_id, port.status, len(port.records.keyframes))
    est_t += _steps(port, L, R, range(SAVE_AT, N_FRAMES))
    j = SystemJ(s, enable_loop_closing=False)
    checkpoint_j.load_checkpoint(j, p)
    assert (j.frame_id, j.status, len(j.keyframes)) == saved
    est_j = np.stack(_steps(j, L, R, range(SAVE_AT, N_FRAMES)))
    np.testing.assert_allclose(est_j[:, :, 3], np.stack(est_t)[SAVE_AT:, :, 3],
                               atol=POS_ATOL_M)
    assert j.stats["n_keyframes"] == port.stats["n_keyframes"]


def test_stage_timer_matches_jax_keys():
    timers = [profiling.StageTimer(), profiling_j.StageTimer()]
    for t in timers:
        for _ in range(2):
            with t.stage("work"):
                time.sleep(0.01)
        t.add("frames", 5)
    a, b = (t.summary() for t in timers)
    assert a.keys() == b.keys() == {"work", "counter/frames"}
    for k in a:
        assert a[k].keys() == b[k].keys()
    assert a["work"]["calls"] == 2 and a["work"]["total_s"] >= 0.02
    assert a["counter/frames"]["value"] == 5
    assert "work" in timers[0].report()
    # the port's recorder keeps each span, its frame and the span around it
    with timers[0].span("outer", frame=3) as outer:
        with timers[0].stage("inner"):
            pass
    (inner,) = timers[0].spans("inner")
    assert inner.parent == outer.id and timers[0].spans("outer")[0].frame == 3
    assert timers[0].count["inner"] == 1
    timers[0].reset()
    assert not timers[0].total_s and not timers[0].spans("inner")


def test_trace_is_a_no_op_without_a_dir_and_writes_one(tmp_path):
    with profiling.trace(None) as prof:
        assert prof is None
    d = str(tmp_path / "trace")
    with profiling.trace(d) as prof:
        torch.ones(64).sum()
    assert prof is not None
    with open(os.path.join(d, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
