"""The port's profiling tools on the CPU: `utils/profiling.py`'s
`trace_summary` and `timeit`, scripts/torch_tools.py's device choice, and every
scripts/torch_profile_*.py and the KITTI trajectory CLI at a tiny cut.

- `trace_summary` on a hand-made chrome trace whose kernels (two streams)
  and copies overlap: the busy share is the union of their intervals over
  the annotated window, exactly.
- Each tool's `main(["--device", "cpu", ...])` at 256x128 and a few
  frames (the tools' `settings()` replaced by TINY, their chunk and batch
  constants cut), checking the keys of
  its result; the ablation's full variant against run_step (equal
  statuses, positions within its POS_TOL_M, 1e-6 m); every tool raises
  without a CUDA device unless it is asked for the CPU.
- The stages of scripts/torch_profile_stages.py against their JAX
  counterparts (scripts/profile_stages.py's calls): its `inputs` are
  profile_stages.py's draws; `_build_pyramid` on them at
  tests/test_torch_ops.py's tolerances (levels 1e-3, gradients 1e-4).
  Those inputs are random images and unrelated observations, on which the
  tracking step and the pose-only LM are degenerate (2 and 0 inliers at
  this size: any pose fits), so `_track_step` and `pose_only_optimize`
  are held on a well-posed seeded scene through the same stage closures,
  at tests/test_torch_map_frontend.py's and test_torch_ba.py's
  tolerances (tracked positions 0.02 px, poses 1e-4 twist, equal inlier
  decisions).
- The KITTI trajectory CLI's file byte for byte against the JAX script's.
- scripts/torch_profile_scaling.py --engine: a world of 1 over gloo
  bit-equal to the plain `Engine._step`, 2 ranks within
  tests/test_dist_ba.py's tolerances (poses 5e-4, landmarks 5e-3: the
  sharded BA sums in another order), through tests/torch_dist_worker.py;
  and the script itself at M 256.
"""

import dataclasses
import importlib
import json
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssvio_tpu import frontend as fe_j
from ssvio_tpu import map as map_j
from ssvio_tpu.config import Settings as SettingsJ
from ssvio_tpu.ops import ba as ba_j
from ssvio_tpu.ops import se3 as se3_j
from ssvio_tpu_torch import interop
from ssvio_tpu_torch import frontend as fe_t
from ssvio_tpu_torch.ops import se3 as se3_t
from ssvio_tpu_torch.utils import profiling
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)
from torch_dist_worker import REPO, launch

SCRIPTS = os.path.join(REPO, "scripts")
sys.path.insert(0, SCRIPTS)

import kitti_poses_and_timestamps_to_trajectory as kitti_cli_j  # noqa: E402
import torch_kitti_poses_and_timestamps_to_trajectory as kitti_cli  # noqa: E402
import torch_ba_trips  # noqa: E402
import torch_lk_kernel_outputs as tlo  # noqa: E402
import torch_profile_ablation  # noqa: E402
import torch_profile_chunk_pipeline  # noqa: E402
import torch_profile_engine  # noqa: E402
import torch_profile_ingest  # noqa: E402
import torch_profile_lk  # noqa: E402
import torch_profile_lk_kernels  # noqa: E402
import torch_profile_scaling  # noqa: E402
import torch_profile_stages  # noqa: E402
import torch_profile_trace  # noqa: E402
import torch_profile_transfer  # noqa: E402
import torch_profile_verify  # noqa: E402
import torch_tools  # noqa: E402

PYR_TOL, GRAD_TOL = 1e-3, 1e-4          # tests/test_torch_ops.py
PX_TOL, POSE_TOL = 0.02, 1e-4           # test_torch_map_frontend / _ba
DIST_POSE_TOL, DIST_LM_TOL = 5e-4, 5e-3  # tests/test_dist_ba.py
SCALING_M = 512


def tiny_settings_j() -> SettingsJ:
    """A 256x128 rig (fx 360, baseline 0.54 m) at 256 features: the tools'
    cut (the bench's straight scene initialises at it)."""
    s = SettingsJ()
    fx = 360.0
    cam = dataclasses.replace(s.cam_left, fx=fx, fy=fx, cx=128.0, cy=64.0)
    s.cam_left, s.cam_right = cam, dataclasses.replace(cam)
    s.image_width, s.image_height = 256, 128
    s.baseline_fx = 0.54 * fx
    s.max_features, s.max_landmarks, s.max_window = 256, 2048, 6
    s.active_map_size = 4
    s.min_init_landmarks, s.init_good = 40, 40
    s.tracking_good, s.tracking_bad = 50, 10
    s.grid_cell, s.detect_octaves = 24, 2
    s.loop_closing_open = False
    return s


def TINY():
    return interop.settings(tiny_settings_j())


def TINY_LOOP():
    s = TINY()
    s.loop_closing_open = True
    s.loop_desc_scales, s.vocab_k, s.vocab_levels = 2, 4, 2
    s.max_keyframes_db = 16
    return s


@pytest.fixture
def tiny(monkeypatch):
    for mod in (torch_profile_engine, torch_profile_stages, torch_ba_trips):
        monkeypatch.setattr(mod, "settings", TINY)
    monkeypatch.setattr(torch_profile_ingest, "settings", TINY_LOOP)
    monkeypatch.setattr(torch_profile_stages, "BA_REPS", 1)


CPU = ["--device", "cpu"]


# ---------------------------------------------------------------- profiling
def _x(name, cat, ts, dur, **kw):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, **kw)


def test_trace_summary_on_a_hand_made_trace(tmp_path):
    """Kernels on two streams overlap, a memcpy and a memset follow, the
    memset runs past the window: busy = union clipped to the window."""
    events = [
        _x(profiling.TRACE_WINDOW, "user_annotation", 100.0, 100.0),
        _x("aten::add", "cpu_op", 100.0, 50.0),
        _x("kA", "kernel", 110.0, 20.0, tid=7),
        _x("kB", "kernel", 120.0, 20.0, tid=8),          # overlaps kA
        _x("Memcpy HtoD", "gpu_memcpy", 150.0, 10.0),
        _x("kA", "kernel", 170.0, 5.0, tid=7),
        _x("Memset", "gpu_memset", 195.0, 15.0),         # past the window
        _x("kC", "kernel", 300.0, 7.0),                  # outside it
        dict(ph="s", name="flow", cat="ac2g", ts=110.0, id=1),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = profiling.trace_summary(str(path), top=3)
    assert s["window_ms"] == pytest.approx(0.1)
    # [110, 140) + [150, 160) + [170, 175) + [195, 200) = 50 us
    assert s["device_ms"] == pytest.approx(0.05)
    assert s["busy_share"] == pytest.approx(0.5)
    assert s["launches"] == {"kA": 2, "kB": 1, "kC": 1}
    assert s["n_kernels"] == 4
    assert [(n, c) for n, c, _ in s["top_ops"]] == [("kA", 2), ("kB", 1),
                                                     ("Memset", 1)]
    assert [ms for _, _, ms in s["top_ops"]] == pytest.approx(
        [0.025, 0.02, 0.015])
    # without the annotation the window is the span of every event
    path.write_text(json.dumps({"traceEvents": events[1:]}))
    s = profiling.trace_summary(str(path))
    assert s["window_ms"] == pytest.approx(0.207)
    assert s["device_ms"] == pytest.approx(0.067)     # 30 + 10 + 5 + 15 + 7


def test_trace_writes_the_window_annotation(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(256).sum()
    s = profiling.trace_summary(str(tmp_path / profiling.TRACE_FILE))
    assert s["window_ms"] > 0 and s["n_kernels"] == 0
    assert s["busy_share"] == 0.0


def test_timeit_on_the_cpu():
    calls = []

    def fn():
        calls.append(1)
        time.sleep(0.002)
    ms = profiling.timeit(fn, n=5, warmup=2, device="cpu")
    assert len(calls) == 7
    assert 2.0 <= ms < 100.0


def test_tool_device_and_card_line(monkeypatch):
    assert torch_tools.tool_device("t", "cpu") == torch.device("cpu")
    assert torch_tools.card_line("cpu") == "CPU"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        torch_tools.tool_device("t")


TOOLS = ("torch_profile_stages", "torch_profile_engine",
         "torch_profile_ablation", "torch_profile_trace",
         "torch_profile_chunk_pipeline", "torch_profile_transfer",
         "torch_profile_lk", "torch_profile_lk_kernels",
         "torch_profile_ingest", "torch_probe_gauge_invariance",
         "torch_probe_tail_divergence", "torch_ba_trips",
         "torch_profile_verify")


@pytest.mark.parametrize("tool", TOOLS)
def test_tools_need_a_device_or_the_cpu_asked_for(tool, monkeypatch):
    """No CUDA device and no --device: the tool raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(tool).main([])


# ------------------------------------------------------------------- tools
def test_stages_tool(tiny):
    r = torch_profile_stages.main(CPU + ["--reps", "1"])
    assert r["card"] == "CPU" and r["image"] == "256x128"
    assert list(r["stages"]) == ["build_pyramid", "track_step",
                                 "lk.track fwd", "pose_only_optimize",
                                 "keyframe_step", "fast.detect_grid",
                                 "local_ba", "track_frame graph",
                                 "pose_only_optimize graph",
                                 "keyframe_branch", "keyframe_frame graph",
                                 "local_ba graph"]
    for v in r["stages"].values():
        assert v["ms"] > 0 and v["launches_per_call"] == {}


def test_engine_tool(tiny):
    r = torch_profile_engine.main(CPU + ["--frames", "6", "--chunk", "3"])
    assert r["frames"] == 6 and len(r["frame_ms"]) == 6
    assert r["n_keyframes"] >= 1 and r["n_tracking"] >= 1
    assert r["track_ms_median"] > 0 and r["kf_ms_median"] > 0
    assert r["frame_ms_mean"] == pytest.approx(np.mean(r["frame_ms"]))
    assert len(r["chunk_ms"]) == 1 and r["chunk_ms_per_frame_median"] > 0


def test_ba_trips_tool(tiny):
    """The BA log of a run: one entry a steady keyframe, the rounds and
    steps a fixed trip's loops would have run."""
    r = torch_ba_trips.main(CPU + ["--frames", "12"])
    assert r["n_ba"] == len(r["rounds"]) == len(r["steps"]) >= 1
    assert r["n_ba"] == r["n_keyframes"] - 1          # all but the init's
    assert all(1 <= a <= 5 and a <= b <= 10 * a
               for a, b in zip(r["rounds"], r["steps"]))
    assert r["steps_total"] == sum(r["steps"]) <= r["fixed_trip_steps"] \
        == 50 * r["n_ba"]
    assert r["path"] == "static buffers"


def test_ablation_full_variant_equals_run_step(tiny):
    r = torch_profile_ablation.main(CPU + ["--chunk", "3", "--reps", "1"])
    assert list(r["variants"]) == ["pyramid", "+ forward LK",
                                   "+ backward LK", "+ pose-only LM",
                                   "full step"]
    assert all(v["ms_per_frame"] > 0 for v in r["variants"].values())
    chk = r["full_vs_run_step"]
    assert chk["statuses_equal"] and len(chk["statuses"]) == 3
    assert chk["max_position_diff_m"] <= torch_profile_ablation.POS_TOL_M


def test_trace_tool(tiny, tmp_path):
    r = torch_profile_trace.main(CPU + ["--chunk", "2", "--out",
                                        str(tmp_path)])
    assert os.path.exists(tmp_path / profiling.TRACE_FILE)
    assert r["window_ms"] > 0 and r["untraced_ms"] > 0
    assert r["stretch"] == pytest.approx(r["window_ms"] / r["untraced_ms"])
    assert r["busy_share"] == r["traced_busy_share"] == 0.0  # no device
    assert r["trace_kernel1"] == r["counter_launches"]["lk_level"] == 0
    assert {"top_ops", "kernels_per_frame", "launches"} <= set(r)
    # no device: one idle gap, the whole window, inside the chunk's spans
    (gap,) = r["idle_gaps"]
    assert gap[1] == pytest.approx(r["window_ms"])
    assert gap[0] is not None and gap[0].split(".")[0] in ("system",
                                                           "engine")
    kf = r["keyframe_frame"]
    assert os.path.exists(tmp_path / "keyframe" / profiling.TRACE_FILE)
    assert kf["untraced_ms"] > 0 and kf["busy_share"] == 0.0
    assert 0 <= kf["frame"] < torch_profile_trace.KF_SEARCH


def test_chunk_pipeline_tool(tiny, monkeypatch):
    monkeypatch.setattr(torch_profile_chunk_pipeline, "CHUNK", 2)
    monkeypatch.setattr(torch_profile_chunk_pipeline, "CHUNKS", 2)
    r = torch_profile_chunk_pipeline.main(CPU)
    d = r["device_only"]
    assert d["ms_per_chunk"] > 0 and d["frames_per_s"] > 0
    rows = r["pipelined"]["rows"]
    assert [x["chunk"] for x in rows] == [0, 1, "final collect"]
    for x in rows[:2]:
        assert {"pad_upload_ms", "get_ms", "dispatch_ms",
                "readback_wait_ms", "host_tail_ms", "total_ms"} <= set(x)
    assert set(r["median"]) == {"pad_upload_ms", "get_ms", "dispatch_ms",
                                "readback_wait_ms", "host_tail_ms",
                                "total_ms"}


def test_transfer_tool_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch_profile_transfer, "CHUNK", 2)
    r = torch_profile_transfer.main(CPU + ["--reps", "2"])
    assert set(r["host_to_device"]) == {"kitti x1", "kitti x2",
                                        "robotcar_xb3 x1", "robotcar_xb3 x2"}
    for v in r["host_to_device"].values():
        assert v["pageable"]["gb_per_s"] > 0 and v["pinned"] is None
    assert r["readback"]["cpu_ms"] > 0
    assert r["readback"]["pinned_event_ms"] is None
    assert r["overlap"]["share"] is None


def test_lk_tool(tiny):
    r = torch_profile_lk.main(CPU + ["--reps", "1"])
    t = r["timings"]
    assert r["n_valid"] > 0
    assert {f"temporal fwd, {n} levels" for n in (1, 2, 3, 4)} <= set(t)
    assert "stereo fwd+bwd, 4 levels" in t
    assert all(v["ms"] >= 0 for v in t.values())


def test_lk_kernels_tool(monkeypatch):
    m = torch_profile_lk_kernels
    monkeypatch.setattr(m, "KITTI_LEVELS", ((64, 128), (32, 64)))
    monkeypatch.setattr(m, "ROBOTCAR_LEVEL0", ((96, 128),))
    monkeypatch.setattr(m, "ITERS", (1, 30))
    monkeypatch.setattr(m, "LIVE", (64, 512))
    monkeypatch.setattr(m, "KERNELS", ("serial", "mm", "patch"))
    r = m.main(CPU + ["--reps", "10"])
    assert set(r["kernels"]) == {"serial", "mm", "patch"}
    for name, k in r["kernels"].items():
        assert [x["iters"] for x in k["iters"]] == [1, 30]
        assert k["iters"][0]["chain"] == 1
        assert [x["live"] for x in k["live"]] == [64, 512]
        assert k["flow"]["hard"]["chain"] == 30       # steps to the cap
        if name != "mm":      # bf16 windows keep mm stepping to the cap
            assert k["flow"]["easy"]["chain"] < 30
    assert len(r["kernels"]["serial"]["per_level"]) == 2
    assert len(r["kernels"]["patch"]["per_level"]) == 1


def test_lk_kernel_inputs_unchanged_by_default():
    """torch_lk_kernel_outputs._inputs' defaults still give the inputs
    another checkout's --out made (448 live of 512, the shifted texture)."""
    lv = tlo._inputs("cpu", tlo.LEVELS[2:])
    planes, pts, guess, frozen0, padded = lv[0]
    assert int((frozen0 == 0).sum()) == tlo.N_LIVE
    rng = np.random.default_rng(7)
    img = tlo._texture(rng, *tlo.LEVELS[2], sigma=3.0)
    np.testing.assert_array_equal(planes[0].numpy(), img.astype(np.float32))


def test_ingest_tool(tiny, monkeypatch):
    monkeypatch.setattr(torch_profile_ingest, "BATCH", 2)
    r = torch_profile_ingest.main(CPU + ["--reps", "1"])
    assert r["batch"] == 2 and r["scales"] == 2 and r["words"] > 1
    for k in ("describe_ms", "transform_ms", "score_ms", "ingest_ms"):
        assert r[k] > 0
    assert r["describe_x_b_plus_ingest_ms"] == pytest.approx(
        2 * r["describe_ms"] + r["ingest_ms"])


def _verify_settings(full=torch_profile_verify.settings):
    s = full()
    s.max_features, s.loop_desc_scales = 96, 2
    return s


def test_verify_tool(monkeypatch):
    """scripts/torch_profile_verify.py at 96 features and 2 octaves on the
    CPU: every stage of both tables timed with its ops counted, the
    replayed stages dispatching only their copies and clones, both ways
    of verifying equal, and the revisit's pose recovered."""
    monkeypatch.setattr(torch_profile_verify, "settings", _verify_settings)
    r = torch_profile_verify.main(CPU + ["--reps", "1"])
    assert r["card"] == "CPU" and not r["captured"]
    assert (r["features"], r["octaves"], r["hypotheses"]) == (96, 2, 128)
    assert list(r["stages_eager"]) == ["match", "sampling", "dlt_minimal",
                                       "polish", "dlt_refit", "lo_pose_only"]
    assert list(r["stages_graphed"]) == ["copy_in", "graph_match",
                                         "dlt_minimal", "graph_polish",
                                         "dlt_refit", "graph_finish"]
    for table in (r["stages_eager"], r["stages_graphed"]):
        for v in table.values():
            assert v["wall_ms"] > 0 and v["device_ms"] is None
    ops = {k: v["ops"] for k, v in r["stages_eager"].items()}
    assert ops["lo_pose_only"] > 5000 and ops["polish"] > 1000
    assert r["equal"] and r["pnp_ok"] and r["pose_error"] < 0.02
    assert r["n_inliers"] >= 40


# ------------------------------------------------------ stages against JAX
def test_stage_inputs_are_profile_stages_draws():
    """scripts/profile_stages.py draws from seed 0: img, img2, the feature
    positions (x then y), the landmarks (x, y, z), the observations."""
    s = TINY()
    w, h = torch_profile_stages.padded_dims(s)
    got = torch_profile_stages.inputs(s, w, h)
    rng = np.random.default_rng(0)
    n, M = s.max_features, s.max_landmarks
    want = dict(
        img=rng.uniform(0, 255, (h, w)).astype(np.float32),
        img2=rng.uniform(0, 255, (h, w)).astype(np.float32),
        xy=np.stack([rng.uniform(20, w - 20, n),
                     rng.uniform(20, h - 20, n)], -1).astype(np.float32),
        lm_pos=np.stack([rng.uniform(-5, 5, M), rng.uniform(-2, 2, M),
                         rng.uniform(5, 40, M)], -1).astype(np.float32),
        uv=rng.uniform(0, 300, (n, 2)).astype(np.float32))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _scene_inputs(s, w, h) -> dict:
    """A well-posed seeded scene with `inputs`' keys: a smooth texture and
    a copy moved by (1.5, -0.8) px; features inside it whose landmarks
    project onto them at the identity (depths 5-40 m); observations of the
    first n landmarks from a pose 2 cm and 0.5 deg away, 0.3 px noise."""
    rng = np.random.default_rng(5)
    img = tlo._texture(rng, h, w, sigma=2.0)
    img2 = tlo._shifted(img, 1.5, -0.8)
    n, M = s.max_features, s.max_landmarks
    c = s.cam_left
    xy = rng.uniform([24, 24], [w - 24, h - 24], (n, 2))
    z = rng.uniform(5, 40, n)
    p = np.stack([(xy[:, 0] - c.cx) / c.fx * z, (xy[:, 1] - c.cy) / c.fy * z,
                  z], -1)
    rest = np.stack([rng.uniform(-5, 5, M - n), rng.uniform(-2, 2, M - n),
                     rng.uniform(5, 40, M - n)], -1)
    T = np.asarray(se3_j.exp(jnp.asarray([0.02, -0.01, 0.01, 0.004, -0.009,
                                          0.002], jnp.float32)))
    pc = p @ T[:, :3].T + T[:, 3]
    uv = np.stack([c.fx * pc[:, 0] / pc[:, 2] + c.cx,
                   c.fy * pc[:, 1] / pc[:, 2] + c.cy], -1)
    uv += rng.normal(0, 0.3, uv.shape)
    f32 = np.float32
    return dict(img=img.astype(f32), img2=img2.astype(f32), xy=xy.astype(f32),
                lm_pos=np.concatenate([p, rest]).astype(f32),
                uv=uv.astype(f32))


def _twist_err(A, B):
    d = se3_t.compose(torch.from_numpy(np.array(A, np.float32)),
                      se3_t.inverse(torch.from_numpy(np.array(B, np.float32))))
    return float(np.abs(se3_t.log(d).numpy()).max())


@pytest.fixture(scope="module")
def stage_pair():
    """(the port's stage closures, JAX's counterparts) over one input set
    builder: inp -> (port closures, JAX thunks)."""
    sj = tiny_settings_j()
    st = interop.settings(sj)
    w, h = torch_profile_stages.padded_dims(st)
    front_t = fe_t.Frontend(st, w, h, st.image_width, st.image_height,
                            device="cpu")
    front_j = fe_j.Frontend(sj, w, h, sj.image_width, sj.image_height)
    n, M = sj.max_features, sj.max_landmarks

    def make(inp):
        pyr = front_j.build_pyramid(jnp.asarray(inp["img"]))
        pyr2 = front_j.build_pyramid(jnp.asarray(inp["img2"]))
        feat = fe_j.FeatState(
            xy=jnp.asarray(inp["xy"]), lm_slot=jnp.arange(n, dtype=jnp.int32),
            lm_gid=jnp.arange(n, dtype=jnp.int32), valid=jnp.ones(n, bool),
            octave=jnp.zeros(n, jnp.int32))
        m = map_j.empty_map(sj.max_window, M)._replace(
            lm_pos=jnp.asarray(inp["lm_pos"]), lm_valid=jnp.ones(M, bool),
            lm_gid=jnp.arange(M, dtype=jnp.int32))
        eye = se3_j.identity()
        jax_fns = dict(
            build_pyramid=lambda: pyr,
            track_step=lambda: front_j.track_step(
                pyr, pyr2, feat, eye, eye, m.lm_pos, m.lm_valid, m.lm_gid),
            pose_only_optimize=lambda: ba_j.pose_only_optimize(
                eye, jnp.asarray(inp["lm_pos"][:n]), jnp.asarray(inp["uv"]),
                feat.valid, front_j._fx, front_j._fy, front_j._cx,
                front_j._cy))
        return torch_profile_stages.stages(front_t, inp), jax_fns
    return st, w, h, make


def test_build_pyramid_stage_matches_jax(stage_pair):
    st, w, h, make = stage_pair
    port, jax_fns = make(torch_profile_stages.inputs(st, w, h))
    pt, pj = port["build_pyramid"](), jax_fns["build_pyramid"]()
    for a, b in zip(pt.levels, pj.levels):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=PYR_TOL)
    for a, b in zip(pt.gx + pt.gy, pj.gx + pj.gy):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_TOL)


def test_track_step_stage_matches_jax(stage_pair):
    st, w, h, make = stage_pair
    port, jax_fns = make(_scene_inputs(st, w, h))
    ot, oj = port["track_step"](), jax_fns["track_step"]()
    assert int(ot.n_inliers) == int(oj.n_inliers) > 100
    vj = np.asarray(oj.feat.valid)
    np.testing.assert_array_equal(ot.feat.valid.numpy(), vj)
    np.testing.assert_allclose(ot.feat.xy.numpy()[vj],
                               np.asarray(oj.feat.xy)[vj], atol=PX_TOL)
    assert _twist_err(ot.T_cw.numpy(), np.asarray(oj.T_cw)) < POSE_TOL


def test_pose_only_stage_matches_jax(stage_pair):
    st, w, h, make = stage_pair
    port, jax_fns = make(_scene_inputs(st, w, h))
    rt, rj = port["pose_only_optimize"](), jax_fns["pose_only_optimize"]()
    assert int(rt.n_inliers) == int(rj.n_inliers) > 200
    np.testing.assert_array_equal(rt.inlier.numpy(), np.asarray(rj.inlier))
    assert _twist_err(rt.T_cw.numpy(), np.asarray(rj.T_cw)) < POSE_TOL


def test_graph_stages_equal_their_eager_stages(stage_pair):
    """The stages replayed from a graph (uncaptured on the CPU: the graph's
    function on its static buffers) give what their eager calls give; the
    tracking branch's pose and inliers are JAX's track_step's."""
    st, w, h, make = stage_pair
    port, jax_fns = make(_scene_inputs(st, w, h))
    _, ot = port["track_frame graph"]()
    oe = port["track_step"]()
    for a, b in zip(torch.utils._pytree.tree_leaves(ot),
                    torch.utils._pytree.tree_leaves(oe)):
        assert torch.equal(a, b)
    oj = jax_fns["track_step"]()
    assert int(ot.n_inliers) == int(oj.n_inliers) > 100
    assert _twist_err(ot.T_cw.numpy(), np.asarray(oj.T_cw)) < POSE_TOL
    rg, re = port["pose_only_optimize graph"](), port["pose_only_optimize"]()
    for a, b in zip(rg, re):
        assert torch.equal(a, b)
    for graph, eager in (("keyframe_frame graph", "keyframe_branch"),
                         ("local_ba graph", "local_ba")):
        rg, re = port[graph](), port[eager]()
        lg, le = (torch.utils._pytree.tree_leaves(r) for r in (rg, re))
        assert [x is None for x in lg] == [x is None for x in le]
        for a, b in zip(lg, le):
            assert a is None or torch.equal(a, b)


# ---------------------------------------------------------------- the CLI
def test_kitti_trajectory_cli_writes_the_jax_scripts_file(tmp_path, capsys):
    rng = np.random.default_rng(3)
    T = np.zeros((6, 3, 4))
    for i in range(6):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        T[i, :, :3] = q * np.sign(np.linalg.det(q))
        T[i, :, 3] = rng.uniform(-50, 50, 3)
    np.savetxt(tmp_path / "poses.txt", T.reshape(6, 12))
    np.savetxt(tmp_path / "times.txt", np.cumsum(rng.uniform(0.09, 0.11, 7)))
    args = [str(tmp_path / "poses.txt"), str(tmp_path / "times.txt")]
    assert kitti_cli.main(args + [str(tmp_path / "port.tum")]) == 0
    assert kitti_cli_j.main(args + [str(tmp_path / "jax.tum")]) == 0
    a = (tmp_path / "port.tum").read_bytes()
    assert a == (tmp_path / "jax.tum").read_bytes() and a.count(b"\n") == 6
    assert kitti_cli.main(args) == 2          # the JAX script's usage exit


# ----------------------------------------------------- scaling --engine
@pytest.fixture(scope="module")
def plain_engine_step():
    return torch_profile_scaling.engine_run(SCALING_M, torch.device("cpu"),
                                            reps=1)[1]


@pytest.mark.parametrize("world", [1, 2])
def test_engine_scaling_ranks_against_the_plain_step(world, tmp_path,
                                                     plain_engine_step):
    out = launch(dict(mode="engine", M=SCALING_M), world, tmp_path)
    r0 = out[0]
    assert all(o is None for o in out[1:])
    c = plain_engine_step
    want = dict(T_cw=c.T_cw.numpy(), kf_pose=c.m.kf_pose.numpy(),
                lm_pos=c.m.lm_pos.numpy())
    if world == 1:
        for k, v in want.items():
            np.testing.assert_array_equal(r0[k], v, err_msg=k)
    else:
        for k in ("T_cw", "kf_pose"):
            np.testing.assert_allclose(r0[k], want[k], atol=DIST_POSE_TOL)
        np.testing.assert_allclose(r0["lm_pos"], want["lm_pos"],
                                   atol=DIST_LM_TOL)


def test_engine_scaling_script_on_the_cpu():
    """--engine cut to M 256: one SCALING line with every world timed."""
    out = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, "torch_profile_scaling.py"),
         "--device", "cpu", "--json", "--engine", "256"], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.splitlines()[0] == "CPU"
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("SCALING ")]
    rep = json.loads(line[0][len("SCALING "):])
    assert rep["engine"] and rep["M"] == 256
    worlds = {str(n) for n in torch_profile_scaling.WORLDS}
    assert set(rep["solve_ms"]) == worlds
    assert all(v > 0 for v in rep["solve_ms"].values())
