"""CPU tests of the benchmark's harness: cells found by name, frozen
copies pinned, no JAX, the open-loop schedule, fps over the whole window,
the traced slice's arithmetic, and a tiny cell run end to end through the
port on the CPU, correct as it is and not correct with each planted fault.

    python -m pytest benchmark/ -q
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import hashlib
import json
import os
import shutil
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import cells, harness, judge as judging, stats, tracing
from benchmark import traffic, work

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "ssvio_tpu"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ data layout
def tiny_settings():
    """bench_loop_settings() cut to a 256x128 rig, 256 features, 1024
    landmarks and a window of 6 (the CPU tests' cut of the port)."""
    from ssvio_tpu_torch.config import bench_loop_settings
    s = bench_loop_settings()
    cam = dataclasses.replace(s.cam_left, fx=360.0, fy=360.0, cx=128.0,
                              cy=64.0)
    s.cam_left, s.cam_right = cam, dataclasses.replace(cam)
    s.image_width, s.image_height = 256, 128
    s.baseline_fx = 0.54 * 360.0
    s.max_features, s.max_landmarks, s.max_window = 256, 1024, 6
    s.n_init_features = s.n_new_features = 256
    s.active_map_size = 4
    s.min_init_landmarks, s.init_good = 40, 40
    s.tracking_good, s.tracking_bad = 50, 10
    s.grid_cell, s.detect_octaves = 24, 2
    s.loop_desc_scales, s.vocab_k, s.vocab_levels = 2, 4, 2
    s.max_keyframes_db, s.loop_db_min_size = 16, 4
    return s


TINY_RPE_LIMIT = 0.15


def tiny_root(tmp_path, mode: str) -> str:
    """A checkout's BENCHMARK.json and benchmark/ data with one more cell,
    `tiny-cell`, made only of added files and entries."""
    root = str(tmp_path)
    shutil.copytree(os.path.join(HERE, "configs"),
                    os.path.join(root, "benchmark", "configs"))
    shutil.copytree(os.path.join(HERE, "traffic"),
                    os.path.join(root, "benchmark", "traffic"))
    shutil.copytree(os.path.join(HERE, "limits"),
                    os.path.join(root, "benchmark", "limits"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-cell", "config": "tiny",
                               "traffic": f"tiny-{mode}", "chips": 1,
                               "why": "test"})
    if mode == "live":
        bench["end_to_end"] += [
            {"name": n, "unit": "ms", "better": "lower", "bound": 0.25,
             "source": "host_clock", "workloads": []}
            for n in ("latency_p50_ms", "latency_p95_ms")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"].endswith("." + mode) or (
                mode == "offline" and m["name"] == "fps") or (
                mode == "live" and m["name"].startswith("latency")):
            m["workloads"].append("tiny-cell")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    with open(os.path.join(root, "benchmark", "configs", "tiny.json"),
              "w") as f:
        json.dump({"name": "tiny",
                   "settings": dataclasses.asdict(tiny_settings())}, f)
    with open(os.path.join(root, "benchmark", "traffic",
                           f"tiny-{mode}.json"), "w") as f:
        json.dump(dict(mode=mode, chunk=8, prefetch_depth=3, rate_hz=10.0,
                       drive=dict(path="straight", frames=48, speed_m=0.3,
                                  speed_swing=0.3, swing_frames=16,
                                  world={}, noise_std=0.0)), f)
    with open(os.path.join(HERE, "limits",
                           "kitti-straight-offline.json")) as f:
        limits = json.load(f)
    # the tiny drive's own: sound CPU runs read 0.039-0.075 m
    limits["rpe_m"] = TINY_RPE_LIMIT
    with open(os.path.join(root, "benchmark", "limits", "tiny-cell.json"),
              "w") as f:
        json.dump(limits, f)
    return root


def test_a_cell_added_as_files_is_found(tmp_path):
    root = tiny_root(tmp_path, "offline")
    cell = cells.load("tiny-cell", root=root)
    assert cell.traffic["chunk"] == 8
    assert {m["name"] for m in cell.end_to_end} == {"fps", "setup_s"}
    assert "system.dispatch_ms.offline" in {m["name"] for m in cell.per_layer}
    s = cells.settings_from(cell.config)
    assert (s.image_width, s.max_window) == (256, 6)
    assert traffic.poses_of(cell.traffic["drive"]).shape == (48, 3, 4)
    with pytest.raises(KeyError):
        cells.load("no-such-cell", root=root)


DEPARTURES = ("tracking_good", "n_init_features", "n_new_features",
              "min_init_landmarks", "loop_db_min_size")


@pytest.mark.parametrize("name,preset", [
    ("kitti_stereo_loop", "bench_loop_settings"),
    ("robotcar_xb3_vo", "robotcar_xb3_wide_settings")])
def test_config_files_hold_the_presets(name, preset):
    from ssvio_tpu_torch import config
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        doc = json.load(f)
    want = dataclasses.asdict(getattr(config, preset)())
    assert doc["settings"] == want
    assert dataclasses.asdict(cells.settings_from(doc)) == want
    # every key changed from kitti_00.yaml (the port's Settings defaults)
    # is listed, with its reason under `assumed`
    kitti_00 = dataclasses.asdict(config.Settings())
    assert doc["reduced"] == [k for k in DEPARTURES if want[k] != kitti_00[k]]
    assert len(doc["reduced"]) >= 4
    for k in doc["reduced"]:
        assert any(a.startswith(f"{k} {want[k]} (kitti_00.yaml: "
                                f"{kitti_00[k]})") for a in doc["assumed"])
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        entry = {c["name"]: c for c in json.load(f)["configs"]}[name]
    assert entry["reduced"] == doc["reduced"]


def test_benchmark_json_names_files_that_exist():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in bench["workloads"]:
        cell = cells.load(w["name"])
        assert cell.limits.keys() >= set(judging.NUMBERS)
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(HERE, "metrics",
                                           m["name"] + ".py"))


# ---------------------------------------------------------- frozen copies
def test_renderer_output_is_pinned():
    from benchmark import render
    d = dict(path="straight", frames=3, speed_m=0.6, world={"wall_x": 4.0},
             noise_std=2.0)
    L, R = render.render_stereo_sequence_device(
        traffic.world_of(d, 2 ** 31 + 7), traffic.poses_of(d), 60.0, 60.0,
        32.0, 24.0, 0.5, 64, 48, noise_std=2.0, noise_seed=99, device="cpu")
    assert hashlib.sha256(L.numpy().tobytes()).hexdigest() == \
        "fd5c87ff3937ae232b85eda8595209146dfb03add23041a59422fc5cc0b79a87"
    assert hashlib.sha256(R.numpy().tobytes()).hexdigest() == \
        "53a23555ad14edeac697ec91acbe46036ea73eca8df6c0ff2bc2259836f0ffc8"
    c = dict(path="straight", frames=7, speed_m=0.6, speed_swing=0.3,
             swing_frames=4, yaw_rate=0.01)
    assert hashlib.sha256(np.round(traffic.poses_of(c), 12).tobytes()
                          ).hexdigest() == \
        "afc0bc4680677e583a074f71159a20824c8b151e54730609d479cb6b5bffbf80"


def test_the_speed_swings_about_its_mean():
    d = dict(path="straight", frames=121, speed_m=0.6, speed_swing=0.3,
             swing_frames=60)
    step = np.linalg.norm(np.diff(traffic.poses_of(d)[:, :, 3], axis=0),
                          axis=1)
    assert step.min() == pytest.approx(0.42) and \
        step.max() == pytest.approx(0.78)
    assert step.mean() == pytest.approx(0.6, abs=1e-9)
    still = traffic.poses_of(dict(d, speed_swing=0.0))
    assert np.array_equal(still, traffic.poses_of(dict(path="straight",
                                                       frames=121,
                                                       speed_m=0.6)))


# ------------------------------------------------------------------ no JAX
def _top_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    for d in (HERE, os.path.join(HERE, "metrics")):
        for name in sorted(os.listdir(d)):
            if name.endswith(".py"):
                yield os.path.join(d, name)


def test_no_jax_in_the_benchmark():
    paths = list(_sources())
    assert len(paths) > 10
    for path in paths:
        found = set(_top_imports(path)) & FORBIDDEN
        assert not found, (path, found)
    # the plain reference takes nothing of the program either
    ref_imports = set(_top_imports(os.path.join(HERE, "reference.py")))
    assert not ref_imports & (FORBIDDEN | {"ssvio_tpu_torch", "benchmark"})


def test_forbidden_modules_compare_whole_names(monkeypatch):
    from benchmark import run
    monkeypatch.setitem(sys.modules, "ssvio_tpu_torch_x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert run.forbidden_modules() == ["jaxlib"]


def _stub_reader(root, stubs):
    """A per-layer metric `stub.reader` of the tiny cell whose reader
    imports a package named jax (a stub in `stubs`)."""
    os.makedirs(os.path.join(stubs, "jax"))
    with open(os.path.join(stubs, "jax", "__init__.py"), "w") as f:
        f.write("")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["per_layer"].append({
        "name": "stub.reader", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "system", "moves": "fps",
        "workloads": ["tiny-cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    with open(os.path.join(root, "benchmark", "metrics", "stub.reader.py"),
              "w") as f:
        f.write("def read(run):\n    import jax  # noqa: F401\n"
                "    return 1.0\n")


@pytest.mark.parametrize("reader_loads_jax", [False, True])
def test_a_module_loaded_after_the_judgement_stops_the_run(
        tmp_path, monkeypatch, capsys, reader_loads_jax):
    from benchmark import run
    assert not run.forbidden_modules()
    root = tiny_root(tmp_path / "root", "offline")
    shutil.copytree(os.path.join(HERE, "metrics"),
                    os.path.join(root, "benchmark", "metrics"))
    if reader_loads_jax:
        _stub_reader(root, str(tmp_path / "stubs"))
        monkeypatch.syspath_prepend(str(tmp_path / "stubs"))
    monkeypatch.setattr(run, "ROOT", root)
    monkeypatch.setattr(run, "require_cards", lambda chips: None)
    monkeypatch.setattr(run, "the_card", lambda: torch.device("cpu"))
    monkeypatch.setattr(run, "card_name", lambda: "CPU")
    monkeypatch.setattr(tracing, "profile", lambda fn, notes=(): (
        fn(), tracing.Slice(1.0, 0.5, {}, {}, []))[1])
    try:
        rc = run.main(["--workload", "tiny-cell", "--seed", "5",
                       "--seconds", "4", "--trace", "1"])
    finally:
        sys.modules.pop("jax", None)
    captured = capsys.readouterr()
    last = captured.out.strip().splitlines()[-1]
    if reader_loads_jax:
        assert rc != 0
        assert "'jax'" in captured.err
        assert '"correct"' not in last
    else:
        assert rc == 0
        assert json.loads(last)["metrics"]


# ------------------------------------------------ the drive against truth
def test_motion_errors_need_no_alignment():
    d = dict(path="straight", frames=30, speed_m=0.5, speed_swing=0.3,
             swing_frames=12, yaw_rate=0.02)
    gt = traffic.poses_of(d)
    # the same drive in another world frame: no error
    c, s_ = np.cos(0.7), np.sin(0.7)
    W = np.array([[c, -s_, 0.0, 3.0], [s_, c, 0.0, -1.0], [0, 0, 1.0, 2.0]])
    moved = np.einsum("ij,njk->nik", W[:, :3], gt)
    moved[:, :, 3] += W[:, 3]
    assert np.allclose(judging.motion_errors(moved, gt, 10), 0, atol=1e-12)
    assert judging.frame_ate(moved, gt) == pytest.approx(0, abs=1e-9)
    # 1 cm too far each frame along a straight drive: 10 cm in 10
    gt = traffic.poses_of(dict(d, yaw_rate=0.0))
    est = gt.copy()
    est[:, 2, 3] += np.arange(30) * 0.01
    err = judging.motion_errors(est, gt, 10)
    assert err.shape == (20,) and np.allclose(err, 0.1, atol=1e-3)


# ------------------------------------------------------ the open loop
class _StepSystem:
    """run_step that takes the given seconds per call, on a fake state."""

    def __init__(self, durations):
        self.durations = list(durations)
        self.status = judging.TRACKING_GOOD
        self.stats = {"n_keyframes": 0, "n_loops": 0}
        self.s = argparse.Namespace(max_features=8)

    def run_step(self, left, right, ts):
        time.sleep(self.durations.pop(0))

    def reset(self, keep_vocab=False):
        pass


def test_live_latency_counts_from_the_due_time():
    period = 0.05
    durations = [0.01, 0.12, 0.01, 0.01, 0.01]   # frame 1 overruns
    fake = _StepSystem(durations)
    drive = traffic.Drive(np.zeros((5, 3, 4)), [0] * 5, [0] * 5)
    run = harness.Run("live", fake.s, (1, 1))
    live = harness.Live(fake, drive, {"rate_hz": 1 / period}, run, None,
                        None)
    live.window(5 * period - 1e-9)
    lat = [r["latency_ms"] for r in run.live]
    assert run.frames == 5
    assert all(r["start"] >= r["due"] for r in run.live)
    # the slow frame delays the next: it starts at the slow one's end,
    # past its own due time, and its latency counts that wait
    assert run.live[2]["start"] >= run.live[1]["end"]
    assert lat[2] > 1e3 * (0.12 - period) + 5
    assert lat[1] >= 120
    assert all(abs(r["latency_ms"] - 1e3 * (r["end"] - r["due"])) < 1e-9
               for r in run.live)


# --------------------------------------------------- fps over the window
class _Handle:
    def __init__(self, k):
        from ssvio_tpu_torch.engine import PER_FRAME_PACK
        per = np.zeros((k, PER_FRAME_PACK), np.float32)
        per[:, 12] = judging.TRACKING_GOOD
        self.packed = torch.from_numpy(per.reshape(-1))
        self.n_frames = k


class _ChunkSystem:
    def __init__(self, collect_s):
        self.s = argparse.Namespace(fps=10.0)
        self.collect_s = collect_s
        self.status = judging.TRACKING_GOOD
        self.stats = {"n_loops": 0}
        self.finished = 0
        self.dispatched = 0
        self.loopclosing = None

    def prefetcher(self, depth):
        return _Prefetcher()

    def dispatch_chunk(self, L, R, ts):
        self.dispatched += len(L)
        return _Handle(len(L))

    def collect_chunk(self, h):
        time.sleep(self.collect_s)
        return np.zeros((h.n_frames, 3, 4))

    def finish(self):
        time.sleep(0.05)
        self.finished += 1

    def reset(self, keep_vocab=False):
        pass


class _Prefetcher:
    def __init__(self):
        self.q = []

    def submit(self, L, R):
        self.q.append((torch.zeros(len(L), 1, 1), torch.zeros(len(R), 1, 1)))

    def get(self):
        return self.q.pop(0)

    def close(self):
        pass


def test_fps_counts_every_frame_over_the_whole_window():
    fake = _ChunkSystem(collect_s=0.02)
    drive = traffic.Drive(np.zeros((10, 3, 4)), np.zeros((10, 1, 1)),
                          np.zeros((10, 1, 1)))
    run = harness.Run("offline", fake.s, (1, 1))
    off = harness.Offline(fake, drive, {"chunk": 4, "prefetch_depth": 3},
                          run, None, None)
    t0 = time.perf_counter()
    off.window(0.3)
    t1 = time.perf_counter()
    # chunks of 4, 4, 2 a drive; every dispatched chunk is collected and
    # finish() (0.05 s) closes the window
    assert run.window[0] >= t0 and run.window[1] <= t1
    assert run.seconds >= 0.3 + 0.05
    assert fake.finished >= 1
    # every frame dispatched in the window is collected and counted, the
    # chunk in flight at the deadline too
    assert run.frames == fake.dispatched > 10
    assert run.drives >= 1


# --------------------------------------------------- the traced slice
class _Event:
    def __init__(self, name, kind, start_us, dur_us):
        self._n, self._k = name, kind
        self._s, self._d = int(start_us * 1000), int(dur_us * 1000)

    def name(self):
        return self._n

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA
                if self._k in ("kernel", "gpu_memcpy", "gpu_annotation")
                else torch.autograd.DeviceType.CPU)

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def test_slice_arithmetic_on_a_toy_trace():
    ev = [_Event(tracing.SLICE, "user_annotation", 0, 100),
          _Event("system.dispatch_chunk", "user_annotation", 0, 60),
          _Event("loopclosing.poll", "user_annotation", 60, 40),
          _Event("level_kernel<A>", "kernel", 10, 20),
          _Event("level_kernel<A>", "kernel", 20, 20),      # overlaps
          _Event("Memcpy HtoD", "gpu_memcpy", 45, 5),
          _Event("gemm", "kernel", 90, 30),                 # runs past
          _Event(tracing.SLICE, "gpu_annotation", 0, 100),  # its mirror
          _Event("aten::add", "cpu_op", 0, 100)]
    sl = tracing.reduce(ev, ["system.dispatch_chunk", "loopclosing.poll"])
    assert sl.window_s == pytest.approx(100e-6)
    # union: [10, 40) + [45, 50) + [90, 100) = 45 us
    assert sl.busy_s == pytest.approx(45e-6)
    assert sl.op_s["level_kernel<A>"] == pytest.approx(40e-6)
    assert sl.op_n["level_kernel<A>"] == 2
    # gaps: [0,10) dispatch, [40,45) dispatch, [50,90) poll (longest first)
    names = [(n, round(s * 1e6)) for n, s in sl.gaps]
    assert names == [("loopclosing.poll", 40), ("system.dispatch_chunk", 10),
                     ("system.dispatch_chunk", 5)]
    br = tracing.breakdown(sl)
    assert br["device_ops"][0][0] == "level_kernel<A>"
    assert br["idle_gaps"][0] == ["loopclosing.poll", pytest.approx(40e-6)]


def test_lk_bytes_are_the_planes_or_the_windows():
    s = argparse.Namespace(lk_levels=3, lk_window=11)
    # level 0 of 384x1248: 512 windows are fewer bytes than the planes
    assert work.lk_level_bytes(384, 1248, 0, 512, 11) == 16 * 512 * 121
    # level 2 of a 64x64 canvas: the planes are fewer
    assert work.lk_level_bytes(64, 64, 2, 512, 11) == 16 * 16 * 16
    both = work.lk_frame_bytes(s, 64, 64, True, True, 1)
    assert both == 2 * 3 * 16 * 121 + 2 * (3 * 16 * 121 + 16 * 8 * 8)


def test_percentile_and_gaps():
    assert stats.percentile([1, 2, 3, 4], 50) == 2.5
    assert stats.percentile(list(range(101)), 95) == 95
    assert stats.gaps([(1, 2)], 0, 3) == [(0, 1), (2, 3)]


# --------------------------------------------- a tiny cell end to end
def _run_tiny(tmp_path, mode="offline", seconds=10.0):
    from benchmark import run
    root = tiny_root(tmp_path, mode)
    cell = cells.load("tiny-cell", root=root)
    args = argparse.Namespace(workload="tiny-cell", seed=2 ** 31 + 11,
                              seconds=seconds, trace=0)
    orig = run.card_name
    run.card_name = lambda: "CPU"
    try:
        return run.execute(cell, args, torch.device("cpu"))
    finally:
        run.card_name = orig


@pytest.mark.parametrize("mode", ["offline", "live"])
def test_a_tiny_cell_runs_and_is_correct(tmp_path, mode):
    out = _run_tiny(tmp_path, mode)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == ({"fps", "setup_s"} if mode == "offline"
                                   else {"latency_p50_ms", "latency_p95_ms",
                                         "setup_s"})
    assert list(out)[-1] == "checks"


def _fault_unchanged_pose(orig):
    def f(T_init, *a, **k):
        return orig(T_init, *a, **k)._replace(T_cw=T_init)
    return f


def _fault_half_tracks(orig):
    def f(T_init, p_w, uv, valid, *a, **k):
        keep = valid & (torch.cumsum(valid.long(), 0) % 2 == 0)
        res = orig(T_init, p_w, uv, keep, *a, **k)
        out = orig(T_init, p_w, uv, valid, *a, **k)
        return out._replace(T_cw=res.T_cw)
    return f


def _fault_altered_pose(orig):
    def f(*a, **k):
        res = orig(*a, **k)
        T = res.T_cw.clone()
        T[2, 3] += 0.05
        return res._replace(T_cw=T)
    return f


def _fault_altered_count(orig):
    def f(*a, **k):
        res = orig(*a, **k)
        return res._replace(n_inliers=res.n_inliers + 7)
    return f


def _fault_unchanged_window(orig):
    def f(prob, *a, **k):
        res = orig(prob, *a, **k)
        return res._replace(kf_T_cw=prob.kf_T_cw, lm_pos=prob.lm_pos)
    return f


def _lk_returns_its_start(orig):
    def f(pyr_prev, pyr_cur, pts_prev, pts_init, valid, *a, **k):
        xy, ok, err = orig(pyr_prev, pyr_cur, pts_prev, pts_init, valid,
                           *a, **k)
        return pts_init, ok, err
    return f


def _points_half_deeper(orig):
    def f(*a, **k):
        p, ok = orig(*a, **k)
        return p * 1.5, ok
    return f


@pytest.mark.parametrize("module,name,fault", [
    ("lk", "track", _lk_returns_its_start),
    ("triangulation", "triangulate_stereo_rectified",
     _points_half_deeper)])
def test_a_fault_the_drive_shows_is_not_correct(tmp_path, monkeypatch,
                                                module, name, fault):
    """LK's tracks left where they start, or new landmarks triangulated
    half as deep again, from the window's start on (the warm-up, which a
    broken LK would stop, runs sound): the three numbers that follow the
    program's own problems cannot see it, `rpe_m` does."""
    import importlib
    mod = importlib.import_module("ssvio_tpu_torch.ops." + module)
    orig, window = getattr(mod, name), harness.Offline.window
    broken = fault(orig)
    on = []

    def switched(*a, **k):
        return (broken if on else orig)(*a, **k)

    def faulty_window(self, seconds):
        on.append(True)
        return window(self, seconds)

    monkeypatch.setattr(mod, name, switched)
    monkeypatch.setattr(harness.Offline, "window", faulty_window)
    out = _run_tiny(tmp_path)
    assert not out["correct"], out["checks"]
    assert out["checks"]["rpe_m"]["value"] > out["checks"]["rpe_m"]["limit"]


@pytest.mark.parametrize("target,fault", [
    ("pose_only_optimize", _fault_unchanged_pose),
    ("pose_only_optimize", _fault_half_tracks),
    ("pose_only_optimize", _fault_altered_pose),
    ("pose_only_optimize", _fault_altered_count),
    ("local_ba", _fault_unchanged_window)])
def test_a_planted_fault_is_not_correct(tmp_path, monkeypatch, target,
                                        fault):
    from ssvio_tpu_torch.ops import ba
    monkeypatch.setattr(ba, target, fault(getattr(ba, target)))
    out = _run_tiny(tmp_path)
    assert not out["correct"], out["checks"]
