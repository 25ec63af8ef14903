"""scripts/torch_bench.py, the port's bench, against bench.py on the CPU.

- Settings: `bench_loop_settings()` equals `bench._make_settings()` on
  every field; BENCH_* are read and trimmed as bench.py reads them.
- `run_pass` against `bench._run_pass` (the root bench.py, imported by
  path; its top level imports no jax) on the same seeded numpy frames, at
  a 256x128 cut of the bench's settings, 3 chunks of 4, pipelined and
  not: equal statuses and keyframe counts, positions within 1e-3 m (the
  two packages sum float32 in another order). Loop closing is off, so the
  hypothesis sampler's generator plays no part.
- 0 frames: the port returns an empty trajectory; bench.py raises
  IndexError there (`times[-1] += ...`), a recorded difference.
- `ate.keyframe_drift` against bench.py:334-346's lines on the same arrays.
- `main(["--device", "cpu"])` with BENCH_FAST=1 at the cut prints one JSON
  line last, with bench.py's keys (read from its source) under the port's
  names; the long-run report is folded only from an NVIDIA card's run.
- `loop_accuracy_bench` at a cut against bench.py's loop bench on the same
  frames (tests/loop_bench_parity.py): both tags with bench.py's keys, and
  equal keyframe, correction and verification counts, ATE and end drift
  within 1e-3 m.
"""

import ast
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from ssvio_tpu.dataio import synthetic as synthetic_j
from ssvio_tpu import engine as engine_j
from ssvio_tpu.eval import ate as ate_j
from ssvio_tpu.system import System as SystemJ
from ssvio_tpu_torch import interop
from ssvio_tpu_torch.config import bench_loop_settings
from ssvio_tpu_torch.eval import ate
from ssvio_tpu_torch.system import System as SystemT
from loop_bench_parity import load_bench, narrow_j
import loop_bench_parity
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import torch_bench  # noqa: E402

BENCH_PY = os.path.join(REPO, "bench.py")
POS_ATOL_M = 1e-3
DRIFT_ATOL_M = 1e-9
CHUNK, CHUNKS = 4, 3
# keys bench.py renames, and the ones it leaves out under BENCH_FAST
RENAMED = {"compile_s": "warmup_s", "e2e_tunnel_fps": "e2e_fps",
           "scaling_virtual8": "scaling"}

bench = load_bench()


def narrow_loop():
    return interop.settings(narrow_j(loop=True))


@pytest.fixture(scope="module")
def frames():
    s = narrow_j()
    poses = synthetic_j.straight_trajectory(CHUNK * CHUNKS,
                                            speed=torch_bench.SPEED_M,
                                            yaw_rate=0.0)
    L, R = synthetic_j.render_stereo_sequence(
        synthetic_j.SyntheticWorld(seed=4), poses, s.cam_left.fx,
        s.cam_left.fy, s.cam_left.cx, s.cam_left.cy, s.baseline,
        s.image_width, s.image_height)
    return s, poses, np.asarray(L), np.asarray(R)


def _jax_statuses(sys_j, log):
    """Record the statuses each collect_chunk reads from its handle."""
    collect = sys_j.collect_chunk
    P = engine_j.PER_FRAME_PACK

    def wrapped(handle):
        packed, K = np.asarray(handle[0]), handle[5]
        log.extend(int(v) for v in packed[:K * P].reshape(K, P)[:, 12])
        return collect(handle)
    sys_j.collect_chunk = wrapped


@pytest.fixture(scope="module")
def jax_runs(frames):
    s, _, L, R = frames
    sys_j = SystemJ(s, enable_backend=True, enable_loop_closing=False)
    runs = {}
    for pipelined in (True, False):
        sys_j.reset()
        status = []
        _jax_statuses(sys_j, status)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(bench, "CHUNK", CHUNK)
            est, times = bench._run_pass(sys_j, L, R, len(L),
                                         pipelined=pipelined)
        del sys_j.collect_chunk
        runs[pipelined] = dict(est=est, times=times, status=status,
                               n_keyframes=sys_j.stats["n_keyframes"])
    return runs


def test_settings_equal_bench_make_settings():
    port, ref = bench_loop_settings(), bench._make_settings()
    common = ({f.name for f in dataclasses.fields(port)}
              & {f.name for f in dataclasses.fields(ref)})
    assert len(common) == len(dataclasses.fields(port))
    for name in sorted(common):
        a, b = getattr(port, name), getattr(ref, name)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, name


@pytest.mark.parametrize("env", [{}, {"BENCH_CHUNK": "8",
                                      "BENCH_FRAMES": "70"},
                                 {"BENCH_FRAMES": "40", "BENCH_LOOPS": "1",
                                  "BENCH_FAST": "1"}])
def test_bench_env_reads_and_trims_as_bench(env, monkeypatch):
    for k in ("BENCH_CHUNK", "BENCH_FRAMES", "BENCH_LOOPS", "BENCH_FAST"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ref = load_bench()                  # reads CHUNK, LOOPS, FAST at import
    n = int(os.environ.get("BENCH_FRAMES", 10 * ref.CHUNK))   # bench.py:124-126
    n -= n % ref.CHUNK
    n = max(n, 2 * ref.CHUNK)
    assert torch_bench.bench_env() == (ref.CHUNK, n, ref.LOOPS, ref.FAST)


@pytest.mark.parametrize("pipelined", [True, False])
def test_run_pass_matches_bench_run_pass(frames, jax_runs, pipelined):
    s, poses, L, R = frames
    j = jax_runs[pipelined]
    sys_t = SystemT(interop.settings(s), enable_backend=True,
                    enable_loop_closing=False, device="cpu")
    est, times, status = torch_bench.run_pass(sys_t, L, R, len(L), CHUNK,
                                              pipelined=pipelined)
    assert len(times) == len(j["times"]) == CHUNKS
    assert status == j["status"]
    assert sys_t.stats["n_keyframes"] == j["n_keyframes"] >= 2
    assert est.shape == j["est"].shape == (len(L), 3, 4)
    np.testing.assert_allclose(est[:, :, 3], j["est"][:, :, 3],
                               atol=POS_ATOL_M)
    kinds = torch_bench.frame_kinds(status)
    assert kinds["init_attempts"] + kinds["tracked"] == len(L)
    assert kinds["tracked"] >= len(L) // 2 and kinds["lost"] == 0


def test_zero_frames_return_empty_where_bench_raises(frames):
    s, _, L, R = frames
    sys_t = SystemT(interop.settings(s), enable_backend=True,
                    enable_loop_closing=False, device="cpu")
    est, times, status = torch_bench.run_pass(sys_t, L, R, 0, CHUNK)
    assert est.shape == (0, 3, 4) and times == [] and status == []
    assert sys_t.trajectory == []
    # the recorded difference: bench.py:100 adds finish()'s time to the
    # last chunk's, and there is none
    sys_j = SystemJ(s, enable_backend=True, enable_loop_closing=False)
    with pytest.raises(IndexError):
        bench._run_pass(sys_j, L, R, 0)


@pytest.mark.parametrize("n_kf", [6, 41])
def test_keyframe_drift_matches_bench_lines(n_kf):
    rng = np.random.default_rng(n_kf)
    t = np.linspace(0.0, 2.5 * np.pi, n_kf)
    gt = np.stack([10.0 * np.sin(t), 0.1 * np.cos(3 * t),
                   10.0 * (1.0 - np.cos(t))], axis=1)
    drift = np.cumsum(rng.normal(0.0, 0.05, (n_kf, 3)), axis=0)
    c, s_ = np.cos(0.3), np.sin(0.3)
    Rg = np.array([[c, 0.0, s_], [0.0, 1.0, 0.0], [-s_, 0.0, c]])
    est = (gt + drift) @ Rg.T + np.array([1.0, -2.0, 0.5])
    got = ate.keyframe_drift(est, gt)
    # bench.py:334-346 on the same arrays
    ref_ate = ate_j.ape_translation(est, gt)["rmse"]
    q = max(4, n_kf // 4)
    _, Rm, tr = ate_j.umeyama_alignment(est[:q], gt[:q])
    est_al = est @ Rm.T + tr
    ref_end = float(np.linalg.norm(est_al[-1] - gt[-1]))
    assert abs(got["end_drift_m"] - ref_end) <= DRIFT_ATOL_M
    assert abs(got["ate_rmse_m"] - ref_ate) <= DRIFT_ATOL_M
    assert ref_end > 0.01


def _bench_extra_keys():
    """bench.py main()'s `extra` keys: the dict literal's, and those it
    adds unless BENCH_FAST."""
    tree = ast.parse(open(BENCH_PY).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "main")
    base, more = [], []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", None) == "extra"
                        for t in node.targets):
            base = [k.value for k in node.value.keys]
        if isinstance(node, ast.Subscript) and getattr(node.value, "id",
                                                       None) == "extra" \
                and isinstance(node.ctx, ast.Store):
            more.append(node.slice.value)
    return base, sorted(set(more))


def test_main_prints_one_json_line_with_bench_keys(monkeypatch, capsys):
    monkeypatch.setattr(torch_bench, "settings", narrow_loop)
    for k, v in dict(BENCH_FAST="1", BENCH_FRAMES="8", BENCH_CHUNK="4",
                     BENCH_LOOPS="1").items():
        monkeypatch.setenv(k, v)
    out = torch_bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == json.loads(json.dumps(out))
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert out["metric"] == "frames_per_second_per_chip"
    assert out["unit"] == "fps" and out["value"] > 0
    assert out["vs_baseline"] == pytest.approx(out["value"] / 10.0)
    base, more = _bench_extra_keys()
    assert "compile_s" in base and "e2e_tunnel_fps" in more
    extra = out["extra"]
    want = {RENAMED.get(k, k) for k in base} | {"path", "kernel_launches"}
    assert want <= set(extra)
    assert not {RENAMED.get(k, k) for k in more} & set(extra)   # FAST
    assert extra["chunk"] == 4 and extra["frames"] == 8
    assert extra["path"]["tracking"] == "static buffers"
    assert extra["path"]["lost"] == 0
    assert extra["path"]["init_attempts"] + extra["path"]["tracked"] == 8
    assert set(extra["kernel_launches"]) >= {"lk_level", "lk_patch"}
    assert all(v == 0 for v in extra["kernel_launches"].values())  # CPU
    assert extra["warmup"]["tracking_graphs"] == 1
    assert np.isfinite(extra["ate_rmse_m"]) and extra["ate_rmse_m"] < 0.5


def test_loop_accuracy_bench_at_a_cut():
    both = loop_bench_parity.run(laps=1, lap_frames=96, chunk=CHUNK,
                                 narrow=True)
    out, ref = both["port"], both["jax"]
    # bench.py:334-350's keys of each tag
    tag_keys = {"ate_rmse_m", "end_drift_m", "n_keyframes", "fps"}
    assert tag_keys <= set(out["loop_off"])
    assert tag_keys | {"n_loops", "n_fused", "n_events"} <= set(out["loop_on"])
    assert out["frames"] == 120 and out["cold_s"] > 0
    for tag in ("loop_on", "loop_off"):
        r, j = out[tag], ref[tag]
        assert r["n_keyframes"] >= 3 and r["fps"] > 0
        assert np.isfinite(r["ate_rmse_m"]) and np.isfinite(r["end_drift_m"])
        # the JAX bench on the same frames
        assert r["n_keyframes"] == j["n_keyframes"]
        for k in ("ate_rmse_m", "end_drift_m"):
            assert abs(r[k] - j[k]) <= POS_ATOL_M, (tag, k, r[k], j[k])
    assert out["loop_on"]["n_loops"] == ref["loop_on"]["n_loops"]
    assert len(out["loop_on"]["events"]) == len(ref["loop_on"]["events"])


def test_longrun_folds_only_a_report_from_an_nvidia_card(tmp_path):
    path = tmp_path / "torch_longrun.json"
    assert torch_bench.longrun_report(str(path)) is None
    report = {"frames": 2304, "laps": 2, "dataset": {}, "loop_on": {},
              "loop_off": {}, "db_initial_cap": 256,
              "device": "NVIDIA H100 80GB HBM3, 700.00 W"}
    path.write_text(json.dumps(report))
    got = torch_bench.longrun_report(str(path))
    assert got == {k: report[k] for k in torch_bench.LONGRUN_KEYS}
    # LONGRUN.json's numbers are a TPU's: no card line, never folded
    with open(os.path.join(REPO, "LONGRUN.json")) as f:
        path.write_text(f.read())
    assert torch_bench.longrun_report(str(path)) is None
    path.write_text(json.dumps(dict(report, device="cpu")))
    assert torch_bench.longrun_report(str(path)) is None


def test_bench_raises_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_bench.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_bench.main(["--build-only"])
