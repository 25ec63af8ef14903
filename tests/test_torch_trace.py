"""The port's recorder (`ssvio_tpu_torch/utils/profiling.py`) on the CPU:
its rings, parents and self time, the switch that turns the device timing
on, the spans a tiny System's pipelined chunks leave (frame ids in stream
order, the branch each frame took, the parts of each frame as its
children), the local BAs' LM steps against `Engine.ba_trips`, no
`record_function` range under a profiler the port did not start and one
per span under its own `trace()`, the idle gaps of `trace_summary`, and
the benchmark's six readers of the recorder (`benchmark/metrics/`) on a
hand-made run.
"""

import dataclasses
import json
import threading
import time

import pytest
import torch

from benchmark import harness, run as bench_run
from ssvio_tpu_torch import engine
from ssvio_tpu_torch import frontend as fe
from ssvio_tpu_torch import graphs
from ssvio_tpu_torch.config import bench_settings
from ssvio_tpu_torch.dataio import synthetic, synthetic_torch
from ssvio_tpu_torch.ops import ba
from ssvio_tpu_torch.system import System
from ssvio_tpu_torch.utils import profiling
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

N_FRAMES, CHUNK = 16, 4
W, H, FX = 256, 128, 360.0


def tiny_settings():
    """bench_settings() cut to a 256x128 rig, 256 features, 1024 landmarks
    and a window of 6 (the CPU tests' cut of the port), loop closing off."""
    s = bench_settings()
    cam = dataclasses.replace(s.cam_left, fx=FX, fy=FX, cx=W / 2, cy=H / 2)
    s.cam_left, s.cam_right = cam, dataclasses.replace(cam)
    s.image_width, s.image_height = W, H
    s.baseline_fx = 0.54 * FX
    s.max_features, s.max_landmarks, s.max_window = 256, 1024, 6
    s.n_init_features = s.n_new_features = 256
    s.active_map_size = 4
    s.min_init_landmarks, s.init_good = 40, 40
    s.tracking_good, s.tracking_bad = 50, 10
    s.grid_cell, s.detect_octaves = 24, 2
    s.loop_closing_open = False
    return s


@pytest.fixture(scope="module")
def frames():
    poses = synthetic.straight_trajectory(N_FRAMES, speed=0.5)
    return synthetic_torch.render_stereo_sequence_device(
        synthetic.SyntheticWorld(seed=4), poses, FX, FX, W / 2, H / 2, 0.54,
        W, H)


def _chunks(sys_, L, R):
    """The frames through pipelined dispatch_chunk / collect_chunk; returns
    the handles."""
    hs, prev = [], None
    with torch.no_grad():
        for k in range(0, len(L), CHUNK):
            h = sys_.dispatch_chunk(L[k:k + CHUNK], R[k:k + CHUNK])
            if prev is not None:
                sys_.collect_chunk(prev)
            hs.append(h)
            prev = h
        sys_.collect_chunk(prev)
    return hs


@pytest.fixture(scope="module")
def traced_run(frames):
    """The tiny System over the frames with the device timing on: (the
    System, the statuses, the recorder's clock before the run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    L, R = frames
    t0 = profiling.CLOCK()
    profiling.enable()
    try:
        sys_ = System(tiny_settings(), device="cpu")
        hs = _chunks(sys_, L, R)
    finally:
        profiling.enable(False)
        torch.set_num_threads(n)
    statuses = [int(s) for h in hs for s in h.outs.status]
    return sys_, statuses, t0


# ------------------------------------------------------------ the recorder
def test_rings_keep_the_last_records_and_every_total():
    tr = profiling.StageTimer(keep=4)
    for i in range(6):
        with tr.span("step", frame=i):
            pass
        tr.add("n", 2.0, frame=i)
    assert [s.frame for s in tr.spans("step")] == [2, 3, 4, 5]
    assert [c.frame for c in tr.counts("n")] == [2, 3, 4, 5]
    assert tr.count["step"] == 6 and tr.counters["n"] == 12.0
    assert tr.summary()["step"]["calls"] == 6


def test_spans_nest_per_thread():
    tr = profiling.StageTimer()
    seen = {}

    def other():
        with tr.span("side") as sp:
            seen["parent"] = sp.parent

    with tr.span("outer") as outer:
        with tr.span("inner") as inner:
            th = threading.Thread(target=other)
            th.start()
            th.join()
        with tr.span("inner"):
            pass
    assert seen["parent"] == -1 and outer.parent == -1
    assert [s.parent for s in tr.spans("inner")] == [outer.id, outer.id]
    assert tr.spans("inner")[0].id == inner.id
    assert tr.spans("outer")[0].t0 <= tr.spans("inner")[0].t0
    assert tr.spans("inner")[1].t1 <= tr.spans("outer")[0].t1


def test_self_time_is_the_span_less_its_children():
    tr = profiling.StageTimer()
    with tr.span("frame") as sp:
        sp.tag = "track"
        with tr.span("read"):
            time.sleep(0.02)
        with tr.span("track"):
            time.sleep(0.01)
    (frame,) = tr.spans("frame")
    (read,), (track,) = tr.spans("read"), tr.spans("track")
    dur = frame.t1 - frame.t0
    (all_kids,) = tr.self_ns([frame])
    (less_read,) = tr.self_ns([frame], ("read",))
    assert frame.tag == "track"
    assert less_read == dur - (read.t1 - read.t0)
    assert all_kids == less_read - (track.t1 - track.t0)
    assert 0 <= all_kids < less_read < dur


def test_counters_are_windowed_and_reset_by_name():
    tr = profiling.StageTimer()
    tr.add("a", 1.0, frame=0)
    mid = profiling.CLOCK()
    tr.add("a", 3.0, frame=1)
    tr.add("b")
    assert [c.value for c in tr.counts("a", mid)] == [3.0]
    assert [c.value for c in tr.counts("a", None, mid)] == [1.0]
    tr.reset("a")
    assert not tr.counts("a") and tr.counters["b"] == 1.0
    assert "counter/a" not in tr.summary()
    tr.reset()
    assert not tr.counts("b") and not tr.counters


def test_replay_counters_live_in_the_recorder():
    profiling.TRACE.add(graphs.TRACK_REPLAYS, 3)
    profiling.TRACE.add(graphs.KEYFRAME_REPLAYS)
    assert graphs.replays()[1] >= 1
    graphs.zero_counts()
    assert graphs.replays() == (0, 0)
    assert not profiling.TRACE.counts(graphs.TRACK_REPLAYS)


def test_tracing_is_on_only_when_asked():
    assert not profiling.tracing()
    profiling.enable()
    try:
        assert profiling.tracing()
    finally:
        profiling.enable(False)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.tracing() and not profiling.TRACE.annotate
    assert not profiling.tracing()


def test_no_range_under_a_profiler_the_port_did_not_start():
    name = "test.foreign_span"
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.TRACE.span(name):
            torch.ones(8).sum()
    names = {e.name for e in prof.events()}
    assert "aten::sum" in names and name not in names
    assert profiling.TRACE.spans(name)


def test_trace_ranges_enclose_a_frames_ops(tmp_path, frames):
    """Under trace(), an engine.frame range encloses the aten ops of its
    frame, and its parts are ranges inside it."""
    L, R = frames
    sys_ = System(tiny_settings(), device="cpu")
    with profiling.trace(str(tmp_path)):
        with torch.no_grad():
            sys_.run_step(L[0], R[0])
            sys_.run_step(L[1], R[1])
    assert not profiling.TRACE.annotate and not profiling.tracing()
    with open(tmp_path / profiling.TRACE_FILE) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]

    def ranges(name):
        return [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e["name"] == name and e.get("cat") == "user_annotation"]

    frame_ranges = ranges("engine.frame")
    assert len(frame_ranges) == 2
    ops = [e["ts"] for e in events if e.get("cat") == "cpu_op"]
    for a, b in frame_ranges:
        assert sum(a <= t < b for t in ops) > 10
    (ta, tb), = ranges("engine.track")
    assert frame_ranges[1][0] <= ta and tb <= frame_ranges[1][1]
    assert len(ranges("engine.keyframe")) == 1      # the init frame's


def test_trace_summary_names_the_idle_gaps(tmp_path):
    def x(name, cat, ts, dur):
        return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur)

    events = [
        x(profiling.TRACE_WINDOW, "user_annotation", 0.0, 100.0),
        x("system.dispatch_chunk", "user_annotation", 0.0, 60.0),
        x("engine.frame", "user_annotation", 5.0, 30.0),
        x("engine.frame", "gpu_user_annotation", 5.0, 30.0),  # mirror
        x("kA", "kernel", 10.0, 10.0),
        x("kB", "kernel", 40.0, 10.0),
        x("Memcpy DtoH", "gpu_memcpy", 90.0, 5.0),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = profiling.trace_summary(str(path))
    # idle: [0, 10) in the frame, [20, 40) in the frame to 35 (midpoint
    # 30), [50, 90) midpoint 70 outside the chunk, [95, 100)
    assert s["idle_gaps"] == [(None, pytest.approx(0.04)),
                              ("engine.frame", pytest.approx(0.02)),
                              ("engine.frame", pytest.approx(0.01)),
                              (None, pytest.approx(0.005))]
    assert s["device_ms"] == pytest.approx(0.025)
    assert len(profiling.trace_summary(str(path), top=1)["idle_gaps"]) == 1


# ------------------------------------------------------- a System's spans
def test_frames_are_spans_in_stream_order(traced_run):
    sys_, statuses, t0 = traced_run
    tr = profiling.TRACE
    fr = tr.spans("engine.frame", t0)
    assert [s.frame for s in fr] == list(range(N_FRAMES))
    # the branch: a steady keyframe is a tracked frame that turned BAD
    before = [fe.INITING] + statuses[:-1]
    tracked = (fe.TRACKING_GOOD, fe.TRACKING_BAD)
    want = ["init" if b == fe.INITING else "lost" if b == fe.LOST
            else "track+keyframe" if a == fe.TRACKING_BAD else "track"
            for b, a in zip(before, statuses)]
    assert [s.tag for s in fr] == want
    steady = [s.frame for s in fr if s.tag == "track+keyframe"]
    assert steady and before[steady[0]] in tracked
    # every part of a frame is a child of its frame's span, with its frame
    ids = {s.id: s.frame for s in fr}
    for name, n in (("engine.track", N_FRAMES - 1),
                    ("engine.read", N_FRAMES),
                    ("engine.keyframe", len(steady) + 1)):
        parts = tr.spans(name, t0)
        assert len(parts) == n, name
        assert all(ids[p.parent] == p.frame for p in parts), name
    # the frames run inside the chunks' dispatches
    chunks = {s.id for s in tr.spans("system.dispatch_chunk", t0)}
    assert len(chunks) == N_FRAMES // CHUNK
    assert {s.parent for s in fr} == chunks
    assert len(tr.spans("system.collect_chunk", t0)) == N_FRAMES // CHUNK


def test_ba_steps_match_the_engines_trips(traced_run):
    sys_, statuses, t0 = traced_run
    trips = torch.stack(list(sys_._engine.ba_trips))
    tr = profiling.TRACE
    needed = sum(c.value for c in tr.counts("ba.lm_steps_needed", t0))
    ran = sum(c.value for c in tr.counts("ba.lm_steps_run", t0))
    assert len(trips) == sys_.stats["n_ba"] >= 1
    assert needed == int(trips[:, 1].sum())
    assert ran == len(trips) * ba.LOCAL_BA_ROUNDS * ba.LOCAL_BA_ITERS
    # the CPU makes no event: no device times
    assert not tr.counts("engine.period_ms", t0)


def test_cpu_bas_run_every_round(traced_run):
    """The CPU's BAs run the fixed trip op by op: no round skipped."""
    sys_, _, t0 = traced_run
    assert sys_._engine.ba_mode == "fixed trip"
    skipped = profiling.TRACE.counts("ba.rounds_skipped", t0)
    assert skipped and sum(c.value for c in skipped) == 0


# three BAs whose loops took 1, 3 and 5 rounds and 10, 27 and 50 LM steps,
# by the mode they ran in: (LM steps run, rounds skipped)
BA_WORK = {"graph": (90, 6), "fixed trip": (150, 0)}


@pytest.mark.parametrize("mode", list(BA_WORK))
def test_chunk_timing_counts_each_modes_ba_work(mode):
    """ChunkTiming.record's LM steps and skipped rounds by a BA's mode: a
    graph runs each of its rounds whole and skips the rest, a fixed trip
    (a mesh BA's too) runs every round."""
    timing = engine.ChunkTiming(torch.device("cpu"))
    for trip in ((1, 10), (3, 27), (5, 50)):
        timing.trips.append(torch.tensor(trip, dtype=torch.int32))
        timing.modes.append(mode)
    t0 = profiling.CLOCK()
    timing.fetch()
    timing.record()

    def total(name):
        return sum(c.value for c in profiling.TRACE.counts(name, t0))

    assert total("ba.lm_steps_needed") == 87
    assert (total("ba.lm_steps_run"), total("ba.rounds_skipped")) \
        == BA_WORK[mode]
    assert not timing.trips and not timing.modes
    for other in ("eager", "mesh"):
        with pytest.raises(ValueError):
            engine.ba_work(other, 1)


def test_no_timing_is_taken_while_off(frames):
    L, R = frames
    t0 = profiling.CLOCK()
    sys_ = System(tiny_settings(), device="cpu")
    hs = _chunks(sys_, L[:CHUNK], R[:CHUNK])
    assert hs[0].timing is None
    assert [s.frame for s in profiling.TRACE.spans("engine.frame", t0)] \
        == list(range(CHUNK))
    assert not profiling.TRACE.counts("ba.lm_steps_run", t0)


# ------------------------------------------------- the benchmark's readers
READERS = ("engine.track_device_ms.offline",
           "engine.keyframe_device_ms.offline",
           "engine.outside_graphs_ms.offline",
           "engine.host_self_ms.offline",
           "ba.lm_steps_used.offline",
           "loopclosing.verify_ms.offline")
S = 1_000_000_000           # ns a second


def _hand_made():
    """A recorder with a window of [10 s, 20 s) and a slice after it:
    three frames in the window, three in the slice (a tracked frame, a
    steady keyframe, a tracked frame), two verifications in the window
    and one after it."""
    tr = profiling.StageTimer()
    ids = iter(range(1000))

    def span(name, t0, t1, frame=-1, parent=-1, tag=""):
        sp = profiling.Span(name, int(t0), int(t1), frame, parent,
                            next(ids), tag)
        tr._put(tr._spans, name, sp)
        return sp

    def count(name, t, value, frame=-1):
        tr._put(tr._counts, name, profiling.Count(name, int(t), value,
                                                  frame))

    ms = S // 1000
    for i, (dur, read) in enumerate(((30, 10), (50, 20), (40, 0))):
        fr = span("engine.frame", 11 * S + i * ms * 100,
                  11 * S + i * ms * 100 + dur * ms, frame=i, tag="track")
        if read:
            span("engine.read", fr.t0, fr.t0 + read * ms, i, fr.id)
    for t, dur in ((12 * S, 100 * ms), (13 * S, 300 * ms),
                   (21 * S, 900 * ms)):
        span("loopclosing.verify", t, t + dur)
    # the slice: frames 100 (track), 101 (steady keyframe), 102 (track)
    tags = {100: "track", 101: "track+keyframe", 102: "track"}
    for f, tag in tags.items():
        span("engine.frame", 22 * S + f, 22 * S + f + 1, frame=f, tag=tag)
    # a window frame's device times do not count in the slice
    count("engine.track_ms", 15 * S, 99.0, frame=1)
    for f, period, track, kf in ((100, 20.0, 15.0, None),
                                 (101, 130.0, 16.0, 100.0),
                                 (102, 22.0, 17.0, None)):
        count("engine.period_ms", 23 * S, period, f)
        count("engine.track_ms", 23 * S, track, f)
        if kf is not None:
            count("engine.keyframe_ms", 23 * S, kf, f)
    count("engine.keyframe_ms", 23 * S, 7.0, frame=99)   # an init frame
    count("ba.lm_steps_needed", 23 * S, 10.0)
    count("ba.lm_steps_run", 23 * S, 50.0)
    count("ba.lm_steps_needed", 23 * S, 20.0)
    count("ba.lm_steps_run", 23 * S, 50.0)
    return tr


WANT = {"engine.track_device_ms.offline": 16.0,
        "engine.keyframe_device_ms.offline": 100.0,
        # (20 - 15 + 130 - 116 + 22 - 17) / 3
        "engine.outside_graphs_ms.offline": 8.0,
        # (30 - 10 + 50 - 20 + 40) / 3
        "engine.host_self_ms.offline": 30.0,
        "ba.lm_steps_used.offline": 30.0,
        "loopclosing.verify_ms.offline": 200.0}


def _run():
    run = harness.Run("offline", tiny_settings(), (H, W))
    run.window = (10.0, 20.0)
    return run


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_hand_made_run(name, monkeypatch):
    monkeypatch.setattr(profiling, "TRACE", _hand_made())
    assert bench_run.load_reader(name)(_run()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_records(name, monkeypatch):
    read = bench_run.load_reader(name)
    monkeypatch.setattr(profiling, "TRACE", profiling.StageTimer())
    assert read(_run()) is None
    # a port without the recorder (the commit before it): None, no raise
    monkeypatch.delattr(profiling, "TRACE")
    assert read(_run()) is None
