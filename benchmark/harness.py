"""One run of one cell: set-up (the System from the configuration's
settings, the cell's drive rendered on the card and copied to the host,
a warm-up until the vocabulary is trained and both CUDA graphs are
captured, then a reset), the measured window, the traced slice (with
--trace 1), and the judgement of what the window produced.

Offline cells feed host frames through `System.prefetcher` into pipelined
`dispatch_chunk` / `collect_chunk` (chunk k dispatched before chunk k-1 is
collected), with `finish()` at the end of each drive and of the window.
Live cells call `run_step` once a frame, each frame released on the
camera's schedule. Drives repeat back to back, with
`reset(keep_vocab=True)` between them, so the window never runs out of
frames.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional

import numpy as np

from benchmark import judge as judging
from benchmark import spans as spanmod
from benchmark import tracing, traffic

TRACKED = judging.TRACKED
LOST = judging.LOST
SLICE_CHUNKS = 2          # chunks in an offline traced slice
SLICE_FRAMES = 20         # frames in a live traced slice


class Run:
    """What a run measured, as the metric readers (`benchmark/metrics/`)
    read it."""

    def __init__(self, mode: str, settings, canvas):
        self.mode = mode
        self.settings = settings
        self.canvas = canvas                  # (h, w) of the engine
        self.spans: Optional[spanmod.Spans] = None
        self.window = (0.0, 0.0)              # perf_counter seconds
        self.frames = 0                       # frames collected / stepped
        self.lost = 0
        self.live: List[Dict] = []            # per live frame
        self.slice: Optional[tracing.Slice] = None
        self.slice_frames: List[tuple] = []   # (tracked, keyframe, points)
        self.drives = 0
        self.loops = 0                        # accepted loop corrections

    @property
    def seconds(self) -> float:
        return self.window[1] - self.window[0]

    def in_window(self, name: str) -> List[float]:
        """Durations (ms) of the spans `name` that started in the window."""
        return self.spans.ms(name, *self.window) if self.spans else []


def _wrap(spans: Optional[spanmod.Spans], sys_, mode: str) -> None:
    """The spans of the metric readers: on the System (once) and on its
    loop closer (again after every reset, which makes a new one)."""
    if spans is None:
        return
    if not getattr(sys_, "_bench_wrapped", False):
        if mode == "offline":
            spans.wrap(sys_, "dispatch_chunk", "system.dispatch_chunk")
            spans.wrap(sys_, "collect_chunk", "system.collect_chunk")
            spans.wrap(sys_, "finish", "system.finish")
        spans.wrap(sys_, "reset", "system.reset")
        sys_._bench_wrapped = True
    lc = sys_.loopclosing
    if lc is not None and not getattr(lc, "_bench_wrapped", False):
        spans.wrap(lc, "process_keyframes_batch",
                   "loopclosing.process_keyframes_batch")
        spans.wrap(lc, "poll", "loopclosing.poll")
        spans.wrap(lc, "process_keyframe", "loopclosing.process_keyframe")
        lc._bench_wrapped = True


def _reset(sys_, spans) -> None:
    sys_.reset(keep_vocab=True)
    _wrap(spans, sys_, "")


def _hand_over(judge, est: List[np.ndarray], drive) -> None:
    """The poses the program gave a drive's first frames in the window,
    with their ground truth, to the judge."""
    if judge is not None and est:
        T = np.stack(est) if est[0].ndim == 2 else np.concatenate(est)
        judge.trajectory(T, drive.poses[:len(T)])


# ---------------------------------------------------------------------------
# offline: chunks from host memory through the prefetcher
# ---------------------------------------------------------------------------

class Feed:
    """The drive's chunks as an endless stream, uploaded by the System's
    prefetcher two chunks ahead of the dispatch point."""

    def __init__(self, sys_, drive: traffic.Drive, chunk: int, depth: int):
        self.sys, self.drive, self.chunk = sys_, drive, chunk
        n = len(drive.left)
        self.starts = collections.deque(range(0, n, chunk))
        self.pf = sys_.prefetcher(depth=depth)
        self.queued = collections.deque()
        for _ in range(min(2, depth)):
            self._submit()

    def _submit(self):
        c = self.starts[0]
        self.starts.rotate(-1)
        k = min(self.chunk, len(self.drive.left) - c)
        self.pf.submit(self.drive.left[c:c + k], self.drive.right[c:c + k])
        self.queued.append((c, k))

    def next(self):
        """(first frame's index in the drive, stacks on the device)."""
        c, _ = self.queued.popleft()
        imgs = self.pf.get()
        self._submit()
        return c, imgs

    def close(self):
        self.pf.close()


class Offline:
    """The pipelined chunk loop of an offline run."""

    def __init__(self, sys_, drive, tr: Dict, run: Run, judge, spans):
        self.sys, self.drive, self.run = sys_, drive, run
        self.judge, self.spans = judge, spans
        self.fps = float(sys_.s.fps)
        self.feed = Feed(sys_, drive, int(tr["chunk"]),
                         int(tr["prefetch_depth"]))
        self.pending = None
        self.started = False
        self.judging = False                  # inside the window
        self.est: List[np.ndarray] = []       # this drive's poses, chunks

    def _collect(self, h, judge: bool = True):
        from ssvio_tpu_torch.engine import PER_FRAME_PACK
        T_wc = self.sys.collect_chunk(h)
        K = h.n_frames
        per = h.packed.numpy()[:K * PER_FRAME_PACK].reshape(K, PER_FRAME_PACK)
        statuses = per[:, 12].astype(np.int64).tolist()
        self.run.frames += K
        self.run.lost += sum(s == LOST for s in statuses)
        self.est.append(T_wc)
        if judge and self.judge is not None:
            self.judge.offline_chunk(h, statuses,
                                     per[:, 13].astype(np.int64).tolist(),
                                     (per[:, 14] > 0.5).tolist())
        return statuses, per

    def _end_drive(self):
        if self.pending is not None:
            self._collect(self.pending)
            self.pending = None
        self.sys.finish()
        if self.judging:
            _hand_over(self.judge, self.est, self.drive)
        self.est = []
        self.run.drives += 1
        self.run.loops += self.sys.stats["n_loops"]

    def step(self):
        """Dispatch the next chunk and collect the one before it."""
        c, (imgs_l, imgs_r) = self.feed.next()
        if c == 0 and self.started:
            self._end_drive()
            _reset(self.sys, self.spans)
        self.started = True
        k = imgs_l.shape[0]
        h = self.sys.dispatch_chunk(imgs_l, imgs_r,
                                    [(c + j) / self.fps for j in range(k)])
        if self.pending is not None:
            self._collect(self.pending)
        self.pending = h

    def drain(self):
        if self.pending is not None:
            self._collect(self.pending)
            self.pending = None
        self.sys.finish()

    def window(self, seconds: float):
        t0 = time.perf_counter()
        deadline = t0 + seconds
        self.judging = True
        while time.perf_counter() < deadline:
            self.step()
        self.drain()
        self.run.window = (t0, time.perf_counter())
        _hand_over(self.judge, self.est, self.drive)
        self.judging = False

    def traced_slice(self):
        """SLICE_CHUNKS chunks, pipelined, under the profiler; the device
        is idle at its start and its end."""
        kinds = []

        def body():
            hs = []
            for _ in range(SLICE_CHUNKS):
                c, (imgs_l, imgs_r) = self.feed.next()
                if c == 0:
                    self._end_drive()
                    _reset(self.sys, self.spans)
                k = imgs_l.shape[0]
                hs.append(self.sys.dispatch_chunk(
                    imgs_l, imgs_r, [(c + j) / self.fps for j in range(k)]))
                if len(hs) > 1:
                    kinds.append(self._collect(hs[-2], judge=False))
            kinds.append(self._collect(hs[-1], judge=False))
            self.outs = [h.outs for h in hs]

        before = self.sys.status
        self.run.slice = tracing.profile(body, self.spans.spans.keys())
        # each frame's kind, and its points: the tracks it ends with
        prev = before
        for (statuses, per), outs in zip(kinds, self.outs):
            points = outs.feat.valid.sum(1).tolist()
            for i, st in enumerate(statuses):
                tracked = prev in TRACKED
                self.run.slice_frames.append(
                    (tracked, bool(per[i, 14] > 0.5), int(points[i])))
                prev = st

    def close(self):
        self.feed.close()


def offline_warmup(sys_, drive, tr: Dict, max_frames: int):
    """The cell's frames through the same pipelined path until the loop
    closer's vocabulary is trained (where it runs) and both CUDA graphs are
    captured; then `finish()` and a reset. Raises if one drive is not
    enough."""
    run = Run("offline", sys_.s, (sys_.h, sys_.w))
    off = Offline(sys_, drive, tr, run, None, None)
    eng = sys_._engine
    try:
        while run.frames < max_frames:
            off.step()
            warm = (eng.graphs and eng.kf_graphs
                    and (sys_.loopclosing is None
                         or sys_.loopclosing.vocab is not None))
            if warm:
                break
        off.drain()
    finally:
        off.close()
    if not warm:
        raise RuntimeError(f"warm-up: no vocabulary or graph after "
                           f"{run.frames} frames")
    sys_.reset(keep_vocab=True)
    return run.frames


# ---------------------------------------------------------------------------
# live: run_step on the camera's schedule
# ---------------------------------------------------------------------------

class Live:
    def __init__(self, sys_, drive, tr: Dict, run: Run, judge, spans):
        self.sys, self.drive, self.run = sys_, drive, run
        self.judge, self.spans = judge, spans
        self.period = 1.0 / float(tr["rate_hz"])
        self.i = 0                            # frame of the drive
        self.judging = False                  # inside the window
        self.est: List[np.ndarray] = []       # this drive's poses

    def frame(self, due: float) -> Dict:
        """Release the next frame at `due` (perf_counter seconds) and
        step it; returns its record."""
        sys_ = self.sys
        if self.i == len(self.drive.left):
            self.run.drives += 1
            self.run.loops += sys_.stats["n_loops"]
            if self.judging:
                _hand_over(self.judge, self.est, self.drive)
            self.est = []
            _reset(sys_, self.spans)
            self.i = 0
        now = time.perf_counter()
        if now < due:
            time.sleep(due - now)
        status0, n_kf = sys_.status, sys_.stats["n_keyframes"]
        before = (self.judge.live_before(sys_) if self.judge is not None
                  else None)
        t0 = time.perf_counter()
        T_wc = sys_.run_step(self.drive.left[self.i],
                             self.drive.right[self.i], self.i * self.period)
        t1 = time.perf_counter()
        if self.judge is not None:
            self.judge.live_after(sys_, before)
            self.est.append(T_wc)
        self.i += 1
        keyframe = sys_.stats["n_keyframes"] > n_kf
        return dict(due=due, start=t0, end=t1, latency_ms=1e3 * (t1 - due),
                    step_ms=1e3 * (t1 - t0), tracked=status0 in TRACKED,
                    keyframe=keyframe, lost=sys_.status == LOST)

    def window(self, seconds: float):
        t0 = time.perf_counter()
        k = 0
        self.judging = True
        while k * self.period < seconds:
            rec = self.frame(t0 + k * self.period)
            self.run.live.append(rec)
            self.run.lost += rec["lost"]
            k += 1
        self.run.frames = k
        self.run.window = (t0, time.perf_counter())
        _hand_over(self.judge, self.est, self.drive)
        self.judging = False

    def traced_slice(self):
        recs = []

        def body():
            t0 = time.perf_counter()
            for k in range(SLICE_FRAMES):
                recs.append(self.frame(t0 + k * self.period))

        self.run.slice = tracing.profile(body, self.spans.spans.keys())
        for r in recs:
            self.run.slice_frames.append((r["tracked"], r["keyframe"],
                                          int(self.sys.s.max_features)))

    def close(self):
        pass


def live_warmup(sys_, drive, tr: Dict, max_frames: int) -> int:
    """run_step over the cell's frames, unpaced, until the vocabulary is
    trained (where loop closing runs) and both graphs are captured; then a
    reset."""
    eng = sys_._engine
    n = 0
    warm = False
    while n < min(max_frames, len(drive.left)):
        sys_.run_step(drive.left[n], drive.right[n], n / float(tr["rate_hz"]))
        n += 1
        warm = (eng.graphs and eng.kf_graphs
                and (sys_.loopclosing is None
                     or sys_.loopclosing.vocab is not None))
        if warm:
            break
    if not warm:
        raise RuntimeError(f"warm-up: no vocabulary or graph after {n} "
                           "frames")
    sys_.reset(keep_vocab=True)
    return n


MODES = {"offline": (Offline, offline_warmup),
         "live": (Live, live_warmup)}
