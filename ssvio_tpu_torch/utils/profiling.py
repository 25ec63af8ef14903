"""The port's recorder, torch.profiler trace capture and its summary
(port of `ssvio_tpu/utils/profiling.py`, and of the timing helpers the JAX
package's scripts/profile_*.py each carry).

`TRACE`, the process's one `StageTimer`, is what the port records into:
host spans (`TRACE.span(name, frame)`: start, end, the frame's index in
the System's stream, the enclosing span) and counters (`TRACE.add`),
always, at about a microsecond each, on `time.perf_counter_ns`. Each name
keeps its last `KEEP` records in a ring; `summary()` has the JAX
package's keys. While `tracing()` (after `enable()`, while a `trace()`
captures, or while any torch profiler runs) the engine also times its
frames on the device with CUDA events from a pool (`event`, `release`)
and reads its local BAs' LM steps. While `trace()` captures, every span is
besides a `record_function` range, so the chrome trace shows the spans
over the kernels they launched. A profiler the port did not start gets no
range from it: such a range's mirror on the device's timeline would read
as device work.

`trace(log_dir)` captures CPU and CUDA activity with torch.profiler and
writes a chrome trace (Perfetto, chrome://tracing) into log_dir; it takes
the place of the JAX package's `xla_trace`. `trace_summary` reads such a
trace back: the top device ops, the kernel launches by name, the device's
busy share and its idle gaps, each named by the span that covered it.
`timeit` is the median time of a call.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import statistics
import threading
import time
from collections import defaultdict, deque
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional

import torch

CLOCK = time.perf_counter_ns
KEEP = 16384                # records kept a name


def _synchronize(value) -> None:
    """Wait for the CUDA devices of the tensors in `value` (a tensor or a
    nested tuple, list or dict of them); nothing to wait for on the CPU."""
    if torch.is_tensor(value):
        if value.is_cuda:
            torch.cuda.synchronize(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _synchronize(v)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _synchronize(v)


class Span(NamedTuple):
    """A closed span, on CLOCK (ns). `frame`: the frame's index in the
    System's stream (-1: none); `parent`: the `id` of the span open around
    it on its thread (-1: none); `tag`: what its code set on it
    (engine.frame: the branch the frame took)."""
    name: str
    t0: int
    t1: int
    frame: int
    parent: int
    id: int
    tag: str


class Count(NamedTuple):
    """A counter's record: when (CLOCK, ns), by how much, for which frame
    (-1: none)."""
    name: str
    t: int
    value: float
    frame: int


class _Open:
    """A span being recorded; its code may set `tag` before it closes."""
    __slots__ = ("rec", "name", "frame", "tag", "t0", "id", "parent", "rf")

    def __init__(self, rec: "StageTimer", name: str, frame: int, tag: str):
        self.rec, self.name, self.frame, self.tag = rec, name, frame, tag

    def __enter__(self) -> "_Open":
        rec = self.rec
        stack = rec._stack()
        self.parent = stack[-1] if stack else -1
        self.id = next(rec._ids)
        stack.append(self.id)
        self.rf = None
        if rec.annotate:
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = CLOCK()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = CLOCK()
        rec = self.rec
        if self.rf is not None:
            self.rf.__exit__(*exc)
        rec._stack().pop()
        rec.total_s[self.name] += (t1 - self.t0) * 1e-9
        rec.count[self.name] += 1
        rec._put(rec._spans, self.name, Span(self.name, self.t0, t1,
                                             self.frame, self.parent,
                                             self.id, self.tag))
        return False


class StageTimer:
    """Named host spans and counters: each name's last `keep` records in a
    ring, and its totals since construction or `reset`.

    with timers.span("engine.frame", frame=7) as sp:   # or .stage(name)
        ...
        sp.tag = "track"
    timers.add("engine.track_replays")

    Spans nest per thread: a span's `parent` is the one open around it on
    its thread. The clock is the host's and never waits for the device:
    the engine's CUDA events time the device."""

    def __init__(self, keep: int = KEEP):
        self.keep = keep
        self.total_s: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self.counters: Dict[str, float] = defaultdict(float)
        self._spans: Dict[str, deque] = {}
        self._counts: Dict[str, deque] = {}
        self._local = threading.local()
        self._ids = itertools.count()
        self.annotate = False       # trace() captures: ranges as well
        self._t0 = CLOCK()

    def _stack(self) -> List[int]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _put(self, rings: Dict[str, deque], name: str, rec) -> None:
        ring = rings.get(name)
        if ring is None:
            ring = rings[name] = deque(maxlen=self.keep)
        ring.append(rec)

    def span(self, name: str, frame: int = -1, tag: str = "") -> _Open:
        return _Open(self, name, frame, tag)

    def stage(self, name: str) -> _Open:
        """A span `name` (the JAX package's StageTimer's word)."""
        return _Open(self, name, -1, "")

    def add(self, counter: str, value: float = 1.0, frame: int = -1):
        self.counters[counter] += value
        self._put(self._counts, counter,
                  Count(counter, CLOCK(), value, frame))

    def spans(self, name: str, t0: Optional[int] = None,
              t1: Optional[int] = None) -> List[Span]:
        """The kept spans `name` that started in [t0, t1) (CLOCK ns; None
        leaves that end open), oldest first."""
        return [s for s in self._spans.get(name, ())
                if (t0 is None or s.t0 >= t0) and (t1 is None or s.t0 < t1)]

    def counts(self, name: str, t0: Optional[int] = None,
               t1: Optional[int] = None) -> List[Count]:
        """The kept records of counter `name` made in [t0, t1)."""
        return [c for c in self._counts.get(name, ())
                if (t0 is None or c.t >= t0) and (t1 is None or c.t < t1)]

    def self_ns(self, spans: Iterable[Span],
                children: Optional[Iterable[str]] = None) -> List[int]:
        """Each span's duration less its children's: the kept spans whose
        parent it is, of the names in `children` (default: every name)."""
        names = list(self._spans) if children is None else children
        kids: Dict[int, int] = defaultdict(int)
        for n in names:
            for c in self._spans.get(n, ()):
                if c.parent >= 0:
                    kids[c.parent] += c.t1 - c.t0
        return [s.t1 - s.t0 - kids.get(s.id, 0) for s in spans]

    def rate(self, counter: str) -> float:
        """counter per wall second since construction/reset."""
        dt = max((CLOCK() - self._t0) * 1e-9, 1e-9)
        return self.counters[counter] / dt

    def summary(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for name, tot in sorted(self.total_s.items()):
            n = self.count[name]
            out[name] = {"total_s": round(tot, 4), "calls": n,
                         "mean_ms": round(1e3 * tot / max(n, 1), 3)}
        for name, v in sorted(self.counters.items()):
            out[f"counter/{name}"] = {"value": v,
                                      "per_s": round(self.rate(name), 3)}
        return out

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2)

    def reset(self, *names: str):
        """Forget the records and totals of `names`; with none, of every
        name, and restart the rates' clock."""
        tables = (self.total_s, self.count, self.counters, self._spans,
                  self._counts)
        for d in tables:
            for n in (names or list(d)):
                d.pop(n, None)
        if not names:
            self._t0 = CLOCK()


TRACE = StageTimer()
_enabled = False


def enable(on: bool = True) -> None:
    """Turn the device timing on (or off) without a profiler."""
    global _enabled
    _enabled = on


def tracing() -> bool:
    """Whether the device timing is on: after `enable()`, while a
    `trace()` captures, or while a torch profiler runs."""
    return (_enabled or TRACE.annotate
            or torch.autograd.profiler._is_profiler_enabled)


def spanned(name: str) -> Callable:
    """A decorator: every call of the function is a span `name` in
    TRACE."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with _Open(TRACE, name, -1, ""):
                return fn(*args, **kwargs)
        return inner
    return wrap


_EVENTS: Dict[torch.device, list] = defaultdict(list)


def event(device: torch.device):
    """A timing CUDA event from the pool, recorded on `device`'s current
    stream."""
    pool = _EVENTS[device]
    e = pool.pop() if pool else torch.cuda.Event(enable_timing=True)
    e.record(torch.cuda.current_stream(device))
    return e


def release(device: torch.device, events: Iterable) -> None:
    """Give events back to the pool once their times are read."""
    _EVENTS[device].extend(e for e in events if e is not None)


TRACE_FILE = "trace.json"
# the host span of the traced call, from its start to the end of the
# device work it queued: a user annotation in the trace
TRACE_WINDOW = "ssvio_trace_window"
# the chrome trace's categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Capture a torch.profiler trace of CPU and (where there is a CUDA
    device) CUDA activity, written as a chrome trace to
    `log_dir/trace.json` on exit. Yields the profiler. No-op (yields None)
    when log_dir is falsy, so call sites can stay unconditional. The body,
    and the wait for the device work it queued, is annotated as
    TRACE_WINDOW (trace_summary's window), and every TRACE span opened in
    it is a range of its own."""
    if not log_dir:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    annotate = TRACE.annotate
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(TRACE_WINDOW):
            TRACE.annotate = True
            try:
                yield prof
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
            finally:
                TRACE.annotate = annotate
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def _union_us(intervals: List[tuple]) -> float:
    """Total length of the union of [start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _gaps_us(intervals: List[tuple], t0: float, t1: float) -> List[tuple]:
    """The stretches of [t0, t1] that no interval covers."""
    out, cur = [], t0
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if cur < t1:
        out.append((cur, t1))
    return out


def trace_summary(path: str, top: int = 10) -> dict:
    """What a chrome trace of `trace` (or any torch.profiler chrome trace)
    says about the device.

    Returns a dict of
      window_ms: the TRACE_WINDOW annotation's span (the host span of the
        traced call); without one, the span of all the trace's events;
      top_ops: the `top` device ops by total time, [(name, count, ms)],
        most first: kernels, memcpys and memsets grouped by name (a device
        event has no children, so its duration is its self time);
      launches: {kernel name: events} over the `kernel` category;
      n_kernels: their sum;
      device_ms: the union of the device events' intervals, clipped to the
        window (kernels on several streams and side-stream copies overlap:
        a union, not a sum);
      busy_share: device_ms / window_ms;
      idle_gaps: the `top` longest stretches of the window with no device
        event, [(name, ms)], longest first, each named by the innermost
        host annotation (a TRACE span under `trace`) that covers its
        midpoint, None where only the window does."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    win = [e for e in events if e.get("name") == TRACE_WINDOW
           and e.get("cat", "").lower() == "user_annotation"]
    if win:
        t0 = float(win[0]["ts"])
        t1 = t0 + float(win[0]["dur"])
    else:
        t0 = min(float(e["ts"]) for e in events)
        t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    dev = [e for e in events if e.get("cat", "").lower() in DEVICE_CATS]
    by_name: Dict[str, list] = defaultdict(lambda: [0, 0.0])
    launches: Dict[str, int] = defaultdict(int)
    spans = []
    for e in dev:
        a = float(e["ts"])
        b = a + float(e["dur"])
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += float(e["dur"]) / 1e3
        if e["cat"].lower() == "kernel":
            launches[e["name"]] += 1
        if b > t0 and a < t1:
            spans.append((max(a, t0), min(b, t1)))
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    window_ms = (t1 - t0) / 1e3
    device_ms = _union_us(spans) / 1e3
    notes = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in events
             if e.get("cat", "").lower() == "user_annotation"
             and e.get("name") != TRACE_WINDOW]
    gaps = []
    for a, b in _gaps_us(spans, t0, t1):
        mid = 0.5 * (a + b)
        inside = [(n1 - n0, name) for n0, n1, name in notes
                  if n0 <= mid < n1]
        gaps.append((min(inside)[1] if inside else None, (b - a) / 1e3))
    gaps.sort(key=lambda g: -g[1])
    return dict(window_ms=window_ms,
                top_ops=[(name, n, ms) for name, (n, ms) in ranked],
                launches=dict(launches), n_kernels=sum(launches.values()),
                device_ms=device_ms,
                busy_share=device_ms / window_ms if window_ms > 0 else 0.0,
                idle_gaps=gaps[:top])


def timeit(fn: Callable, n: int = 20, warmup: int = 1,
           device=None) -> float:
    """Median milliseconds of one call of `fn`, after `warmup` calls. On a
    CUDA `device` each call is timed by CUDA events recorded around it on
    the current stream (the device's time for the work the call queued,
    and the host's where the call waits on the device); elsewhere by the
    host clock, after which the call's device is synchronised."""
    cuda = device is not None and torch.device(device).type == "cuda"
    for _ in range(warmup):
        fn()
    times = []
    if cuda:
        evts = [(torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True)) for _ in range(n)]
        for a, b in evts:
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize(device)
        times = [a.elapsed_time(b) for a, b in evts]
    else:
        for _ in range(n):
            t0 = time.perf_counter()
            _synchronize(fn())
            times.append(1e3 * (time.perf_counter() - t0))
    return float(statistics.median(times))
