"""Per-stage timers and counters, torch.profiler trace capture and its
summary (port of `ssvio_tpu/utils/profiling.py`, and of the timing helpers
the JAX package's scripts/profile_*.py each carry).

`StageTimer` accumulates named wall-clock stages (synchronised with the
device when asked), monotonic counters and their rates; `summary()` has
the JAX package's keys. `trace(log_dir)` captures CPU and CUDA activity
with torch.profiler and writes a chrome trace (Perfetto, chrome://tracing)
into log_dir; it takes the place of the JAX package's `xla_trace`.
`trace_summary` reads such a trace back: the top device ops, the kernel
launches by name and the device's busy share. `timeit` is the median time
of a call.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch


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


class StageTimer:
    """Accumulating named wall-clock timers.

    with timers.stage("track"):   # accumulate into 'track'
        ...
    Device work is asynchronous: pass `sync=result` to wait for the CUDA
    device of that tensor (or tuple of tensors) before the clock stops, so
    the stage is charged its device time."""

    def __init__(self):
        self.total_s: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self.counters: Dict[str, float] = defaultdict(float)
        self._t0 = time.time()

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.time()
        try:
            yield
        finally:
            if sync is not None:
                _synchronize(sync)
            self.total_s[name] += time.time() - t0
            self.count[name] += 1

    def add(self, counter: str, value: float = 1.0):
        self.counters[counter] += value

    def rate(self, counter: str) -> float:
        """counter per wall second since construction/reset."""
        dt = max(time.time() - self._t0, 1e-9)
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

    def reset(self):
        self.total_s.clear()
        self.count.clear()
        self.counters.clear()
        self._t0 = time.time()


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
    TRACE_WINDOW (trace_summary's window)."""
    if not log_dir:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(TRACE_WINDOW):
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
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
      busy_share: device_ms / window_ms."""
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
    return dict(window_ms=window_ms,
                top_ops=[(name, n, ms) for name, (n, ms) in ranked],
                launches=dict(launches), n_kernels=sum(launches.values()),
                device_ms=device_ms,
                busy_share=device_ms / window_ms if window_ms > 0 else 0.0)


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

