"""Per-stage timers and counters, and torch.profiler trace capture (port of
`ssvio_tpu/utils/profiling.py`).

`StageTimer` accumulates named wall-clock stages (synchronised with the
device when asked), monotonic counters and their rates; `summary()` has
the JAX package's keys. `trace(log_dir)` captures CPU and CUDA activity
with torch.profiler and writes a chrome trace (Perfetto, chrome://tracing)
into log_dir; it takes the place of the JAX package's `xla_trace`.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional

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


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Capture a torch.profiler trace of CPU and (where there is a CUDA
    device) CUDA activity, written as a chrome trace to
    `log_dir/trace.json` on exit. Yields the profiler. No-op (yields None)
    when log_dir is falsy, so call sites can stay unconditional."""
    if not log_dir:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
