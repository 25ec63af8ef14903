"""The traced slice: torch.profiler over a few steady chunks (or frames)
after the window has closed, reduced on the host to what the device did:
the slice's length, the union of its kernel, memcpy and memset intervals
(`stats.union_length`, the arithmetic of the port's
`utils/profiling.py::trace_summary`), device time by operation name, and
its idle gaps named by the innermost host span (`benchmark/spans.py`)
that covered them. The events are read from the profiler in memory; no
trace file is written.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

from benchmark import stats

SLICE = "bench.slice"


class Slice(NamedTuple):
    window_s: float                     # the slice's host span
    busy_s: float                       # union of device intervals in it
    op_s: Dict[str, float]              # device seconds by op name
    op_n: Dict[str, int]                # device events by op name
    gaps: List[Tuple[str, float]]       # idle gaps, longest first

    def seconds(self, match: Callable[[str], bool]) -> float:
        """Device seconds of the ops whose name `match` accepts."""
        return sum(s for n, s in self.op_s.items() if match(n))


def _on_device(e) -> bool:
    return e.device_type() == torch.autograd.DeviceType.CUDA


def profile(fn: Callable[[], None], notes=()) -> Slice:
    """Run fn() under the profiler (CPU and CUDA activity), with the
    device synchronised before and after, and reduce its events; `notes`
    names the host spans that may name an idle gap."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SLICE):
            fn()
            torch.cuda.synchronize()
    return reduce(prof.profiler.kineto_results.events(), notes)


def reduce(events, notes=()) -> Slice:
    """A Slice from kineto events (name(), device_type(), start_ns(),
    duration_ns()): the slice is the host's SLICE annotation; every
    device event other than an annotation's mirror on the device's
    timeline is device work (kernels, memcpys, memsets); host events
    named in `notes` name the gaps."""
    notes = set(notes)
    t0 = t1 = None
    device, named_spans = [], []
    op_s: Dict[str, float] = defaultdict(float)
    op_n: Dict[str, int] = defaultdict(int)
    for e in events:
        name = e.name()
        a = e.start_ns() * 1e-9
        b = a + e.duration_ns() * 1e-9
        if _on_device(e):
            if name == SLICE or name in notes:
                continue
            device.append((a, b))
            op_s[name] += b - a
            op_n[name] += 1
        elif name == SLICE:
            if t0 is None or b - a > t1 - t0:
                t0, t1 = a, b
        elif name in notes:
            named_spans.append((a, b, name))
    if t0 is None:          # no host annotation read: the events' extent
        ends = [(e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9)
                for e in events]
        t0, t1 = min(a for a, _ in ends), max(b for _, b in ends)
    busy = stats.union_length(stats.clip(device, t0, t1))
    named = []
    for a, b in stats.gaps(device, t0, t1):
        mid = 0.5 * (a + b)
        inside = [(n1 - n0, name) for n0, n1, name in named_spans
                  if n0 <= mid < n1]
        named.append((min(inside)[1] if inside else "harness", b - a))
    named.sort(key=lambda g: -g[1])
    return Slice(t1 - t0, busy, dict(op_s), dict(op_n), named)


def short(name: str) -> str:
    """A kernel's name without its argument list, at most 120 characters."""
    return name.split("(")[0][:120]


def breakdown(sl: Slice, top: int = 10) -> Dict:
    """The result line's breakdown: the device ops that took most time and
    the longest idle gaps, each [name, seconds]."""
    ops = sorted(sl.op_s.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[short(n), s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in sl.gaps[:top]]}
