#!/usr/bin/env python
"""A torch.profiler trace of one steady chunk of the port's engine, and
what it says about the device (the port's counterpart of
scripts/profile_trace.py).

The bench's sequence (torch_profile_engine.steady_chunk: bench_frames,
bench_settings()) is rendered on the device and handed to the System from
the host, as a camera's frames are. Two chunks of `--chunk` frames warm
the System up (the first initialises); the third is uploaded, the
System's state is taken (torch_tools.snapshot), and the chunk is run
through `run_chunk` twice from that state: once without the profiler, on
the host clock to the end of its device work, and once under
`utils/profiling.trace`,
which writes a chrome trace to `--out`. `profiling.trace_summary` reads
the trace back: the top device ops by total time (the 10 longest), the
kernel launches by name (a frame's), the union of the kernel and copy
intervals (device ms), and the 10 longest idle gaps of the device, each
named by the port's span that covered it (`engine.frame`,
`engine.read`, ...: under `trace` the recorder's spans are ranges of the
trace).

The profiler stretches the host span of what it traces (it records every
launch and kernel), so the busy share is the device ms over the untraced
run's span, the same chunk from the same state; the traced run's share,
device ms over its own span, is returned beside it with the stretch,
traced span / untraced span. The launch counters' delta over the traced
chunk is returned beside the trace's counts: the profiler can drop events
on a long trace, so the two are held against each other (kernel #1's
events are named `level_kernel`; the profiler reports the kernels a CUDA
graph launches, each as its own event). The System runs its default
path, both graphs on a card (`path` in the result); the keyframe graph
is built before the traced chunk (torch_profile_engine.warm_graphs).

Then one steady keyframe frame alone (`keyframe_frame`): from the same
state the frames after it run one at a time through `Engine._step` until
one turns into a steady keyframe (at most KF_SEARCH frames), and that
frame runs twice from the carry before it, untraced and traced (a chrome
trace in `--out`/keyframe), with the same summary: its ms, device ms,
busy share over the untraced span, kernels and top ops.

It runs on the current CUDA device unless --device names another
(--device cpu for the CPU; there the trace holds no device events);
without a CUDA device and without --device it raises.

Usage: python scripts/torch_profile_trace.py [--chunk 8]
           [--out build/torch_profile_trace] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_profile_engine as tpe  # noqa: E402
from ssvio_tpu_torch import frontend as fe  # noqa: E402
from ssvio_tpu_torch.utils import profiling  # noqa: E402
import torch_tools as tools  # noqa: E402

KERNEL1 = "level_kernel"     # kernel #1's events (lk_level.cu)
KF_SEARCH = 24               # frames searched for a steady keyframe


def _summary(path: str, untraced_ms: float, frames: int) -> dict:
    summ = profiling.trace_summary(os.path.join(path, profiling.TRACE_FILE))
    return dict(trace=os.path.join(path, profiling.TRACE_FILE),
                window_ms=summ["window_ms"], untraced_ms=untraced_ms,
                stretch=summ["window_ms"] / untraced_ms,
                device_ms=summ["device_ms"],
                busy_share=summ["device_ms"] / untraced_ms,
                traced_busy_share=summ["busy_share"],
                n_kernels=summ["n_kernels"],
                kernels_per_frame=summ["n_kernels"] / frames,
                top_ops=summ["top_ops"], idle_gaps=summ["idle_gaps"],
                launches=summ["launches"])


def keyframe_frame(sys_, L, R, out: str, dev) -> dict:
    """The first steady keyframe among the frames L, R (device, padded)
    from the System's state, run alone untraced and traced (module
    docstring). The System's state is left as it was."""
    engine = sys_._engine
    c = sys_._carry()
    for k in range(len(L)):
        c2, fr = engine._step(c, L[k], lambda k=k: R[k])
        if fr.keyframe and c.status != fe.INITING:
            break
        c = c2
    else:
        raise RuntimeError(f"no steady keyframe in {len(L)} frames")
    tools.synchronize(dev)
    t0 = time.perf_counter()
    engine._step(c, L[k], lambda: R[k])
    tools.synchronize(dev)
    untraced_ms = 1e3 * (time.perf_counter() - t0)
    n0 = tools.launch_counts()
    with profiling.trace(out):
        engine._step(c, L[k], lambda: R[k])
    res = _summary(out, untraced_ms, 1)
    res.update(frame=k, counter_launches=tools.launches_since(n0))
    return res


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--chunk", type=int, default=8)
    p.add_argument("--out", default=os.path.join(REPO, "build",
                                                 "torch_profile_trace"),
                   help="directory of the chrome trace")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)
    dev = tools.tool_device("torch_profile_trace", args.device)
    card = tools.card_line(dev)
    print(card)
    K = args.chunk
    sys_, up = tpe.steady_chunk(K, dev)
    _, L, R = tpe.bench_frames(sys_.s, 2 * K + KF_SEARCH, dev,
                               (sys_.h, sys_.w), u8=True)
    with torch.no_grad():
        snap = tools.snapshot(sys_)
        tools.synchronize(dev)
        t0 = time.perf_counter()
        sys_.run_chunk(*up)
        tools.synchronize(dev)
        untraced_ms = 1e3 * (time.perf_counter() - t0)
        tools.restore(sys_, snap)
        n0 = tools.launch_counts()
        with profiling.trace(args.out):
            sys_.run_chunk(*up)
        counted = tools.launches_since(n0)
        tools.restore(sys_, snap)
        kf = keyframe_frame(sys_, L[2 * K:], R[2 * K:],
                            os.path.join(args.out, "keyframe"), dev)
    res = _summary(args.out, untraced_ms, K)
    traced_k1 = sum(v for k, v in res["launches"].items() if KERNEL1 in k)
    res.update(card=card, device=str(dev), chunk=K,
               path=sys_._engine.tracking_path,
               keyframe_path=sys_._engine.keyframe_path,
               counter_launches=counted, trace_kernel1=traced_k1,
               statuses=[int(sys_.status)], keyframe_frame=kf)
    print(f"tracking path: {res['path']}, keyframe path: "
          f"{res['keyframe_path']}")
    for tag, r, n in ((f"chunk of {K}", res, K),
                      (f"steady keyframe frame (frame {kf['frame']} of the "
                       "chunk on)", kf, 1)):
        print(f"{tag}: untraced {r['untraced_ms']:.1f} ms, traced "
              f"{r['window_ms']:.1f} ms (stretch {r['stretch']:.3f}); "
              f"device busy {r['device_ms']:.1f} ms: busy share "
              f"{r['busy_share']:.4f} of the untraced span "
              f"({r['traced_busy_share']:.4f} of the traced); "
              f"{r['n_kernels']} kernels ({r['n_kernels'] / n:.0f} a "
              "frame)")
        for name, cnt, ms in r["top_ops"]:
            print(f"  {ms:9.3f} ms  {cnt:6d}x  {name[:100]}")
        print("  idle gaps: " + ", ".join(f"{ms:.3f} ms in {name}"
                                          for name, ms in r["idle_gaps"]))
    print(f"kernel #1: {traced_k1} in the trace, {counted['lk_level']} by "
          "its counter")
    print("TRACE " + json.dumps(
        {k: ({a: b for a, b in v.items() if a != "launches"}
             if k == "keyframe_frame" else v)
         for k, v in res.items() if k != "launches"}))
    return res


if __name__ == "__main__":
    main()
