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
kernel launches by name (a frame's), and the union of the kernel and copy
intervals (device ms).

The profiler stretches the host span of what it traces (it records every
launch and kernel), so the busy share is the device ms over the untraced
run's span, the same chunk from the same state; the traced run's share,
device ms over its own span, is returned beside it with the stretch,
traced span / untraced span. The launch counters' delta over the traced
chunk is returned beside the trace's counts: the profiler can drop events
on a long trace, so the two are held against each other (kernel #1's
events are named `level_kernel`; the profiler reports the kernels a CUDA
graph launches, each as its own event). The System runs its default
path, the tracking graph on a card (`path` in the result).

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
from ssvio_tpu_torch.utils import profiling  # noqa: E402
import torch_tools as tools  # noqa: E402

KERNEL1 = "level_kernel"     # kernel #1's events (lk_level.cu)


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
    summ = profiling.trace_summary(os.path.join(args.out,
                                                profiling.TRACE_FILE))
    traced_k1 = sum(v for k, v in summ["launches"].items() if KERNEL1 in k)
    res = dict(card=card, device=str(dev), chunk=K,
               path=sys_._engine.tracking_path,
               trace=os.path.join(args.out, profiling.TRACE_FILE),
               window_ms=summ["window_ms"], untraced_ms=untraced_ms,
               stretch=summ["window_ms"] / untraced_ms,
               device_ms=summ["device_ms"],
               busy_share=summ["device_ms"] / untraced_ms,
               traced_busy_share=summ["busy_share"],
               n_kernels=summ["n_kernels"],
               kernels_per_frame=summ["n_kernels"] / K,
               top_ops=summ["top_ops"], launches=summ["launches"],
               counter_launches=counted, trace_kernel1=traced_k1,
               statuses=[int(sys_.status)])
    print(f"tracking path: {res['path']}")
    print(f"chunk of {K}: untraced {untraced_ms:.1f} ms, traced "
          f"{summ['window_ms']:.1f} ms (stretch {res['stretch']:.3f}); "
          f"device busy {summ['device_ms']:.1f} ms: busy share "
          f"{res['busy_share']:.4f} of the untraced span "
          f"({summ['busy_share']:.4f} of the traced); "
          f"{summ['n_kernels']} kernels ({summ['n_kernels'] / K:.0f} a "
          "frame)")
    print(f"kernel #1: {traced_k1} in the trace, {counted['lk_level']} by "
          "its counter")
    for name, n, ms in summ["top_ops"]:
        print(f"  {ms:9.3f} ms  {n:6d}x  {name[:100]}")
    print("TRACE " + json.dumps({k: v for k, v in res.items()
                                 if k != "launches"}))
    return res


if __name__ == "__main__":
    main()
