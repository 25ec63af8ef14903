#!/usr/bin/env python
"""Where the pipelined chunk loop's time goes, chunk by chunk (the port's
counterpart of scripts/profile_chunk_pipeline.py,
profile_bench_breakdown.py and profile_device_throughput.py).

The bench's sequence (torch_profile_engine.bench_frames, bench_settings();
CHUNKS chunks after a warm-up chunk, of CHUNK frames: BENCH_CHUNK, 32 by
default, as there) is rendered on the device and handed over from the
host as uint8, as a camera's frames are. Two passes, each on a fresh
System whose first chunk (initialisation) is a warm-up:

1. device-only throughput: every chunk uploaded first (upload_chunk), then
   dispatched back to back with no collect between, one wait at the end,
   then every collect: ms a chunk, frames a second.
2. the pipelined loop as bench.py and the driver run it (prefetcher;
   dispatch chunk k+1 before collecting chunk k), for each chunk:
   pad + upload (the prefetcher thread's host padding and copy, until the
   copy is done), the loop's wait in get(), dispatch_chunk, the wait for
   the packed readback of the chunk collected, and the host tail
   (collect_chunk once the readback is in: trajectory, keyframe records,
   window refresh).

The JAX package's dispatch_chunk returns at once (an asynchronous scan)
and its compute shows in collect. The port's engine reads the host inside
each step (Engine.run_chunk), so its dispatch_chunk returns when the
chunk's compute is done: here "dispatch" holds the compute, and the
readback wait is short.

It runs on the current CUDA device unless --device names another
(--device cpu for the CPU); without a CUDA device and without --device it
raises.

Usage: BENCH_CHUNK=32 python scripts/torch_profile_chunk_pipeline.py
           [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_profile_engine as tpe  # noqa: E402
from ssvio_tpu_torch.system import System  # noqa: E402
import torch_tools as tools  # noqa: E402

CHUNK = int(os.environ.get("BENCH_CHUNK", "32"))
CHUNKS = 4                   # timed after the warm-up chunk (at least 2)


def _ms(t0):
    return 1e3 * (time.perf_counter() - t0)


def _fresh(s, dev, L, R, K):
    sys_ = System(s, enable_backend=True, enable_loop_closing=False,
                  device=dev)
    sys_.run_chunk(L[:K], R[:K], [0.1 * i for i in range(K)])   # warm-up
    return sys_


def device_only(s, dev, L, R, K) -> dict:
    sys_ = _fresh(s, dev, L, R, K)
    ups = [sys_.upload_chunk(L[c:c + K], R[c:c + K])
           for c in range(K, len(L), K)]
    tools.synchronize(dev)
    t0 = time.perf_counter()
    handles = [sys_.dispatch_chunk(*u) for u in ups]
    dispatch_ms = _ms(t0)
    if handles[-1].ready is not None:
        handles[-1].ready.synchronize()
    total_ms = _ms(t0)
    t1 = time.perf_counter()
    for h in handles:
        sys_.collect_chunk(h)
    n = len(ups) * K
    return dict(dispatch_all_ms=dispatch_ms, total_ms=total_ms,
                ms_per_chunk=total_ms / len(ups),
                frames_per_s=1e3 * n / total_ms, collects_ms=_ms(t1))


def pipelined(s, dev, L, R, K) -> dict:
    sys_ = _fresh(s, dev, L, R, K)
    upload_ms = []
    upload = sys_._upload

    def timed_upload(lefts, rights):
        # the prefetcher thread's pad + copy, until the copy is done
        t0 = time.perf_counter()
        imgs_l, imgs_r, done = upload(lefts, rights)
        if done is not None:
            done.synchronize()
        upload_ms.append(_ms(t0))
        return imgs_l, imgs_r, done
    sys_._upload = timed_upload
    starts = list(range(K, len(L), K))
    pf = sys_.prefetcher()
    pf.submit(L[starts[0]:starts[0] + K], R[starts[0]:starts[0] + K])
    rows, pending = [], None
    try:
        for i, c in enumerate(starts):
            t0 = time.perf_counter()
            cur = pf.get()
            get_ms = _ms(t0)
            t1 = time.perf_counter()
            h = sys_.dispatch_chunk(*cur, [0.1 * (c + j) for j in range(K)])
            dispatch_ms = _ms(t1)
            if i + 1 < len(starts):
                n = starts[i + 1]
                pf.submit(L[n:n + K], R[n:n + K])
            wait_ms = tail_ms = 0.0
            if pending is not None:
                t2 = time.perf_counter()
                if pending.ready is not None:
                    pending.ready.synchronize()
                wait_ms = _ms(t2)
                t3 = time.perf_counter()
                sys_.collect_chunk(pending)
                tail_ms = _ms(t3)
            pending = h
            rows.append(dict(chunk=i, get_ms=get_ms, dispatch_ms=dispatch_ms,
                             readback_wait_ms=wait_ms, host_tail_ms=tail_ms,
                             total_ms=_ms(t0)))
        t2 = time.perf_counter()
        if pending.ready is not None:
            pending.ready.synchronize()
        wait_ms = _ms(t2)
        t3 = time.perf_counter()
        sys_.collect_chunk(pending)
        rows.append(dict(chunk="final collect", readback_wait_ms=wait_ms,
                         host_tail_ms=_ms(t3)))
    finally:
        pf.close()
    for r, ms in zip(rows, upload_ms):
        r["pad_upload_ms"] = ms
    return dict(rows=rows, statuses=[int(sys_.status)],
                n_keyframes=sys_.stats["n_keyframes"])


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)
    dev = tools.tool_device("torch_profile_chunk_pipeline", args.device)
    card = tools.card_line(dev)
    print(card)
    s = tpe.settings()
    K = CHUNK
    _, L, R = tpe.bench_frames(s, K * (CHUNKS + 1), dev, u8=True)
    L, R = L.cpu().numpy(), R.cpu().numpy()
    with torch.no_grad():
        dev_only = device_only(s, dev, L, R, K)
        pipe = pipelined(s, dev, L, R, K)
    print(f"device-only: {dev_only['ms_per_chunk']:.1f} ms a chunk of {K}, "
          f"{dev_only['frames_per_s']:.2f} frames/s (dispatch-all "
          f"{dev_only['dispatch_all_ms']:.1f} ms of "
          f"{dev_only['total_ms']:.1f}: the port's dispatch runs the "
          "compute)")
    for r in pipe["rows"]:
        print("  " + "  ".join(f"{k} {v:.1f}" if isinstance(v, float)
                               else f"{k} {v}" for k, v in r.items()))
    # the chunks that collect one before them
    steady = [r for r in pipe["rows"] if isinstance(r["chunk"], int)
              and r["chunk"] >= 1]
    med = {k: float(np.median([r[k] for r in steady]))
           for k in ("pad_upload_ms", "get_ms", "dispatch_ms",
                     "readback_wait_ms", "host_tail_ms", "total_ms")}
    res = dict(card=card, device=str(dev), chunk=K, chunks=CHUNKS,
               device_only=dev_only, pipelined=pipe, median=med,
               note="dispatch_chunk holds the compute (the engine reads "
                    "the host inside each step)")
    print("PIPELINE " + json.dumps(dict(res, pipelined=None)))
    return res


if __name__ == "__main__":
    main()
