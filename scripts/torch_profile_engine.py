#!/usr/bin/env python
"""Per-frame time of the port's engine step on the bench's sequence (the
port's counterpart of scripts/profile_engine.py).

Renders the bench's straight sequence on the device (world seed 4, 0.6 m
a frame, yaw 0.002 rad a frame; `bench_settings()`: 1241x376, 512
features, 8192 landmarks) and runs it through `Engine._step` one frame at
a time from a fresh carry, the device synchronised after each frame:
tracking frames, init frames and steady keyframe frames apart (median and
p90 ms; `kf_ms_median` over both kinds of keyframe). The engine runs its
default path, both branches replayed from CUDA graphs on a card (the
init frame's keyframe branch runs eagerly), or with --eager op by op
(`path` and `keyframe_path` in the result); two frames run first from the
fresh carry and then the keyframe branch once from the second
(`warm_graphs`), which build the two graphs, so no timed frame captures
one. Then the
frames after the first chunk again, through `Engine.run_chunk` in chunks
from the state the per-frame pass had there: ms a frame. Every time is the host clock around work that ends
synchronised. It runs on the current CUDA device unless --device names
another (--device cpu for the CPU); without a CUDA device and without
--device it raises.

Usage: python scripts/torch_profile_engine.py [--frames 48] [--chunk 8]
           [--eager] [--device cpu]

`bench_frames` renders the sequence for the other profiling tools, and
`steady_chunk` warms a System on it.
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

from ssvio_tpu_torch import engine as eng  # noqa: E402
from ssvio_tpu_torch import frontend as fe  # noqa: E402
from ssvio_tpu_torch.config import bench_settings  # noqa: E402
from ssvio_tpu_torch.dataio import synthetic, synthetic_torch  # noqa: E402
from ssvio_tpu_torch.system import System  # noqa: E402
import torch_tools as tools  # noqa: E402

SEED, SPEED, YAW_RATE = 4, 0.6, 0.002     # profile_engine.py's sequence


def settings():
    """The configuration the tools profile: the bench's."""
    return bench_settings()


def bench_frames(s, n: int, device, pad_hw=None, u8: bool = False):
    """The bench's straight sequence, n frames, rendered on `device` at the
    settings' camera, edge-padded to pad_hw = (h, w) when given. Returns
    (T_wc poses [n, 3, 4] np, left [n, h, w], right [n, h, w])."""
    cam = s.cam_left
    poses = synthetic.straight_trajectory(n, speed=SPEED, yaw_rate=YAW_RATE)
    ph, pw = pad_hw or (0, 0)
    L, R = synthetic_torch.render_stereo_sequence_device(
        synthetic.SyntheticWorld(seed=SEED), poses, cam.fx, cam.fy, cam.cx,
        cam.cy, s.baseline, s.image_width, s.image_height, pad_w=pw,
        pad_h=ph, u8=u8, device=device)
    return poses, L, R


def steady_chunk(K: int, device):
    """A System at settings() after two chunks of K bench frames (the
    first initialises), and the third chunk uploaded: (System, the device
    stacks to pass to run_chunk)."""
    s = settings()
    sys_ = System(s, enable_backend=True, enable_loop_closing=False,
                  device=device)
    _, L, R = bench_frames(s, 3 * K, device, u8=True)
    L, R = L.cpu().numpy(), R.cpu().numpy()
    with torch.no_grad():
        sys_.run_chunk(L[:K], R[:K])
        sys_.run_chunk(L[K:2 * K], R[K:2 * K])
        warm_graphs(sys_._engine, sys_._carry(), sys_._pad(L[2 * K]),
                    sys_._pad(R[2 * K]))
        return sys_, sys_.upload_chunk(L[2 * K:], R[2 * K:])


def warm_graphs(engine, carry, img_l, img_r) -> None:
    """Build the engine's tracking and keyframe graphs for the canvas of
    `img_l` from a tracking carry, as its next frame would if it were a
    steady keyframe, without changing any state (both branches are
    functions of the carry)."""
    pyr, out = engine._track(carry, img_l)
    engine._keyframe(img_r, pyr, out, carry.m, is_init=False)


def _median(xs):
    return float(np.median(xs)) if xs else None


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--frames", type=int, default=48)
    p.add_argument("--chunk", type=int, default=8,
                   help="frames a chunk (at most half of --frames)")
    p.add_argument("--eager", action="store_true",
                   help="run both branches op by op, not through their "
                        "CUDA graphs")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)
    if not 0 < 2 * args.chunk <= args.frames:
        p.error("--chunk must be at most half of --frames")
    dev = tools.tool_device("torch_profile_engine", args.device)
    card = tools.card_line(dev)
    print(card)
    s = settings()
    n, K = args.frames, args.chunk
    sys_ = System(s, enable_backend=True, enable_loop_closing=False,
                  device=dev, eager=args.eager)
    engine = sys_._engine
    print(f"tracking path: {engine.tracking_path}, keyframe path: "
          f"{engine.keyframe_path}")
    carry = eng.fresh_carry(s, sys_.frontend, sys_.map)
    _, L, R = bench_frames(s, n, dev, (sys_.h, sys_.w))
    with torch.no_grad():
        c = engine._step(carry, L[0], lambda: R[0])[0]        # warm-up
        engine._step(c, L[1], lambda: R[1])
        warm_graphs(engine, c, L[1], R[1])
        tools.synchronize(dev)
        c, frames = carry, []
        for i in range(n):
            if i == K:
                c_k = c                 # the chunks start from frame K
            t0 = time.perf_counter()
            init = c.status == fe.INITING
            c, fr = engine._step(c, L[i], lambda i=i: R[i])
            tools.synchronize(dev)
            kind = ("init" if init else "steady_kf" if fr.keyframe
                    else "track")
            frames.append((1e3 * (time.perf_counter() - t0),
                           kind != "track", fr.status, kind))
        c = c_k
        chunk_ms = []
        for b in range(K, n - K + 1, K):
            tools.synchronize(dev)
            t0 = time.perf_counter()
            c, *_ = engine.run_chunk(c, L[b:b + K], R[b:b + K])
            tools.synchronize(dev)
            chunk_ms.append(1e3 * (time.perf_counter() - t0))
    track = [t for t, kf, st, _ in frames if not kf and st != fe.INITING]
    kf = [t for t, k, _, _ in frames if k]
    steady = [t for t, _, _, kind in frames if kind == "steady_kf"]
    init = [t for t, _, _, kind in frames if kind == "init"]
    res = dict(card=card, device=str(dev), path=engine.tracking_path,
               keyframe_path=engine.keyframe_path, frames=n,
               n_keyframes=len(kf), n_tracking=len(track),
               n_steady_keyframes=len(steady), n_init_frames=len(init),
               statuses=[st for _, _, st, _ in frames],
               frame_ms=[t for t, _, _, _ in frames],
               frame_ms_mean=float(np.mean([t for t, _, _, _ in frames])),
               track_ms_median=_median(track),
               track_ms_p90=(float(np.percentile(track, 90)) if track
                             else None),
               kf_ms_median=_median(kf), steady_kf_ms_median=_median(steady),
               steady_kf_ms=steady, init_ms=init, chunk=K, chunk_ms=chunk_ms,
               chunk_ms_per_frame_median=(_median(chunk_ms) / K
                                          if chunk_ms else None))
    print(f"frames: {n}  keyframes: {len(kf)}  tracking: {len(track)}")
    print(f"track frame ms: median {res['track_ms_median']}  "
          f"p90 {res['track_ms_p90']}")
    print(f"kf    frame ms: median {res['kf_ms_median']}; steady "
          f"keyframes ({engine.keyframe_path}) median "
          f"{res['steady_kf_ms_median']} of {len(steady)}, init frames "
          f"(eager) {init}")
    print(f"all frames ms: mean {res['frame_ms_mean']}")
    print(f"chunk({K}) ms/frame: median {res['chunk_ms_per_frame_median']}")
    print("ENGINE " + json.dumps({k: v for k, v in res.items()
                                  if k not in ("frame_ms", "statuses")}))
    return res


if __name__ == "__main__":
    main()
