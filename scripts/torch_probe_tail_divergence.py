#!/usr/bin/env python
"""Which loop-closing action degrades the tracking of a long looped run:
drive the loop stress scene to a cut with loop closing live, take a
snapshot of the whole live state, then rerun the same tail of frames from
it once per variant of the loop closer and compare each tail's tracking
health with the frozen tail's (the port's counterpart of
scripts/probe_tail_divergence.py).

The scene is scripts/torch_repro_loop5.py's (`small_settings`: 320x128,
192 features, a keyframe nearly every frame; a 6 m circle of 120 frames,
world seed 11) driven to frame END (400), rendered on the device.
Frames 0..CUT (250) go through pipelined dispatch_chunk / collect_chunk in
chunks of 10 with loop closing on, then finish(). torch_tools.snapshot
deep-copies the System's state and its LoopClosing's (the keyframe
database tensors, the pending candidates, the torch Generator's state), so
every tail starts from one state. The tails, frames CUT..END, pipelined as before:
  frozen:     no candidate can pass (loop_threshold_higher 2.0: BoW
              scores are <= 1), so no loop event;
  live:       the loop closer as configured;
  identity C: every accepted correction runs its whole path (map swap,
              fusion, relink, gauge event, PGO) with the rigid transform
              replaced by the identity: the mechanics without the values.
Each tail prints its health (the median tracked inlier count) after
every chunk, its loop count and final status.

It runs on the current CUDA device unless --device names another
(--device cpu for the CPU); without a CUDA device and without --device it
raises.

Usage: python scripts/torch_probe_tail_divergence.py [--device cpu]

`render` and `drive` are shared with scripts/torch_probe_gauge_invariance.py.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_repro_loop5 as loop5  # noqa: E402
from ssvio_tpu_torch.dataio import synthetic, synthetic_torch  # noqa: E402
from ssvio_tpu_torch.system import System  # noqa: E402
import torch_tools as tools  # noqa: E402

CHUNK = 10
CUT, END = 250, 400   # the cut and the last frame (probe_tail_divergence.py's)


def render(s, n: int, device):
    """The first n frames of the scene, laps of the circle."""
    world = synthetic.SyntheticWorld(seed=11, wall_x=16.0, ceiling_y=-5.0)
    circ = synthetic.loop_trajectory(loop5.LAP_FRAMES, radius=6.0)
    poses = np.concatenate([circ] * -(-n // loop5.LAP_FRAMES), axis=0)[:n]
    L, R = synthetic_torch.render_stereo_sequence_device(
        world, poses, s.cam_left.fx, s.cam_left.fy, s.cam_left.cx,
        s.cam_left.cy, s.baseline, s.image_width, s.image_height, u8=False,
        device=device)
    return poses, L, R


def drive(sys_: System, L, R, a: int, b: int) -> list:
    """Frames a..b in pipelined chunks; the health after each collect."""
    healths, pending = [], None
    for c in range(a, b, CHUNK):
        h = sys_.dispatch_chunk(L[c:c + CHUNK], R[c:c + CHUNK],
                                [0.1 * (c + j) for j in range(CHUNK)])
        if pending is not None:
            sys_.collect_chunk(pending)
            healths.append(sys_.track_health)
        pending = h
    sys_.collect_chunk(pending)
    healths.append(sys_.track_health)
    return [None if x is None else int(x) for x in healths]


def tail(sys_: System, snap: dict, L, R, cut: int, end: int,
         variant: str) -> dict:
    """Frames cut..end from the snapshot with the loop closer's variant
    (VARIANTS), which is undone afterwards."""
    tools.restore(sys_, snap)
    lc = sys_.loopclosing
    s0 = lc.s
    if variant == "frozen":
        lc.s = dataclasses.replace(s0, loop_threshold_higher=2.0)
    elif variant == "identity C":
        eye = np.eye(3, 4, dtype=np.float32)
        correct, apply = lc._correct_active_impl, sys_.apply_loop_correction
        lc._correct_active_impl = (lambda kf, lm, lv, C: correct(
            kf, lm, lv, torch.as_tensor(eye, device=C.device)))
        sys_.apply_loop_correction = (
            lambda loopclosing, m, C, relink=None:
            apply(loopclosing, m, eye, relink=relink))
    try:
        healths = drive(sys_, L, R, cut, end)
    finally:
        lc.s = s0
        if variant == "identity C":
            del lc._correct_active_impl, sys_.apply_loop_correction
    return dict(healths=healths, n_loops=sys_.stats["n_loops"],
                status=int(sys_.status))


VARIANTS = ("frozen", "live", "identity C")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)
    dev = tools.tool_device("torch_probe_tail_divergence", args.device)
    card = tools.card_line(dev)
    print(card)
    s = loop5.small_settings()
    _, L, R = render(s, END, dev)
    sys_ = System(s, enable_backend=True, enable_loop_closing=True,
                  device=dev)
    with torch.no_grad():
        drive(sys_, L, R, 0, CUT)
        sys_.finish()
        print(f"state at cut {CUT}: n_loops {sys_.stats['n_loops']}, "
              f"health {sys_.track_health}", flush=True)
        snap = tools.snapshot(sys_)
        out = {}
        for v in VARIANTS:
            out[v] = r = tail(sys_, snap, L, R, CUT, END, v)
            print(f"{v:12s}: healths={r['healths']} n_loops={r['n_loops']} "
                  f"status={r['status']}", flush=True)
    base = out["frozen"]["healths"]
    for v in VARIANTS[1:]:
        out[v]["min_health_vs_frozen"] = min(
            (a - b for a, b in zip(out[v]["healths"], base)
             if a is not None and b is not None), default=None)
    res = dict(card=card, device=str(dev), cut=CUT, end=END,
               tails=out)
    print("TAIL " + json.dumps(res))
    return res


if __name__ == "__main__":
    main()
