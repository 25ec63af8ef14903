#!/usr/bin/env python
"""Where a tracked frame's time goes, by ablation: chunks of frames with
progressively more of the tracking step turned on (the port's counterpart
of scripts/profile_scan_ablation.py).

The bench's sequence (torch_profile_engine.bench_frames, bench_settings())
is rendered on the device; a System initialises on its first frame, and
that state (its carry) starts every variant afresh, so no variant changes
what another sees. Over the next `--chunk` frames:
  1. pyramid: `_build_pyramid` of each frame;
  2. + forward LK from the previous frame (the carry's live features);
  3. + backward LK and the forward-backward gate's inputs;
  4. + the pose-only LM on the tracks both ways kept;
  5. full: `Engine.run_chunk`, the whole step (keyframes and BA where the
     status machine asks).
Each variant synchronises the device once a chunk (the port's LK and LM
also read the host inside); ms a chunk and a frame are the median of
`--reps` chunks (profiling.timeit; the initialising frame warmed the
device up). The JAX script scans random images in
one compiled program; these are the bench's frames, so the full step
tracks and takes its keyframes as a run does.

The full variant is checked against `System.run_step` on the same frames
from the same state: equal statuses, positions within POS_TOL_M (the same
step; BA's atomics may reorder sums on a GPU). A mismatch raises.

The System runs eagerly (`System(eager=True)`): the variants are pieces
of the step called one by one, and the full variant is held against the
same path; the tracking graph (graphs.py) is timed by
torch_profile_engine.py and torch_profile_stages.py.

It runs on the current CUDA device unless --device names another
(--device cpu for the CPU); without a CUDA device and without --device it
raises.

Usage: python scripts/torch_profile_ablation.py [--chunk 32] [--reps 3]
           [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_profile_engine as tpe  # noqa: E402
from ssvio_tpu_torch import frontend as fe  # noqa: E402
from ssvio_tpu_torch.ops import ba, lk, se3  # noqa: E402
from ssvio_tpu_torch.system import System  # noqa: E402
from ssvio_tpu_torch.utils import profiling  # noqa: E402
import torch_tools as tools  # noqa: E402

POS_TOL_M = 1e-6


def variants(system: System, carry, imgs_l, imgs_r, last: dict):
    """The five variants as closures over the chunk (device stacks), each
    from `carry`; each returns its last result after one device sync. The
    full variant also leaves run_chunk's result in last["full"]."""
    f = system.frontend
    dev = f.device
    lm_idx = fe._link(carry.feat.lm_slot, carry.m.lm_pos.shape[0])
    xy = carry.feat.xy
    valid = carry.feat.valid & (carry.feat.lm_slot >= 0)
    p_w = carry.m.lm_pos[lm_idx]
    T0 = carry.T_cw
    prm = f.lk_params

    def chain(depth):
        def run():
            prev, out = carry.pyr_last, None
            for img in imgs_l:
                pyr = f._build_pyramid(img.to(torch.float32))
                out = pyr
                if depth >= 2:
                    new_xy, ok, _ = lk.track(prev.levels, pyr.levels, xy, xy,
                                             valid, prm, compute_err=False,
                                             grads_prev=prev.grads)
                    out = new_xy
                if depth >= 3:
                    _, ok_b, _ = lk.track(pyr.levels, prev.levels, new_xy,
                                          new_xy, valid & ok, prm,
                                          compute_err=False,
                                          grads_prev=pyr.grads)
                    out = ok_b
                if depth >= 4:
                    out = ba.pose_only_optimize(T0, p_w, new_xy, ok & ok_b,
                                                f._fx, f._fy, f._cx, f._cy)
                prev = pyr
            tools.synchronize(dev)
            return out
        return run

    def full():
        last["full"] = system._engine.run_chunk(carry, imgs_l, imgs_r)
        tools.synchronize(dev)
        return last["full"]
    return [("pyramid", chain(1)), ("+ forward LK", chain(2)),
            ("+ backward LK", chain(3)), ("+ pose-only LM", chain(4)),
            ("full step", full)]


def check_full(s, dev, carry, imgs_l, imgs_r, outs) -> dict:
    """The full variant's statuses and positions against run_step on a
    System given the same state and frames. Both poses T_cw are read back
    and inverted on the host alike (inverting one [3, 4] pose on the card
    and a stack of them can round a position one ulp apart)."""
    ref = System(s, enable_backend=True, enable_loop_closing=False,
                 device=dev, eager=True)
    ref._install(carry)
    st, T_ref = [], []
    for a, b in zip(imgs_l, imgs_r):
        ref.run_step(a, b)
        st.append(ref.status)
        T_ref.append(ref.T_cw.cpu().numpy())
    mine = se3.inverse_np(outs.T_cw.cpu().numpy())[:, :, 3]
    d = float(np.abs(mine - se3.inverse_np(np.stack(T_ref))[:, :, 3]).max())
    got = [int(v) for v in outs.status]
    res = dict(statuses=got, statuses_equal=got == st, max_position_diff_m=d)
    if got != st or not d <= POS_TOL_M:
        raise AssertionError(f"ablation: the full variant differs from "
                             f"run_step: {res} against {st}")
    return res


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--chunk", type=int, default=32)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)
    dev = tools.tool_device("torch_profile_ablation", args.device)
    card = tools.card_line(dev)
    print(card)
    s = tpe.settings()
    K = args.chunk
    system = System(s, enable_backend=True, enable_loop_closing=False,
                    device=dev, eager=True)
    print(f"tracking path: {system._engine.tracking_path} (pieces of the "
          "step turned on one by one)")
    _, L, R = tpe.bench_frames(s, K + 1, dev, (system.h, system.w))
    out = {}
    with torch.no_grad():
        system.run_step(L[0], R[0])
        if system.status != fe.TRACKING_GOOD:
            raise RuntimeError("ablation: the System did not initialise on "
                               "the first frame")
        carry = system._carry()
        imgs_l, imgs_r = L[1:], R[1:]
        last = {}
        # the first frame warmed the device up
        for name, fn in variants(system, carry, imgs_l, imgs_r, last):
            ms = profiling.timeit(fn, n=args.reps, warmup=0, device=dev)
            out[name] = dict(ms_per_chunk=ms, ms_per_frame=ms / K)
            print(f"{name:24s} {ms:9.1f} ms/chunk  {ms / K:7.2f} ms/frame")
        check = check_full(s, dev, carry, imgs_l, imgs_r, last["full"][1])
    print(f"full vs run_step: statuses equal, max position difference "
          f"{check['max_position_diff_m']:.3g} m")
    res = dict(card=card, device=str(dev), chunk=K, reps=args.reps,
               path=system._engine.tracking_path,
               variants=out, full_vs_run_step=check)
    print("ABLATION " + json.dumps(res))
    return res


if __name__ == "__main__":
    main()
