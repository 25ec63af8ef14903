#!/usr/bin/env python
"""Cost structure of the port's LK level kernels (the port's counterpart
of scripts/profile_lk_kernel.py, profile_lk_kernels.py, profile_lk_mm.py
and profile_lk_vmem.py).

On scripts/torch_lk_kernel_outputs.py's inputs (a smooth random texture
moved by (2.3, -1.4) px a level-0 pixel, 512 keypoints; `_inputs`), every
flavour's kernel at the bench's window (11): serial (#1), sw (#3), pk
(ymm / pkmm, #4), mm and mm_f32 (#5) at KITTI level 0 (384x1248), and
kernel #2 (patch) at RobotCar XB3 level 0 (960x1280). For each, the
device time of one launch (torch_lk_kernel_outputs._device_ms: the
profiler's mean over 20 launches) against
- iterations (ITERS), with the longest keypoint chain at each (counted by
  the plain version) and a least-squares line through (chain, ms): the
  slope, us an iteration of the chain, and the fixed part at no iteration
  (the staged region's load and the template, which every launch pays);
- live keypoints (LIVE) of the 512, at 30 iterations;
- easy flow (the shifted texture) against hard flow (independent noise,
  tracks step to the cap), at 30 iterations;
- each level of the bench's 4-level pyramid (the serial and flavour
  kernels; #2 runs at level 0 only), at 30 iterations.
torch_lk_kernel_outputs.py already gives the device time at 30 and 1
iterations and compares checkouts; this adds the sweeps.

Needs a CUDA device for device times. With --device cpu the kernels'
plain versions run and the times are host-clock medians (profiling.timeit),
not device times. Without a CUDA device and without --device it raises.

Usage: python scripts/torch_profile_lk_kernels.py [--reps 20] [--device cpu]
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

import torch_lk_kernel_outputs as tlo  # noqa: E402
from ssvio_tpu_torch.utils import profiling  # noqa: E402
import torch_tools as tools  # noqa: E402

WIN = 11
ITERS = (1, 5, 10, 20, 30)
LIVE = (64, 128, 256, 512)
KITTI_LEVELS = tlo.LEVELS
ROBOTCAR_LEVEL0 = ((960, 1280),)
KERNELS = ("serial", "sw", "pk", "mm", "mm_f32", "patch")   # all swept


def _line(chains, ms):
    """(slope us per chain iteration, fixed ms): least squares of ms on
    the chain; None where the chains do not vary."""
    x = np.asarray(chains, np.float64)
    if np.ptp(x) == 0:
        return None, None
    slope, fixed = np.polyfit(x, np.asarray(ms, np.float64), 1)
    return 1e3 * float(slope), float(fixed)


def _live(level, n):
    """`level` with only its first n keypoints live."""
    planes, pts, guess, frozen0, padded = level
    frozen = torch.ones_like(frozen0)
    frozen[:n] = frozen0[:n]
    return planes, pts, guess, frozen, padded


def sweep(name, dev, reps, inputs) -> dict:
    """Every sweep of one kernel; inputs(levels, hard) gives
    torch_lk_kernel_outputs._inputs of those levels (all 512 keypoints
    live)."""
    def ms_of(level, iters):
        planes, pts, guess, frozen0, padded = level
        kern, _ = tlo._runners(name, planes, pts, guess, frozen0, padded,
                               WIN)
        if dev.type == "cuda":
            return tlo._device_ms(lambda: kern(iters), reps=reps)
        return profiling.timeit(lambda: kern(iters), n=max(1, reps // 10),
                                warmup=0, device=dev)

    def chain_of(level, iters):
        planes, pts, guess, frozen0, padded = level
        _, plain = tlo._runners(name, planes, pts, guess, frozen0, padded,
                                WIN)
        return tlo._chain(plain, iters)

    levels = ROBOTCAR_LEVEL0 if name == "patch" else KITTI_LEVELS
    easy = inputs(levels, False)
    lv0 = easy[0]
    it = [dict(iters=i, ms=ms_of(lv0, i), chain=chain_of(lv0, i))
          for i in ITERS]
    slope, fixed = _line([r["chain"] for r in it], [r["ms"] for r in it])
    live = [dict(live=n, ms=ms_of(_live(lv0, n), 30)) for n in LIVE]
    hard = inputs(levels[:1], True)[0]
    flow = dict(easy=dict(ms=it[-1]["ms"], chain=it[-1]["chain"]),
                hard=dict(ms=ms_of(hard, 30), chain=chain_of(hard, 30)))
    per_level = [dict(level=l, hw=list(levels[l]), ms=ms_of(easy[l], 30))
                 for l in range(len(easy))]
    return dict(level0=list(levels[0]), iters=it, us_per_iter=slope,
                fixed_ms=fixed, live=live, flow=flow, per_level=per_level)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--reps", type=int, default=20,
                   help="launches a device time averages")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)
    dev = tools.tool_device("torch_profile_lk_kernels", args.device)
    card = tools.card_line(dev)
    print(card)
    timer = ("torch.profiler device ms a launch" if dev.type == "cuda"
             else "host-clock ms a call of the plain version (CPU)")
    made = {}

    def inputs(levels, hard):
        if (levels, hard) not in made:
            made[levels, hard] = tlo._inputs(dev, levels, n_live=tlo.N_KP,
                                             hard=hard)
        return made[levels, hard]
    out = {}
    with torch.no_grad():
        for name in KERNELS:
            r = out[name] = sweep(name, dev, args.reps, inputs)
            print(f"[{name}] level 0 {r['level0']}: " + ", ".join(
                f"{x['iters']} it {x['ms']:.4f} ms (chain {x['chain']})"
                for x in r["iters"]))
            print(f"  slope {r['us_per_iter']} us/iteration, fixed "
                  f"{r['fixed_ms']} ms")
            print("  live: " + ", ".join(f"{x['live']} {x['ms']:.4f}"
                                         for x in r["live"]))
            print(f"  easy {r['flow']['easy']}  hard {r['flow']['hard']}")
            print("  levels: " + ", ".join(
                f"{x['level']} {x['hw']} {x['ms']:.4f}"
                for x in r["per_level"]))
    res = dict(card=card, device=str(dev), timer=timer, window=WIN,
               kernels=out)
    print("LK_KERNELS " + json.dumps(res))
    return res


if __name__ == "__main__":
    main()
