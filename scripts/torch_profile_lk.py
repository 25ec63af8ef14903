#!/usr/bin/env python
"""LK tracking and image upload on the bench's rendered imagery (the port's
counterpart of scripts/profile_lk.py).

The bench's sequence (torch_profile_engine.bench_frames) at
profile_lk.py's settings (Settings() with 512 features, 8192 landmarks)
is rendered on the device; corners are detected on frame 0 as the
keyframe step detects them (`_detect_merge`), then `lk.track` runs
forward (frame 0 to 1) and forward + backward (the gate's pair of tracks)
on the temporal pair at 1 to 4 pyramid levels (the bench tracks at 3
temporally and at 4 in stereo) and on the stereo pair at the stereo
level count: the median ms of `--reps` calls (CUDA events on a CUDA
device) and the kernel launches a call makes. Then the upload of 8
frames, uint8 (as the chunk path ships them) against float32, and the
host padding of 8 frames into one buffer (System._pad_stack).

It runs on the current CUDA device unless --device names another
(--device cpu for the CPU); without a CUDA device and without --device it
raises.

Usage: python scripts/torch_profile_lk.py [--reps 20] [--device cpu]
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
import torch_profile_stages as tps  # noqa: E402
from ssvio_tpu_torch.ops import lk  # noqa: E402
from ssvio_tpu_torch.system import System  # noqa: E402
from ssvio_tpu_torch.utils import profiling  # noqa: E402
import torch_tools as tools  # noqa: E402

UPLOAD_FRAMES = 8


def _timed(fn, reps, dev) -> dict:
    ms = profiling.timeit(fn, n=reps, warmup=1, device=dev)
    n0 = tools.launch_counts()
    fn()
    return dict(ms=ms, launches_per_call={
        k: v for k, v in tools.launches_since(n0).items() if v})


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)
    dev = tools.tool_device("torch_profile_lk", args.device)
    card = tools.card_line(dev)
    print(card)
    s = tps.settings()
    sys_ = System(s, enable_backend=True, enable_loop_closing=False,
                  device=dev)
    front = sys_.frontend
    _, L, R = tpe.bench_frames(s, 2, dev, (sys_.h, sys_.w))
    out = {}
    with torch.no_grad():
        pyr0, pyr1, pyrr = (front._build_pyramid(x) for x in (L[0], L[1],
                                                               R[0]))
        feat = front.detect_features(pyr0.levels[0])
        xy, valid = feat.xy, feat.valid
        print(f"valid features: {int(valid.sum())}")
        prm = front.lk_params

        def fwd_bwd(a, b, params):
            new, ok, _ = lk.track(a.levels, b.levels, xy, xy, valid, params,
                                  compute_err=False, grads_prev=a.grads)
            return lk.track(b.levels, a.levels, new, new, valid & ok, params,
                            compute_err=False, grads_prev=b.grads)
        for n_lv in range(1, front.lk_params_stereo.levels + 1):
            pl = prm._replace(levels=n_lv)
            out[f"temporal fwd, {n_lv} levels"] = _timed(
                lambda: lk.track(pyr0.levels, pyr1.levels, xy, xy, valid, pl,
                                 compute_err=False, grads_prev=pyr0.grads),
                args.reps, dev)
            out[f"temporal fwd+bwd, {n_lv} levels"] = _timed(
                lambda: fwd_bwd(pyr0, pyr1, pl), args.reps, dev)
        ps = front.lk_params_stereo
        out[f"stereo fwd, {ps.levels} levels"] = _timed(
            lambda: lk.track(pyr0.levels, pyrr.levels, xy, xy, valid, ps,
                             grads_prev=pyr0.grads), args.reps, dev)
        out[f"stereo fwd+bwd, {ps.levels} levels"] = _timed(
            lambda: fwd_bwd(pyr0, pyrr, ps), args.reps, dev)

        host = [np.asarray(L[i % 2].cpu()) for i in range(UPLOAD_FRAMES)]
        u8 = np.clip(np.stack(host), 0, 255).astype(np.uint8)
        f32 = np.stack(host).astype(np.float32)
        for tag, arr in (("u8", u8), ("f32", f32)):
            src = torch.from_numpy(arr)
            out[f"upload {tag} [{UPLOAD_FRAMES}, H, W] pageable"] = _timed(
                lambda: src.to(dev), args.reps, dev)
        out[f"host pad x{UPLOAD_FRAMES} (_pad_stack)"] = _timed(
            lambda: sys_._pad_stack([a[:s.image_height, :s.image_width]
                                     for a in u8]), args.reps, dev)
    for name, r in out.items():
        print(f"{name:40s} {r['ms']:8.3f} ms  launches/call "
              f"{r['launches_per_call']}")
    res = dict(card=card, device=str(dev), n_valid=int(valid.sum()),
               timings=out)
    print("LK " + json.dumps(res))
    return res


if __name__ == "__main__":
    main()
