#!/usr/bin/env python
"""A rigid gauge correction applied between chunks must leave the later
tracking unchanged: the map and the pose move together, so every
reprojection is the same (the port's counterpart of
scripts/probe_gauge_invariance.py).

The scene is scripts/torch_repro_loop5.py's (`small_settings`: 320x128,
192 features; world seed 11; a 6 m circle of 120 frames, then its first
frames again: the tail probe's `render`), rendered on the device, with loop closing on but no candidate able
to pass (loop_threshold_higher 2.0: BoW scores are <= 1), so the only
gauge change is the probe's. Frames 0..--prefix run through run_chunk in
chunks of 10; a snapshot of the state is taken (torch_tools.snapshot). Then frames --prefix..--end, three times from it:
  baseline:  as they are;
  corrected: after a rigid correction C (se3.exp of a fixed twist: 0.4 m,
             0.05 rad) applied as the loop closer applies one
             (`_correct_active_impl`, `System.apply_loop_correction`);
  pipelined: the first chunk dispatched first and C applied while it is in
             flight (to the map it leaves), then collected (collect_chunk
             re-gauges its poses) and the rest run.
Each gives the health (median tracked inlier count) after every chunk and
the camera pose T_cw after every frame. Invariance: the same healths, and
poses equal up to the gauge, T_cw' = T_cw C, within POSE_TOL_M in
translation (and rotation entries). A difference is reported, not raised.

It runs on the current CUDA device unless --device names another
(--device cpu for the CPU); without a CUDA device and without --device it
raises.

Usage: python scripts/torch_probe_gauge_invariance.py [--prefix 100]
           [--end 160] [--device cpu]
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

import torch_probe_tail_divergence as tail_probe  # noqa: E402
import torch_repro_loop5 as loop5  # noqa: E402
from ssvio_tpu_torch.ops import se3  # noqa: E402
from ssvio_tpu_torch.system import System  # noqa: E402
import torch_tools as tools  # noqa: E402

CHUNK = 10
TWIST = (0.4, -0.2, 0.3, 0.03, 0.05, -0.02)     # probe_gauge_invariance.py's
POSE_TOL_M = 1e-3     # chip_smoke.py's CHUNK_VS_STEP_M: the corrected run
                      # solves in another gauge, so its float32 rounding differs


def settings():
    s = loop5.small_settings()
    s.loop_threshold_higher = 2.0
    return s


def _correct(sys_: System, C: torch.Tensor):
    """Apply C as the loop closer applies an accepted correction."""
    m = sys_.map
    lc = sys_.loopclosing
    kf, lm = lc._correct_active_impl(m.kf_pose, m.lm_pos, m.lm_valid, C)
    sys_.apply_loop_correction(lc, m._replace(kf_pose=kf, lm_pos=lm),
                               C.cpu().numpy())


def _run(sys_, L, R, a, b, C=None, pipelined=False):
    """Frames a..b in chunks through run_chunk, or with `pipelined` the
    first through dispatch_chunk / collect_chunk: (healths after each
    chunk, T_cw [n, 3, 4]). C: applied before the first chunk, or with
    `pipelined` while it is in flight."""
    healths, poses = [], []
    if C is not None and not pipelined:
        _correct(sys_, C)
    for c in range(a, b, CHUNK):
        if pipelined and c == a:
            h = sys_.dispatch_chunk(L[c:c + CHUNK], R[c:c + CHUNK])
            if C is not None:
                _correct(sys_, C)
            T_wc = sys_.collect_chunk(h)
        else:
            T_wc = sys_.run_chunk(L[c:c + CHUNK], R[c:c + CHUNK])
        poses.append(se3.inverse_np(T_wc))
        healths.append(None if sys_.track_health is None
                       else float(sys_.track_health))
    return healths, np.concatenate(poses)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--prefix", type=int, default=100)
    p.add_argument("--end", type=int, default=160)
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)
    if args.prefix % CHUNK or args.end % CHUNK or not \
            0 < args.prefix < args.end:
        p.error(f"--prefix < --end, multiples of {CHUNK}")
    dev = tools.tool_device("torch_probe_gauge_invariance", args.device)
    card = tools.card_line(dev)
    print(card)
    s = settings()
    _, L, R = tail_probe.render(s, args.end, dev)
    sys_ = System(s, enable_backend=True, enable_loop_closing=True,
                  device=dev)
    C = se3.exp(torch.tensor(TWIST, dtype=torch.float32, device=dev))
    C_np = C.cpu().numpy()
    runs = {}
    with torch.no_grad():
        for c in range(0, args.prefix, CHUNK):
            sys_.run_chunk(L[c:c + CHUNK], R[c:c + CHUNK])
        snap = tools.snapshot(sys_)
        for tag, kw in (("baseline", {}), ("corrected", dict(C=C)),
                        ("pipelined", dict(C=C, pipelined=True))):
            tools.restore(sys_, snap)
            runs[tag] = _run(sys_, L, R, args.prefix, args.end, **kw)
    base_h, base_T = runs["baseline"]
    want = se3.compose_np(base_T, C_np)          # T_cw' = T_cw C
    out = dict(card=card, device=str(dev), prefix=args.prefix, end=args.end,
               baseline_healths=base_h, pose_tol_m=POSE_TOL_M)
    for tag in ("corrected", "pipelined"):
        h, T = runs[tag]
        dh = [abs(a - b) for a, b in zip(h, base_h)
              if a is not None and b is not None]
        out[tag] = dict(
            healths=h, max_health_delta=max(dh) if dh else None,
            max_translation_delta_m=float(np.abs(T[:, :, 3]
                                                 - want[:, :, 3]).max()),
            max_rotation_delta=float(np.abs(T[:, :, :3]
                                            - want[:, :, :3]).max()))
        out[tag]["invariant"] = (
            h == base_h and out[tag]["max_translation_delta_m"] <= POSE_TOL_M
            and out[tag]["max_rotation_delta"] <= POSE_TOL_M)
        print(f"{tag:9s}: healths={h} max health delta "
              f"{out[tag]['max_health_delta']}, pose vs baseline C: "
              f"{out[tag]['max_translation_delta_m']:.3g} m, rotation "
              f"{out[tag]['max_rotation_delta']:.3g}; invariant "
              f"{out[tag]['invariant']}")
    print(f"baseline : healths={base_h}")
    print("GAUGE " + json.dumps(out))
    return out


if __name__ == "__main__":
    main()
