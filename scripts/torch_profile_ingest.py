#!/usr/bin/env python
"""The loop closer's keyframe ingest, part by part (the port's counterpart
of scripts/profile_ingest.py).

At the bench's loop-closing scale (`config.bench_loop_settings()`: 512
features, Settings.loop_desc_scales octaves, KITTI 1241x376 padded to
1248x384), on profile_ingest.py's seeded inputs (numpy seed 0: a random
image, 512 feature positions), it times on the device:
- `loopclosing.loop_describe` of one keyframe (the descriptor ladder; the
  port's engine runs it in the keyframe branch, the JAX package in its
  ingest);
- the BoW transform of one keyframe (`loopclosing.transform_rows`), with a
  vocabulary trained on 30 copies of 400 of its descriptors, as there;
- the database score of one keyframe (`bow.score_l1_database`);
- the ingest of a batch of B = BATCH (4) keyframes (`LoopClosing._ingest_impl_v`:
  store, transform, score against the database under the age gate), and
  describe x B + that ingest, the whole of what a batch costs.
Each is the median of `--reps` calls (CUDA events on a CUDA device). It
runs on the current CUDA device unless --device names another (--device
cpu for the CPU); without a CUDA device and without --device it raises.

Usage: python scripts/torch_profile_ingest.py [--reps 5] [--device cpu]
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

from ssvio_tpu_torch import map as mapmod  # noqa: E402
from ssvio_tpu_torch.config import bench_loop_settings  # noqa: E402
from ssvio_tpu_torch.loopclosing import LoopClosing, transform_rows  # noqa: E402
from ssvio_tpu_torch.ops import bow  # noqa: E402
from ssvio_tpu_torch.utils import profiling  # noqa: E402
import torch_tools as tools  # noqa: E402

VOCAB_DOCS, VOCAB_ROWS = 30, 400
BATCH = 4                    # keyframes an ingest takes (B)


def settings():
    return bench_loop_settings()


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)
    dev = tools.tool_device("torch_profile_ingest", args.device)
    card = tools.card_line(dev)
    print(card)
    s = settings()
    B = BATCH
    cam = s.cam_left
    lc = LoopClosing(s, cam.fx, cam.fy, cam.cx, cam.cy, device=dev)
    H = -(-s.image_height // 16) * 16
    W = -(-s.image_width // 16) * 16
    F = s.max_features
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32)
                           ).to(dev)
    xy = torch.from_numpy(np.stack([rng.uniform(30, W - 30, F),
                                    rng.uniform(30, H - 30, F)], -1)
                          .astype(np.float32)).to(dev)
    valid = torch.ones(F, dtype=torch.bool, device=dev)
    print(f"B={B} F={F} scales={lc.S} img={H}x{W}")

    def t(fn):
        return profiling.timeit(fn, n=args.reps, warmup=1, device=dev)
    out = {}
    with torch.no_grad():
        out["describe_ms"] = t(lambda: lc._describe(img, xy, valid))
        desc, dval = lc._describe(img, xy, valid)
        rows = desc[dval].cpu().numpy()[:VOCAB_ROWS].view(np.uint32)
        lc.vocab = bow.train([rows] * VOCAB_DOCS, k=s.vocab_k,
                             levels=s.vocab_levels, seed=7).to(dev)
        lc._vocab_levels = s.vocab_levels
        lc.bow_db = torch.zeros((lc.cap, lc.vocab.n_words),
                                dtype=torch.float32, device=dev)
        descs, dvals = desc[None].expand(B, -1, -1), dval[None].expand(B, -1)
        out["transform_ms"] = t(lambda: transform_rows(
            lc.vocab, descs[:1], dvals[:1], lc._vocab_levels))
        v = transform_rows(lc.vocab, descs[:1], dvals[:1], lc._vocab_levels)[0]
        age_ok = torch.ones(lc.cap, dtype=torch.bool, device=dev)
        out["score_ms"] = t(lambda: bow.score_l1_database(v, lc.bow_db,
                                                          age_ok))
        m = mapmod.empty_map(s.max_window, s.max_landmarks, dev)
        i32 = dict(dtype=torch.int32, device=dev)
        xys = xy[None].expand(B, -1, -1)
        valids = valid[None].expand(B, -1)
        slots = torch.full((B, F), -1, **i32)
        gids = torch.arange(100, 100 + B, **i32)
        refresh = torch.full((s.max_window,), -1, **i32)

        def ingest():
            # the same rows each call: the database does not fill up
            return lc._ingest_impl_v(
                lc.desc_db, lc.desc_valid, lc.kp_xy, lc.lm_pos, lc.lm_has,
                lc.lm_gid_db, lc.bow_db, lc.db_gid_dev, 0, descs, dvals,
                xys, valids, slots, slots, m.lm_pos, m.lm_gid, m.lm_valid,
                lc.vocab, gids, refresh, min_age=int(s.loop_min_age),
                levels=lc._vocab_levels)
        out["ingest_ms"] = t(ingest)
    out["describe_x_b_plus_ingest_ms"] = B * out["describe_ms"] + \
        out["ingest_ms"]
    for k, v in out.items():
        print(f"{k:30s} {v:9.2f} ms")
    res = dict(card=card, device=str(dev), batch=B, features=F,
               scales=lc.S, image=f"{W}x{H}", words=lc.vocab.n_words, **out)
    print("INGEST " + json.dumps(res))
    return res


if __name__ == "__main__":
    main()
