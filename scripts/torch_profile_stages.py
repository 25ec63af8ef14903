#!/usr/bin/env python
"""Each per-frame stage of the port's engine step alone, after warm-up
(the port's counterpart of scripts/profile_stages.py).

On profile_stages.py's seeded inputs (numpy seed 0, drawn in its order:
two random images, 512 feature positions, 8192 landmarks, 512 pixel
observations) at its settings (Settings() with 512 features and 8192
landmarks: 1241x376 padded to 1248x384), it times `_build_pyramid`,
`_track_step`, `lk.track` forward, `ba.pose_only_optimize`,
`_keyframe_core` (the keyframe step), `fast.detect_grid` and `local_ba`
(on the window the keyframe step leaves), each called op by op, then the
two branches as the engine runs them by default: `Frontend.track_frame`
(undistortion, pyramid, `_track_step`) replayed from its CUDA graph
(graphs.TrackGraph) and the keyframe branch of a steady keyframe frame
(`Engine.keyframe_branch`: the right pyramid, `_keyframe_core`, the
5 x 10 local BA, whose graph skips the rounds after the inlier-ratio
flag) eagerly and replayed from its graph
(graphs.KeyframeGraph), and `pose_only_optimize` and `local_ba` replayed
from graphs of their own (graphs.StaticGraph; on the CPU every graph runs
uncaptured): the median of `--reps` calls (local BA and the keyframe
branch 5), each
timed by CUDA events on a CUDA device (profiling.timeit), and the kernel
launches one call makes. It runs on the current CUDA device unless
--device names another (--device cpu for the CPU); without a CUDA device
and without --device it raises.

Usage: python scripts/torch_profile_stages.py [--reps 20] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import OrderedDict

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ssvio_tpu_torch import engine as eng  # noqa: E402
from ssvio_tpu_torch import frontend as fe  # noqa: E402
from ssvio_tpu_torch import graphs  # noqa: E402
from ssvio_tpu_torch import map as mapmod  # noqa: E402
from ssvio_tpu_torch.config import Settings  # noqa: E402
from ssvio_tpu_torch.ops import ba, fast, lk, se3  # noqa: E402
from ssvio_tpu_torch.utils import profiling  # noqa: E402
import torch_tools as tools  # noqa: E402

BA_REPS = 5
BA_STAGES = ("local_ba", "keyframe_branch", "keyframe_frame graph",
             "local_ba graph")


def settings() -> Settings:
    """profile_stages.py's: Settings() at 512 features, 8192 landmarks."""
    s = Settings()
    s.max_features = 512
    s.max_landmarks = 8192
    return s


def padded_dims(s) -> tuple:
    """(w, h): the image dims rounded up to 2^(lk_levels + 1), as the
    System pads them."""
    div = 2 ** (s.lk_levels + 1)
    return (-(-s.image_width // div) * div, -(-s.image_height // div) * div)


def inputs(s, w: int, h: int) -> dict:
    """profile_stages.py's inputs as numpy arrays, drawn from seed 0 in its
    order: img, img2 [h, w]; xy [n, 2]; lm_pos [M, 3]; uv [n, 2]."""
    rng = np.random.default_rng(0)
    f32 = np.float32
    img = rng.uniform(0, 255, (h, w)).astype(f32)
    img2 = rng.uniform(0, 255, (h, w)).astype(f32)
    n, M = s.max_features, s.max_landmarks
    xy = np.stack([rng.uniform(20, w - 20, n),
                   rng.uniform(20, h - 20, n)], -1).astype(f32)
    lm_pos = np.stack([rng.uniform(-5, 5, M), rng.uniform(-2, 2, M),
                       rng.uniform(5, 40, M)], -1).astype(f32)
    uv = rng.uniform(0, 300, (n, 2)).astype(f32)
    return dict(img=img, img2=img2, xy=xy, lm_pos=lm_pos, uv=uv)


def stages(front: fe.Frontend, inp: dict) -> "OrderedDict[str, callable]":
    """The stages as closures over `inp` (numpy, from `inputs`) on the
    frontend's device, in profile_stages.py's order."""
    s, dev = front.s, front.device
    t = {k: torch.from_numpy(v).to(dev) for k, v in inp.items()}
    n, M = s.max_features, s.max_landmarks
    feat = fe.FeatState(
        xy=t["xy"], lm_slot=torch.arange(n, dtype=torch.int32, device=dev),
        lm_gid=torch.arange(n, dtype=torch.int32, device=dev),
        valid=torch.ones(n, dtype=torch.bool, device=dev),
        octave=torch.zeros(n, dtype=torch.int32, device=dev))
    m = mapmod.empty_map(s.max_window, M, dev)._replace(
        lm_pos=t["lm_pos"], lm_valid=torch.ones(M, dtype=torch.bool,
                                                device=dev),
        lm_gid=torch.arange(M, dtype=torch.int32, device=dev))
    eye = se3.identity(device=dev)
    pyr = front._build_pyramid(t["img"])
    pyr2 = front._build_pyramid(t["img2"])
    occ = torch.zeros((front.h, front.w), dtype=torch.bool, device=dev)
    m2 = front._keyframe_core(pyr, pyr2, feat, eye, m)[1]
    prob = mapmod.ba_problem_from_map(m2)
    track_args = (pyr, feat, eye, eye, m.lm_pos, m.lm_valid, m.lm_gid)
    track_graph = graphs.TrackGraph(front, t["img2"], *track_args)

    def lm(T, p_w, uv, valid):
        return ba.pose_only_optimize(T, p_w, uv, valid, front._fx, front._fy,
                                     front._cx, front._cy)
    lm_args = (eye, t["lm_pos"][:n], t["uv"], feat.valid)
    lm_graph = graphs.StaticGraph(lm, *lm_args)
    # the keyframe branch of a steady keyframe: img2 as the right frame
    engine = eng.Engine(front, enable_backend=True)
    kf_args = (t["img2"], pyr, feat, eye, eye, m)
    kf_graph = graphs.KeyframeGraph(engine.keyframe_branch, *kf_args)

    def bundle(p):
        return ba.local_ba(p, front._fx, front._fy, front._cx, front._cy,
                           front._baseline)
    ba_graph = graphs.StaticGraph(bundle, prob)
    return OrderedDict([
        ("build_pyramid", lambda: front._build_pyramid(t["img"])),
        ("track_step", lambda: front._track_step(
            pyr, pyr2, feat, eye, eye, m.lm_pos, m.lm_valid, m.lm_gid)),
        ("lk.track fwd", lambda: lk.track(pyr.levels, pyr2.levels, feat.xy,
                                          feat.xy, feat.valid,
                                          front.lk_params)),
        ("pose_only_optimize", lambda: ba.pose_only_optimize(
            eye, t["lm_pos"][:n], t["uv"], feat.valid, front._fx, front._fy,
            front._cx, front._cy)),
        ("keyframe_step", lambda: front._keyframe_core(pyr, pyr2, feat, eye,
                                                       m)),
        ("fast.detect_grid", lambda: fast.detect_grid(
            pyr.levels[0], max_kps=n, cell=s.grid_cell,
            ini_threshold=float(s.ini_th_fast),
            min_threshold=float(s.min_th_fast), occupancy=occ,
            kps_per_cell=4)),
        ("local_ba", lambda: ba.local_ba(prob, front._fx, front._fy,
                                         front._cx, front._cy,
                                         front._baseline)),
        ("track_frame graph", lambda: track_graph(t["img2"], *track_args)),
        ("pose_only_optimize graph", lambda: lm_graph(*lm_args)),
        ("keyframe_branch", lambda: engine.keyframe_branch(
            *kf_args, is_init=False)),
        ("keyframe_frame graph", lambda: kf_graph(*kf_args)),
        ("local_ba graph", lambda: ba_graph(prob)),
    ])


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)
    dev = tools.tool_device("torch_profile_stages", args.device)
    card = tools.card_line(dev)
    print(card)
    s = settings()
    w, h = padded_dims(s)
    front = fe.Frontend(s, w, h, s.image_width, s.image_height, device=dev)
    out = OrderedDict()
    with torch.no_grad():
        for name, fn in stages(front, inputs(s, w, h)).items():
            reps = BA_REPS if name in BA_STAGES else args.reps
            ms = profiling.timeit(fn, n=reps, warmup=1, device=dev)
            n0 = tools.launch_counts()
            fn()
            launched = {k: v for k, v in tools.launches_since(n0).items()
                        if v}
            out[name] = dict(ms=ms, reps=reps, launches_per_call=launched)
            print(f"{name:28s} {ms:8.2f} ms  launches/call {launched}")
    res = dict(card=card, device=str(dev), image=f"{w}x{h}",
               n_features=s.max_features, n_landmarks=s.max_landmarks,
               stages=out)
    print("STAGES " + json.dumps(res))
    return res


if __name__ == "__main__":
    main()
