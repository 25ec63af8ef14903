#!/usr/bin/env python
"""One loop verification (`LoopClosing._complete_loop`'s match +
PnP-RANSAC + correction magnitude) timed stage by stage, op by op and as
the loop closer runs it: three CUDA graphs (`loopclosing.VerifyGraphs`)
with the two DLT fits op by op between them.

The scene (`scene`, seeded): a database at the loop cells' sizes
(`config.bench_loop_settings()`: 512 features, 8 descriptor octaves, KITTI
intrinsics) whose loop row holds 512 landmarks and whose current row sees
70% of them again from a pose 0.3 m and a few degrees away (their
descriptors with 5% of the bits flipped, keypoints at the projections
with 0.5 px of noise); the other 30% are new. The estimate given to the
verification is the truth moved by a twist of norm 0.3.

Stages, op by op: `match` (the [S F, S F] Hamming match, the landmark
mask and gather), `sampling` (the uniforms' draw and the Gumbel top-k),
`dlt_minimal`, `polish` (the 128 hypotheses' 5-step LM, scores and LO
weights), `dlt_refit`, `lo_pose_only` (LO scores, the best, the 4x10
pose-only LM, the correction magnitude and the pack); as replayed:
`copy_in` (the draw and the row copies), `graph_match`, `dlt_minimal`,
`graph_polish`, `dlt_refit`, `graph_finish`. For each: the host ms until
the call returns, the wall ms until the device is done (the call, then a
synchronise), the device ms between CUDA events around it, and the aten
ops it dispatches (a TorchDispatchMode's count: a replay dispatches only
its copies and clones). Then the whole verification, op by op
(`_verify_impl`) and replayed (`_verify`), by the wall clock over
`--reps` calls, and whether both give the same pack, matches and inliers.

It runs on the current CUDA device unless --device names another
(--device cpu for the CPU, where the graphs run uncaptured); without a
CUDA device and without --device it raises. Prints the card's line first
and `VERIFY {...}` last.

Usage: python scripts/torch_profile_verify.py [--reps 10] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from collections import OrderedDict

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ssvio_tpu_torch import config  # noqa: E402
from ssvio_tpu_torch import loopclosing as lcm  # noqa: E402
from ssvio_tpu_torch.ops import orb, pnp, se3  # noqa: E402
import torch_tools as tools  # noqa: E402

LOOP_ROW, CUR_ROW, ROWS = 1, 9, 12
SEEN = 0.7               # share of the current features that are revisits


def settings():
    """The loop cells' verification sizes: bench_loop_settings() with a
    database of 32 rows (its capacity does not enter a verification)."""
    s = config.bench_loop_settings()
    s.max_keyframes_db = 32
    return s


def _exp(xi) -> np.ndarray:
    return se3.exp(torch.as_tensor(np.asarray(xi, np.float32))).numpy()


def scene(lc: lcm.LoopClosing, seed: int = 0) -> dict:
    """Fill `lc`'s database with ROWS rows as the module docstring says.
    Returns the current features' xy and the estimate T_est (device
    tensors), the true pose T_true (numpy) and the rows."""
    rng = np.random.default_rng(seed)
    F, S, dev = lc.F, lc.S, lc.device
    fx, fy, cx, cy = lc._fx, lc._fy, lc._cx, lc._cy
    T_loop = _exp([0.5, 0.0, 2.0, 0.0, 0.2, 0.0])
    T_true = se3.compose_np(_exp([0.3, 0.0, 0.1, 0.0, 0.05, 0.0]), T_loop)
    T_est = se3.compose_np(_exp(0.3 * np.array([0.6, -0.2, 0.7, 0.05, 0.1,
                                                -0.05]) / 0.9452), T_true)
    # landmarks in front of the true pose, inside KITTI's 1241 x 376 image
    z = rng.uniform(5.0, 30.0, F)
    P_cam = np.stack([z * rng.uniform(-0.7, 0.7, F),
                      z * rng.uniform(-0.22, 0.22, F), z], -1)
    P = ((P_cam - T_true[:, 3]) @ T_true[:, :3]).astype(np.float32)
    perm = rng.permutation(F)
    seen = rng.random(F) < SEEN
    pc = P[perm] @ T_true[:, :3].T + T_true[:, 3]
    xy = np.stack([fx * pc[:, 0] / pc[:, 2] + cx,
                   fy * pc[:, 1] / pc[:, 2] + cy], -1)
    xy = np.where(seen[:, None], xy, rng.uniform([0, 0], [1241, 376],
                                                 (F, 2)))
    xy = (xy + rng.normal(0, 0.5, xy.shape)).astype(np.float32)

    desc = rng.integers(0, 2 ** 32, (ROWS, S, F, orb.DESC_WORDS),
                        dtype=np.uint32)
    cur = desc[LOOP_ROW][:, perm]
    flips = (rng.random(cur.shape + (32,)) < 0.05).astype(np.uint32)
    cur = cur ^ (flips << np.arange(32, dtype=np.uint32)).sum(
        -1, dtype=np.uint32)
    desc[CUR_ROW] = np.where(seen[None, :, None], cur, desc[CUR_ROW])

    def t(a):
        return torch.as_tensor(a, device=dev)

    lc.desc_db[:ROWS] = t(desc.reshape(ROWS, S * F, -1).view(np.int32))
    lc.desc_valid[:ROWS] = True
    lc.lm_pos[:ROWS] = t(rng.normal(0, 5, (ROWS, F, 3)).astype(np.float32))
    lc.lm_pos[LOOP_ROW] = t(P)
    lc.lm_has[:ROWS] = t(rng.random((ROWS, F)) < 0.7)
    lc.lm_has[LOOP_ROW] = True
    lc.n = ROWS
    return dict(xy=t(xy), T_est=t(T_est.astype(np.float32)), T_true=T_true,
                row=CUR_ROW, brow=LOOP_ROW)


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _timed(fn, dev):
    """(result, host ms to return, wall ms to done, device ms)."""
    cuda = dev.type == "cuda"
    tools.synchronize(dev)
    if cuda:
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
    t0 = time.perf_counter()
    out = fn()
    t1 = time.perf_counter()
    if cuda:
        b.record()
    tools.synchronize(dev)
    t2 = time.perf_counter()
    dev_ms = a.elapsed_time(b) if cuda else None
    return out, 1e3 * (t1 - t0), 1e3 * (t2 - t0), dev_ms


def _stage_table(lc, stages, dev, reps):
    """`stages` [(name, fn)] one after another, each fn given the one
    before's result (the first None), `reps` times from the generator's
    seed, then once more under the op counter (untimed); per stage the
    medians and the ops dispatched."""
    runs = {name: [] for name, _ in stages}
    for rep in range(reps + 1):
        lc._gen.manual_seed(17)
        x = None
        for name, fn in stages:
            if rep < reps:
                x, *m = _timed(lambda: fn(x), dev)
                runs[name].append(m)
            else:
                with _OpCount() as count:
                    x = fn(x)
                runs[name] = (runs[name], count.n)
    return OrderedDict(
        (k, dict(host_ms=statistics.median(m[0] for m in ms),
                 wall_ms=statistics.median(m[1] for m in ms),
                 device_ms=(None if ms[0][2] is None
                            else statistics.median(m[2] for m in ms)),
                 ops=n))
        for k, (ms, n) in runs.items())


def _eager_stages(lc, sc, dev, reps):
    """The stages op by op (the match split from its sampling)."""
    cam = (lc._fx, lc._fy, lc._cx, lc._cy)
    row, brow = sc["row"], sc["brow"]

    def match(_):
        best_j, _, ok = lcm.match(lc.desc_db[row], lc.desc_valid[row],
                                  lc.desc_db[brow], lc.desc_valid[brow],
                                  lc.F, lc.S)
        bj = best_j.long()
        ok = ok & lc.lm_has[brow][bj]
        return (best_j, ok, lc.lm_pos[brow][bj],
                pnp.normalized(sc["xy"], *cam))

    def sampling(ins):
        u = pnp.draw_uniforms(lcm.N_HYP, lc.F, lc._gen)
        return ins + (pnp.sample_indices(ins[1], lcm.N_HYP, lcm.SAMPLE,
                                         uniforms=u),)

    def dlt_minimal(ins):
        best_j, ok, p_w, xn, idx = ins
        return ins, pnp.minimal_fit(p_w, xn, idx)

    def polish(x):
        (best_j, ok, p_w, xn, idx), T = x
        return x[0], lcm._stage_polish(cam, T, p_w, sc["xy"], ok, idx)

    def dlt_refit(x):
        return x, pnp.refit(x[0][2], x[0][3], x[1][3])

    def lo_pose_only(x):
        ((best_j, ok, p_w, xn, idx), (T_hyp, inl, scores, _)), T_lo = x
        return lcm._stage_finish(cam, T_lo, T_hyp, inl, scores, p_w,
                                 sc["xy"], ok, sc["T_est"])

    return _stage_table(
        lc, [("match", match), ("sampling", sampling),
             ("dlt_minimal", dlt_minimal), ("polish", polish),
             ("dlt_refit", dlt_refit), ("lo_pose_only", lo_pose_only)],
        dev, reps)


def _graph_stages(lc, sc, dev, reps):
    """The stages as _verify runs them."""
    st = lc.verify_graphs().stages
    row, brow, xy = sc["row"], sc["brow"], sc["xy"]

    def copy_in(_):
        u = pnp.draw_uniforms(lcm.N_HYP, lc.F, lc._gen)
        return tuple(t.clone() for t in (
            lc.desc_db[row], lc.desc_valid[row], lc.desc_db[brow],
            lc.desc_valid[brow], lc.lm_has[brow], lc.lm_pos[brow])) + (xy, u)

    def dlt_minimal(a):
        best_j, ok, p_w, xn, idx = a
        return a, pnp.minimal_fit(p_w, xn, idx)

    def graph_polish(x):
        (best_j, ok, p_w, xn, idx), T = x
        return x[0], st.polish(T, p_w, xy, ok, idx)

    def dlt_refit(x):
        return x, pnp.refit(x[0][2], x[0][3], x[1][3])

    def graph_finish(x):
        ((best_j, ok, p_w, xn, idx), (T_hyp, inl, scores, _)), T_lo = x
        return st.finish(T_lo, T_hyp, inl, scores, p_w, xy, ok, sc["T_est"])

    return _stage_table(
        lc, [("copy_in", copy_in),
             ("graph_match", lambda ins: st.match(*ins)),
             ("dlt_minimal", dlt_minimal), ("graph_polish", graph_polish),
             ("dlt_refit", dlt_refit), ("graph_finish", graph_finish)],
        dev, reps)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)
    dev = tools.tool_device("torch_profile_verify", args.device)
    card = tools.card_line(dev)
    print(card)
    s = settings()
    cam = s.cam_left
    lc = lcm.LoopClosing(s, cam.fx, cam.fy, cam.cx, cam.cy, device=dev)
    with torch.no_grad():
        sc = scene(lc)
        t0 = time.perf_counter()
        lc.verify_graphs()
        tools.synchronize(dev)
        capture_s = time.perf_counter() - t0
        eager = _eager_stages(lc, sc, dev, args.reps)
        graphed = _graph_stages(lc, sc, dev, args.reps)
        whole, outs = {}, {}
        for name, fn in (("eager", lc._verify_impl), ("graphed", None)):
            times = []
            for _ in range(args.reps):
                lc._gen.manual_seed(17)
                tools.synchronize(dev)
                t0 = time.perf_counter()
                if fn is None:
                    out = lc._verify(sc["row"], sc["brow"], sc["xy"],
                                     sc["T_est"])
                else:
                    out = fn(lc.desc_db, lc.desc_valid, lc.lm_has,
                             lc.lm_pos, sc["row"], sc["brow"], sc["xy"],
                             sc["T_est"])
                pack = out[0].cpu()
                times.append(1e3 * (time.perf_counter() - t0))
            whole[name] = statistics.median(times)
            outs[name] = (pack,) + tuple(o.cpu() for o in out[1:])
    same = all(torch.equal(a, b) for a, b in zip(outs["eager"],
                                                 outs["graphed"]))
    pack = outs["graphed"][0].numpy()
    err = float(np.abs(se3.log(torch.as_tensor(se3.compose_np(
        pack[4:].reshape(3, 4), se3.inverse_np(sc["T_true"])))).numpy()).max())
    for title, table in (("op by op", eager), ("replayed", graphed)):
        print(title)
        for k, v in table.items():
            dms = "-" if v["device_ms"] is None else f"{v['device_ms']:8.2f}"
            print(f"  {k:14s} host {v['host_ms']:8.2f} ms  wall "
                  f"{v['wall_ms']:8.2f} ms  device {dms} ms  ops {v['ops']}")
    print(f"whole verification: op by op {whole['eager']:.2f} ms, replayed "
          f"{whole['graphed']:.2f} ms; equal {same}; n_matches "
          f"{int(pack[0])}, inliers {int(pack[2])}, pose error {err:.2e}")
    res = dict(card=card, device=str(dev), reps=args.reps,
               features=lc.F, octaves=lc.S, hypotheses=lcm.N_HYP,
               capture_s=capture_s, captured=lc.verify_graphs().captured,
               stages_eager=eager, stages_graphed=graphed,
               verify_ms=whole, equal=same, n_matches=int(pack[0]),
               n_inliers=int(pack[2]), pnp_ok=bool(pack[1] > 0.5),
               pose_error=err)
    lc.close()
    print("VERIFY " + json.dumps(res))
    return res


if __name__ == "__main__":
    main()
