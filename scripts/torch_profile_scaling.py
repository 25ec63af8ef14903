#!/usr/bin/env python
"""ms per local BA solve of the landmark-sharded BA at 1, 2 and 4 ranks
(the port's counterpart of scripts/profile_scaling.py, BA only).

Each world size starts its ranks as processes (spawn), joined over a file
store in a temporary directory; every rank builds the same problem
(`build_problem`, profile_scaling.py's, with its window of 12
keyframes), takes its shard and runs
`dist_ba.distributed_local_ba` (2 rounds x 10 LM iterations, as there):
two warm-up solves, then the median of 5, timed on rank 0 between two
all_reduces that line the ranks up. Speedup and efficiency are against
the 1-rank time.

On the CPU the ranks run over gloo, each on one thread. On CUDA, ranks
take devices cuda:0..; a world of more ranks than devices shares them
over gloo (NCCL refuses two ranks on one device), and the output line
says so: on one GPU that measures the collectives' cost, not scaling.

Usage: python scripts/torch_profile_scaling.py [--device cpu] [--json]
           [M_landmarks]
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ssvio_tpu_torch.ops import ba  # noqa: E402
from ssvio_tpu_torch.parallel import dist_ba  # noqa: E402

WARMUP, REPS = 2, 5
WORLDS = (1, 2, 4)
WINDOW = 12              # profile_scaling.py's
TIMEOUT = datetime.timedelta(minutes=10)


def build_problem(M: int, W: int = 12, seed: int = 0):
    """profile_scaling.py's problem (and tests/multihost_worker.py's at M
    512, W 8): a straight window of W keyframes 0.8 m apart along -z
    observing M landmarks through both eyes with 0.3 px noise, poses
    perturbed by 1e-3 and landmarks by 0.05 m. Returns (LocalBAProblem of
    CPU tensors, (fx, fy, cx, cy, baseline))."""
    rng = np.random.default_rng(seed)
    fx = fy = 718.0
    cx, cy = 607.0, 185.0
    baseline = 0.537
    p_w = np.stack([rng.uniform(-20, 20, M), rng.uniform(-5, 5, M),
                    rng.uniform(5, 60, M)], -1).astype(np.float32)
    kf_T = np.zeros((W, 3, 4), np.float32)
    kf_T[:, :3, :3] = np.eye(3)
    for w in range(W):
        kf_T[w, 2, 3] = -0.8 * w
    obs_uv = np.zeros((M, W, 2, 2), np.float32)
    obs_valid = np.zeros((M, W, 2), bool)
    for w in range(W):
        for c, bx in enumerate([0.0, baseline]):
            pc = p_w @ kf_T[w, :, :3].T + kf_T[w, :, 3] - np.array([bx, 0, 0])
            uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx,
                           fy * pc[:, 1] / pc[:, 2] + cy], -1)
            obs_uv[:, w, c] = uv + rng.normal(0, 0.3, uv.shape)
            obs_valid[:, w, c] = ((pc[:, 2] > 1.0)
                                  & (np.abs(uv[:, 0] - cx) < 640)
                                  & (np.abs(uv[:, 1] - cy) < 200))
    kf_fixed = np.zeros(W, bool)
    kf_fixed[0] = True
    t = torch.from_numpy
    prob = ba.LocalBAProblem(
        kf_T_cw=t(kf_T + rng.normal(0, 1e-3, kf_T.shape).astype(np.float32)),
        kf_valid=torch.ones(W, dtype=torch.bool), kf_fixed=t(kf_fixed),
        lm_pos=t(p_w + rng.normal(0, 0.05, p_w.shape).astype(np.float32)),
        lm_valid=torch.ones(M, dtype=torch.bool),
        lm_fixed=torch.zeros(M, dtype=torch.bool),
        obs_uv=t(obs_uv), obs_valid=t(obs_valid))
    return prob, (fx, fy, cx, cy, baseline)


def layout(world: int, device: str) -> tuple:
    """(backend, shared): the ranks' backend, and whether they share
    devices (more ranks than CUDA devices)."""
    if device == "cpu":
        return "gloo", False
    shared = world > torch.cuda.device_count()
    return ("gloo" if shared else "nccl"), shared


def _rank_main(rank: int, world: int, device: str, M: int, W: int,
               workdir: str):
    torch.set_num_threads(1)
    backend, _ = layout(world, device)
    dev = torch.device("cpu")
    if device != "cpu":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{workdir}/store",
                            world_size=world, rank=rank, timeout=TIMEOUT)
    try:
        mesh = dist_ba.make_mesh(device=dev)
        prob, cam = build_problem(M, W)
        step = dist_ba.distributed_local_ba(mesh, *cam, max_rounds=2,
                                            iters=10)
        shard = dist_ba.shard_problem(mesh, prob)
        line_up = torch.zeros(1, device=dev)
        times = []
        with torch.no_grad():
            for i in range(WARMUP + REPS):
                dist.all_reduce(line_up, group=mesh.group)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                res = step(shard)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                if i >= WARMUP:
                    times.append(time.perf_counter() - t0)
        if rank == 0:
            with open(os.path.join(workdir, "result.json"), "w") as f:
                json.dump(dict(ms=1e3 * float(np.median(times)),
                               inlier_ratio=float(res.inlier_ratio)), f)
    finally:
        dist.destroy_process_group()


def measure(world: int, device: str, M: int, W: int) -> dict:
    """Start `world` ranks, wait for them, return rank 0's timing."""
    with tempfile.TemporaryDirectory(prefix="ssvio_scaling_") as workdir:
        mp.start_processes(_rank_main, args=(world, device, M, W, workdir),
                           nprocs=world, start_method="spawn")
        with open(os.path.join(workdir, "result.json")) as f:
            return json.load(f)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("M", nargs="?", type=int, default=32768,
                   help="landmark capacity (divisible by every world size)")
    p.add_argument("--device", default=None,
                   help="cpu, or cuda (the default; needs a CUDA device)")
    p.add_argument("--json", action="store_true",
                   help="one SCALING line of JSON instead of a table")
    args = p.parse_args(argv)
    device = args.device or "cuda"
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("torch_profile_scaling: no CUDA device; pass "
                           "--device cpu to run on the CPU")
    where = ("CPU" if device == "cpu" else
             f"{torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}")
    report = dict(M=args.M, W=WINDOW, device=where,
                  reps=f"median of {REPS}", solve_ms={}, efficiency={},
                  backend={}, shared_devices={})
    for n in WORLDS:
        r = measure(n, device, args.M, WINDOW)
        backend, shared = layout(n, device)
        base = report["solve_ms"].get("1", r["ms"] if n == 1 else None)
        eff = base / (n * r["ms"]) if base else float("nan")
        report["solve_ms"][str(n)] = r["ms"]
        report["efficiency"][str(n)] = eff
        report["backend"][str(n)] = backend
        report["shared_devices"][str(n)] = shared
        if not args.json:
            note = (" (ranks share the GPU: collective cost, not scaling)"
                    if shared else "")
            print(f"ranks={n} [{backend}, {where}]  {r['ms']:8.1f} ms/solve"
                  f"  speedup={(base or float('nan')) / r['ms']:5.2f}x  "
                  f"efficiency={100 * eff:5.1f}%  inlier_ratio="
                  f"{r['inlier_ratio']:.3f}{note}", flush=True)
    if args.json:
        print("SCALING " + json.dumps(report))
    return report


if __name__ == "__main__":
    main()
