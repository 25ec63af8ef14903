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

With --engine (profile_scaling.py:72-150) it times the whole engine step
instead, the keyframe + BA branch: `Engine._step` at 256x128 with 256
features, M landmarks (8192 by default) and a window of 12, the branch
forced by tracking_good 10**9 and tracking_bad -1, from one seeded carry
(random images, features linked to random landmarks) each time. Rank 0
drives `Engine(mesh=...)`, whose local BA is sharded over the ranks
(dist_ba.PrimaryBA); the other ranks serve it (dist_ba.serve). One
warm-up step, then the median of ENGINE_REPS.

On the CPU the ranks run over gloo, each on one thread. On CUDA, ranks
take devices cuda:0..; a world of more ranks than devices shares them
over gloo (NCCL refuses two ranks on one device), and the output line
says so: on one GPU that measures the collectives' cost, not scaling.

Usage: python scripts/torch_profile_scaling.py [--device cpu] [--json]
           [--engine] [M_landmarks]
"""

from __future__ import annotations

import argparse
import dataclasses
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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ssvio_tpu_torch import engine as eng  # noqa: E402
from ssvio_tpu_torch import frontend as fe  # noqa: E402
from ssvio_tpu_torch import map as mapmod  # noqa: E402
from ssvio_tpu_torch.config import Settings  # noqa: E402
from ssvio_tpu_torch.ops import ba, camera, se3  # noqa: E402
from ssvio_tpu_torch.parallel import dist_ba  # noqa: E402
import torch_tools as tools  # noqa: E402

WARMUP, REPS = 2, 5
ENGINE_REPS = 3          # profile_scaling.py's engine mode
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


def engine_settings(M: int) -> Settings:
    """profile_scaling.py's engine mode: 256x128 (fx 360), 256 features, M
    landmarks, a window of 12, 2 detection octaves, every tracked frame
    forced down the keyframe + BA branch."""
    s = Settings()
    fx = 360.0
    cam = dataclasses.replace(s.cam_left, fx=fx, fy=fx, cx=128.0, cy=64.0)
    s.cam_left, s.cam_right = cam, dataclasses.replace(cam)
    s.image_width, s.image_height = 256, 128
    s.baseline_fx = 0.54 * fx
    s.max_features = 256
    s.max_landmarks = M
    s.max_window = 12
    s.tracking_good = 10 ** 9
    s.tracking_bad = -1
    s.detect_octaves = 2
    return s


def engine_run(M: int, dev, mesh=None, reps: int = ENGINE_REPS):
    """Time `Engine._step` from profile_scaling.py's seeded carry (numpy
    seed 0: two random images, features at random positions linked to
    landmarks 0..255, M random landmarks; TRACKING_GOOD) on `dev`, its BA
    sharded over `mesh` when given (this process rank 0): one warm-up
    step, then `reps`. Returns (ms of each step, the last step's carry)."""
    s = engine_settings(M)
    front = fe.Frontend(s, s.image_width, s.image_height, device=dev)
    engine = eng.Engine(front, enable_backend=True, mesh=mesh)
    rng = np.random.default_rng(0)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=dev)
    img0 = t(rng.uniform(0, 255, (128, 256)))
    img1 = t(rng.uniform(0, 255, (128, 256)))
    n = s.max_features
    feat = fe.FeatState(
        xy=t(np.stack([rng.uniform(20, 236, n), rng.uniform(20, 108, n)],
                      -1)),
        lm_slot=t(np.arange(n), torch.int32),
        lm_gid=t(np.arange(n), torch.int32),
        valid=torch.ones(n, dtype=torch.bool, device=dev),
        octave=torch.zeros(n, dtype=torch.int32, device=dev))
    lm_pos = t(np.stack([rng.uniform(-5, 5, M), rng.uniform(-2, 2, M),
                         rng.uniform(5, 40, M)], -1))
    m = mapmod.empty_map(s.max_window, M, dev)._replace(
        lm_pos=lm_pos, lm_valid=torch.ones(M, dtype=torch.bool, device=dev),
        lm_gid=t(np.arange(M), torch.int32),
        lm_first_kf=torch.zeros(M, dtype=torch.int32, device=dev))
    carry = eng.EngineCarry(front._build_pyramid(img0), feat,
                            se3.identity(device=dev),
                            se3.identity(device=dev), m, fe.TRACKING_GOOD)
    times = []
    with torch.no_grad():
        for i in range(1 + reps):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            c2, fr = engine._step(carry, img1, lambda: img1)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            if i:
                times.append(1e3 * (time.perf_counter() - t0))
    if not fr.keyframe or not fr.ran_ba:
        raise RuntimeError("engine mode: the step took no keyframe + BA")
    if engine.dist is not None:
        engine.dist.close()
    return times, c2


def engine_rank(M: int, mesh, reps: int = ENGINE_REPS):
    """This rank's part of the engine mode over `mesh`: rank 0 times the
    engine step (engine_run) and returns (ms of each step, the last step's
    carry); every other rank serves rank 0's sharded BAs until it is done
    and returns None."""
    if mesh.rank == 0:
        return engine_run(M, mesh.device, mesh, reps)
    rig = camera.StereoRig.from_settings(engine_settings(M), mesh.device)
    il = rig.intr_left
    dist_ba.serve(mesh, il.fx, il.fy, il.cx, il.cy, rig.baseline)
    return None


def _engine_rank_main(rank: int, world: int, device: str, M: int,
                      workdir: str):
    """A rank of the engine mode (engine_rank); rank 0 writes its timing
    and its last step's poses and landmarks."""
    torch.set_num_threads(1)
    backend, _ = layout(world, device)
    dev = torch.device("cpu")
    if device != "cpu":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{workdir}/store",
                            world_size=world, rank=rank, timeout=TIMEOUT)
    try:
        out = engine_rank(M, dist_ba.make_mesh(device=dev))
        if out is not None:
            times, c2 = out
            np.savez(os.path.join(workdir, "carry.npz"),
                     T_cw=c2.T_cw.cpu().numpy(),
                     kf_pose=c2.m.kf_pose.cpu().numpy(),
                     lm_pos=c2.m.lm_pos.cpu().numpy())
            with open(os.path.join(workdir, "result.json"), "w") as f:
                json.dump(dict(ms=float(np.median(times))), f)
    finally:
        dist.destroy_process_group()


def measure(world: int, device: str, M: int, W: int,
            engine: bool = False) -> dict:
    """Start `world` ranks, wait for them, return rank 0's timing (engine
    mode: and its last step's T_cw, kf_pose and lm_pos as numpy)."""
    with tempfile.TemporaryDirectory(prefix="ssvio_scaling_") as workdir:
        if engine:
            mp.start_processes(_engine_rank_main,
                               args=(world, device, M, workdir),
                               nprocs=world, start_method="spawn")
        else:
            mp.start_processes(_rank_main,
                               args=(world, device, M, W, workdir),
                               nprocs=world, start_method="spawn")
        with open(os.path.join(workdir, "result.json")) as f:
            out = json.load(f)
        if engine:
            with np.load(os.path.join(workdir, "carry.npz")) as z:
                out.update({k: z[k] for k in z.files})
        return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("M", nargs="?", type=int, default=None,
                   help="landmark capacity (divisible by every world size; "
                        "32768, with --engine 8192)")
    p.add_argument("--engine", action="store_true",
                   help="time the whole engine step (keyframe + BA "
                        "branch) instead of the BA solve")
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
    card = tools.card_line(device if device == "cpu" else
                               torch.device("cuda", 0))
    print(card)
    M = args.M or (8192 if args.engine else 32768)
    what = "ms/engine-step (KF+BA branch)" if args.engine else "ms/solve"
    report = dict(M=M, W=WINDOW, device=where, card=card, engine=args.engine,
                  reps=f"median of {ENGINE_REPS if args.engine else REPS}",
                  solve_ms={}, efficiency={}, backend={}, shared_devices={})
    for n in WORLDS:
        r = measure(n, device, M, WINDOW, engine=args.engine)
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
            ratio = ("" if args.engine else
                     f"  inlier_ratio={r['inlier_ratio']:.3f}")
            print(f"ranks={n} [{backend}, {where}]  {r['ms']:8.1f} {what}"
                  f"  speedup={(base or float('nan')) / r['ms']:5.2f}x  "
                  f"efficiency={100 * eff:5.1f}%{ratio}{note}", flush=True)
    if args.json:
        print("SCALING " + json.dumps(report))
    return report


if __name__ == "__main__":
    main()
