#!/usr/bin/env python
"""KITTI odometry batch driver of the PyTorch port (`ssvio_tpu_torch`).

The port's counterpart of scripts/run_kitti.py, with its flags and its
output lines (reference test/test_system.cpp:16-53): takes a config file
and a KITTI sequence directory, builds the System, runs the per-frame loop
(or, with --chunk, the pipelined chunk loop: native PNG decode, then the
prefetcher's pad and upload, then dispatch_chunk of chunk k+1 before
collect_chunk of chunk k), logs progress every 100 frames, writes the
trajectory in TUM format, evaluates the keyframe ATE against KITTI ground
truth and renders a map snapshot. It runs on the current CUDA device
unless --device names another (--device cpu for the CPU); without a CUDA
device and without --device it raises. With no --config_yaml_path it runs
Settings(), the KITTI-00 defaults, and needs no YAML parser.

With --distributed the process joins a process group
(`parallel/multihost.py`: the SSVIO_COORDINATOR / SSVIO_NUM_PROCESSES /
SSVIO_PROCESS_ID variables, or torchrun's; with neither, a world of 1 in
this process) and the local BA's landmark axis is sharded over its ranks:
rank 0 runs the driver, and every other rank serves its shard of each BA
(`dist_ba.serve`) until rank 0 has finished. Backend: NCCL on CUDA
devices, gloo on the CPU.

Usage:
    python scripts/torch_run_kitti.py --kitti_dataset_path /data/kitti/00 \\
        [--config_yaml_path config.yaml] [--gt_poses 00.txt] \\
        [--save_traj traj.tum] [--snapshot map.png] [--no_loop] \\
        [--chunk 32] [--device cpu] [--distributed]

`run(system, args)` runs the loop for a System built in code, with the
arguments of `parse_args`.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ssvio_tpu_torch.config import Settings  # noqa: E402
from ssvio_tpu_torch.dataio import kitti  # noqa: E402
from ssvio_tpu_torch.ops import camera  # noqa: E402
from ssvio_tpu_torch.parallel import dist_ba, multihost  # noqa: E402
from ssvio_tpu_torch.system import System  # noqa: E402
from ssvio_tpu_torch.utils import profiling  # noqa: E402

PROFILE_FRAMES = (20, 40)     # --profile_dir traces these frames, inclusive


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config_yaml_path", default=None,
                   help="config file (reference YAML schema; none for the "
                        "KITTI 00 defaults, which need no YAML parser)")
    p.add_argument("--kitti_dataset_path", required=True,
                   help="KITTI odometry sequence dir (times.txt + image_0/1)")
    p.add_argument("--gt_poses", default=None,
                   help="KITTI ground-truth poses .txt for ATE evaluation")
    p.add_argument("--save_traj", default="./trajectory.tum",
                   help="TUM trajectory output path")
    p.add_argument("--snapshot", default=None,
                   help="render final map+trajectory to this PNG")
    p.add_argument("--no_backend", action="store_true",
                   help="disable local BA (frame-to-frame odometry only)")
    p.add_argument("--no_loop", action="store_true",
                   help="disable loop closing")
    p.add_argument("--max_frames", type=int, default=0,
                   help="stop after N frames (0 = whole sequence)")
    p.add_argument("--chunk", type=int, default=0,
                   help="process N frames per dispatch (decode, upload and "
                        "compute overlap; loop closing runs at chunk "
                        "boundaries). 0 = per-frame run_step")
    p.add_argument("--viewer", action="store_true",
                   help="live matplotlib viewer (needs a display)")
    p.add_argument("--frames_only_traj", action="store_true",
                   help="export every frame pose instead of keyframes only")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler chrome trace of frames "
                        f"{PROFILE_FRAMES[0]}..{PROFILE_FRAMES[1]} of the "
                        "per-frame loop here")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the current CUDA "
                        "device; cpu for the CPU)")
    p.add_argument("--distributed", action="store_true",
                   help="join a process group before the run (SSVIO_"
                        "COORDINATOR/SSVIO_NUM_PROCESSES/SSVIO_PROCESS_ID "
                        "or torchrun's variables; with neither, a world of "
                        "1) and shard the local BA's landmark axis over its "
                        "ranks: rank 0 drives, the others serve "
                        "(parallel/multihost.py)")
    return p.parse_args(argv)


def _run_chunked(system, loader, ts, n, chunk, viewer, gt, t0):
    """Pipelined chunk loop: decode (native loader threads) -> pad and
    upload (ChunkPrefetcher thread) -> the device step (chunk k+1
    dispatched before chunk k is collected). Loop closing runs at collect
    time; the frames after the last whole chunk run through run_step."""
    it = iter(loader)

    def read_chunk():
        bl, br = [], []
        for _ in range(chunk):
            l, r = next(it)
            bl.append(l)
            br.append(r)
        return bl, br

    n_chunks = n // chunk
    pf = system.prefetcher()
    if n_chunks:
        pf.submit(*read_chunk())
    pending = None
    for ci in range(n_chunks):
        dev_l, dev_r = pf.get()
        c0 = ci * chunk
        h = system.dispatch_chunk(dev_l, dev_r,
                                  [float(ts[c0 + j]) for j in range(chunk)])
        if ci + 1 < n_chunks:
            pf.submit(*read_chunk())    # decode+upload ride behind compute
        if pending is not None:
            system.collect_chunk(pending)
        pending = h
        if ci % max(1, 100 // chunk) == 0:
            el = time.time() - t0
            print(f"[run_kitti] frame {c0}/{n}  "
                  f"kfs={system.stats['n_keyframes']} "
                  f"loops={system.stats['n_loops']}  "
                  f"{(c0 + chunk) / max(el, 1e-9):.1f} fps", flush=True)
        if viewer is not None:
            viewer.update(system, gt_poses_wc=gt)
    if pending is not None:
        system.collect_chunk(pending)
    pf.close()
    for i in range(n_chunks * chunk, n):
        img_l, img_r = next(it)
        system.run_step(img_l, img_r, float(ts[i]))
    system.finish()    # resolve loop candidates deferred in the last chunks


def _require_device(args):
    """Raises when no device is named and there is no CUDA device (the
    driver never falls back to the CPU)."""
    if args.device is None and not torch.cuda.is_available():
        raise RuntimeError("torch_run_kitti: no CUDA device; pass "
                           "--device cpu to run on the CPU")


def _settings(args) -> Settings:
    return (Settings.from_yaml(args.config_yaml_path)
            if args.config_yaml_path else Settings())


def build_system(args, mesh=None) -> System:
    """The System the arguments ask for (its local BA sharded over `mesh`
    when one is given)."""
    _require_device(args)
    return System(_settings(args),
                  enable_backend=False if args.no_backend else None,
                  enable_loop_closing=False if args.no_loop else None,
                  mesh=mesh, device=args.device)


def join_mesh(args) -> dist_ba.Mesh:
    """--distributed: join the process group (multihost.initialize) and
    return the mesh over its ranks, printing the JAX driver's lines."""
    _require_device(args)
    if not multihost.initialize(
            backend=multihost.default_backend(args.device)):
        print("[run_kitti] --distributed: no coordinator configured "
              "(set SSVIO_COORDINATOR/SSVIO_NUM_PROCESSES/"
              "SSVIO_PROCESS_ID) and no torchrun environment; "
              "continuing single-process")
    mesh = multihost.global_mesh(args.device)
    print(f"[run_kitti] distributed: process {mesh.rank}/{mesh.size}, "
          f"{mesh.size} global devices, mesh axes {mesh.shape}")
    return mesh


def serve(args, mesh: dist_ba.Mesh) -> int:
    """A rank > 0 of --distributed: serve this rank's shard of each local
    BA of rank 0's System until it has finished. Returns the BAs served."""
    rig = camera.StereoRig.from_settings(_settings(args), mesh.device)
    il = rig.intr_left
    n = dist_ba.serve(mesh, il.fx, il.fy, il.cx, il.cy, rig.baseline)
    print(f"[run_kitti] process {mesh.rank}/{mesh.size}: served {n} "
          "local BAs")
    return n


def run(system: System, args) -> dict:
    """Drive `system` over the sequence of `args` and write its outputs.
    Returns {"frames", "wall_s", "ate"} (ate: the keyframe ATE statistics
    with --gt_poses and at least one keyframe, else None)."""
    left, right, ts = kitti.load_image_paths_and_timestamps(
        args.kitti_dataset_path)
    n = len(ts) if not args.max_frames else min(args.max_frames, len(ts))
    print(f"[run_kitti] {n} stereo frames from {args.kitti_dataset_path}; "
          f"tracking: {system._engine.tracking_path}")

    gt = kitti.load_kitti_gt_poses(args.gt_poses) if args.gt_poses else None

    viewer = None
    if args.viewer:
        from ssvio_tpu_torch.viz import LiveViewer
        viewer = LiveViewer(update_every=5)

    loader = kitti.prefetching_reader(
        left[:n], right[:n],
        capacity=max(8, 2 * args.chunk) if args.chunk else 8)
    t0 = time.time()
    if args.chunk:
        _run_chunked(system, loader, ts, n, args.chunk, viewer, gt, t0)
    else:
        with contextlib.ExitStack() as profile:
            for i, (img_l, img_r) in enumerate(loader):
                if args.profile_dir and i == PROFILE_FRAMES[0]:
                    profile.enter_context(profiling.trace(args.profile_dir))
                system.run_step(img_l, img_r, float(ts[i]))
                if i == PROFILE_FRAMES[1]:
                    profile.close()
                if i % 100 == 0:
                    el = time.time() - t0
                    print(f"[run_kitti] frame {i}/{n}  "
                          f"status={system.status}  "
                          f"kfs={system.stats['n_keyframes']} "
                          f"loops={system.stats['n_loops']}  "
                          f"{(i + 1) / max(el, 1e-9):.1f} fps")
                if viewer is not None:
                    viewer.update(system, gt_poses_wc=gt)
    wall = time.time() - t0
    print(f"[run_kitti] done: {n} frames in {wall:.1f}s "
          f"({n / wall:.1f} fps), {system.stats['n_keyframes']} keyframes, "
          f"{system.stats['n_loops']} loop closures")
    for w in system.stats.get("warnings", []):
        print(f"[run_kitti] warning: {w}")

    system.save_trajectory_tum(args.save_traj,
                               keyframes_only=not args.frames_only_traj)
    print(f"[run_kitti] trajectory -> {args.save_traj}")

    res = None
    if gt is not None and not system.records.keyframes:
        print("[run_kitti] ATE: no keyframes (the run never initialised)")
    elif gt is not None:
        from ssvio_tpu_torch.eval import ate
        _, est = system.keyframe_trajectory()
        # associate keyframes to gt rows via frame ids
        kf_frames = [k["frame_id"] for k in system.records.keyframes]
        gt_kf = gt[[f for f in kf_frames if f < len(gt)]]
        est = est[:len(gt_kf)]
        res = ate.ape_translation(est[:, :, 3], gt_kf[:, :, 3])
        print(f"[run_kitti] ATE (SE3 Umeyama): rmse={res['rmse']:.3f} m  "
              f"mean={res['mean']:.3f}  min={res['min']:.3f}  "
              f"max={res['max']:.3f}")

    if args.snapshot:
        from ssvio_tpu_torch import viz
        viz.snapshot(system, args.snapshot, gt_poses_wc=gt)
        print(f"[run_kitti] map snapshot -> {args.snapshot}")
    if viewer is not None:
        viewer.close()
    return {"frames": n, "wall_s": wall, "ate": res}


def main(argv=None) -> int:
    args = parse_args(argv)
    if not args.distributed:
        with torch.no_grad():
            run(build_system(args), args)
        return 0
    mesh = join_mesh(args)
    try:
        if mesh.rank > 0:
            serve(args, mesh)
            return 0
        system = build_system(args, mesh)
        try:
            with torch.no_grad():
                run(system, args)
        finally:
            system.close()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
