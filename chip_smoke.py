"""Drive the PyTorch port's main paths once on one NVIDIA GPU, and check them.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
1. device: a CUDA device is required; prints nvidia-smi's name and power
   limit line.
2. build: compiles the five LK kernel sources of the checkout
   (ssvio_tpu_torch/csrc/lk_level.cu, lk_patch.cu, lk_level_sw.cu,
   lk_level_pk.cu, lk_level_mm.cu; each with every pixel class its
   windows need), one nvcc each, all started together.
3. kernels vs plain: for the KITTI bench configuration (1241x376) and the
   RobotCar XB3 wide configuration (1280x960), renders a scene on the card,
   detects 512 keypoints as the keyframe step does, and at every level of
   the 4-level pyramid runs the kernel that level takes (ops/lk.py: kernel
   #1 lk_cuda.lk_level within the 12 MiB plane budget, kernel #2
   lk_patch_cuda.lk_patch above it: level 0 at 1280x960) and its plain torch
   version on the same inputs, for a temporal pair and a stereo pair, coarse
   to fine as lk.track seeds them. Flags must be equal and converged
   positions within POS_TOL_PX; both are timed with CUDA events. Kernel
   #2's chain is read there too (_chain: slope, fixed part, windows read
   outside the staged region), and at RobotCar level 0 it is also held at
   its widest window and with guesses REGION_OFFSET_PX off
   (_check_patch_region_fallback).
3b. flavours vs plain: at every KITTI level of phase 3, on the same inputs,
   each `Settings.lk_kernel` flavour's kernel (serial: #1 again, sw: #3,
   ymm and pkmm: #4, one function, run once; mm and mm_f32: #5;
   ops/lk_variants_cuda.py) against its plain version, with phase 3's
   checks (for mm, MM_MIN_AGREE_SHARE replaces the cap share and the
   converged tolerance, and the tight checks of _mm_tight and their
   control are added) and times; at every temporal level its device time
   from torch.profiler and its ratio to kernel #1's there (phase 3), the
   most iterations of any keypoint, the time per iteration of that chain
   as a slope between the path's iterations and one, with the fixed part,
   and the search windows read outside the staged region (_chain); prints
   each flavour's largest position difference from kernel #1, which must
   be 0 for serial and sw (one kernel). Then two checks of every flavour:
   the region fallback (guesses REGION_OFFSET_PX off at REGION_LEVEL, so
   that searches leave the staged region: outside count > 0, held against
   the plain versions) and its kernel's widest window (at WIDE_LEVEL; mm
   with _mm_tight); kernel #2's widest window is held in phase 3, at
   RobotCar level 0.
Phases 4-12 run the System's default path: the tracking branch of every
tracked frame replays the engine's tracking graph (graphs.TrackGraph,
one CUDA graph of the pyramid, the LK kernels and the pose-only LM,
captured at the System's first tracked frame), and the keyframe branch
of every steady keyframe its keyframe graph (graphs.KeyframeGraph, one
CUDA graph of the right pyramid, detection, stereo LK, triangulation, the
map inserts, the loop descriptors and the 5 x 10 local BA, whose rounds
after the inlier-ratio flag its conditional nodes skip, captured at
the first steady keyframe; an init frame's branch runs eagerly, and with
a mesh every keyframe's). Their launch checks count what the statuses
imply plus the launches of each graph's warm-up
(graphs.WARMUP_LAUNCHES: one eager run before the capture), and the
tracking graphs' replays must equal the tracked frames, the keyframe
graphs' the steady keyframes (the recorder's counters, graphs.replays();
_check_replays). Each phase closes its Systems (System.close releases
the graphs' memory pools).

4. the run_step path: System(device="cuda") with the bench configuration
   (512 features, 8192 landmarks, window 16, 8 FAST octaves, LK 11x11 / 3
   levels / 30 iterations, local BA on, loop closing off) runs 96 frames of
   the bench's straight sequence (world seed 4, 0.6 m per frame), rendered
   on the card, through run_step. The run must never go LOST, make >= 2
   keyframes and >= 1 local BA, launch kernel #1 exactly as often as the
   statuses imply (and no other kernel), and keep ATE under 0.5 m.
   Prints the median and mean ms a frame, the steady keyframe frames'
   median and the first one's (it builds the keyframe graph), and the
   rounds and LM steps each local BA's loops take (Engine.ba_trips; the
   keyframe graph runs those rounds, 10 steps each, an eager BA 5 x 10).
5. the chunk path: the RobotCar configuration runs 96 frames of a straight
   drive down a street (SCENES; rendered on the card, handed over as host
   uint8 as a camera's are) in chunks of 32
   through the prefetcher and pipelined dispatch_chunk / collect_chunk, as
   bench.py drives the JAX package, then finish(). Same checks as phase 4
   with both kernels' launch counts; the same frames through run_step must
   give the same statuses and keyframes and trajectories within 1e-3 m.
5b. graph against eager: phase 4's frames through run_step and phase 5's
   through the prefetcher and pipelined chunks, each in turns on a new
   System eager (System(eager=True): both branches op by op), graph,
   graph, eager, every call of either graph (copy-in, replay, copy-out)
   under torch.cuda.set_sync_debug_mode("error"), so a call on its way
   that waits for the device (an item(), a nonzero()) raises. Phase 4's
   and 5's checks on each run (launches as the statuses imply, tracking
   replays equal to the tracked frames and keyframe replays to the steady
   keyframes on the graph path, none on the eager one), at least one
   steady keyframe in every run (else the keyframe graph went untested);
   statuses and keyframe counts equal across the four runs, positions within
   GRAPH_VS_EAGER_M between the paths (the largest differences printed).
   Then on the last tracked frame of the first graph run, eager and
   replayed from a graph of it, with CUDA-event ms of each: the pose-only
   LM (4 x 10 iterations, a fixed trip) and the local BA of the window
   (5 x 10, a fixed trip, whose graph skips the rounds after the ratio
   flag); beside ms/frame of every run and its steady
   keyframe frames' median ms.
6. the flavours: phase 4's frames through run_step once for each of sw,
   ymm, pkmm, mm and mm_f32 (bench configuration with lk_kernel set). Same
   checks as phase 4, with the flavour's kernel launched as often as the
   statuses imply and kernel #1 never, and pkmm's run equal to ymm's;
   prints ms per frame and the status and position differences from phase
   4's serial run.
7. place recognition at KITTI width (run before phase 6, so that phase
   6's cut sees its time): the bench configuration drives a circle that
   passes over its start again (LOOP_* below) through run_step with loop
   closing off, with phase 4's checks. Every keyframe's image, features
   and landmarks are kept and run through the loop-closing ops on the card
   (512 features x Settings.loop_desc_scales octaves):
   loopclosing.loop_describe on every keyframe, bow.train (host) on the
   first half lap's descriptors, bow.transform into a database,
   score_l1_database for the last keyframe (the best candidate at least
   LOOP_MIN_GAP_KF keyframes older must be one of the first pass
   within LOOP_MAX_DIST_M of the query's true position), the multi-scale
   Hamming match against it, pnp.pnp_ransac on the matched landmarks (ok,
   and T_cw within LOOP_PNP_TOL_* of the ground truth), and pgo.optimize
   on the keyframes' pose graph with drifted odometry and that loop edge
   (dense) and on a circle of PGO_CG_POSES poses (above DENSE_MAX_POSES:
   CG): both must cut the error to PGO_MAX_ERR_SHARE.
   Card against the port's own CPU result on the same inputs: equal for
   words_of, the Hamming match (LoopClosing._match_impl), fast_check_sparse
   and the descriptors from one angle array; within the CPU tests'
   tolerances for ic_angle_integral, transform, pnp_ransac and
   pgo.optimize. Prints each op's CUDA-event ms beside the card's name and
   power limit.
8. loop closing in the System at KITTI width (run before phase 6 too):
   bench_loop_settings() (bench.py:51-69: the bench configuration with
   loop closing on, database warm-up at 24 keyframes), the database
   started at LOOP8_DB_ROWS rows so the run outgrows it. The JAX loop
   bench's scene (bench.py:294-307): a 10 m circle of LOOP8_LAP frames,
   seed 11, walls 24 m out, ceiling 8 m up, sensor noise 2.0, rendered on
   the card; LOOP8_LAPS laps and a quarter lap, trimmed to chunks of
   CHUNK (the bench drives 5 laps). Driven through the prefetcher and
   pipelined dispatch_chunk / collect_chunk, then finish(), as
   bench.py::_run_pass drives the JAX package: once with loop closing on,
   once off on the same frames. Checks: no LOST frame, kernel #1's
   launches as the statuses imply and every other kernel 0 (both runs),
   the vocabulary trained, the database grown, at least one accepted
   correction with fused landmarks, the keyframe end drift (gauge fixed on
   the first quarter, bench.py:338-346) below the loop-off run's, the
   keyframe ATE under ATE_MAX_M. Then relocalization through run_step on
   the loop-on System: RELOC_BLANKS blank frames drive it LOST with no
   relocalization, first-lap frame RELOC_FRAME relocalizes within
   RELOC_TOL_M of the truth (in the System's gauge: the camera of the
   frame it initialised at is its origin) and tracking resumes. Prints ms/frame both
   ways, ingest ms per keyframe, ms per verification and per PGO run, the
   events' ranges, ATE and end drift, beside the card's name and power
   limit.
9. the KITTI driver (scripts/torch_run_kitti.py; run before phase 6
   too) as users run it with no config: the System its build_system makes,
   Settings() (the KITTI-00 defaults, loop closing on). Phase 4's endless
   corridor cannot initialise it (Settings()' init gate wants 200
   landmarks of 300 detections within 60 baselines, 32 m; the corridor's
   vanishing point leaves ~160), so the scene is phase 8's circle (the
   JAX loop bench's, seed 11, noise 2.0) in a room closed at z = -10 and
   30 m (DRIVER_WORLD). DRIVER_FRAMES frames of it rendered on the card at
   1241x376 as uint8, written in the KITTI layout (kitti.write_sequence: times.txt,
   image_0/ and image_1/ PNGs, poses.txt) under build/, and decoded back
   through the native prefetching loader (built from the checkout's
   ssvio_tpu_torch/native/dataloader.cpp): every frame must equal the
   rendered one bit for bit; prints decode ms a pair on one thread and the
   loader's pairs a second. Then the driver twice, with --gt_poses and
   --frames_only_traj: per frame (with --profile_dir) and with --chunk
   DRIVER_CHUNK. Checks: no LOST frame, keyframe ATE under ATE_MAX_M in
   both, the two TUM files within CHUNK_VS_STEP_M, kernel #1's launches
   as the statuses imply and every other kernel 0 (#2 is not taken at
   1241x376); the chrome trace of frames 20..40 exists and holds as many
   kernel #1 launches as lk_cuda.LAUNCHES counted over those frames. Then
   a checkpoint with loop closing off (Settings()): CKPT_FRAMES frames, save_checkpoint,
   load_checkpoint into a fresh System, CKPT_FRAMES more, against the
   same System run on: equal statuses and keyframe counts, positions
   within CKPT_TOL_M. Prints ms a frame of each pass and the phase's wall
   time, beside the card's name and power limit.
10. multi-device BA (parallel/dist_ba.py, parallel/multihost.py; run
   before phase 6 too). The standalone sharded local BA at the bench's
   capacities (window DIST_W, DIST_M landmarks; the problem of
   scripts/profile_scaling.py::build_problem, the System's 5 x 10 LM
   schedule): a world of 1 over NCCL on the card (multihost.global_mesh
   with no process group) must equal ba.local_ba on the card bit for
   bit; then two ranks sharing the card over gloo (NCCL refuses two ranks
   on one device): this process is rank 0, a spawned process rank 1,
   joined over a file store under build/. The ranks' poses and inlier
   ratio must be equal bit for bit, and poses, landmarks and inlier ratio
   within DIST_*_TOL of the single-device result. Then the System through
   that mesh (rank 0 the primary, rank 1 serving every local BA:
   dist_ba.PrimaryBA / serve) on phase 4's frames through pipelined
   dispatch_chunk / collect_chunk: statuses and the counts of keyframes
   and local BAs equal to phase 4's, positions within CHUNK_VS_STEP_M, phase 4's checks (ATE under
   ATE_MAX_M, kernel #1's launches as the statuses imply and every other
   kernel 0), and every local BA sharded (stats n_dist_ba = n_ba = the
   problems rank 1 served). Prints CUDA-event ms per local BA solve
   plain, at 1 and at 2 ranks, ms per frame, and the phase's seconds,
   beside the card's name and power limit. A collective that waits more
   than DIST_TIMEOUT raises.
11. the profiling tools on the card (scripts/torch_profile_*.py,
   scripts/torch_probe_gauge_invariance.py; run after phase 10, before
   phase 6), each through its main(argv) at a cut: one traced steady
   chunk of PROFILE_CHUNK frames (torch_profile_trace: kernel #1's events
   in the chrome trace equal lk_cuda.LAUNCHES' delta over the chunk, the
   busy share over the untraced run of the chunk and over the traced one
   both in (0, 1], the top ops' time within the traced window);
   the ablation over PROFILE_FRAMES frames, eager (its full variant's
   statuses equal to run_step's, positions within its POS_TOL_M); each
   stage alone (torch_profile_stages: every LK stage launches kernel #1
   once a level: lk.track 3, _track_step 2 x 3, _keyframe_core 2 x 4, the
   tracking graph's replay 2 x 3, the keyframe branch eager and replayed
   2 x 4; the LM's and the local BA's graphs none), one steady keyframe
   frame alone traced (its busy share in (0, 1], kernel #1's events equal
   to its counter); the engine step
   per frame over PROFILE_FRAMES frames and in chunks of half as many
   (tracking and keyframe frames both seen); transfers (pinned and
   pageable GB/s above 0, side-stream copies overlapping the port's step
   by a share above OVERLAP_MIN); one ingest batch; and one gauge probe
   at GAUGE_PREFIX / GAUGE_END (healths equal, poses within its
   POSE_TOL_M up to the gauge). Prints each tool's numbers and the
   phase's seconds beside the card's name and power limit; its kernel
   launches join the kernel table's.
12. the bench (scripts/torch_bench.py; after phase 11, before phase 6)
   through its main(argv) at a cut (BENCH_ENV, BENCH_FAST unset, its loop
   bench BENCH_LOOP_LAPS laps and a quarter): the bench's configuration
   (bench_loop_settings()) in chunks of 32 through the tracking and
   keyframe graphs, the prefetcher pass, the loop bench and the scaling
   subprocess. Checks: the median fps above 0 with no LOST frame, the
   straight run's ATE under ATE_MAX_M, both branches on their graphs
   with tracking replays equal to the tracked frames and keyframe replays
   to the steady keyframes of the timed loops, kernel #1's launches there
   as the frames' kinds imply and every other kernel 0 (over the whole
   phase too), e2e_fps above 0, and the loop bench's revisit verified at
   least once, with both runs' keyframe ATE under ATE_MAX_M. Its claim
   that loop closing lowers the end drift is phase 8's, at two laps and a
   quarter: at one lap and a quarter the revisit comes in the last chunks,
   and the JAX bench on the same frames accepts no correction there and
   ends where loop off does (tests/loop_bench_parity.py). Prints the
   bench's line and the phase's seconds beside the card's name and power
   limit.
13. prints the kernel table as one JSON line (with each kernel's bound,
   bound_ms: the plane pixels the level needs over the memory rate, or
   its operations over the peak rate, BOUND_*), then the result line.
"""

import contextlib
import dataclasses
import datetime
import functools
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from ssvio_tpu_torch import frontend as fe
from ssvio_tpu_torch import graphs, interop, loopclosing
from ssvio_tpu_torch import map as mapmod
from ssvio_tpu_torch.config import (Settings, bench_loop_settings,
                                    bench_settings,
                                    robotcar_xb3_wide_settings)
from ssvio_tpu_torch.dataio import synthetic, synthetic_torch
from ssvio_tpu_torch.eval import ate
from ssvio_tpu_torch.ops import (_nvcc, bow, fast, lk, lk_cuda, lk_patch_cuda,
                                 orb, pgo, pnp, pyramid, sampling, se3)
from ssvio_tpu_torch import native
from ssvio_tpu_torch.dataio import kitti as kitti_io
from ssvio_tpu_torch.ops import ba, camera
from ssvio_tpu_torch.ops import lk_variants_cuda as lkv
from ssvio_tpu_torch.parallel import dist_ba, multihost
from ssvio_tpu_torch.system import System
from ssvio_tpu_torch.utils import checkpoint, profiling

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import torch_ba_trips as ba_trips  # noqa: E402
import torch_bench  # noqa: E402
import torch_probe_gauge_invariance as gauge_probe  # noqa: E402
import torch_profile_ablation as prof_ablation  # noqa: E402
import torch_profile_engine as prof_engine  # noqa: E402
import torch_profile_ingest as prof_ingest  # noqa: E402
import torch_profile_scaling as scaling  # noqa: E402
import torch_profile_stages as prof_stages  # noqa: E402
import torch_profile_trace as prof_trace  # noqa: E402
import torch_profile_transfer as prof_transfer  # noqa: E402
import torch_run_kitti as driver  # noqa: E402

# Kernel vs plain version, positions (px), on every live track that
# converged before the iteration cap. Both run the same float32 steps;
# they differ in FMA contraction (the kernel's bilinear blend) and in the
# order the 121 window products are summed (warp butterfly vs torch's
# reduction), ~1e-6 px per step. A track whose last step sits at the
# |delta| < 0.01 px convergence edge can take one more sub-0.01 px step on
# one side only, hence 0.02 px. A track still stepping at the cap (an
# oscillation that never converges) amplifies that noise without bound;
# those are counted and printed, not held to the tolerance, and they must
# stay a small share of the live tracks.
POS_TOL_PX = 0.02
MAX_CAPPED_SHARE = 0.05
N_FRAMES = 96
CHUNK = 32
ATE_MAX_M = 0.5          # the bound of tests/test_system_e2e.py
# The synthetic scene of each configuration, and its speed (m per frame).
# KITTI: the bench's world (walls 16 m apart) at 0.6 m per 10 Hz frame.
# RobotCar: a street 8 m wall to wall under an overhead plane 5 m up, at
# 0.4 m per 16 Hz frame (6.4 m/s). The geometry is a choice made so that
# the run initialises at the first frame, not a measured street: the wide
# baseline's triangulation cap is 60 x 0.24 m = 14.4 m, and in the bench's
# 16 m world too few points fall inside it for the init gate (150
# landmarks). A 12 m street initialises only at frame 25 (PERF.md, Cells).
SCENES = {"kitti_bench": (dict(), 0.6),
          "robotcar_xb3_wide": (dict(wall_x=4.0, ceiling_y=-5.0), 0.4)}
CHUNK_VS_STEP_M = 1e-3   # run_chunk vs run_step on one card: the same ops
GRAPH_VS_EAGER_M = 1e-5  # a graph replays the eager path's kernels in its
                         # order on one stream: equal bits expected
                         # in the same order; atomics may reorder sums
# mm (bf16): its windows carry about half an intensity unit of rounding
# noise, and a one-ulp difference between kernel and plain version (how the
# tensor cores round an f32 accumulation, the order of the window sums) can
# flip a bf16 rounding and move a track to another point inside that noise
# floor, whether it then converges or not (one converged track 0.034 px
# apart at KITTI level 0, measured on one H100). So after 30 iterations mm
# is held by the share of live tracks within POS_TOL_PX, which must be at
# least MM_MIN_AGREE_SHARE; and where noise cannot build up, tightly: every
# value of the windows its tensor-core sampler takes
# (lk_variants_cuda.mm_windows) at the level's template and search
# top-lefts must lie within MM_WINDOW_ULPS float32 ulps (of its window's
# largest magnitude) of the plain blend's, where one bf16 rounding that
# went the other way is ~2^15 of them; and one step (iters = 1) must land
# within MM_STEP_TOL_PX of the plain version on every live track, or within
# one float32 ulp of the position where that is coarser (1.22e-04 px at
# x >= 1024, the right fifth of KITTI level 0: a step summed in another
# order can round the position one ulp the other way there). Control:
# the mm_f32 kernel, which leaves out the bf16 roundings, held against mm's
# plain version must fail each of the three.
MM_MIN_AGREE_SHARE = 1.0 - MAX_CAPPED_SHARE
MM_WINDOW_ULPS = 2.0
MM_STEP_TOL_PX = 1e-4
FLAVOUR_FRAMES_CUT = 48     # phase 6 frames of the flavours other than mm
                            # when the script would pass SCRIPT_BUDGET_S,
SCRIPT_BUDGET_S = 600.0     # half its 1200 s limit (phase 8 is the largest)
PLAIN_REPS = 5              # timed calls of a plain version (~30 ms each)
# Phase 7: a circle of LOOP_RADIUS_M driven once in LOOP_LAP_FRAMES frames
# (1.5 degrees and 0.26 m a frame, the turn eased in over LOOP_EASE_FRAMES)
# and LOOP_OVERLAP_FRAMES further, over the start again, between walls
# LOOP_WORLD["wall_x"] from the centre line (the circle spans x in [0, 20]).
LOOP_RADIUS_M = 10.0
LOOP_LAP_FRAMES = 240
LOOP_EASE_FRAMES = 8
LOOP_OVERLAP_FRAMES = 24
LOOP_WORLD = dict(wall_x=24.0, ceiling_y=-5.0)
LOOP_MIN_GAP_KF = 10      # Settings.loop_min_age is 20, more than the ~20
                          # keyframes of this run leave room for
LOOP_MAX_DIST_M = 4.0     # keyframes lie ~3.5 m apart
LOOP_PNP_TOL_M = 0.5      # ATE_MAX_M: the candidate's landmarks carry the
LOOP_PNP_TOL_RAD = 0.05   # run's own error
PGO_DRIFT = 0.05          # per odometry edge, on the twist (rotation x 0.3)
PGO_CG_POSES = 600        # tests/test_pgo.py:122's circle, in 640 slots
PGO_MAX_ERR_SHARE = 0.35  # tests/test_pgo.py:90 and :135
# card against CPU, the CPU tests' tolerances
# (tests/test_torch_loop_ops.py, tests/test_torch_loop_geom.py)
INTEGRAL_MEDIAN_TOL, INTEGRAL_WIDE_TOL, INTEGRAL_WIDE_MIN_SHARE = \
    1e-3, 2e-2, 0.98
TRANSFORM_TOL = 1e-6
PNP_POSE_TOL = 1e-3
PGO_DENSE_TOL, PGO_CG_TOL = 1e-4, 1e-3
# Phase 8: the JAX loop bench's scene (bench.py:294-307), cut to
# LOOP8_LAPS laps and a quarter lap of LOOP8_LAP frames (the bench: 5)
LOOP8_LAP = 288
LOOP8_LAPS = 2
LOOP8_RADIUS_M = 10.0
LOOP8_WORLD = dict(seed=11, wall_x=24.0, ceiling_y=-8.0)
LOOP8_NOISE = 2.0
LOOP8_DB_ROWS = 16        # the database's rows at the start (it doubles)
RELOC_BLANKS = 3          # tests/test_relocalization.py's
RELOC_FRAME = 40          # a first-lap view
RELOC_TOL_M = 0.5         # tests/test_relocalization.py's
# Phase 9: the driver at Settings() on phase 8's circle in a closed room
DRIVER_WORLD = dict(LOOP8_WORLD, end_z=(-10.0, 30.0))
DRIVER_FRAMES = 128
DRIVER_CHUNK = 32
CKPT_FRAMES = 64          # frames before the checkpoint, and after it
CKPT_TOL_M = CHUNK_VS_STEP_M   # a resumed run is the same ops on the same
                               # state; BA's atomics may reorder sums (the
                               # JAX package's test allows 0.05 m)
# Phase 10: the bench's window and landmark capacity, tests/test_dist_ba.py's
# tolerances (the same math, summed in another order over two shards)
DIST_W, DIST_M = 16, 8192
DIST_POSE_TOL, DIST_LM_TOL, DIST_RATIO_TOL = 5e-4, 5e-3, 0.02
DIST_REPS = 5             # timed solves, after one warm-up
DIST_TIMEOUT = datetime.timedelta(seconds=120)
# Phase 11: the profiling tools at cuts
PROFILE_CHUNK = 3         # torch_profile_trace's chunk (its default: 8)
PROFILE_FRAMES = 16       # the ablation's chunk and the engine tool's frames
PROFILE_REPS = 3          # timed calls of a stage, an ingest; the
                          # transfer tool's turns (its overlap share is
                          # the median of a turn's)
GAUGE_PREFIX, GAUGE_END = 10, 20    # the gauge probe's frames (its scene's
                                    # defaults: 100, 160)
OVERLAP_MIN = 0.5         # side-stream copies against the step: a share a
                          # serialised copy (near 0) cannot reach (on an
                          # H100 a turn gives 0.67-1.21, the median 0.9-1)
# Phase 12: the bench (scripts/torch_bench.py) at a cut: two chunks of the
# straight sequence, one timed pass, and its loop bench one lap and a
# quarter (its default: 320 frames, 3 passes, 5 laps)
BENCH_ENV = dict(BENCH_FRAMES="64", BENCH_LOOPS="1")
BENCH_LOOP_LAPS = 1
KERNELS = {
    "lk_level": dict(source="ssvio_tpu_torch/csrc/lk_level.cu",
                     replaces="ssvio_tpu/ops/lk_pallas.py:344"),
    "lk_patch": dict(source="ssvio_tpu_torch/csrc/lk_patch.cu",
                     replaces="ssvio_tpu/ops/lk_pallas.py:375"),
    "lk_level_sw": dict(source="ssvio_tpu_torch/csrc/lk_level_sw.cu",
                        replaces="ssvio_tpu/ops/lk_pallas_variants.py:167"),
    "lk_level_pk": dict(source="ssvio_tpu_torch/csrc/lk_level_pk.cu",
                        replaces="ssvio_tpu/ops/lk_pallas_variants.py:104"),
    "lk_level_mm": dict(source="ssvio_tpu_torch/csrc/lk_level_mm.cu",
                        replaces="ssvio_tpu/ops/lk_pallas_variants.py:416"),
    "lk_level_mm_f32": dict(source="ssvio_tpu_torch/csrc/lk_level_mm.cu",
                            replaces="ssvio_tpu/ops/lk_pallas_variants.py:416"),
}
# the kernel pairs of phase 3b: launch counter, wrapper, plain version,
# keywords (ops/lk.py::_level_fns; ymm and pkmm are one function)
PAIRS = {
    "serial": ("lk_level", lk_cuda.lk_level, lk_cuda.lk_level_ref, {}),
    "sw": ("lk_level_sw", lkv.lk_level_sw, lkv.lk_level_sw_ref, {}),
    "ymm/pkmm": ("lk_level_pk", lkv.lk_level_pk, lkv.lk_level_pk_ref, {}),
    "mm": ("lk_level_mm", lkv.lk_level_mm, lkv.lk_level_mm_ref,
           dict(use_bf16=True)),
    "mm_f32": ("lk_level_mm_f32", lkv.lk_level_mm, lkv.lk_level_mm_ref,
               dict(use_bf16=False)),
}
# the flavours of phase 6 and the launch counter of each one's kernel
FLAVOURS = {"sw": "lk_level_sw", "ymm": "lk_level_pk", "pkmm": "lk_level_pk",
            "mm": "lk_level_mm", "mm_f32": "lk_level_mm_f32"}
# The least time one H100 SXM could take for a kernel's work (the
# card's published peaks, at 700 W): device memory
# 3.35 TB/s; 67 TFLOP/s float32 on the CUDA cores, 989 TFLOP/s bf16 on the
# tensor cores (mm's sampling products).
BOUND_BYTES_PER_S = 3.35e12
BOUND_F32_PER_S = 67e12
BOUND_BF16_PER_S = 989e12


def bound_ms(n_kp: int, work: dict, win: int, bf16: bool,
             io_words: int = 8):
    """(ms, "bytes" or "operations"): the larger of the two times for one
    KLT level of n_kp keypoints doing `work` (_work: counted by the plain
    version on this run's inputs).
    Bytes: each plane pixel the function needs, read once (the union of
    the windows of _work, at 4 B, 2 B for bf16 planes), plus io_words
    4-byte words a keypoint in and out.
    Operations: sampling the gx and gy template windows of every keypoint,
    the prev one of each keypoint live at the start and one search window
    per keypoint-iteration, separably, 3 per output of the y pass
    (win x (win+1)) and of the x pass (win x win), on the tensor cores for
    bf16; the structure tensor (6 per pixel) and per iteration the residual
    and two sums (5 per pixel) and the 2x2 solve (20), in float32."""
    w1 = win + 1
    kp_iters = work["kp_iters"]
    windows = 2 * n_kp + work["live0"] + kp_iters
    nbytes = work["pixels"] * (2 if bf16 else 4) + 4 * io_words * n_kp
    sample_ops = windows * 3 * (win * w1 + win * win)
    other_ops = n_kp * 6 * win * win + kp_iters * (5 * win * win + 20)
    t_bytes = nbytes / BOUND_BYTES_PER_S
    t_ops = (sample_ops / (BOUND_BF16_PER_S if bf16 else BOUND_F32_PER_S)
             + other_ops / BOUND_F32_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); the port's main path needs one")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    return line


def phase_build() -> None:
    seconds = torch_bench.build_kernels()
    sources = (lk_cuda.SRC, lk_patch_cuda.SRC, *lkv.SRC.values())
    print(f"build: {len(sources)} kernel sources in {seconds:.2f} s")
    for src in sources:
        info = _nvcc.build_info[src.stem]
        print(f"  {info['path']} (nvcc {info['seconds']:.2f} s)")
        for ln in info["log"].splitlines():
            if "registers" in ln or "spill" in ln:
                print("  ptxas:", ln.strip())


def _time_ms(fn, reps=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _timed_once(fn):
    """(fn(), its CUDA-event ms): one call, no warm-up."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _device_ms(fn, reps=20, tries=3) -> float:
    """Device time of one launch of the LK kernel `fn` launches: the mean
    of the kernel's own durations in a torch.profiler trace of `reps`
    calls (the CUDA-event time of back-to-back wrapper calls also holds
    the host work of each call). The trace may miss launches (19 of 20
    seen on one H100, and once none of 20 in a process that took ~100
    traces), so the mean is over those it holds, and a trace that holds
    fewer than half is taken again, up to `tries` times."""
    fn()
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages()
                if "level_kernel" in e.key or "lk_patch_kernel" in e.key]
        if len(evts) > 1:
            break
        if evts and reps // 2 <= evts[0].count <= reps:
            return evts[0].device_time_total / 1e3 / evts[0].count
    raise AssertionError(
        f"profiler: expected one LK kernel launched {reps} times, got "
        f"{[(e.key, e.count) for e in evts]}")


def _level_pair(name, pa, pb, l, pts, guess, valid, params):
    """The kernel `name` and its plain version as closures over the same
    inputs at level l. Returns (kernel(**overrides of its keywords, e.g.
    iters, stats), plain(iters, **counts),
    to_global(out): the output as level positions, frozen0, level
    arguments (planes, pts, guess, frozen0) or None for kernel #2, the
    padded dims the plain version pads to)."""
    h, w = pa.levels[l].shape
    planes = (pa.levels[l], pa.gx[l], pa.gy[l], pb.levels[l])
    r = params.window // 2
    if name == "lk_patch":
        args, kw, org_C = lk.patch_inputs(h, w, pts, guess, valid, params)
        return (lambda **o: lk_patch_cuda.lk_patch(*planes, *args,
                                                   **dict(kw, **o)),
                lambda it, **c: lk_patch_cuda.lk_patch_ref(
                    *planes, *args, **dict(kw, iters=it), **c),
                lambda out: org_C + r + out, args[-1], None,
                kw["padded_hw"])
    frozen0 = (~valid | ~sampling.in_bounds(guess, h, w, r + 1)) \
        .to(torch.int32)[:, None]
    kw = dict(win=params.window, eps=params.eps, min_eig=params.min_eig,
              padded_hw=lk.padded_dims(h, w))
    args = (*planes, pts, guess, frozen0)
    return (lambda **o: lk_cuda.lk_level(
                *args, **dict(kw, iters=params.iters, **o)),
            lambda it, **c: lk_cuda.lk_level_ref(*args, iters=it, **kw, **c),
            lambda out: out, frozen0, (args, kw), kw["padded_hw"])


def _hold(label, out_k, flag_k, plain, iters, frozen0, to_global, h, w,
          mm=False):
    """Phase 3's checks of a kernel's output against its plain version.
    Returns (stats, plain output as level positions)."""
    out_r, flag_r = plain(iters)
    # tracks still stepping at the iteration cap: the plain version one
    # step short lands elsewhere. They have not converged, so float-order
    # noise is not bounded there; they are reported, and the tolerance
    # holds on every track that converged
    capped = torch.any(plain(iters - 1)[0] != out_r, dim=-1)
    torch.cuda.synchronize()
    n_flag_diff = int((flag_k != flag_r).sum())
    g_r = to_global(out_r)
    live = (flag_k[:, 0] > 0) & (frozen0[:, 0] == 0) \
        & sampling.in_bounds(g_r, h, w, 1.0)
    d = torch.max(torch.abs(out_k - out_r), dim=-1).values
    err = float(d[live & ~capped].max()) if bool((live & ~capped).any()) \
        else 0.0
    err_capped = float(d[live & capped].max()) \
        if bool((live & capped).any()) else 0.0
    n_live, n_capped = int(live.sum()), int((live & capped).sum())
    agree = float((d[live] <= POS_TOL_PX).float().mean()) if n_live else 1.0
    res = dict(live=n_live, capped=n_capped, flag_diff=n_flag_diff,
               max_abs_err=err, max_abs_err_capped=err_capped,
               agree_share=agree)
    if n_flag_diff:
        raise AssertionError(f"{label}: {n_flag_diff} flags differ")
    if mm:
        if agree < MM_MIN_AGREE_SHARE:
            raise AssertionError(f"{label}: {agree:.3f} of the live tracks "
                                 f"agree, < {MM_MIN_AGREE_SHARE}")
    elif n_capped > MAX_CAPPED_SHARE * n_live:
        raise AssertionError(f"{label}: {n_capped} of {n_live} live tracks "
                             "hit the cap")
    elif not err <= POS_TOL_PX:
        raise AssertionError(f"{label}: positions differ by {err} px > "
                             f"{POS_TOL_PX}")
    if not bool(torch.isfinite(out_k).all()):
        raise AssertionError(f"{label}: non-finite")
    return res, g_r, live


def _work(plain, iters, padded_hw, hw) -> dict:
    """What the kernel must do on these inputs, counted by its plain
    version (lk_cuda.klt_solve_ref): keypoint-iterations, keypoints live
    at the loop's start, the most iterations of any keypoint (the level's
    longest chain) and the distinct plane pixels the function needs inside
    the true level dims hw."""
    counts = {}
    plain(iters, counts=counts)
    return dict(kp_iters=int(counts["kp_iters"]), live0=int(counts["live0"]),
                max_iters=int(counts["max_iters"]),
                pixels=lk_cuda.touched_pixels(counts, padded_hw, hw))


def phase_kernels_vs_plain(tag: str, s: Settings, dev):
    """Every level of a temporal and a stereo track, each on the kernel
    the level takes, against its plain version. Returns one row per level,
    and the inputs of every level on kernel #1 (for phase 3b)."""
    front = System(s, enable_loop_closing=False, device=dev).frontend
    world = synthetic.SyntheticWorld(seed=4, **SCENES[tag][0])
    cam = s.cam_left
    T0 = synthetic.straight_trajectory(1)[0]
    T1 = T0.copy()                        # a few px of temporal flow
    T1[:3, 3] += [0.02, 0.0, 0.1]
    c, sn = np.cos(0.003), np.sin(0.003)
    T1[:3, :3] = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]])
    L, R = synthetic_torch.render_stereo_sequence_device(
        world, np.stack([T0, T1]), cam.fx, cam.fy, cam.cx, cam.cy, s.baseline,
        s.image_width, s.image_height, pad_w=front.w, pad_h=front.h,
        u8=False, device=dev)
    pyr = {k: front._build_pyramid(v) for k, v in
           (("L0", L[0]), ("L1", L[1]), ("R0", R[0]))}
    feat, _ = front._detect_merge(pyr["L0"].levels[0],
                                  fe.empty_feat_state(s.max_features, dev))
    print(f"kernels-vs-plain [{tag}]: {int(feat.valid.sum())} of "
          f"{s.max_features} keypoints detected (the rest ride along "
          "frozen, as on the path)")
    params = front.lk_params_stereo          # 4 levels
    rows, levels = [], []
    for pair, (a, b) in (("temporal", ("L0", "L1")), ("stereo", ("L0", "R0"))):
        pa, pb = pyr[a], pyr[b]
        flow = torch.zeros_like(feat.xy)
        for l in range(len(pa.levels) - 1, -1, -1):
            h, w = pa.levels[l].shape
            name = "lk_patch" if lk.uses_patch_kernel(h, w) else "lk_level"
            pts = (feat.xy / 2.0 ** l).contiguous()
            guess = (pts + flow).contiguous()
            kern, plain, to_global, frozen0, level_args, padded_hw = \
                _level_pair(name, pa, pb, l, pts, guess, feat.valid, params)
            out_k, flag_k = kern()
            res, g_r, live = _hold(f"{tag} {pair} level {l}", out_k, flag_k,
                                   plain, params.iters, frozen0, to_global,
                                   h, w)
            if name == "lk_patch" and pair == "temporal":
                _check_patch_wide(pa, pb, l, pts, guess, feat.valid, params)
                _check_patch_region_fallback(pa, pb, l, pts, guess,
                                             feat.valid, params)
            ms_k = _time_ms(kern)
            ms_r = _time_ms(lambda: plain(params.iters), reps=PLAIN_REPS)
            chain = None
            if name == "lk_patch":      # phase 3b has kernel #1's chain
                chain = _chain(kern, dict(pair=pair, out_1=out_k,
                                          device_ms_1=None))
                dev_ms = chain["device_ms"]
            else:
                dev_ms = _device_ms(kern) if pair == "temporal" else None
            n_kp = pts.shape[0]
            work = _work(plain, params.iters, padded_hw, (h, w))
            kp_iters = work["kp_iters"]
            b_ms, b_by = bound_ms(n_kp, work, params.window, False,
                                  io_words=12 if name == "lk_patch" else 8)
            moved = torch.linalg.norm(g_r[live] - pts[live], dim=-1)
            print(f"  {pair:8s} level {l} [{h}x{w}] {name} live "
                  f"{res['live']:3d} capped {res['capped']} flag_diff "
                  f"{res['flag_diff']} max_abs_err {res['max_abs_err']:.3g} px"
                  f" (capped {res['max_abs_err_capped']:.3g} px) median_flow "
                  f"{float(moved.median()) if res['live'] else 0:.2f} px "
                  f"kernel {ms_k:.4f} ms plain {ms_r:.4f} ms kp_iters "
                  f"{kp_iters} max_iters {work['max_iters']} needed_px "
                  f"{work['pixels']} bound {b_ms:.6f} ms ({b_by}) "
                  + (_chain_text(chain) if chain else
                     f"device {dev_ms:.4f} ms" if dev_ms else ""))
            rows.append(dict(config=tag, pair=pair, level=l, kernel=name,
                             pixels=h * w, max_abs_err=res["max_abs_err"],
                             ms=ms_k, plain_ms=ms_r, bound_ms=b_ms,
                             bound_by=b_by, kp_iters=kp_iters,
                             needed_px=work["pixels"],
                             **(chain or dict(device_ms=dev_ms))))
            if level_args is not None:
                levels.append(dict(pair=pair, level=l, h=h, w=w,
                                   args=level_args, out_1=out_k,
                                   device_ms_1=dev_ms, frozen0=frozen0,
                                   iters=params.iters, padded_hw=padded_hw))
            if l > 0:
                flow = (g_r - pts) * 2.0
    return rows, levels


def _check_patch_wide(pa, pb, l, pts, guess, valid, params):
    """Kernel #2 at its widest window (_nvcc.MAX_WIN: 24, 18 pixels a
    lane) on phase 3's inputs at level l, against its plain version with
    phase 3's checks."""
    wide = params._replace(window=_nvcc.MAX_WIN["lk_patch"])
    h, w = pa.levels[l].shape
    kern, plain, to_global, frozen0, _, _ = _level_pair(
        "lk_patch", pa, pb, l, pts, guess, valid, wide)
    out_k, flag_k = kern()
    res, _, _ = _hold(f"win {wide.window} lk_patch", out_k, flag_k, plain,
                      wide.iters, frozen0, to_global, h, w)
    print(f"  win {wide.window} [lk_patch] temporal level {l}: "
          + json.dumps(res))


def _check_patch_region_fallback(pa, pb, l, pts, guess, valid, params):
    """Kernel #2 at level l with every guess REGION_OFFSET_PX off the one
    phase 3 gave (its patch boxes follow the guesses), so that searches
    walk past the staged region and read L2: _check_region_fallback's
    checks."""
    h, w = pa.levels[l].shape
    off = (guess + torch.tensor(REGION_OFFSET_PX,
                                device=guess.device)).contiguous()
    kern, plain, to_global, frozen0, _, _ = _level_pair(
        "lk_patch", pa, pb, l, pts, off, valid, params)
    stats = torch.zeros(3, dtype=torch.int32, device=guess.device)
    out_k, flag_k = kern(stats=stats)
    res, _, _ = _hold("region fallback lk_patch", out_k, flag_k, plain,
                      params.iters, frozen0, to_global, h, w, mm=True)
    n_out, kp_iters, max_iters = (int(v) for v in stats.cpu())
    print(f"  region fallback [lk_patch] temporal level {l}, guesses "
          f"{REGION_OFFSET_PX} px off: outside_region {n_out} of {kp_iters} "
          f"search windows, max_iters {max_iters}, " + json.dumps(res))
    if n_out <= 0:
        raise AssertionError("region fallback lk_patch: no search window "
                             "left the staged region")
    if not res["max_abs_err"] <= POS_TOL_PX:
        raise AssertionError("region fallback lk_patch: converged positions "
                             f"differ by {res['max_abs_err']} px > "
                             f"{POS_TOL_PX}")


def phase_flavours_vs_plain(levels) -> list:
    """Phase 3b: each flavour's kernel against its plain version at the
    KITTI levels of phase 3 (kernel #1's inputs), and its largest position
    difference from kernel #1 there."""
    print("flavours-vs-plain [kitti_bench]:")
    rows = []
    for flavour, (counter, fn, ref, extra) in PAIRS.items():
        diff_1 = 0.0
        for lv in levels:
            (args, kw), h, w, l = lv["args"], lv["h"], lv["w"], lv["level"]
            kern = functools.partial(fn, *args, iters=lv["iters"], **kw,
                                     **extra)
            def plain(it, **c):
                return ref(*args, iters=it, **kw, **extra, **c)
            out_k, flag_k = kern()
            res, _, live = _hold(f"{flavour} {lv['pair']} level {l}", out_k,
                                 flag_k, plain, lv["iters"], lv["frozen0"],
                                 lambda out: out, h, w, mm=flavour == "mm")
            d1 = float(torch.max(torch.abs(out_k - lv["out_1"])[live])) \
                if res["live"] else 0.0
            diff_1 = max(diff_1, d1)
            tight = _mm_tight(lv, plain(lv["iters"])[0]) \
                if flavour == "mm" else None
            ms_k = _time_ms(kern)
            ms_r = _time_ms(lambda: plain(lv["iters"]), reps=PLAIN_REPS)
            work = _work(plain, lv["iters"], lv["padded_hw"], (h, w))
            b_ms, b_by = bound_ms(args[4].shape[0], work, kw["win"],
                                  flavour == "mm")
            chain = _chain(kern, lv)
            print(f"  {flavour:8s} {lv['pair']:8s} level {l} [{h}x{w}] "
                  f"{counter} live {res['live']:3d} capped {res['capped']} "
                  f"agree {res['agree_share']:.3f} max_abs_err "
                  f"{res['max_abs_err']:.3g} px (capped "
                  f"{res['max_abs_err_capped']:.3g} px) vs kernel #1 "
                  f"{d1:.3g} px kernel {ms_k:.4f} ms plain {ms_r:.4f} ms "
                  f"kp_iters {work['kp_iters']} needed_px {work['pixels']} "
                  f"bound {b_ms:.6f} ms ({b_by}) {_chain_text(chain)}")
            if tight:
                print("    mm tight: " + json.dumps(tight))
            rows.append(dict(config="kitti_bench", pair=lv["pair"], level=l,
                             kernel=counter, flavour=flavour, pixels=h * w,
                             max_abs_err=res["max_abs_err"], ms=ms_k,
                             plain_ms=ms_r, bound_ms=b_ms, bound_by=b_by,
                             kp_iters=work["kp_iters"],
                             needed_px=work["pixels"], vs_kernel1_px=d1,
                             **chain))
        print(f"  {flavour}: largest position difference from kernel #1 on "
              f"the same inputs {diff_1:.3g} px (live tracks)")
        if counter in ("lk_level", "lk_level_sw") and diff_1 != 0.0:
            raise AssertionError(f"{flavour}: differs from kernel #1 by "
                                 f"{diff_1} px; it is kernel #1's kernel")
    _check_region_fallback(levels)
    _check_wide(levels)
    return rows


# the region fallback check's offset of the guesses from the true motion
# (px) and its KITTI level; the KITTI level of the widest-window check
REGION_OFFSET_PX = (12.0, 0.0)
REGION_LEVEL = ("stereo", 2)
WIDE_LEVEL = ("temporal", 0)


def _chain(kern, lv) -> dict:
    """A staged kernel's chain at one level, from its `stats`: the most
    iterations of any keypoint and the search windows read outside the
    staged region; at temporal levels its device time, the ratio to kernel
    #1's at the level (kernel #2 has none: lv["device_ms_1"] None), the
    time per iteration as a slope, (device at the
    path's iterations - device at one) / (the difference in longest chain,
    max_iters - 1), and the fixed part (device at one less one slope:
    template windows, staging, write-back, launch)."""
    out = dict(device_ms=None, ratio_to_1=None, us_per_iter=None,
               fixed_ms=None)
    stats = torch.zeros(3, dtype=torch.int32, device=lv["out_1"].device)
    kern(stats=stats)
    out["outside"], _, out["max_iters"] = (int(v) for v in stats.cpu())
    if lv["pair"] == "temporal":
        out["device_ms"] = _device_ms(kern)
        if lv["device_ms_1"] is not None:
            out["ratio_to_1"] = out["device_ms"] / lv["device_ms_1"]
        if out["max_iters"] > 1:        # one iteration: a chain of 1
            ms_1 = _device_ms(functools.partial(kern, iters=1))
            us = 1e3 * (out["device_ms"] - ms_1) / (out["max_iters"] - 1)
            out.update(us_per_iter=us, fixed_ms=ms_1 - 1e-3 * us)
    return out


def _chain_text(c) -> str:
    s = f"max_iters {c['max_iters']} outside_region {c['outside']}"
    if c["device_ms"] is not None:
        s += f" device {c['device_ms']:.4f} ms"
        if c["ratio_to_1"] is not None:
            s += f" ratio_to_1 {c['ratio_to_1']:.3f}"
        if c["us_per_iter"] is not None:
            s += (f" us_per_iter {c['us_per_iter']:.4f} (slope) fixed "
                  f"{c['fixed_ms']:.4f} ms")
    return s


def _find_level(levels, which):
    return next(lv for lv in levels
                if (lv["pair"], lv["level"]) == which)


def _check_region_fallback(levels):
    """Every flavour at REGION_LEVEL with every guess REGION_OFFSET_PX off
    the one phase 3 gave, so that searches walk past the region staged
    around their first window and read L2. Each kernel reports windows read
    outside it (> 0) and is held against its plain version: flags equal,
    at least MM_MIN_AGREE_SHARE of the live tracks within POS_TOL_PX, and
    (not mm) every converged one. Starting 12 px off, a quarter to a half
    of the tracks still step at the cap (one H100), so phase 3's bound on
    that share does not apply here; the agree share holds them instead.
    (Kernel #2: _check_patch_region_fallback, in phase 3.)"""
    lv = _find_level(levels, REGION_LEVEL)
    (args, kw), h, w = lv["args"], lv["h"], lv["w"]
    guess = (args[5] + torch.tensor(REGION_OFFSET_PX,
                                    device=args[5].device)).contiguous()
    frozen0 = (lv["frozen0"].bool() | ~sampling.in_bounds(
        guess, h, w, kw["win"] // 2 + 1)[:, None]).to(torch.int32)
    a = (*args[:5], guess, frozen0)
    for flavour, (counter, fn, ref, extra) in PAIRS.items():
        stats = torch.zeros(3, dtype=torch.int32, device=guess.device)
        out_k, flag_k = fn(*a, iters=lv["iters"], **kw, **extra, stats=stats)
        res, _, _ = _hold(f"region fallback {flavour}", out_k, flag_k,
                          lambda it, **c: ref(*a, iters=it, **kw, **extra,
                                              **c),
                          lv["iters"], frozen0, lambda out: out, h, w,
                          mm=True)
        n_out, kp_iters, max_iters = (int(v) for v in stats.cpu())
        print(f"  region fallback [{flavour}] {lv['pair']} level "
              f"{lv['level']}, guesses {REGION_OFFSET_PX} px off: "
              f"outside_region {n_out} of {kp_iters} search windows, "
              f"max_iters {max_iters}, " + json.dumps(res))
        if n_out <= 0:
            raise AssertionError(f"region fallback {flavour}: no search "
                                 "window left the staged region")
        if flavour != "mm" and not res["max_abs_err"] <= POS_TOL_PX:
            raise AssertionError(f"region fallback {flavour}: converged "
                                 f"positions differ by {res['max_abs_err']}"
                                 f" px > {POS_TOL_PX}")


def _check_wide(levels):
    """Every flavour's kernel at its widest window (_nvcc.MAX_WIN: #1 24,
    #3 23, #4 and #5 16; 18 or 8 pixels a lane, two k-steps of mm's
    products) at WIDE_LEVEL against its plain version, with phase 3's
    checks; mm by its agree share and _mm_tight."""
    lv = _find_level(levels, WIDE_LEVEL)
    (args, kw), h, w = lv["args"], lv["h"], lv["w"]
    for flavour, (counter, fn, ref, extra) in PAIRS.items():
        kw_w = dict(kw, win=_nvcc.MAX_WIN[counter])
        out_k, flag_k = fn(*args, iters=lv["iters"], **kw_w, **extra)
        def plain(it, **c):
            return ref(*args, iters=it, **kw_w, **extra, **c)
        res, _, _ = _hold(f"win {kw_w['win']} {flavour}", out_k, flag_k,
                          plain, lv["iters"], lv["frozen0"], lambda out: out,
                          h, w, mm=flavour == "mm")
        print(f"  win {kw_w['win']} [{flavour}] {lv['pair']} level "
              f"{lv['level']}: " + json.dumps(res))
        if flavour == "mm":
            print("    mm tight: " + json.dumps(_mm_tight(
                dict(lv, args=(args, kw_w)), plain(lv["iters"])[0])))


def window_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| over windows [n, win, win], in float32
    ulps (2^-23) of each window's largest magnitude in `want`."""
    scale = want.abs().amax(dim=(1, 2), keepdim=True).clamp_min(2.0 ** -126)
    return float(((got - want).abs() / (scale * 2.0 ** -23)).max())


def _mm_tight(lv, out_r, check=True) -> dict:
    """mm's tight checks at one level of phase 3b, and their control
    (MM_* above): the windows the tensor-core sampler takes at the level's
    template (prev, gx, gy; read from L2) and search-start (cur; read from
    a staged region) top-lefts, clipped as
    the solve clips them, against the plain blend's; one step against the
    plain version on every live track; and the mm_f32 kernel against mm's
    plain version through all three checks. `out_r`: the plain version's
    answer at lv["iters"]. Raises unless mm passes and the control fails
    each check (`check`)."""
    (args, kw), h, w = lv["args"], lv["h"], lv["w"]
    planes, pts, guess, frozen0 = args[:4], args[4], args[5], args[6]
    win, r = kw["win"], kw["win"] // 2
    hb, wb = kw["padded_hw"]
    lim = torch.tensor([min(wb - win - 2, w - 1), min(hb - win - 2, h - 1)],
                       dtype=torch.float32, device=pts.device)

    def top_left(p):
        return torch.minimum(torch.clamp(p - r, min=0.0), lim).contiguous()

    t_tl, c_tl = top_left(pts), top_left(guess)
    one = dict(kw, iters=1)
    step_r, flag_r = lkv.lk_level_mm_ref(*args, **one, use_bf16=True)
    live = (flag_r[:, 0] > 0) & (frozen0[:, 0] == 0)
    pos = step_r[live].abs()
    step_tol = torch.clamp(torch.nextafter(pos, pos + 1.0) - pos,
                           min=MM_STEP_TOL_PX)
    res = {}
    for tag, use_bf16 in (("mm", True), ("control_mm_f32", False)):
        n_eq = n_all = 0
        d_win = ulps = 0.0
        for k, (plane, tl) in enumerate(zip(planes, (t_tl, t_tl, t_tl,
                                                     c_tl))):
            # the search windows (cur) from a staged region, as the solve
            # reads them; the templates from L2
            got = lkv.mm_windows(plane, tl, win=win, use_bf16=use_bf16,
                                 staged=k == 3)
            want = lkv.mm_windows_ref(plane, tl, win=win, use_bf16=True)
            n_eq += int((got == want).sum())
            n_all += got.numel()
            d_win = max(d_win, float((got - want).abs().max()))
            ulps = max(ulps, window_ulps(got, want))
        step_k, _ = lkv.lk_level_mm(*args, **one, use_bf16=use_bf16)
        out_k, flag_k = lkv.lk_level_mm(*args, **kw, iters=lv["iters"],
                                        use_bf16=use_bf16)
        d = torch.max(torch.abs(out_k - out_r), dim=-1).values
        live30 = live & (flag_k[:, 0] > 0) \
            & sampling.in_bounds(out_r, h, w, 1.0)
        res[tag] = dict(
            window_ulps=ulps, window_equal_share=n_eq / n_all,
            window_max_diff=d_win,
            step_max_px=float(torch.abs(step_k - step_r)[live].max()),
            step_over_tol=float((torch.abs(step_k - step_r)[live]
                                 / step_tol).max()),
            agree_share=float((d[live30] <= POS_TOL_PX).float().mean()))
    torch.cuda.synchronize()
    mm, ctl = res["mm"], res["control_mm_f32"]
    passes = [mm["window_ulps"] <= MM_WINDOW_ULPS,
              mm["step_over_tol"] <= 1.0,
              mm["agree_share"] >= MM_MIN_AGREE_SHARE]
    control_fails = [ctl["window_ulps"] > MM_WINDOW_ULPS,
                     ctl["step_over_tol"] > 1.0,
                     ctl["agree_share"] < MM_MIN_AGREE_SHARE]
    if check and not (all(passes) and all(control_fails)):
        raise AssertionError(f"mm {lv['pair']} level {lv['level']}: tight "
                             f"checks {passes}, control fails "
                             f"{control_fails}: {res}")
    return res


def _launches_of(kinds) -> dict:
    """Kernel launches that frames of each kind imply (the counts of
    torch_bench.frame_kinds): a stereo match (init attempt, steady
    keyframe, the keyframe of a relocalization) is 2 tracks x 4 levels, a
    tracked frame 2 tracks x 3 levels. Counts for a camera whose level 0
    stays on kernel #1 and for one whose level 0 takes kernel #2."""
    n_stereo = (kinds["init_attempts"] + kinds["steady_keyframes"]
                + kinds["relocalized"])
    n_track = kinds["tracked"]
    return dict(level0_on_level=dict(lk_level=8 * n_stereo + 6 * n_track,
                                     lk_patch=0),
                level0_on_patch=dict(lk_level=6 * n_stereo + 4 * n_track,
                                     lk_patch=2 * n_stereo + 2 * n_track))


def _implied_launches(before, after):
    """The frames of each kind that the statuses before and after each
    frame imply (a relocalization: a frame that entered LOST and left
    it), and the kernel launches they imply (_launches_of)."""
    k = torch_bench.frame_kinds(after, before)
    return dict(n_init_attempts=k["init_attempts"], n_tracked=k["tracked"],
                n_steady_keyframes=k["steady_keyframes"],
                n_relocalized=k["relocalized"], **_launches_of(k))


def _check_run(tag, sys_, after, est, poses, launches, expected):
    res = dict(n_keyframes=sys_.stats["n_keyframes"], n_ba=sys_.stats["n_ba"],
               n_lost=sum(a == fe.LOST for a in after))
    stats = ate.ape_translation(est[:, :, 3], poses[:, :, 3])
    res["ate_rmse_m"] = stats["rmse"]
    if res["n_lost"]:
        raise AssertionError(f"{tag}: the run went LOST")
    if res["n_keyframes"] < 2 or res["n_ba"] < 1:
        raise AssertionError(f"{tag}: need >= 2 keyframes and >= 1 BA: {res}")
    if launches != expected:
        raise AssertionError(f"{tag}: kernel launches {launches} != "
                             f"{expected} implied by the statuses")
    if not np.all(np.isfinite(est)) or est.shape != (len(poses), 3, 4):
        raise AssertionError(f"{tag}: trajectory not finite / wrong shape")
    if not stats["rmse"] < ATE_MAX_M:
        raise AssertionError(f"{tag}: ATE {stats['rmse']} m >= {ATE_MAX_M} m")
    return res


def _launches():
    return graphs.launch_counts()


def _zero_launches():
    """Every kernel's launch counter, the graphs' replays and their
    warm-ups' launches to 0 (graphs.zero_counts)."""
    graphs.zero_counts()


def _expect(warmups=None, **counts):
    """Every kernel's launch count: `counts`, and 0 for the others, plus
    the launches of the warm-ups of the tracking and keyframe graphs built
    since the counters were zeroed (real launches, once a graph, before
    its capture): `warmups`, by default graphs.WARMUP_LAUNCHES."""
    warm = graphs.WARMUP_LAUNCHES if warmups is None else warmups
    want = dict(dict.fromkeys(_launches(), 0), **counts)
    return {k: v + warm.get(k, 0) for k, v in want.items()}


def _check_replays(tag, imp, eager=False, replays=None, kf_replays=None,
                   kf_graph=True):
    """Every tracked frame since the counters were zeroed replayed a
    tracking graph, and every steady keyframe a keyframe graph (none on
    the eager path, and no keyframe graph where `kf_graph` is False: a
    System with a mesh): `replays` and `kf_replays`, by default the
    recorder's counters (graphs.replays())."""
    counted = graphs.replays()
    got = counted[0] if replays is None else replays
    kf = counted[1] if kf_replays is None else kf_replays
    want = 0 if eager else imp["n_tracked"]
    want_kf = imp["n_steady_keyframes"] if kf_graph and not eager else 0
    if got != want or kf != want_kf:
        raise AssertionError(f"{tag}: {got} tracking-graph replays for "
                             f"{imp['n_tracked']} tracked frames, {kf} "
                             f"keyframe-graph replays for "
                             f"{imp['n_steady_keyframes']} steady keyframes "
                             f"({'eager' if eager else 'graph'} path)")


def _render(tag, s, sys_, dev):
    cam = s.cam_left
    scene, speed = SCENES[tag]
    poses = synthetic.straight_trajectory(N_FRAMES, speed=speed, yaw_rate=0.0)
    t0 = time.perf_counter()
    L, R = synthetic_torch.render_stereo_sequence_device(
        synthetic.SyntheticWorld(seed=4, **scene), poses, cam.fx, cam.fy, cam.cx,
        cam.cy, s.baseline, s.image_width, s.image_height, pad_w=sys_.w,
        pad_h=sys_.h, device=dev)
    torch.cuda.synchronize()
    print(f"  rendered {N_FRAMES} {s.image_width}x{s.image_height} stereo "
          f"pairs on the card in {time.perf_counter() - t0:.2f} s")
    return poses, L, R


def _run_steps(sys_, L, R, ts):
    before, after, ms = [], [], []
    for i in range(len(L)):
        before.append(sys_.status)
        t = time.perf_counter()
        sys_.run_step(L[i], R[i], ts[i])         # returns numpy: synchronized
        ms.append(1e3 * (time.perf_counter() - t))
        after.append(sys_.status)
    return before, after, ms


def _steady_kf_ms(ms, before, after):
    """The ms of the steady keyframe frames (tracked, turned BAD): their
    median, and the first one's (on the graph path it builds the keyframe
    graph: a warm-up run, the capture and a replay)."""
    kf = [m for m, b, a in zip(ms, before, after)
          if b in (fe.TRACKING_GOOD, fe.TRACKING_BAD) and a == fe.TRACKING_BAD]
    return (float(np.median(kf)), kf[0]) if kf else (None, None)


def phase_run_step(s: Settings, dev):
    print("run_step path [kitti_bench]:")
    sys_ = System(s, enable_backend=True, enable_loop_closing=False,
                  device=dev)
    poses, L, R = _render("kitti_bench", s, sys_, dev)
    _zero_launches()
    before, after, ms = _run_steps(sys_, L, R, [i / s.fps for i in range(N_FRAMES)])
    launches = _launches()
    imp = _implied_launches(before, after)
    _, est = sys_.frame_trajectory()
    res = _check_run("run_step", sys_, after, est, poses, launches,
                     _expect(**imp["level0_on_level"]))
    _check_replays("run_step", imp)
    trips = ba_trips.trips(sys_._engine)
    sys_.close()
    res.update(launches=launches, median_ms_per_frame=float(np.median(ms)),
               mean_ms_per_frame=float(np.mean(ms)),
               median_ms_tracked_good=float(np.median(
                   [m for m, b, a in zip(ms, before, after)
                    if b in (fe.TRACKING_GOOD, fe.TRACKING_BAD)
                    and a == fe.TRACKING_GOOD])),
               steady_keyframe_ms=dict(zip(("median", "first"),
                                           _steady_kf_ms(ms, before, after))),
               total_s=sum(ms) / 1e3, n_init_attempts=imp["n_init_attempts"],
               n_tracked=imp["n_tracked"],
               n_steady_keyframes=imp["n_steady_keyframes"], ba_trips=trips)
    print("  run_step: " + json.dumps(res))
    return res, dict(poses=poses, L=L, R=R, after=after, est=est,
                     n_keyframes=res["n_keyframes"], n_ba=res["n_ba"])


def phase_chunks(s: Settings, dev) -> dict:
    print(f"chunk path [robotcar_xb3_wide]: {N_FRAMES} frames in chunks of "
          f"{CHUNK}; frame period {1e3 / s.fps:.1f} ms at {s.fps:g} Hz")
    sys_ = System(s, enable_backend=True, enable_loop_closing=False,
                  device=dev)
    poses, L, R = _render("robotcar_xb3_wide", s, sys_, dev)
    # set-up: the frames reach the System from the host, as a camera's do
    L, R = L.cpu().numpy(), R.cpu().numpy()
    ts = [i / s.fps for i in range(N_FRAMES)]

    _zero_launches()
    after, chunk_ms, total_s = _drive_chunks(sys_, L, R, ts)
    launches = _launches()
    before = [fe.INITING] + after[:-1]
    imp = _implied_launches(before, after)
    _, est = sys_.frame_trajectory()
    res = _check_run("run_chunk", sys_, after, est, poses, launches,
                     _expect(**imp["level0_on_patch"]))
    _check_replays("run_chunk", imp)
    sys_.close()
    res.update(launches=launches, n_init_attempts=imp["n_init_attempts"],
               n_tracked=imp["n_tracked"],
               chunk_ms=chunk_ms, median_ms_per_chunk=float(np.median(chunk_ms)),
               median_ms_per_frame=float(np.median(chunk_ms)) / CHUNK,
               total_s=total_s, ms_per_frame_overall=1e3 * total_s / N_FRAMES)
    print("  run_chunk: " + json.dumps(res))

    # the same host frames through run_step
    ref = System(s, enable_backend=True, enable_loop_closing=False,
                 device=dev)
    _zero_launches()
    before2, after2, ms = _run_steps(ref, L, R, ts)
    imp2 = _implied_launches(before2, after2)
    if _launches() != _expect(**imp2["level0_on_patch"]):
        raise AssertionError(f"run_step at 1280x960: launches {_launches()} "
                             f"!= {imp2['level0_on_patch']}")
    _check_replays("run_step at 1280x960", imp2)
    ref.close()
    _, est2 = ref.frame_trajectory()
    d = float(np.abs(est[:, :, 3] - est2[:, :, 3]).max())
    print(f"  run_step on the same frames: median {np.median(ms):.2f} "
          f"ms/frame, keyframes {ref.stats['n_keyframes']}, max position "
          f"difference to run_chunk {d:.3g} m")
    if after2 != after or ref.stats["n_keyframes"] != res["n_keyframes"]:
        raise AssertionError("run_chunk and run_step disagree on statuses "
                             "or keyframes")
    if not d <= CHUNK_VS_STEP_M:
        raise AssertionError(f"run_chunk vs run_step: positions differ by "
                             f"{d} m > {CHUNK_VS_STEP_M}")
    res.update(run_step_median_ms_per_frame=float(np.median(ms)),
               chunk_vs_step_max_m=d)
    return res, dict(L=L, R=R, ts=ts, poses=poses, after=after, est=est)


def _drive_chunks(sys_, L, R, ts):
    """L, R (host frames) in chunks of CHUNK through the prefetcher and
    pipelined dispatch_chunk / collect_chunk (chunk k+1 dispatched before
    chunk k is collected), then finish(), as bench.py::_run_pass drives
    the JAX package. Returns (statuses after each frame, ms per pipelined
    iteration, total seconds)."""
    chunks = [slice(a, a + CHUNK) for a in range(0, len(L), CHUNK)]
    t0 = time.perf_counter()
    pf = sys_.prefetcher(depth=2)
    for sl in chunks[:2]:
        pf.submit(L[sl], R[sl])
    handles, chunk_ms, prev = [], [], None
    for k, sl in enumerate(chunks):
        t = time.perf_counter()
        h = sys_.dispatch_chunk(*pf.get(), ts[sl])
        if k + 2 < len(chunks):
            pf.submit(L[chunks[k + 2]], R[chunks[k + 2]])
        if prev is not None:
            sys_.collect_chunk(prev)
        chunk_ms.append(1e3 * (time.perf_counter() - t))
        handles.append(h)
        prev = h
    sys_.collect_chunk(prev)
    sys_.finish()
    pf.close()
    total_s = time.perf_counter() - t0
    return ([int(v) for h in handles for v in h.outs.status], chunk_ms,
            total_s)


@contextlib.contextmanager
def _sync_free_replays():
    """Every tracking-graph call (its copy-in, replay and copy-out) under
    torch.cuda.set_sync_debug_mode("error"): a call on its way that waits
    for the device raises."""
    call = graphs.StaticGraph.__call__

    def guarded(self, *args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return call(self, *args)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    graphs.StaticGraph.__call__ = guarded
    try:
        yield
    finally:
        graphs.StaticGraph.__call__ = call


def _lm_ms(sys_) -> dict:
    """The pose-only LM (4 x 10 iterations, a fixed trip) on the System's
    last tracked frame: its features against their landmarks from the
    pose, eager and replayed from a CUDA graph of it (graphs.StaticGraph),
    CUDA-event ms a call; the two must agree (poses within
    GRAPH_VS_EAGER_M, equal inliers)."""
    f, feat, m = sys_.frontend, sys_.feat, sys_.map
    args = (sys_.T_cw, m.lm_pos[torch.clamp(feat.lm_slot, min=0).long()],
            feat.xy, feat.valid)

    def lm(T, p_w, uv, valid):
        return ba.pose_only_optimize(T, p_w, uv, valid, f._fx, f._fy, f._cx,
                                     f._cy)

    graph = graphs.StaticGraph(lm, *args)
    want, got = lm(*args), graph(*args)
    d = float((want.T_cw - got.T_cw).abs().max())
    if not d <= GRAPH_VS_EAGER_M or not torch.equal(want.inlier, got.inlier):
        raise AssertionError(f"the pose-only LM's graph differs from its "
                             f"eager call: pose by {d}, inliers "
                             f"{int(want.n_inliers)} / {int(got.n_inliers)}")
    res = dict(eager_ms=_time_ms(lambda: lm(*args), reps=5, warmup=1),
               graph_ms=_time_ms(lambda: graph(*args), reps=20, warmup=2),
               iterations=40, n_valid=int(feat.valid.sum()),
               graph_vs_eager=d)
    graph.close()
    return res


def _ba_ms(sys_) -> dict:
    """The local BA (5 x 10, a fixed trip) on the System's window, eager
    and replayed from a CUDA graph of it (graphs.StaticGraph, which skips
    the rounds after the inlier-ratio flag), CUDA-event
    ms a call; the two must agree (poses and landmarks within
    GRAPH_VS_EAGER_M, equal edges)."""
    f = sys_.frontend
    prob = mapmod.ba_problem_from_map(sys_.map)

    def bundle(p):
        return ba.local_ba(p, f._fx, f._fy, f._cx, f._cy, f._baseline)

    graph = graphs.StaticGraph(bundle, prob)
    want, got = bundle(prob), graph(prob)
    d = max(float((want.kf_T_cw - got.kf_T_cw).abs().max()),
            float((want.lm_pos - got.lm_pos).abs().max()))
    if not d <= GRAPH_VS_EAGER_M or not torch.equal(want.obs_valid,
                                                    got.obs_valid):
        raise AssertionError(f"the local BA's graph differs from its eager "
                             f"call by {d}")
    res = dict(eager_ms=_time_ms(lambda: bundle(prob), reps=5, warmup=1),
               graph_ms=_time_ms(lambda: graph(prob), reps=10, warmup=2),
               rounds=int(want.rounds), steps=int(want.iterations),
               n_keyframes=int(prob.kf_valid.sum()),
               n_landmarks=int(prob.lm_valid.sum()), graph_vs_eager=d)
    graph.close()
    return res


def _turns(tag, run) -> list:
    """`run(eager)` in turns eager, graph, graph, eager (each a new
    System), every graph replay sync-free (_sync_free_replays). Statuses
    and keyframe counts must be equal across the four, and positions
    within GRAPH_VS_EAGER_M between the paths; the differences are
    printed."""
    runs = []
    for eager in (True, False, False, True):
        with _sync_free_replays():
            runs.append(run(eager))
    e1, g1, g2, e2 = runs
    diff = {name: float(np.abs(a["est"][:, :, 3] - b["est"][:, :, 3]).max())
            for name, a, b in (("graph_vs_eager", g1, e1),
                               ("graph2_vs_eager2", g2, e2),
                               ("graph_vs_graph", g1, g2),
                               ("eager_vs_eager", e1, e2))}
    ms = [r["ms_per_frame"] for r in runs]
    print(f"  {tag}: ms/frame eager {ms[0]:.2f}, graph {ms[1]:.2f}, graph "
          f"{ms[2]:.2f}, eager {ms[3]:.2f}; keyframes "
          f"{[r['n_keyframes'] for r in runs]} (steady "
          f"{[r['n_steady_keyframes'] for r in runs]}); largest position "
          "differences (m) " + json.dumps(diff))
    if any(r["after"] != e1["after"] or r["n_keyframes"] != e1["n_keyframes"]
           for r in runs):
        raise AssertionError(f"{tag}: the graph and eager paths disagree "
                             "on statuses or keyframes")
    if not max(diff.values()) <= GRAPH_VS_EAGER_M:
        raise AssertionError(f"{tag}: positions differ by {diff} m > "
                             f"{GRAPH_VS_EAGER_M} m")
    return [dict({k: v for k, v in r.items() if k not in ("est", "after")},
                 eager=eager) for r, eager in zip(runs, (True, False, False,
                                                         True))], diff


def phase_graph_vs_eager(kitti: Settings, robotcar: Settings, dev,
                         frames: dict, chunk_frames: dict, card: str) -> dict:
    """Phase 5b (module docstring)."""
    print("graph against eager: phase 4's frames through run_step and "
          "phase 5's in pipelined chunks, in turns eager, graph, graph, "
          "eager")
    t_phase = time.perf_counter()
    out = dict(launches=dict.fromkeys(_launches(), 0))
    lm, ba_graph = {}, {}

    def counted(tag, sys_, before, after, est, poses, eager, imp_key):
        launches = _launches()
        imp = _implied_launches(before, after)
        _check_run(tag, sys_, after, est, poses, launches,
                   _expect(**imp[imp_key]))
        _check_replays(tag, imp, eager)
        if imp["n_steady_keyframes"] < 1:
            raise AssertionError(f"{tag}: no steady keyframe, so nothing "
                                 "held the keyframe graph against eager")
        for k, v in launches.items():
            out["launches"][k] += v
        return imp["n_steady_keyframes"]

    def kitti_run(eager):
        tag = f"run_step [{'eager' if eager else 'graph'}]"
        sys_ = System(kitti, enable_backend=True, enable_loop_closing=False,
                      device=dev, eager=eager)
        _zero_launches()
        before, after, ms = _run_steps(
            sys_, frames["L"], frames["R"],
            [i / kitti.fps for i in range(len(frames["L"]))])
        _, est = sys_.frame_trajectory()
        n_steady = counted(tag, sys_, before, after, est, frames["poses"],
                           eager, "level0_on_level")
        if not eager and not lm:
            lm.update(_lm_ms(sys_))
            ba_graph.update(_ba_ms(sys_))
        sys_.close()
        return dict(after=after, est=est, ms_per_frame=float(np.median(ms)),
                    mean_ms_per_frame=float(np.mean(ms)),
                    steady_kf_ms=_steady_kf_ms(ms, before, after)[0],
                    n_keyframes=sys_.stats["n_keyframes"],
                    n_steady_keyframes=n_steady)

    def robotcar_run(eager):
        tag = f"run_chunk [{'eager' if eager else 'graph'}]"
        sys_ = System(robotcar, enable_backend=True,
                      enable_loop_closing=False, device=dev, eager=eager)
        _zero_launches()
        after, chunk_ms, total_s = _drive_chunks(
            sys_, chunk_frames["L"], chunk_frames["R"], chunk_frames["ts"])
        _, est = sys_.frame_trajectory()
        n_steady = counted(tag, sys_, [fe.INITING] + after[:-1], after, est,
                           chunk_frames["poses"], eager, "level0_on_patch")
        sys_.close()
        return dict(after=after, est=est,
                    ms_per_frame=float(np.median(chunk_ms)) / CHUNK,
                    total_s=total_s, n_keyframes=sys_.stats["n_keyframes"],
                    n_steady_keyframes=n_steady)

    out["run_step"], out["run_step_diff_m"] = _turns(
        "run_step [kitti_bench]", kitti_run)
    out["run_chunk"], out["run_chunk_diff_m"] = _turns(
        "run_chunk [robotcar_xb3_wide]", robotcar_run)
    out["pose_only_lm"] = lm
    out["local_ba"] = ba_graph
    out["wall_s"] = time.perf_counter() - t_phase
    kf_ms = [r["steady_kf_ms"] for r in out["run_step"]]
    print(f"  [{card}] steady keyframe frames, median ms, eager / graph / "
          f"graph / eager: {kf_ms}")
    print(f"  [{card}] pose-only LM on the last tracked frame "
          f"({lm['n_valid']} features, {lm['iterations']} iterations): "
          f"eager {lm['eager_ms']:.3f} ms, graph {lm['graph_ms']:.3f} ms; "
          f"local BA of its window ({ba_graph['n_keyframes']} keyframes, "
          f"{ba_graph['n_landmarks']} landmarks, {ba_graph['rounds']} "
          f"rounds / {ba_graph['steps']} LM steps of the 50 run): eager "
          f"{ba_graph['eager_ms']:.3f} ms, graph {ba_graph['graph_ms']:.3f} "
          f"ms (CUDA events); phase 5b {out['wall_s']:.1f} s")
    return out


def phase_flavours(s: Settings, dev, serial: dict, t_start: float) -> dict:
    """Phase 6: phase 4's frames through run_step on each flavour."""
    est_s = len(FLAVOURS) * serial["seconds"]
    n_cut = N_FRAMES
    if time.perf_counter() - t_start + est_s > SCRIPT_BUDGET_S:
        n_cut = FLAVOUR_FRAMES_CUT
        print(f"flavours: the script would pass {SCRIPT_BUDGET_S:.0f} s; "
              f"the flavours other than mm run {n_cut} of {N_FRAMES} frames")
    out = {}
    for flavour, counter in FLAVOURS.items():
        n = N_FRAMES if flavour == "mm" else n_cut
        sk = dataclasses.replace(s, lk_kernel=flavour)
        sys_ = System(sk, enable_backend=True, enable_loop_closing=False,
                      device=dev)
        _zero_launches()
        before, after, ms = _run_steps(sys_, serial["L"][:n], serial["R"][:n],
                                       [i / s.fps for i in range(n)])
        launches = _launches()
        imp = _implied_launches(before, after)
        _, est = sys_.frame_trajectory()
        res = _check_run(f"run_step [{flavour}]", sys_, after, est,
                         serial["poses"][:n], launches,
                         _expect(**{counter: imp["level0_on_level"]
                                    ["lk_level"]}))
        _check_replays(f"run_step [{flavour}]", imp)
        sys_.close()
        res.update(frames=n, launches=launches,
                   median_ms_per_frame=float(np.median(ms)),
                   status_diff_vs_serial=sum(
                       a != b for a, b in zip(after, serial["after"][:n])),
                   max_position_diff_vs_serial_m=float(np.abs(
                       est[:, :, 3] - serial["est"][:n, :, 3]).max()))
        print(f"  run_step [{flavour}]: " + json.dumps(res))
        out[flavour] = dict(res, est=est, after=after)
    # ymm and pkmm name one function: the runs must be the same
    y, p = out["ymm"], out["pkmm"]
    if y["after"] != p["after"] or not np.array_equal(y["est"], p["est"]):
        raise AssertionError("run_step [pkmm] differs from run_step [ymm]")
    print("  run_step [pkmm] = run_step [ymm]: statuses and trajectory equal")
    return out


def _loop_drive() -> np.ndarray:
    """[N, 3, 4] T_wc on a circle through the origin, heading along the
    tangent (synthetic.loop_trajectory's), a lap and LOOP_OVERLAP_FRAMES
    more, the turn rate eased in over the first frames."""
    n = LOOP_LAP_FRAMES + LOOP_OVERLAP_FRAMES
    step = 2.0 * np.pi / LOOP_LAP_FRAMES * np.minimum(
        1.0, (np.arange(n) + 1.0) / LOOP_EASE_FRAMES)
    ang = np.concatenate([[0.0], np.cumsum(step)[:-1]])
    c, sn = np.cos(ang), np.sin(ang)
    poses = np.zeros((n, 3, 4))
    poses[:, 0, 0], poses[:, 0, 2], poses[:, 1, 1] = c, sn, 1.0
    poses[:, 2, 0], poses[:, 2, 2] = -sn, c
    poses[:, 0, 3] = LOOP_RADIUS_M * sn
    poses[:, 2, 3] = LOOP_RADIUS_M * (1.0 - c)
    return poses


def _ang_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a.double().cpu() - b.double().cpu()
    return torch.abs(torch.atan2(torch.sin(d), torch.cos(d)))


def _twist_err(A: torch.Tensor, B: torch.Tensor):
    """(|rho|, |phi|) of log(A B^-1), on the CPU."""
    xi = se3.log(se3.compose(A.cpu(), se3.inverse(B.cpu())))
    return float(torch.linalg.norm(xi[:3])), float(torch.linalg.norm(xi[3:]))


def _centre_err(T_cw, centres_true: np.ndarray) -> np.ndarray:
    """Per-pose distance of the camera centres of T_cw [K, 3, 4] from
    centres_true [K, 3]."""
    c = se3.translation(se3.inverse(torch.as_tensor(
        np.asarray(T_cw, np.float32)))).numpy()
    return np.linalg.norm(c - centres_true, axis=1)


def _circle_graph(n: int, slots: int, drift: float, seed: int):
    """tests/test_pgo.py's graph: true poses on a circle of radius 10 m,
    exact odometry edges, estimates integrated from drifted odometry, loop
    edges last->first and across the middle; the first pose fixed; `slots`
    pose slots. Returns (PGOProblem of CPU tensors, true centres [n, 3])."""
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(n) / n
    c, sn = np.cos(ang), np.sin(ang)
    T_wc = np.zeros((n, 3, 4), np.float32)
    T_wc[:, 0, 0], T_wc[:, 0, 2], T_wc[:, 1, 1] = c, sn, 1.0
    T_wc[:, 2, 0], T_wc[:, 2, 2] = -sn, c
    T_wc[:, 0, 3], T_wc[:, 2, 3] = 10.0 * sn, 10.0 * (1 - c)
    T_true = se3.inverse_np(T_wc)
    Zs = se3.compose_np(T_true[1:], se3.inverse_np(T_true[:-1]))
    noise = rng.normal(0, drift, (n - 1, 6)).astype(np.float32)
    noise[:, 3:] *= 0.3
    Zn = se3.compose(se3.exp(torch.from_numpy(noise)),
                     torch.from_numpy(Zs)).numpy()
    est = [T_true[0]]
    for k in range(n - 1):
        est.append(se3.compose_np(Zn[k], est[-1]))
    loops = [(n - 1, 0), (n // 2, n // 2 - 1)]
    ei = np.concatenate([np.arange(1, n), [i for i, _ in loops]])
    ej = np.concatenate([np.arange(0, n - 1), [j for _, j in loops]])
    Z = np.concatenate([Zs, np.stack([se3.compose_np(
        T_true[i], se3.inverse_np(T_true[j])) for i, j in loops])])
    poses = np.tile(np.eye(3, 4, dtype=np.float32), (slots, 1, 1))
    poses[:n] = np.stack(est)
    valid = np.arange(slots) < n
    prob = pgo.PGOProblem(
        poses=torch.from_numpy(poses), pose_valid=torch.from_numpy(valid),
        pose_fixed=torch.from_numpy(np.arange(slots) == 0),
        edge_i=torch.from_numpy(ei.astype(np.int32)),
        edge_j=torch.from_numpy(ej.astype(np.int32)),
        edge_Z=torch.from_numpy(Z.astype(np.float32)),
        edge_valid=torch.ones(len(ei), dtype=torch.bool),
        edge_weight=torch.ones(len(ei), dtype=torch.float32))
    return prob, T_wc[:, :, 3]


def phase_place_recognition(s: Settings, dev, card: str) -> dict:
    """Phase 7 (module docstring)."""
    print(f"place recognition [kitti_bench]: a circle of {LOOP_RADIUS_M:g} m "
          f"in {LOOP_LAP_FRAMES} frames and {LOOP_OVERLAP_FRAMES} more")
    cam = s.cam_left
    F, S = s.max_features, s.loop_desc_scales
    sys_ = System(s, enable_backend=True, enable_loop_closing=False,
                  device=dev)
    poses = _loop_drive()
    n = len(poses)
    t0 = time.perf_counter()
    L, R = synthetic_torch.render_stereo_sequence_device(
        synthetic.SyntheticWorld(seed=4, **LOOP_WORLD), poses, cam.fx, cam.fy,
        cam.cx, cam.cy, s.baseline, s.image_width, s.image_height,
        pad_w=sys_.w, pad_h=sys_.h, device=dev)
    torch.cuda.synchronize()
    print(f"  rendered {n} stereo pairs on the card in "
          f"{time.perf_counter() - t0:.2f} s")

    # --- the run that feeds it: keyframes with image, features, landmarks
    _zero_launches()
    before, after, ms, kfs = [], [], [], []
    for i in range(n):
        before.append(sys_.status)
        t = time.perf_counter()
        sys_.run_step(L[i], R[i], i / s.fps)
        ms.append(1e3 * (time.perf_counter() - t))
        after.append(sys_.status)
        if len(sys_.records.keyframes) > len(kfs):
            feat, m = sys_.feat, sys_.map
            slot = torch.clamp(feat.lm_slot, min=0).long()
            has_lm = feat.valid & (feat.lm_slot >= 0) & m.lm_valid[slot] \
                & (m.lm_gid[slot] == feat.lm_gid)
            kfs.append(dict(rec=sys_.records.keyframes[-1], frame=i,
                            img=sys_.last_pyr.levels[0].clone(),
                            xy=feat.xy.clone(), valid=feat.valid.clone(),
                            has_lm=has_lm, lm_pos=m.lm_pos[slot].clone()))
    launches = _launches()
    imp = _implied_launches(before, after)
    _, est = sys_.frame_trajectory()
    res = _check_run("place recognition run", sys_, after, est, poses,
                     launches, _expect(**imp["level0_on_level"]))
    _check_replays("place recognition run", imp)
    sys_.close()
    res.update(launches=launches, frames=n,
               median_ms_per_frame=float(np.median(ms)))
    print("  run_step: " + json.dumps(res))
    K = len(kfs)
    # the vocabulary's training set: the keyframes of the first half lap
    first = [k for k, kf in enumerate(kfs)
             if kf["frame"] < LOOP_LAP_FRAMES // 2]
    if K < LOOP_MIN_GAP_KF + 4 or len(first) < 4 \
            or kfs[-1]["frame"] < LOOP_LAP_FRAMES:
        raise AssertionError(f"place recognition: {K} keyframes, "
                             f"{len(first)} in the first half lap, the last "
                             f"at frame {kfs[-1]['frame']}")
    times = {}

    def timed(name, fn, reps=5, warmup=1):
        times[name] = _time_ms(fn, reps=reps, warmup=warmup)

    # --- descriptors of every keyframe
    screen = float(s.min_th_fast) if s.loop_screen_fast else 0.0
    pattern = loopclosing.pattern_from_settings(s)

    def describe(kf):
        return loopclosing.loop_describe(kf["img"], kf["xy"], kf["valid"],
                                         S, s.scale_factor,
                                         screen_threshold=screen,
                                         pattern=pattern)

    for kf in kfs:
        kf["desc"], kf["dval"] = describe(kf)
    timed("loop_describe (1 keyframe)", lambda: describe(kfs[-1]))
    n_rows = [int(kf["dval"].sum()) for kf in kfs]
    print(f"  {K} keyframes ({len(first)} in the first half lap), {F} "
          f"features x "
          f"{S} octaves = {F * S} descriptor rows each, valid rows "
          f"{min(n_rows)}-{max(n_rows)}")

    # --- vocabulary (host) and database
    docs = [interop.descriptors_numpy(kfs[k]["desc"][kfs[k]["dval"]])
            for k in first]
    t0 = time.perf_counter()
    vocab_cpu = bow.train(docs, k=s.vocab_k, levels=s.vocab_levels)
    train_s = time.perf_counter() - t0
    vocab = vocab_cpu.to(dev)
    print(f"  bow.train on the host: {sum(len(d) for d in docs)} descriptors "
          f"of {len(docs)} keyframes, k={s.vocab_k} L={s.vocab_levels} -> "
          f"{vocab.n_words} words in {train_s:.2f} s")
    Lv = s.vocab_levels
    db = torch.stack([bow.transform(vocab, kf["desc"], kf["dval"], Lv)
                      for kf in kfs])
    q = K - 1
    kq = kfs[q]
    timed("bow.words_of", lambda: bow.words_of(vocab, kq["desc"], kq["dval"],
                                               Lv))
    timed("bow.transform", lambda: bow.transform(vocab, kq["desc"],
                                                 kq["dval"], Lv))

    # --- retrieval
    cand_ok = torch.arange(K, device=dev) <= q - LOOP_MIN_GAP_KF
    scores = bow.score_l1_database(db[q], db, cand_ok)
    timed("bow.score_l1_database", lambda: bow.score_l1_database(
        db[q], db, cand_ok))
    c = int(torch.argmax(scores))
    kc = kfs[c]
    dist = float(np.linalg.norm(poses[kq["frame"], :, 3]
                                - poses[kc["frame"], :, 3]))
    print(f"  query keyframe {q} (frame {kq['frame']}): best candidate "
          f"{c} (frame {kc['frame']}) score {float(scores[c]):.4f}, true "
          f"distance {dist:.3f} m; scores "
          + json.dumps([round(float(v), 4) for v in scores.cpu()]))
    if kc["frame"] >= LOOP_LAP_FRAMES // 2 or not dist <= LOOP_MAX_DIST_M:
        raise AssertionError(f"place recognition: candidate {c} (frame "
                             f"{kc['frame']}, {dist} m away) is not a "
                             "keyframe of the first pass near the query")

    # --- match (the loop closer's, adaptive gate; it needs no database
    # rows) and PnP
    match = loopclosing.LoopClosing(
        dataclasses.replace(s, max_keyframes_db=1), cam.fx, cam.fy, cam.cx,
        cam.cy, device=dev)._match_impl
    best_j, hd, ok = match(kq["desc"], kq["dval"], kc["desc"], kc["dval"])
    timed("multi-scale Hamming match", lambda: match(
        kq["desc"], kq["dval"], kc["desc"], kc["dval"]))
    best_j = best_j.long()
    ok = ok & kc["has_lm"][best_j]
    p_w = kc["lm_pos"][best_j].contiguous()
    gen = torch.Generator(device=dev).manual_seed(6)
    idx = pnp.sample_indices(ok, 128, 6, gen)
    K4 = (cam.fx, cam.fy, cam.cx, cam.cy)
    r_pnp = pnp.pnp_ransac(p_w, kq["xy"], ok, *K4, sample_idx=idx)
    timed("pnp.pnp_ransac", lambda: pnp.pnp_ransac(p_w, kq["xy"], ok, *K4,
                                                   sample_idx=idx), reps=3)
    T_true = torch.from_numpy(se3.inverse_np(
        poses[kq["frame"]].astype(np.float32)))
    e_t, e_r = _twist_err(r_pnp.T_cw, T_true)
    print(f"  match: {int(ok.sum())} mutual matches with a landmark (median "
          f"Hamming {float(hd[ok].float().median()):.0f}); pnp_ransac ok "
          f"{bool(r_pnp.ok)}, {int(r_pnp.n_inliers)} inliers, T_cw off the "
          f"ground truth by {e_t:.4f} m, {e_r:.5f} rad")
    if not bool(r_pnp.ok) or not (e_t <= LOOP_PNP_TOL_M
                                  and e_r <= LOOP_PNP_TOL_RAD):
        raise AssertionError("place recognition: pnp_ransac did not recover "
                             f"the pose ({e_t} m, {e_r} rad)")

    # --- pose graphs: the keyframes' with drifted odometry + the loop edge
    gid_ix = {kf["rec"]["gid"]: k for k, kf in enumerate(kfs)}
    T_kf = np.stack([kf["rec"]["T_cw"] for kf in kfs]).astype(np.float32)
    centres = np.stack([poses[kf["frame"], :, 3] for kf in kfs])
    edges = [(gid_ix[g], gid_ix[gp], Z)
             for gp, g, Z in sys_.records.odometry_edges]
    rng = np.random.default_rng(8)
    noise = rng.normal(0, PGO_DRIFT, (len(edges), 6)).astype(np.float32)
    noise[:, 3:] *= 0.3
    Zn = se3.compose(se3.exp(torch.from_numpy(noise)), torch.from_numpy(
        np.stack([Z for _, _, Z in edges]).astype(np.float32))).numpy()
    drifted = T_kf.copy()
    for (i, j, _), Z in zip(edges, Zn):     # in keyframe order
        drifted[i] = se3.compose_np(Z, drifted[j])
    Z_loop = se3.compose_np(r_pnp.T_cw.cpu().numpy(), se3.inverse_np(T_kf[c]))
    prob_kf = pgo.PGOProblem(
        poses=torch.from_numpy(drifted),
        pose_valid=torch.ones(K, dtype=torch.bool),
        pose_fixed=torch.arange(K) == 0,
        edge_i=torch.tensor([i for i, _, _ in edges] + [q],
                            dtype=torch.int32),
        edge_j=torch.tensor([j for _, j, _ in edges] + [c],
                            dtype=torch.int32),
        edge_Z=torch.from_numpy(np.concatenate([Zn, Z_loop[None]])),
        edge_valid=torch.ones(len(edges) + 1, dtype=torch.bool),
        edge_weight=torch.ones(len(edges) + 1, dtype=torch.float32))
    prob_cg, centres_cg = _circle_graph(PGO_CG_POSES, 640, 0.01, seed=9)
    if not K <= pgo.DENSE_MAX_POSES < prob_cg.poses.shape[0]:
        raise AssertionError("pose graphs: one dense, one CG")
    pgo_out = {}
    for name, prob, cen, iters, tol in (
            ("dense", prob_kf, centres, 20, PGO_DENSE_TOL),
            ("cg", prob_cg, centres_cg, 15, PGO_CG_TOL)):
        nv = len(cen)
        prob_d = pgo.PGOProblem(*[t.to(dev) for t in prob])
        out, times[f"pgo.optimize ({name}, {prob.poses.shape[0]} poses, "
                   f"{iters} LM steps)"] = _timed_once(
            lambda: pgo.optimize(prob_d, iters=iters))
        t0 = time.perf_counter()
        out_cpu = pgo.optimize(prob, iters=iters)
        cpu_s = time.perf_counter() - t0
        e0 = _centre_err(prob.poses[:nv], cen)
        e1 = _centre_err(out.cpu()[:nv], cen)
        d_cpu = float((out.cpu() - out_cpu).abs().max())
        # the end point: the query keyframe; the circle's, its mean error
        # (tests/test_pgo.py's `ate`)
        b, a = (e0[q], e1[q]) if name == "dense" else (e0.mean(), e1.mean())
        pgo_out[name] = dict(poses=int(prob.poses.shape[0]), before_m=float(b),
                             after_m=float(a), mean_before_m=float(e0.mean()),
                             mean_after_m=float(e1.mean()),
                             card_vs_cpu_max=d_cpu, cpu_s=cpu_s)
        print(f"  pgo.optimize [{name}]: " + json.dumps(pgo_out[name]))
        if not bool(torch.isfinite(out).all()) or not a < PGO_MAX_ERR_SHARE * b:
            raise AssertionError(f"pgo [{name}]: error {b} m -> {a} m, not "
                                 f"under {PGO_MAX_ERR_SHARE} of it")
        if not d_cpu <= tol:
            raise AssertionError(f"pgo [{name}]: card and CPU differ by "
                                 f"{d_cpu} > {tol}")

    # --- card against the port's own CPU result on the same inputs
    xy_c, val_c = kq["xy"].cpu(), kq["valid"].cpu()
    dq_c, dvq_c = kq["desc"].cpu(), kq["dval"].cpu()
    dc_c, dvc_c = kc["desc"].cpu(), kc["dval"].cpu()
    exact = {}
    exact["words_of"] = torch.equal(
        bow.words_of(vocab, kq["desc"], kq["dval"], Lv).cpu(),
        bow.words_of(vocab_cpu, dq_c, dvq_c, Lv))
    m_cpu = match(dq_c, dvq_c, dc_c, dvc_c)
    exact["hamming match"] = all(torch.equal(a.cpu(), b) for a, b in zip(
        match(kq["desc"], kq["dval"], kc["desc"], kc["dval"]), m_cpu))
    exact["hamming_distance"] = torch.equal(
        orb.hamming_distance(kq["desc"][:, None, :],
                             kc["desc"][None, :F, :]).cpu(),
        orb.hamming_distance(dq_c[:, None, :], dc_c[None, :F, :]))
    lvl1 = pyramid.build_orb_pyramid(kq["img"], 2, s.scale_factor)[1]
    xy1 = kq["xy"] / s.scale_factor
    exact["fast_check_sparse"] = torch.equal(
        fast.fast_check_sparse(lvl1, xy1, screen or 7.0).cpu(),
        fast.fast_check_sparse(lvl1.cpu(), xy1.cpu(), screen or 7.0))
    blurred = pyramid.blur(kq["img"], sigma=2.0, radius=3)
    ang = orb.ic_angle_integral(blurred, kq["xy"])
    timed("orb.ic_angle_integral", lambda: orb.ic_angle_integral(blurred,
                                                                kq["xy"]))
    timed("orb.compute_descriptors_pool",
          lambda: orb.compute_descriptors_pool(blurred, kq["xy"], ang))
    timed("fast.fast_check_sparse",
          lambda: fast.fast_check_sparse(lvl1, xy1, 7.0))
    ang_c = ang.cpu()                   # one angle array for both sides
    for name, fn in (("descriptors (pool)", orb.compute_descriptors_pool),
                     ("descriptors (classic)", orb.compute_descriptors)):
        exact[name] = torch.equal(fn(blurred, kq["xy"], ang).cpu(),
                                  fn(blurred.cpu(), xy_c, ang_c))
    inb = sampling.in_bounds(xy_c, *blurred.shape, border=22.0) & val_c
    d_ang = _ang_diff(ang, orb.ic_angle_integral(blurred.cpu(), xy_c))[inb]
    d_ref = _ang_diff(ang, orb.ic_angle(blurred.cpu(), xy_c))[inb]
    d_tr = float((bow.transform(vocab, kq["desc"], kq["dval"], Lv).cpu()
                  - bow.transform(vocab_cpu, dq_c, dvq_c, Lv)).abs().max())
    r_cpu = pnp.pnp_ransac(p_w.cpu(), xy_c, ok.cpu(), *K4,
                           sample_idx=idx.cpu())
    e_pnp = max(_twist_err(r_pnp.T_cw, r_cpu.T_cw))
    close = dict(
        ic_angle_integral_median=float(d_ang.median()),
        ic_angle_integral_share_within=float(
            (d_ang < INTEGRAL_WIDE_TOL).float().mean()),
        ic_angle_integral_max=float(d_ang.max()),
        ic_angle_integral_vs_ic_angle_median=float(d_ref.median()),
        transform_max=d_tr, pnp_pose=e_pnp,
        pnp_inliers_equal=bool(torch.equal(r_pnp.inlier.cpu(), r_cpu.inlier)),
        pnp_ok_equal=bool(r_pnp.ok) == bool(r_cpu.ok),
        pgo_dense_max=pgo_out["dense"]["card_vs_cpu_max"],
        pgo_cg_max=pgo_out["cg"]["card_vs_cpu_max"])
    print("  card == CPU: " + json.dumps(exact))
    print("  card vs CPU: " + json.dumps(close))
    if not all(exact.values()):
        raise AssertionError(f"card and CPU differ: {exact}")
    if not (close["ic_angle_integral_median"] < INTEGRAL_MEDIAN_TOL
            and close["ic_angle_integral_share_within"]
            >= INTEGRAL_WIDE_MIN_SHARE
            and close["ic_angle_integral_vs_ic_angle_median"]
            < INTEGRAL_MEDIAN_TOL
            and d_tr <= TRANSFORM_TOL and e_pnp <= PNP_POSE_TOL
            and close["pnp_inliers_equal"] and close["pnp_ok_equal"]):
        raise AssertionError(f"card and CPU too far apart: {close}")
    print(f"  op times (CUDA events, {card}):")
    for name, t in times.items():
        print(f"    {name}: {t:.4f} ms")
    res.update(n_keyframes_trained_on=len(first), candidate=c,
               candidate_distance_m=dist, pnp_err_m=e_t, pnp_err_rad=e_r,
               train_s=train_s, op_ms=times, pgo=pgo_out)
    return res


def _loop8_poses() -> np.ndarray:
    """bench.py:296-300's trajectory, LOOP8_LAPS laps instead of 5."""
    circ = synthetic.loop_trajectory(LOOP8_LAP, radius=LOOP8_RADIUS_M)
    poses = np.concatenate([circ] * LOOP8_LAPS + [circ[:LOOP8_LAP // 4]])
    return poses[:len(poses) // CHUNK * CHUNK]


def _kf_metrics(sys_, poses) -> dict:
    """bench.py:334-346: the keyframe ATE, and the end drift with the
    gauge fixed on the first quarter of the keyframes."""
    _, est = sys_.keyframe_trajectory()
    gt = poses[[k["frame_id"] for k in sys_.records.keyframes]]
    m = ate.keyframe_drift(est[:, :, 3], gt[:, :, 3])
    return dict(kf_ate_m=m["ate_rmse_m"], end_drift_m=m["end_drift_m"])


def _timed_calls(obj, name, log):
    """Wrap obj.name (an instance attribute from now on) to append the
    milliseconds of each call, the device synchronised on both sides, to
    log; the wrapper returns what the method returns."""
    fn = getattr(obj, name)

    def wrapped(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        log.append((1e3 * (time.perf_counter() - t0), a, out))
        return out
    setattr(obj, name, wrapped)


def _range(vals):
    return [min(vals), max(vals)] if vals else None


def phase_loop_system(dev, card: str) -> dict:
    """Phase 8 (module docstring)."""
    s = dataclasses.replace(bench_loop_settings(),
                            max_keyframes_db=LOOP8_DB_ROWS)
    poses = _loop8_poses()
    n = len(poses)
    print(f"loop closing in the System [kitti_bench, bench_loop_settings()]: "
          f"{LOOP8_LAPS} laps of {LOOP8_LAP} frames + a quarter lap, "
          f"{n} frames in chunks of {CHUNK} (the JAX loop bench: 5 laps, "
          f"{(5 * LOOP8_LAP + LOOP8_LAP // 4) // CHUNK * CHUNK} frames)")
    cam = s.cam_left
    sys_on = System(s, enable_backend=True, enable_loop_closing=True,
                    device=dev)
    t0 = time.perf_counter()
    L, R = synthetic_torch.render_stereo_sequence_device(
        synthetic.SyntheticWorld(**LOOP8_WORLD), poses, cam.fx, cam.fy,
        cam.cx, cam.cy, s.baseline, s.image_width, s.image_height,
        pad_w=sys_on.w, pad_h=sys_on.h, noise_std=LOOP8_NOISE, device=dev)
    L, R = L.cpu().numpy(), R.cpu().numpy()
    print(f"  rendered {n} stereo pairs on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    ts = [i / s.fps for i in range(n)]

    out = {}
    lc = sys_on.loopclosing
    ingest, verify, pgo_runs = [], [], []
    _timed_calls(lc, "process_keyframes_batch", ingest)
    _timed_calls(lc, "_complete_loop", verify)
    _timed_calls(lc, "_pose_graph_optimize", pgo_runs)
    for tag, sys_ in (("loop_on", sys_on),
                      ("loop_off", System(s, enable_backend=True,
                                          enable_loop_closing=False,
                                          device=dev))):
        _zero_launches()
        after, chunk_ms, total_s = _drive_chunks(sys_, L, R, ts)
        launches = _launches()
        imp = _implied_launches([fe.INITING] + after[:-1], after)
        _, est = sys_.frame_trajectory()
        res = dict(frames=n, n_keyframes=sys_.stats["n_keyframes"],
                   n_ba=sys_.stats["n_ba"],
                   n_lost=sum(a == fe.LOST for a in after),
                   launches=launches,
                   ms_per_frame=1e3 * total_s / n,
                   median_ms_per_chunk=float(np.median(chunk_ms)),
                   frame_ate_m=ate.ape_translation(est[:, :, 3],
                                                   poses[:, :, 3])["rmse"],
                   **_kf_metrics(sys_, poses))
        if res["n_lost"]:
            raise AssertionError(f"loop system [{tag}]: the run went LOST")
        if launches != _expect(**imp["level0_on_level"]):
            raise AssertionError(f"loop system [{tag}]: kernel launches "
                                 f"{launches} != {imp['level0_on_level']} "
                                 "implied by the statuses")
        _check_replays(f"loop system [{tag}]", imp)
        if not np.all(np.isfinite(est)) or est.shape != (n, 3, 4):
            raise AssertionError(f"loop system [{tag}]: trajectory not "
                                 "finite / wrong shape")
        out[tag] = res
    ev = lc.events
    on = out["loop_on"]
    on.update(
        n_loops=sys_on.stats["n_loops"],
        n_fused=sys_on.stats.get("n_fused", 0), n_events=len(ev),
        db_rows=lc.n, db_cap=lc.cap,
        vocab_words=None if lc.vocab is None else lc.vocab.n_words,
        warnings=sys_on.stats["warnings"][:4],
        score_range=_range([e.score for e in ev]),
        matches_range=_range([e.n_matches for e in ev]),
        inliers_range=_range([e.n_inliers for e in ev]),
        error_range=_range([e.error for e in ev]),
        corrected=[dict(cur=e.cur_gid, loop=e.loop_gid, error=e.error,
                        inliers=e.n_inliers, fused=e.n_fused)
                   for e in ev if e.corrected],
        ingest_ms_per_keyframe=(sum(ms for ms, _, _ in ingest)
                                / max(1, sum(len(a[1]) for _, a, _ in
                                             ingest))),
        ingest_calls=len(ingest),
        verify_ms=_range([ms for ms, _, _ in verify]),
        verify_ms_median=(float(np.median([ms for ms, _, _ in verify]))
                          if verify else None),
        n_verifications=len(verify),
        pgo_ms=[ms for ms, _, _ in pgo_runs])
    print(f"  [{card}]")
    for tag in ("loop_on", "loop_off"):
        print(f"  {tag}: " + json.dumps(out[tag]))
    if lc.vocab is None:
        raise AssertionError("loop system: the vocabulary was never trained")
    if not (lc.cap > LOOP8_DB_ROWS and any(
            "database grown" in w for w in sys_on.stats["warnings"])):
        raise AssertionError("loop system: the database never grew")
    if on["n_loops"] < 1 or on["n_fused"] <= 0:
        raise AssertionError(f"loop system: {on['n_loops']} accepted "
                             f"corrections, {on['n_fused']} fused; events "
                             f"{ev[-8:]}")
    if not on["end_drift_m"] < out["loop_off"]["end_drift_m"]:
        raise AssertionError("loop system: end drift loop on "
                             f"{on['end_drift_m']} m >= loop off "
                             f"{out['loop_off']['end_drift_m']} m")
    if not on["kf_ate_m"] < ATE_MAX_M:
        raise AssertionError(f"loop system: keyframe ATE {on['kf_ate_m']} m "
                             f">= {ATE_MAX_M} m")

    # --- relocalization, through run_step on the loop-on System
    blank = np.full_like(L[0], 128)
    k = RELOC_FRAME
    frames = [(blank, blank)] * RELOC_BLANKS + [(L[i], R[i])
                                                 for i in range(k, k + 5)]
    _zero_launches()
    before, after = [], []
    n_reloc = []
    for i, (a, b) in enumerate(frames):
        before.append(sys_on.status)
        sys_on.run_step(a, b, 100.0 + 0.1 * i)
        after.append(sys_on.status)
        n_reloc.append(sys_on.stats.get("n_relocalizations", 0))
    # the truth in the System's gauge: its world frame is the camera of
    # its first keyframe (the frame it initialised at)
    f0 = sys_on.records.keyframes[0]["frame_id"]
    g0 = np.linalg.inv(np.vstack([poses[f0], [0.0, 0.0, 0.0, 1.0]]))
    err = [float(np.linalg.norm(sys_on.trajectory[-5 + j][2][:, 3]
                                - g0[:3, :3] @ poses[k + j][:, 3]
                                - g0[:3, 3])) for j in range(5)]
    imp = _implied_launches(before, after)
    reloc = dict(init_frame=f0, statuses=after, n_relocalizations=n_reloc,
                 reloc_err_m=err[0], resumed_err_m=err[1:],
                 launches=_launches(), implied=imp["level0_on_level"])
    print("  relocalization: " + json.dumps(reloc))
    nb = RELOC_BLANKS
    if after[nb - 1] != fe.LOST or n_reloc[nb - 1] != 0:
        raise AssertionError("relocalization: blank frames did not drive "
                             "the System LOST, or relocalized it")
    if n_reloc[nb] != 1 or after[nb] != fe.TRACKING_GOOD \
            or not err[0] < RELOC_TOL_M:
        raise AssertionError(f"relocalization: frame {k} did not "
                             f"relocalize within {RELOC_TOL_M} m: {reloc}")
    if fe.LOST in after[nb:] or not max(err) < RELOC_TOL_M:
        raise AssertionError(f"relocalization: tracking did not resume: "
                             f"{reloc}")
    if reloc["launches"] != _expect(**imp["level0_on_level"]):
        raise AssertionError(f"relocalization: kernel launches "
                             f"{reloc['launches']} != {imp['level0_on_level']}")
    _check_replays("relocalization", imp)
    sys_on.close()
    out["reloc"] = reloc
    out["launches"] = {name: out["loop_on"]["launches"][name]
                       + out["loop_off"]["launches"][name]
                       + reloc["launches"][name] for name in _launches()}
    return out


def _record_statuses(sys_, log):
    """Wrap sys_.run_step and sys_.collect_chunk (instance attributes from
    now on) to append the status after each frame to log['after'] in frame
    order, and the milliseconds of each run_step call to log['step_ms']."""
    run_step, collect = sys_.run_step, sys_.collect_chunk

    def step(*a, **k):
        t0 = time.perf_counter()
        out = run_step(*a, **k)
        log["step_ms"].append(1e3 * (time.perf_counter() - t0))
        log["after"].append(sys_.status)
        return out

    def coll(handle):
        out = collect(handle)
        log["after"] += [int(v) for v in handle.outs.status]
        return out
    sys_.run_step, sys_.collect_chunk = step, coll


def _trace_kernel1(path) -> int:
    """Kernel #1's launches in a chrome trace (its kernel events named
    level_kernel; #3, which is #1's instantiation, does not run here)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for e in events if e.get("cat", "").lower() == "kernel"
               and "level_kernel" in e.get("name", ""))


def _driver_pass(tag, seq, out, dev, *flags):
    """One run of the driver (torch_run_kitti.run) on the System its
    build_system makes with no config; returns its result with the
    statuses, launches and the per-frame run_step ms."""
    log = dict(after=[], step_ms=[])
    args = driver.parse_args(
        ["--kitti_dataset_path", seq, "--device", str(dev),
         "--gt_poses", os.path.join(seq, "poses.txt"), "--frames_only_traj",
         "--save_traj", os.path.join(out, f"{tag}.tum"), *flags])
    sys_ = driver.build_system(args)
    if sys_.s != Settings() or sys_.device != dev or sys_.loopclosing is None:
        raise AssertionError(f"driver [{tag}]: no config must give "
                             f"Settings() with loop closing on {dev}")
    _record_statuses(sys_, log)
    _zero_launches()
    res = driver.run(sys_, args)
    replays, kf_replays = graphs.replays()
    res.update(launches=_launches(), replays=replays, kf_replays=kf_replays,
               warmups=dict(graphs.WARMUP_LAUNCHES), sys=sys_, **log)
    sys_.close()
    return res


def _check_driver_pass(tag, res):
    after = res["after"]
    imp = _implied_launches([fe.INITING] + after[:-1], after)
    n_lost = sum(a == fe.LOST for a in after)
    if len(after) != DRIVER_FRAMES or n_lost:
        raise AssertionError(f"driver [{tag}]: {len(after)} frames, "
                             f"{n_lost} LOST")
    if res["launches"] != _expect(
            res["warmups"], lk_level=imp["level0_on_level"]["lk_level"]):
        raise AssertionError(f"driver [{tag}]: kernel launches "
                             f"{res['launches']} != {imp['level0_on_level']} "
                             "implied by the statuses")
    _check_replays(f"driver [{tag}]", imp, replays=res["replays"],
                   kf_replays=res["kf_replays"])
    if res["ate"] is None or not res["ate"]["rmse"] < ATE_MAX_M:
        raise AssertionError(f"driver [{tag}]: keyframe ATE {res['ate']} "
                             f"(>= {ATE_MAX_M} m, or no keyframe)")
    return imp


def phase_driver(dev, card: str) -> dict:
    """Phase 9 (module docstring)."""
    t_phase = time.perf_counter()
    s = Settings()
    cam = s.cam_left
    print(f"the KITTI driver [Settings(), no config]: {DRIVER_FRAMES} "
          f"frames of phase 8's circle in a closed room, per frame and in "
          f"chunks of {DRIVER_CHUNK}")
    poses = synthetic.loop_trajectory(
        LOOP8_LAP, radius=LOOP8_RADIUS_M)[:DRIVER_FRAMES]
    L, R = synthetic_torch.render_stereo_sequence_device(
        synthetic.SyntheticWorld(**DRIVER_WORLD), poses, cam.fx, cam.fy,
        cam.cx, cam.cy, s.baseline, s.image_width, s.image_height,
        noise_std=LOOP8_NOISE, device=dev)
    Lh, Rh = L.cpu().numpy(), R.cpu().numpy()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_driver_",
                            dir=os.path.join(REPO, "build"))
    try:
        seq = os.path.join(work, "seq")
        t0 = time.perf_counter()
        kitti_io.write_sequence(seq, Lh, Rh,
                             [i / s.fps for i in range(DRIVER_FRAMES)], poses)
        write_s = time.perf_counter() - t0
        out = _decode_check(seq, Lh, Rh)
        out["write_s"] = write_s

        # the driver, per frame (profiled over frames 20..40) and chunked
        counted = []
        real_trace = profiling.trace

        @contextlib.contextmanager
        def trace_counting(log_dir):
            with real_trace(log_dir) as prof:
                n0 = lk_cuda.LAUNCHES
                yield prof
                torch.cuda.synchronize()
                counted.append(lk_cuda.LAUNCHES - n0)
        prof_dir = os.path.join(work, "profile")
        profiling.trace = trace_counting
        try:
            step = _driver_pass("per_frame", seq, work, dev,
                                "--profile_dir", prof_dir)
        finally:
            profiling.trace = real_trace
        chunk = _driver_pass("chunk", seq, work, dev,
                             "--chunk", str(DRIVER_CHUNK))
        traced = _trace_kernel1(os.path.join(prof_dir, profiling.TRACE_FILE))
        a = np.loadtxt(os.path.join(work, "per_frame.tum"))
        b = np.loadtxt(os.path.join(work, "chunk.tum"))
        d = float(np.abs(a[:, 1:4] - b[:, 1:4]).max())
        lo, hi = driver.PROFILE_FRAMES
        unprofiled = [m for i, m in enumerate(step["step_ms"])
                      if not lo <= i <= hi]
        for tag, res in (("per_frame", step), ("chunk", chunk)):
            imp = _check_driver_pass(tag, res)
            sys_ = res["sys"]
            out[tag] = dict(
                frames=res["frames"], wall_s=res["wall_s"],
                ms_per_frame=1e3 * res["wall_s"] / res["frames"],
                n_keyframes=sys_.stats["n_keyframes"],
                n_ba=sys_.stats["n_ba"], n_loops=sys_.stats["n_loops"],
                kf_ate_m=res["ate"]["rmse"], launches=res["launches"],
                implied=imp["level0_on_level"])
        out["per_frame"].update(
            median_ms_per_frame_unprofiled=float(np.median(unprofiled)),
            profiled_frames=[lo, hi], trace_kernel1=traced,
            counter_kernel1=counted)
        out["tum_max_diff_m"] = d
        print(f"  [{card}]")
        for tag in ("per_frame", "chunk"):
            print(f"  driver [{tag}]: " + json.dumps(out[tag]))
        print(f"  per frame vs chunk: TUM positions within {d:.3g} m; "
              f"profiler trace of frames {lo}..{hi}: {traced} kernel #1 "
              f"launches, the counter {counted}")
        if a.shape != (DRIVER_FRAMES, 8) or b.shape != a.shape:
            raise AssertionError(f"driver: TUM shapes {a.shape} {b.shape}")
        if not d <= CHUNK_VS_STEP_M:
            raise AssertionError(f"driver: per frame vs chunk {d} m > "
                                 f"{CHUNK_VS_STEP_M} m")
        if counted != [traced] or traced <= 0:
            raise AssertionError(f"driver: the trace holds {traced} kernel "
                                 f"#1 launches, the counter {counted}")

        out["checkpoint"] = _checkpoint_check(s, L, R, work, dev)
        out["launches"] = {name: step["launches"][name]
                           + chunk["launches"][name]
                           + out["checkpoint"]["launches"][name]
                           for name in _launches()}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  phase 9: {out['wall_s']:.1f} s")
    return out


def _decode_check(seq, Lh, Rh) -> dict:
    """The written PNGs through the native loader: every pair equal to the
    rendered uint8 bit for bit. Returns decode ms a pair (one thread, the
    caller's) and the prefetching loader's pairs a second."""
    t0 = time.perf_counter()
    native.load()
    build_s = time.perf_counter() - t0
    left, right, ts = kitti_io.load_image_paths_and_timestamps(seq)
    t0 = time.perf_counter()
    for lp, rp in zip(left[:16], right[:16]):
        native.decode_gray(lp), native.decode_gray(rp)
    one_ms = 1e3 * (time.perf_counter() - t0) / 16
    t0 = time.perf_counter()
    pairs = list(kitti_io.prefetching_reader(left, right))
    loader_s = time.perf_counter() - t0
    bad = [i for i, (a, b) in enumerate(pairs)
           if not (np.array_equal(a, Lh[i]) and np.array_equal(b, Rh[i]))]
    res = dict(library=str(native.library_path()), build_s=build_s,
               pairs=len(pairs), decode_ms_per_pair=one_ms,
               loader_pairs_per_s=len(pairs) / loader_s)
    print("  decode: " + json.dumps(res))
    if len(pairs) != len(Lh) or bad or len(ts) != len(Lh):
        raise AssertionError(f"decode: {len(pairs)} pairs of {len(Lh)}, "
                             f"frames {bad[:8]} differ from the rendered ones")
    return dict(decode=res)


def _checkpoint_check(s, L, R, work, dev) -> dict:
    """CKPT_FRAMES frames, a checkpoint, a fresh System resumed from it for
    CKPT_FRAMES more, against the first System run on."""
    cont = System(s, enable_loop_closing=False, device=dev)
    ts = [i / s.fps for i in range(2 * CKPT_FRAMES)]
    _zero_launches()
    for i in range(CKPT_FRAMES):
        cont.run_step(L[i], R[i], ts[i])
    path = os.path.join(work, "state.npz")
    t0 = time.perf_counter()
    checkpoint.save_checkpoint(cont, path)
    save_ms = 1e3 * (time.perf_counter() - t0)
    resumed = System(s, enable_loop_closing=False, device=dev)
    t0 = time.perf_counter()
    checkpoint.load_checkpoint(resumed, path)
    load_ms = 1e3 * (time.perf_counter() - t0)
    after_c, after_r = [], []
    for i in range(CKPT_FRAMES, 2 * CKPT_FRAMES):
        cont.run_step(L[i], R[i], ts[i])
        after_c.append(cont.status)
        resumed.run_step(L[i], R[i], ts[i])
        after_r.append(resumed.status)
    _, tc = cont.frame_trajectory()
    _, tr = resumed.frame_trajectory()
    d = float(np.abs(tc[:, :, 3] - tr[:, :, 3]).max())
    res = dict(frames=[CKPT_FRAMES, CKPT_FRAMES], save_ms=save_ms,
               load_ms=load_ms, npz_mb=os.path.getsize(path) / 2 ** 20,
               n_keyframes=[cont.stats["n_keyframes"],
                            resumed.stats["n_keyframes"]],
               max_position_diff_m=d, tol_m=CKPT_TOL_M,
               launches=_launches())
    print("  checkpoint: " + json.dumps(res))
    cont.close()
    resumed.close()
    if (after_c != after_r or fe.LOST in after_c
            or res["n_keyframes"][0] != res["n_keyframes"][1]
            or tc.shape != tr.shape or not d <= CKPT_TOL_M):
        raise AssertionError(f"checkpoint: the resumed run differs from the "
                             f"continuous one: {res}")
    return res


def _solve_ms(fn, reps=DIST_REPS):
    """(the last result, median CUDA-event ms) of `reps` calls of fn after
    one warm-up call."""
    fn()
    ms = []
    for _ in range(reps):
        out, t = _timed_once(fn)
        ms.append(t)
    return out, float(np.median(ms))


def _dist_rank1(store: str, device: str, s: Settings):
    """Phase 10's rank 1, a spawned process sharing the card: the same
    standalone solves as rank 0 (its shard), its result sent to rank 0,
    then dist_ba.serve for rank 0's System, and the number it served."""
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=2, rank=1, timeout=DIST_TIMEOUT)
    try:
        mesh = dist_ba.make_mesh(device=dev)
        prob, cam = scaling.build_problem(DIST_M, DIST_W)
        step = dist_ba.distributed_local_ba(mesh, *cam)
        shard = dist_ba.shard_problem(mesh, prob)
        with torch.no_grad():
            for _ in range(1 + DIST_REPS):
                res = step(shard)
            dist.broadcast(torch.cat([res.kf_T_cw.reshape(-1),
                                      res.inlier_ratio.reshape(1),
                                      res.lm_pos.reshape(-1)]), src=1)
            rig = camera.StereoRig.from_settings(s, dev)
            il = rig.intr_left
            n = dist_ba.serve(mesh, il.fx, il.fy, il.cx, il.cy, rig.baseline)
            dist.broadcast(torch.tensor([n], device=dev), src=1)
    finally:
        dist.destroy_process_group()


def _standalone_two_ranks(mesh, prob, cam, plain, dev) -> dict:
    """Phase 10's two-rank solve on rank 0, held against rank 1's (sent
    by broadcast) and the single-device result."""
    step = dist_ba.distributed_local_ba(mesh, *cam)
    shard = dist_ba.shard_problem(mesh, prob)
    two, ms = _solve_ms(lambda: step(shard))
    W, half = DIST_W, DIST_M // 2
    theirs = torch.empty(12 * W + 1 + 3 * half, device=dev)
    dist.broadcast(theirs, src=1)
    kf1, ratio1, lm1 = torch.split(theirs, [12 * W, 1, 3 * half])
    lm = torch.cat([two.lm_pos, lm1.view(half, 3)])
    res = dict(
        ms_per_solve=ms, inlier_ratio=float(two.inlier_ratio),
        ranks_equal=bool(torch.equal(kf1.view(W, 3, 4), two.kf_T_cw)
                         and torch.equal(ratio1[0], two.inlier_ratio)),
        pose_max_diff=float((two.kf_T_cw - plain.kf_T_cw).abs().max()),
        lm_max_diff=float((lm - plain.lm_pos).abs().max()),
        ratio_diff=abs(float(two.inlier_ratio - plain.inlier_ratio)))
    if not (res["ranks_equal"] and res["pose_max_diff"] <= DIST_POSE_TOL
            and res["lm_max_diff"] <= DIST_LM_TOL
            and res["ratio_diff"] < DIST_RATIO_TOL):
        raise AssertionError(f"dist BA, 2 ranks: {res}")
    return res


def _mesh_system(s, mesh, frames, dev) -> dict:
    """Phase 10's System through the mesh on phase 4's frames (device
    stacks) in pipelined chunks; held against phase 4's run_step: its
    statuses, keyframe and BA counts, and positions."""
    L, R, poses = frames["L"], frames["R"], frames["poses"]
    ts = [i / s.fps for i in range(len(L))]
    sys_ = System(s, enable_backend=True, enable_loop_closing=False,
                  mesh=mesh, device=dev)
    _zero_launches()
    t0 = time.perf_counter()
    handles, prev = [], None
    for a in range(0, len(L), CHUNK):
        h = sys_.dispatch_chunk(L[a:a + CHUNK], R[a:a + CHUNK],
                                ts[a:a + CHUNK])
        if prev is not None:
            sys_.collect_chunk(prev)
        handles.append(h)
        prev = h
    sys_.collect_chunk(prev)
    sys_.finish()
    wall = time.perf_counter() - t0
    launches = _launches()
    sys_.close()
    served = torch.zeros(1, dtype=torch.int64, device=dev)
    dist.broadcast(served, src=1)
    after = [int(v) for h in handles for v in h.outs.status]
    imp = _implied_launches([fe.INITING] + after[:-1], after)
    _, est = sys_.frame_trajectory()
    res = _check_run("dist System", sys_, after, est, poses, launches,
                     _expect(lk_level=imp["level0_on_level"]["lk_level"]))
    _check_replays("dist System", imp, kf_graph=False)
    d = float(np.abs(est[:, :, 3] - frames["est"][:, :, 3]).max())
    res.update(launches=launches, n_dist_ba=sys_.stats["n_dist_ba"],
               served=int(served.item()), ms_per_frame=1e3 * wall / len(L),
               wall_s=wall, vs_phase4_max_m=d)
    if (after != frames["after"] or d > CHUNK_VS_STEP_M
            or res["n_keyframes"] != frames["n_keyframes"]
            or res["n_ba"] != frames["n_ba"]):
        raise AssertionError(f"dist System: statuses, keyframes, BAs or "
                             f"positions differ from phase 4's run_step "
                             f"({frames['n_keyframes']} keyframes, "
                             f"{frames['n_ba']} BAs; {d} m): {res}")
    if not res["n_dist_ba"] == res["n_ba"] == res["served"] >= 1:
        raise AssertionError(f"dist System: not every local BA went through "
                             f"the mesh: {res}")
    return res


def phase_dist_ba(s: Settings, dev, card: str, frames: dict) -> dict:
    """Phase 10 (module docstring)."""
    t_phase = time.perf_counter()
    print(f"multi-device BA [W {DIST_W}, M {DIST_M}]: a world of 1 over "
          "NCCL, then 2 ranks sharing the card over gloo")
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    store = os.path.join(REPO, "build", f"chip_smoke_dist_{os.getpid()}")
    # rank 1 starts now: its imports and CUDA context overlap the world of 1
    child = multiprocessing.get_context("spawn").Process(
        target=_dist_rank1, args=(store, str(dev), s))
    child.start()
    done = False
    try:
        prob, cam = scaling.build_problem(DIST_M, DIST_W)
        prob = ba.LocalBAProblem(*[x.to(dev) for x in prob])
        plain, plain_ms = _solve_ms(lambda: ba.local_ba(prob, *cam))

        mesh = multihost.global_mesh(dev)       # no group yet: a world of 1
        backend = dist.get_backend()
        step = dist_ba.distributed_local_ba(mesh, *cam)
        one, one_ms = _solve_ms(
            lambda: step(dist_ba.shard_problem(mesh, prob)))
        equal = {k: bool(torch.equal(a, b)) for k, a, b in
                 zip(ba.LocalBAResult._fields, one, plain)}
        dist.destroy_process_group()
        if backend != "nccl" or not all(equal.values()):
            raise AssertionError(f"dist BA, world of 1 [{backend}]: not "
                                 f"bit-equal to local_ba: {equal}")

        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=2, rank=0, timeout=DIST_TIMEOUT)
        mesh = dist_ba.make_mesh(device=dev)
        two = _standalone_two_ranks(mesh, prob, cam, plain, dev)
        system = _mesh_system(s, mesh, frames, dev)
        dist.destroy_process_group()
        done = True
    finally:
        child.join(timeout=60 if done else 0)
        if child.is_alive():
            child.kill()
            child.join()
        if dist.is_initialized():
            dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    if child.exitcode != 0:
        raise AssertionError(f"dist BA: rank 1 exited {child.exitcode}")
    out = dict(plain_ms_per_solve=plain_ms,
               one_rank=dict(backend=backend, ms_per_solve=one_ms,
                             bit_equal=True),
               two_ranks=dict(two, backend="gloo", shared_card=True),
               system=system, launches=system["launches"],
               wall_s=time.perf_counter() - t_phase)
    print(f"  [{card}]")
    print(f"  standalone BA, ms per solve (CUDA events, median of "
          f"{DIST_REPS}): plain {plain_ms:.2f}, 1 rank [NCCL] {one_ms:.2f} "
          f"(bit-equal), 2 ranks sharing the card [gloo] "
          f"{two['ms_per_solve']:.2f} (the collectives' cost, not scaling)")
    print("  two ranks: " + json.dumps(two))
    print("  System through the mesh: " + json.dumps(system))
    print(f"  phase 10: {out['wall_s']:.1f} s")
    return out


def _check_trace(tr) -> None:
    k1 = tr["counter_launches"]["lk_level"]
    top_ms = sum(ms for _, _, ms in tr["top_ops"])
    if k1 <= 0 or tr["trace_kernel1"] != k1:
        raise AssertionError(f"trace: {tr['trace_kernel1']} kernel #1 "
                             f"events, its counter {k1}")
    for key in ("busy_share", "traced_busy_share"):
        if not 0.0 < tr[key] <= 1.0:
            raise AssertionError(f"trace: {key} {tr[key]}")
    if not top_ms <= tr["window_ms"]:
        raise AssertionError(f"trace: the top ops' {top_ms} ms exceed the "
                             f"window's {tr['window_ms']} ms")
    kf = tr["keyframe_frame"]
    kf1 = sum(v for k, v in kf["launches"].items() if prof_trace.KERNEL1 in k)
    if not 0.0 < kf["busy_share"] <= 1.0 or \
            kf1 != kf["counter_launches"]["lk_level"] or kf1 <= 0:
        raise AssertionError(f"trace of a keyframe frame: busy share "
                             f"{kf['busy_share']}, kernel #1 {kf1} events, "
                             f"its counter {kf['counter_launches']}")


def _check_stages(st) -> None:
    want = {"build_pyramid": {}, "lk.track fwd": {"lk_level": 3},
            "track_step": {"lk_level": 6}, "keyframe_step": {"lk_level": 8},
            "track_frame graph": {"lk_level": 6},
            "pose_only_optimize graph": {},
            "keyframe_branch": {"lk_level": 8},
            "keyframe_frame graph": {"lk_level": 8}, "local_ba graph": {}}
    got = {k: st["stages"][k]["launches_per_call"] for k in want}
    if got != want:
        raise AssertionError(f"stages: launches a call {got} != {want}")


def phase_profiling(dev, card: str) -> dict:
    """Phase 11 (module docstring)."""
    t_phase = time.perf_counter()
    print("the profiling tools at cuts:")
    d = ["--device", str(dev)]
    work = os.path.join(REPO, "build", f"chip_smoke_trace_{os.getpid()}")
    secs = {}

    def run(tag, tool, argv):
        t = time.perf_counter()
        res = tool.main(argv + d)
        secs[tag] = time.perf_counter() - t
        return res
    _zero_launches()
    try:
        tr = run("trace", prof_trace, ["--chunk", str(PROFILE_CHUNK), "--out",
                                       work])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    _check_trace(tr)
    ab = run("ablation", prof_ablation, ["--chunk", str(PROFILE_FRAMES),
                                         "--reps", "1"])
    chk = ab["full_vs_run_step"]
    if not chk["statuses_equal"] or \
            not chk["max_position_diff_m"] <= prof_ablation.POS_TOL_M:
        raise AssertionError(f"ablation: full variant vs run_step {chk}")
    st = run("stages", prof_stages, ["--reps", str(PROFILE_REPS)])
    _check_stages(st)
    en = run("engine", prof_engine, ["--frames", str(PROFILE_FRAMES),
                                     "--chunk", str(PROFILE_FRAMES // 2)])
    if not en["n_keyframes"] or not en["n_tracking"]:
        raise AssertionError(f"engine: {en['n_tracking']} tracking and "
                             f"{en['n_keyframes']} keyframe frames")
    trf = run("transfer", prof_transfer, ["--reps", str(PROFILE_REPS)])
    h2d = trf["host_to_device"][f"kitti x{prof_transfer.CHUNK}"]
    if not (h2d["pageable"]["gb_per_s"] > 0 and h2d["pinned"]["gb_per_s"] > 0
            and trf["overlap"]["share"] > OVERLAP_MIN):
        raise AssertionError(f"transfer: {h2d}, {trf['overlap']}")
    ing = run("ingest", prof_ingest, ["--reps", str(PROFILE_REPS)])
    gp = run("gauge", gauge_probe, ["--prefix", str(GAUGE_PREFIX), "--end",
                                    str(GAUGE_END)])
    for tag in ("corrected", "pipelined"):
        if not gp[tag]["invariant"]:
            raise AssertionError(f"gauge probe [{tag}]: not invariant "
                                 f"(tolerance {gp['pose_tol_m']} m): "
                                 f"{gp[tag]}")
    out = dict(launches=_launches(), wall_s=time.perf_counter() - t_phase,
               tool_s=secs, trace=dict(tr, top_ops=tr["top_ops"][:10]),
               ablation=ab,
               stages=st, engine=en, transfer=trf, ingest=ing, gauge=gp)
    print(f"  [{card}]")
    kf = tr["keyframe_frame"]
    print(f"  trace: busy share {tr['busy_share']:.4f} of the untraced "
          f"chunk ({tr['traced_busy_share']:.4f} of the traced, stretched "
          f"{tr['stretch']:.3f}x), {tr['kernels_per_frame']:.0f} kernels a "
          f"frame, kernel #1 {tr['trace_kernel1']} events = its counter; "
          f"a steady keyframe frame alone {kf['untraced_ms']:.2f} ms, busy "
          f"share {kf['busy_share']:.4f}, {kf['n_kernels']} kernels")
    print("  ablation ms/frame: " + ", ".join(
        f"{k} {v['ms_per_frame']:.2f}" for k, v in ab["variants"].items())
        + f"; full vs run_step {chk['max_position_diff_m']:.3g} m")
    print("  stages ms: " + ", ".join(f"{k} {v['ms']:.2f}"
                                      for k, v in st["stages"].items()))
    print(f"  engine: tracking frame median {en['track_ms_median']:.2f} ms "
          f"(p90 {en['track_ms_p90']:.2f}), keyframe frame median "
          f"{en['kf_ms_median']:.2f} ms, chunks of {PROFILE_FRAMES // 2} "
          f"{en['chunk_ms_per_frame_median']:.2f} ms/frame")
    print(f"  transfer: a chunk of {prof_transfer.CHUNK} KITTI pairs pageable "
          f"{h2d['pageable']['gb_per_s']:.2f} GB/s, pinned "
          f"{h2d['pinned']['gb_per_s']:.2f} GB/s; readback "
          f"{trf['readback']['pinned_event_ms']:.3f} ms; overlap share "
          f"{trf['overlap']['share']:.3f} (turns "
          f"{[round(x, 3) for x in trf['overlap']['shares']]}; "
          f"{trf['overlap']['copies']} "
          f"copies of {trf['overlap']['copy_ms']:.1f} ms against a step of "
          f"{trf['overlap']['step_ms']:.1f} ms)")
    print(f"  ingest: describe {ing['describe_ms']:.2f}, transform "
          f"{ing['transform_ms']:.2f}, score {ing['score_ms']:.3f}, ingest "
          f"of {ing['batch']} {ing['ingest_ms']:.2f} ms")
    print(f"  gauge probe: healths equal; poses within "
          f"{gp['corrected']['max_translation_delta_m']:.3g} / "
          f"{gp['pipelined']['max_translation_delta_m']:.3g} m of the "
          f"baseline's in the corrected gauge (tolerance "
          f"{gp['pose_tol_m']} m)")
    print(f"  phase 11: {out['wall_s']:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in secs.items()) + f"), launches "
        f"{out['launches']}")
    return out


def phase_bench(dev, card: str) -> dict:
    """Phase 12 (module docstring)."""
    t_phase = time.perf_counter()
    print(f"the bench (scripts/torch_bench.py) at a cut: {BENCH_ENV}, "
          f"loop bench {BENCH_LOOP_LAPS} lap(s) and a quarter")
    with mock.patch.dict(os.environ, BENCH_ENV), \
            mock.patch.object(torch_bench, "LOOP_LAPS", BENCH_LOOP_LAPS):
        for k in ("BENCH_FAST", "BENCH_CHUNK"):
            os.environ.pop(k, None)
        _zero_launches()
        out = torch_bench.main(["--device", str(dev)])
        launches = _launches()
    extra = out["extra"]
    path, on, off = (extra["path"], extra["loop_bench"]["loop_on"],
                     extra["loop_bench"]["loop_off"])
    if not out["value"] > 0 or path["lost"]:
        raise AssertionError(f"bench: {out['value']} fps, {path['lost']} "
                             "LOST frames")
    if not extra["ate_rmse_m"] < ATE_MAX_M:
        raise AssertionError(f"bench: ATE {extra['ate_rmse_m']} m >= "
                             f"{ATE_MAX_M} m")
    if (path["tracking"], path["keyframe"]) != ("graph", "graph"):
        raise AssertionError(f"bench: tracking {path['tracking']}, "
                             f"keyframes {path['keyframe']}, not graphs")
    _check_replays("bench", dict(n_tracked=path["tracked"],
                                 n_steady_keyframes=path["steady_keyframes"]),
                   replays=path["tracking_replays"],
                   kf_replays=path["keyframe_replays"])
    want = _expect(warmups={}, **_launches_of(path)["level0_on_level"])
    if extra["kernel_launches"] != want:
        raise AssertionError(f"bench: kernel launches over the timed loops "
                             f"{extra['kernel_launches']} != {want} implied "
                             "by the statuses")
    if not launches["lk_level"] or any(v for k, v in launches.items()
                                       if k != "lk_level"):
        raise AssertionError(f"bench: kernel launches {launches}: kernel #1 "
                             "only")
    if not extra["e2e_fps"] > 0:
        raise AssertionError(f"bench: e2e_fps {extra['e2e_fps']}")
    if on["n_events"] < 1 or not max(on["ate_rmse_m"],
                                     off["ate_rmse_m"]) < ATE_MAX_M:
        raise AssertionError(f"bench: loop bench: {on['n_events']} "
                             f"verifications, keyframe ATE loop on "
                             f"{on['ate_rmse_m']} m, off {off['ate_rmse_m']} m")
    wall = time.perf_counter() - t_phase
    print(f"  [{card}] the bench's line: " + json.dumps(out))
    print(f"  phase 12: {wall:.1f} s; launches {launches}")
    return dict(launches=launches, wall_s=wall, result=out)


def main() -> None:
    t_start = time.perf_counter()
    card = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    kitti, robotcar = bench_settings(), robotcar_xb3_wide_settings()
    with torch.no_grad():
        rows, levels = phase_kernels_vs_plain("kitti_bench", kitti, dev)
        rows += phase_kernels_vs_plain("robotcar_xb3_wide", robotcar, dev)[0]
        rows += phase_flavours_vs_plain(levels)
        t0 = time.perf_counter()
        step, frames = phase_run_step(kitti, dev)
        frames["seconds"] = time.perf_counter() - t0
        chunk, chunk_frames = phase_chunks(robotcar, dev)
        turns = phase_graph_vs_eager(kitti, robotcar, dev, frames,
                                     chunk_frames, card)
        place = phase_place_recognition(kitti, dev, card)
        loop8 = phase_loop_system(dev, card)
        drive = phase_driver(dev, card)
        dist_res = phase_dist_ba(kitti, dev, card, frames)
        prof = phase_profiling(dev, card)
        bench_res = phase_bench(dev, card)
        flavours = phase_flavours(kitti, dev, frames, t_start)
    table = []
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        # timed at the largest level it ran, temporal pair
        big = max((r for r in mine if r["pair"] == "temporal"),
                  key=lambda r: r["pixels"])
        table.append(dict(
            name=name, route="cuda", **meta,
            launches=(step["launches"][name] + chunk["launches"][name]
                      + turns["launches"][name]
                      + place["launches"][name] + loop8["launches"][name]
                      + drive["launches"][name]
                      + dist_res["launches"][name]
                      + prof["launches"][name]
                      + bench_res["launches"][name]
                      + sum(f["launches"][name] for f in flavours.values())),
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=big["ms"], plain_ms=big["plain_ms"], bound_ms=big["bound_ms"],
            bound_by=big["bound_by"], library_ms=None))
    for name in KERNELS:
        big = max((r for r in rows if r["kernel"] == name
                   and r["pair"] == "temporal"), key=lambda r: r["pixels"])
        print(f"device time [{name}] at {big['config']} level "
              f"{big['level']}: {big['device_ms']:.4f} ms a launch "
              f"(torch.profiler), bound {big['bound_ms']:.6f} ms "
              f"({big['bound_by']}): {big['bound_ms'] / big['device_ms']:.4f}"
              " of the bound")
    print(f"script: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
