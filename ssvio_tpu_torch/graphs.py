"""The two branches of the per-frame step as CUDA graphs: the port's
counterparts of `jax.jit(Engine._step)`'s `do_track` and `do_kf` branches
(`ssvio_tpu/engine.py:149-236`).

The JAX engine compiles the whole step into one program, so a frame costs
one dispatch. Eager PyTorch launches each of its thousands of small kernels
from the host instead. `TrackGraph` captures `Frontend.track_frame`
(undistortion, the LK pyramid with its Sobel planes, `_track_step`: the
seeded forward and backward LK with the level kernels, the FB gate and the
4 x 10 pose-only LM) once into a `torch.cuda.CUDAGraph` and replays it
every tracked frame. `KeyframeGraph` captures `Engine.keyframe_branch` of
a steady keyframe (the right pyramid, re-detection, stereo LK both ways,
triangulation, the map inserts, the loop descriptors, the 5 x 10 local
BA, whose rounds after the first are conditional nodes that a replay runs
only until the inlier ratio passes its target: `ops/ba.py::_if_live`)
and replays it every steady keyframe, after the frame's tracking
replay. `Engine._step` builds one of each per canvas shape (the engine's
settings fix the LK flavour) at its first frame of that branch.

- Static buffers: the tracking graph reads the left image, the last
  pyramid's planes, the `FeatState` fields, `T_cw`, `rel_motion`,
  `lm_pos`, `lm_valid` and `lm_gid` from buffers of its own; the keyframe
  graph the right image, the frame's pyramid, the tracked features and
  pose and the whole map (its `obs_uv` is 8192 x 16 x 2 x 2 f32 = 2 MiB
  at the bench's size). Every call copies its inputs into them: a
  keyframe, a BA refresh, a loop fusion, a relocalization or a checkpoint
  load each replace the carry's tensors, so tensor identity is never
  trusted.
- Outputs: the next replay overwrites what the graph wrote, and some
  outputs are its input buffers (the pyramid's level 0 is the image, the
  features' slot links pass through). So every call returns clones: the
  carry, `System.last_stereo`, a chunk's `FrameOut` stacks and the tools'
  snapshots never alias a buffer of the graph.
- Warm-up: before the capture the function runs once on a side stream
  (cuBLAS's and cuSOLVER's handles and workspaces, the LK kernels' build
  and first launch), then the capture runs on that stream. Both open the
  graph's `cuda_if.Bodies`: the body of an IF node (`cuda_if.if_node`)
  runs on a stream of its own in the warm-up and is captured on it. A
  failed capture or replay raises; nothing gives way to the eager path.
- Launch counts: the kernel wrappers count in Python (`lk_cuda.LAUNCHES`,
  `lk_patch_cuda.LAUNCHES`, `lk_variants_cuda.LAUNCHES`), so a replay
  would count nothing and the capture would count launches that never
  ran. The counters are set back after the capture, which records the
  launches it holds per kernel (`launches`), and every replay adds them.
  The warm-up's launches are real and stay counted; `warmup_launches`
  records them (the module's `WARMUP_LAUNCHES` sums them over graphs), so
  a caller that checks the counts against a run's statuses can add them.
  The recorder's counter `engine.keyframe_replays` (`utils/profiling.py`,
  `KEYFRAME_REPLAYS`) counts the keyframe graphs' replays,
  `engine.track_replays` (`TRACK_REPLAYS`) the others' (the tracking
  graphs' and the tools' single stages); `replays()` reads both.
- The `stats` pointer of the level kernels would be baked into the graph;
  the path passes none (the tools that pass stats run the kernels
  eagerly).

The capture itself is generic (`StaticGraph`: any function of a tuple of
tensors, shapes fixed at construction); the profiling tools capture
single stages with it, and the loop closer the three stretches of a
verification that read nothing from the host (`VerifyGraph`,
`loopclosing.VerifyGraphs`). On the CPU the same function runs on the
same buffers without a capture, so the CPU tests exercise the copy-in
and the copy-out.
"""

import functools
import gc
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from ssvio_tpu_torch import frontend as fe
from ssvio_tpu_torch.ops import (cuda_if, lk_cuda, lk_patch_cuda,
                                 lk_variants_cuda)
from ssvio_tpu_torch.utils import profiling

# the recorder's counters of graph replays since they were last zeroed
# (the keyframe graphs' apart), and the kernel launches of the graphs'
# warm-ups (real launches, counted by the wrappers as well), by kernel:
# what a caller that checks the wrappers' counters against a run's
# statuses reads beside them
TRACK_REPLAYS = "engine.track_replays"
KEYFRAME_REPLAYS = "engine.keyframe_replays"
WARMUP_LAUNCHES: Dict[str, int] = {}


def launch_counts() -> Dict[str, int]:
    """The kernel wrappers' launch counters, by kernel."""
    return dict(lk_level=lk_cuda.LAUNCHES, lk_patch=lk_patch_cuda.LAUNCHES,
                **lk_variants_cuda.LAUNCHES)


def _set_counts(counts: Dict[str, int]) -> None:
    lk_cuda.LAUNCHES = counts["lk_level"]
    lk_patch_cuda.LAUNCHES = counts["lk_patch"]
    for k in lk_variants_cuda.LAUNCHES:
        lk_variants_cuda.LAUNCHES[k] = counts[k]


def _since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in launch_counts().items()}


def replays() -> Tuple[int, int]:
    """(tracking, keyframe) graph replays since the counters were last
    zeroed, as the recorder counted them."""
    c = profiling.TRACE.counters
    return int(c.get(TRACK_REPLAYS, 0)), int(c.get(KEYFRAME_REPLAYS, 0))


def zero_counts() -> None:
    """Set every kernel's launch counter, both replay counters and
    WARMUP_LAUNCHES to 0."""
    _set_counts(dict.fromkeys(launch_counts(), 0))
    profiling.TRACE.reset(TRACK_REPLAYS, KEYFRAME_REPLAYS)
    WARMUP_LAUNCHES.clear()


class StaticGraph:
    """`fn(*inputs)` on static buffers of the inputs' shapes and dtypes
    (`inputs`: tensors and tuples of them), captured into a CUDA graph at
    construction on a CUDA device and replayed by each call, or run on the
    buffers on the CPU. A call copies its inputs into the buffers (casting
    to the buffers' dtypes) and returns clones of the outputs. Call
    `close()` to release the graph and its private memory pool."""

    # the recorder's counter of its replays (None: its owner counts them)
    REPLAYS: Optional[str] = TRACK_REPLAYS

    def __init__(self, fn: Callable, *inputs):
        self._fn = fn
        leaves, self._spec = pytree.tree_flatten(inputs)
        self._in = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
                    for t in leaves]
        self.device = leaves[0].device
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        # the stream and memory of its IF nodes' bodies
        self._bodies: Optional[cuda_if.Bodies] = None
        self._out = None
        self.launches: Dict[str, int] = dict.fromkeys(launch_counts(), 0)
        self.warmup_launches: Dict[str, int] = dict(self.launches)
        self.calls = 0
        if self.device.type == "cuda":
            self._capture(leaves)

    def _run(self):
        return self._fn(*pytree.tree_unflatten(self._in, self._spec))

    def _load(self, leaves) -> None:
        for dst, src in zip(self._in, leaves, strict=True):
            if dst.shape != src.shape:
                raise ValueError(f"a graph input of shape {tuple(src.shape)}"
                                 f"; the graph was built for "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)

    def _capture(self, leaves) -> None:
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        bodies = cuda_if.Bodies(dev)
        with torch.cuda.stream(side), cuda_if.bodies_of(bodies):
            self._load(leaves)
            before = launch_counts()
            self._run()
            self.warmup_launches = _since(before)
        for k, v in self.warmup_launches.items():
            WARMUP_LAUNCHES[k] = WARMUP_LAUNCHES.get(k, 0) + v
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        # no garbage collection inside the capture: one that frees another
        # graph, or gives back its bodies' pool, makes a call the capture
        # forbids, and the capture fails
        collecting = gc.isenabled()
        gc.disable()
        try:
            # thread_local: the chunk prefetcher's thread may upload (pinned
            # buffers, copies on its own stream) while this one captures
            with cuda_if.bodies_of(bodies), \
                    torch.cuda.graph(graph, stream=side,
                                     capture_error_mode="thread_local"):
                self._out = self._run()
        finally:
            if collecting:
                gc.enable()
            # the wrappers counted launches that only the replays make
            self.launches = _since(before)
            _set_counts(before)
        self._graph, self._bodies = graph, bodies

    def __call__(self, *inputs):
        leaves, spec = pytree.tree_flatten(inputs)
        if spec != self._spec:
            raise ValueError("graph inputs of another structure than the "
                             "graph was built for")
        self._load(leaves)
        if self._graph is None:
            out = self._run()
        else:
            self._graph.replay()
            _set_counts({k: v + self.launches[k]
                         for k, v in launch_counts().items()})
            if self.REPLAYS:
                profiling.TRACE.add(self.REPLAYS)
            out = self._out
        self.calls += 1
        return pytree.tree_map_only(torch.Tensor, torch.clone, out)

    def close(self) -> None:
        """Drop the graph, its outputs and its buffers, and the memory of
        its IF nodes' bodies."""
        self._graph = self._out = self._in = None
        if self._bodies is not None:
            self._bodies.close()
            self._bodies = None


class TrackGraph(StaticGraph):
    """`Frontend.track_frame` as a StaticGraph, built from the first frame
    it tracks, whose inputs set the shapes. A call takes the same
    arguments as `track_frame`, the left frame in any dtype (promoted to
    float32 by the copy), and returns (the frame's pyramid, its
    TrackOut)."""

    def __init__(self, frontend: fe.Frontend, img: torch.Tensor,
                 pyr_last: fe.Pyr, feat: fe.FeatState, T_cw: torch.Tensor,
                 rel_motion: torch.Tensor, lm_pos: torch.Tensor,
                 lm_valid: torch.Tensor, lm_gid: torch.Tensor):
        super().__init__(frontend.track_frame, img.to(torch.float32),
                         pyr_last, feat, T_cw, rel_motion, lm_pos, lm_valid,
                         lm_gid)


class KeyframeGraph(StaticGraph):
    """`Engine.keyframe_branch` of a steady keyframe as a StaticGraph,
    built from the first steady keyframe, whose inputs set the shapes. A
    call takes the branch's arguments but `is_init` (the right frame in
    any dtype, promoted to float32 by the copy) and returns its
    KeyframeOut. Its replays count in KEYFRAME_REPLAYS."""

    REPLAYS = KEYFRAME_REPLAYS

    def __init__(self, branch: Callable, img_r: torch.Tensor, pyr_l: fe.Pyr,
                 feat: fe.FeatState, T_cw: torch.Tensor,
                 rel_motion: torch.Tensor, m):
        super().__init__(functools.partial(branch, is_init=False),
                         img_r.to(torch.float32), pyr_l, feat, T_cw,
                         rel_motion, m)


class VerifyGraph(StaticGraph):
    """One stage of a loop verification (`loopclosing.VerifyGraphs`) as a
    StaticGraph, built from inputs of the stage's shapes. Its replays
    count in no counter of their own: the loop closer counts the three
    replays of a verification as one (`loopclosing.VERIFY_REPLAYS`)."""

    REPLAYS = None
