"""Chunked engine: K frames per dispatch (port of `ssvio_tpu/engine.py`).

The JAX engine makes the whole per-frame step (pyramid, seeded LK,
pose-only LM, the status machine, keyframe insertion, stereo triangulation,
sliding-window BA) one compiled program and scans it over a chunk of
frames, with the status machine as `lax.cond` branches on the device:

    carry = (pyramid of last frame, feature set, pose, rel motion,
             map window, status)
    carry, per_frame_outputs = lax.scan(step, carry, (imgs_l, imgs_r))

torch has neither `lax.scan` nor `lax.cond`. Here the same step runs, in the
same order, as a Python loop over the chunk's frames that branches on the
status on the host. What the chunk keeps from the JAX engine is its
contract: the SLAM state stays on the device in an `EngineCarry` between
chunks, the per-frame outputs stay on the device, and the host reads back
ONE packed vector per chunk (`pack_readback`).

Both branches are the JAX program's counterparts on the card, each one CUDA
graph with no host read inside (`graphs.py`): the tracking branch
(`do_track`: pyramid, seeded LK, pose-only LM; `graphs.TrackGraph`) is
replayed every tracked frame, and the keyframe branch of a steady keyframe
(`do_kf`: detection, stereo LK, triangulation, the map inserts, the loop
descriptors, local BA as a fixed trip whose rounds after the inlier-ratio
flag the graph skips on the device; `Engine.keyframe_branch` in a
`graphs.KeyframeGraph`) every steady keyframe. Each is built at its first
frame. What stays on the host is the branch choice, as `lax.cond`'s
predicate: one read of the inlier count a tracked frame, and one read of
the init gate on an init frame (whose keyframe branch runs the same
function eagerly: it happens once a run). An Engine built with
`eager=True` runs both branches op by op, as `jax.disable_jit` runs the
JAX step; with a mesh the keyframe branch runs eagerly, its local BA
driven from the host over the mesh.

With `loop_desc` the keyframe branch also emits the loop closer's
descriptor ladder (`loopclosing.loop_describe`) of every keyframe it
inserts, in `FrameOut.desc` / `dval`, as the JAX engine does.

Every frame is a span `engine.frame` in the recorder (`utils/profiling.py`,
its frame id and the branch it took as its tag) around `engine.track`
(the tracking call, the graph's copies in and out included),
`engine.read` (the host read) and `engine.keyframe` (the keyframe call).
While the recorder traces, a chunk also times its frames on the device
(`ChunkTiming`).
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from ssvio_tpu_torch import frontend as fe
from ssvio_tpu_torch import graphs, loopclosing
from ssvio_tpu_torch import map as mapmod
from ssvio_tpu_torch.ops import ba, se3
from ssvio_tpu_torch.parallel import dist_ba
from ssvio_tpu_torch.utils import profiling


class EngineCarry(NamedTuple):
    """Everything the per-frame step needs from the previous frame."""
    pyr_last: fe.Pyr
    feat: fe.FeatState
    T_cw: torch.Tensor        # [3, 4]
    rel_motion: torch.Tensor  # [3, 4]
    m: mapmod.MapState
    status: int               # fe.INITING/TRACKING_GOOD/BAD/LOST (host)


class FrameOut(NamedTuple):
    """Per-frame outputs of a chunk, stacked over its K frames, on the
    device. The scalars are read back through `pack_readback`; `feat`,
    `desc` and `dval` stay on the device. `desc`/`dval` hold the loop
    descriptors of keyframe frames (zeros elsewhere); with an engine built
    without loop_desc they have 0 rows."""
    T_cw: torch.Tensor        # [K, 3, 4] post-BA pose of the frame
    status: torch.Tensor      # [K] int32 status AFTER the frame
    n_inliers: torch.Tensor   # [K] int32
    kf_flag: torch.Tensor     # [K] bool: a keyframe was inserted
    kf_slot: torch.Tensor     # [K] int32 window slot of that keyframe (-1)
    kf_gid: torch.Tensor      # [K] int32 global id of that keyframe (-1)
    feat: fe.FeatState        # feature state after each frame, [K, ...]
    desc: torch.Tensor        # [K, S*F, 8] int32 loop descriptors
    dval: torch.Tensor        # [K, S*F] bool (or [K, 0])


class KeyframeOut(NamedTuple):
    """The keyframe branch's outputs (`Engine.keyframe_branch`), all on the
    device: the post-frame state (the branch's where the init gate accepts,
    else the carried state) and the keyframe's record."""
    accept: torch.Tensor      # [] bool: the init gate (True when steady)
    feat: fe.FeatState
    m: mapmod.MapState
    T_cw: torch.Tensor        # [3, 4] post-BA pose of the frame
    rel_motion: torch.Tensor  # [3, 4]
    T_kf: torch.Tensor        # [3, 4] the pose the keyframe was inserted at
    kf_slot: torch.Tensor     # [] int32 window slot (-1: rejected)
    kf_gid: torch.Tensor      # [] int32 global keyframe id (-1: rejected)
    img_r: torch.Tensor       # level 0 of the right pyramid
    desc: Optional[torch.Tensor]   # loop descriptors (engine with loop_desc)
    dval: Optional[torch.Tensor]
    ba_trip: Optional[torch.Tensor]  # [2] int32 rounds, LM steps of its BA


class _Frame(NamedTuple):
    """One frame's outputs as `_step` leaves them: the pose, inlier count,
    keyframe record and features on the device; the status and the branch
    taken on the host."""
    T_cw: torch.Tensor
    T_kf: torch.Tensor        # the pose a keyframe was inserted at (pre-BA)
    img_r: Optional[torch.Tensor]  # level 0 of the right pyramid, if built
    status: int
    n_inliers: torch.Tensor
    inliers: int              # n_inliers as the host read it (0 untracked)
    keyframe: bool            # a keyframe was inserted
    kf_flag: torch.Tensor     # [] bool, the same on the device
    kf_slot: torch.Tensor     # [] int32 (-1: no keyframe)
    kf_gid: torch.Tensor      # [] int32 (-1: no keyframe)
    feat: fe.FeatState
    ran_ba: bool
    ran_dist_ba: bool         # that BA sharded over the mesh
    desc: Optional[torch.Tensor]   # loop descriptors of a keyframe (or None)
    dval: Optional[torch.Tensor]


# how a steady keyframe's local BA runs: replayed in the keyframe graph,
# whose conditional nodes skip the rounds after the ratio flag; or op by
# op as the fixed trip, every round and step run (eagerly, uncaptured on
# the CPU, and over a mesh)
BA_MODES = ("graph", "fixed trip")


def ba_work(mode: str, rounds: int) -> Tuple[int, int]:
    """(LM steps run, rounds skipped) of a local BA that ran in `mode`
    (BA_MODES) and whose loops took `rounds` rounds: a graph runs each of
    those rounds whole, a fixed trip all LOCAL_BA_ROUNDS."""
    if mode == "graph":
        return rounds * ba.LOCAL_BA_ITERS, ba.LOCAL_BA_ROUNDS - rounds
    if mode == "fixed trip":
        return ba.LOCAL_BA_ROUNDS * ba.LOCAL_BA_ITERS, 0
    raise ValueError(f"a BA mode of {BA_MODES}, not {mode!r}")


class ChunkTiming:
    """A chunk's frames timed on the device, made at dispatch while the
    recorder traces (`profiling.tracing()`) and read at collect, once the
    chunk's readback has landed (`record`): nothing then waits on the
    device.

    CUDA events from the recorder's pool, on the compute stream: at the
    start of each frame, around its tracking call and its keyframe call,
    and one after the chunk's stacks and `pack_readback`. `record` adds
    per frame `engine.period_ms` (its start to the next frame's, or to the
    chunk's end), `engine.track_ms` and `engine.keyframe_ms`, and per
    chunk `ba.lm_steps_needed` (the LM steps its local BAs' loops took,
    `Engine.ba_trips`, read in one copy), `ba.lm_steps_run` (the steps
    they ran) and `ba.rounds_skipped` (the rounds of LOCAL_BA_ROUNDS they
    did not run), by the mode each BA ran in (`BA_MODES`, `ba_work`; a
    mesh BA runs the fixed trip). On the CPU no event is made; the LM
    steps are read all the same."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.frames: List[list] = []   # [frame, start, track, keyframe]
        self.trips: List[torch.Tensor] = []    # [2] int32 a BA
        self.modes: List[str] = []             # how that BA ran (BA_MODES)
        self.end = None
        self._trips_host: Optional[torch.Tensor] = None

    def event(self):
        """An event recorded now on the compute stream (None on the
        CPU)."""
        return profiling.event(self.device) if self.cuda else None

    def fetch(self) -> None:
        """Start the copy of the chunk's BA trips to the host, before its
        readback's event is recorded."""
        if not self.trips:
            return
        trips = torch.stack(self.trips)
        if self.cuda:
            self._trips_host = torch.empty(trips.shape, dtype=trips.dtype,
                                           pin_memory=True)
            self._trips_host.copy_(trips, non_blocking=True)
        else:
            self._trips_host = trips

    def record(self) -> None:
        """Add the chunk's device times and LM steps to the recorder and
        give the events back to the pool; call it once the readback has
        landed."""
        rec = profiling.TRACE
        used = []
        ends = [f[1] for f in self.frames[1:]] + [self.end]
        for (frame, start, track, kf), end in zip(self.frames, ends):
            if start is None:
                continue
            rec.add("engine.period_ms", start.elapsed_time(end), frame)
            used.append(start)
            for name, pair in (("engine.track_ms", track),
                               ("engine.keyframe_ms", kf)):
                if pair is not None:
                    rec.add(name, pair[0].elapsed_time(pair[1]), frame)
                    used += pair
        if self.cuda:
            profiling.release(self.device, used + [self.end])
        if self._trips_host is not None:
            trips = self._trips_host.tolist()
            work = [ba_work(mode, rounds)
                    for (rounds, _), mode in zip(trips, self.modes,
                                                 strict=True)]
            rec.add("ba.lm_steps_needed", float(sum(n for _, n in trips)))
            rec.add("ba.lm_steps_run", float(sum(w[0] for w in work)))
            rec.add("ba.rounds_skipped", float(sum(w[1] for w in work)))
        self.frames, self.trips, self.modes = [], [], []
        self._trips_host = None


class Engine:
    """Runs chunks of the per-frame step on the frontend's device.
    Stateless but for the mesh's BA client: all SLAM state lives in the
    EngineCarry the caller threads through.

    `mesh` (`parallel.dist_ba.Mesh`, this process rank 0 of it, on the
    frontend's device): the local BA of every steady keyframe is sharded
    over the mesh's landmark axis, through `dist_ba.PrimaryBA` (`self.dist`;
    the other ranks run `dist_ba.serve`). The JAX engine gets the same
    sharding from sharding constraints on the map inside its compiled
    chunk; tracking stays on one rank in both.

    `eager`: run both branches op by op instead of through the tracking
    graph (`graphs.TrackGraph`, one per canvas shape, in `self.graphs`)
    and the keyframe graph (`graphs.KeyframeGraph`, one per canvas shape,
    in `self.kf_graphs`); the tests and chip_smoke.py hold the two paths
    against each other. `close()` releases the graphs.

    `ba_trips` logs, for the tools, the rounds and LM steps of each local
    BA the engine ran (device [2] int32, the last 1024): the steps JAX's
    `while_loop`s take. The keyframe graph runs those rounds, 10 steps
    each; an eager, CPU or mesh BA runs 5 x 10 (`ba_mode`, `ba_work`)."""

    def __init__(self, frontend: fe.Frontend, enable_backend: bool,
                 mesh=None, loop_desc: bool = False, eager: bool = False):
        self.fe = frontend
        self.s = frontend.s
        self.enable_backend = enable_backend
        self.eager = eager
        self.graphs: Dict[Tuple[int, ...], graphs.TrackGraph] = {}
        self.kf_graphs: Dict[Tuple[int, ...], graphs.KeyframeGraph] = {}
        self.ba_trips: collections.deque = collections.deque(maxlen=1024)
        dev = frontend.device
        # a frame without a keyframe: its flag, slot and gid (never written)
        self._no_kf = (torch.zeros((), dtype=torch.bool, device=dev),
                       torch.full((), -1, dtype=torch.int32, device=dev),
                       torch.full((), -1, dtype=torch.int32, device=dev))
        # set by the System when a loop correction has moved and fused the
        # window; the next steady keyframe's local BA then runs all its
        # rounds (`local_ba`'s `hold`), and the flag is cleared after it
        self.after_correction = torch.zeros((), dtype=torch.bool, device=dev)
        self.dist = None
        if mesh is not None:
            if mesh.device != frontend.device:
                raise ValueError(f"the mesh's device {mesh.device} is not "
                                 f"the frontend's {frontend.device}")
            if self.s.max_landmarks % mesh.size:
                raise ValueError(f"max_landmarks {self.s.max_landmarks} is "
                                 f"not divisible by the mesh's {mesh.size} "
                                 "ranks")
            f = frontend
            self.dist = dist_ba.PrimaryBA(mesh, f._fx, f._fy, f._cx, f._cy,
                                          f._baseline)
        # loop_desc: keyframe frames emit the loop-closing descriptor
        # ladder (FrameOut.desc)
        self.loop_desc = loop_desc
        self._desc_rows = (self.s.loop_desc_scales * self.s.max_features
                           if loop_desc else 0)

    # ------------------------------------------------------------------
    def _track(self, carry: EngineCarry, img_l: torch.Tensor
               ) -> Tuple[fe.Pyr, fe.TrackOut]:
        """The tracking branch on one left frame: the pyramid and
        `_track_step` against the carry, through the canvas's tracking
        graph (built here at its first frame) unless the engine is eager."""
        args = (carry.pyr_last, carry.feat, carry.T_cw, carry.rel_motion,
                carry.m.lm_pos, carry.m.lm_valid, carry.m.lm_gid)
        if self.eager:
            return self.fe.track_frame(img_l.to(torch.float32), *args)
        key = tuple(img_l.shape)
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = graphs.TrackGraph(self.fe, img_l,
                                                         *args)
        return graph(img_l, *args)

    def keyframe_branch(self, img_r: torch.Tensor, pyr_l: fe.Pyr,
                        feat: fe.FeatState, T_cw: torch.Tensor,
                        rel_motion: torch.Tensor, m: mapmod.MapState,
                        is_init: bool) -> KeyframeOut:
        """The keyframe branch of the step (JAX `do_kf` and the selects
        after it, ssvio_tpu/engine.py:167-236) on the right frame and the
        left pyramid, after tracking (`feat`, `T_cw`, `rel_motion`: the
        tracking output, or the carry on an init frame) against the carried
        map `m`: the right pyramid, re-detection with the init or steady
        budget, stereo LK, triangulation and the map inserts
        (`Frontend._keyframe_core`), the init gate, the loop descriptors
        (engine with loop_desc), and on a steady keyframe the local BA
        (`ba_problem_from_map` -> `local_ba` -> `apply_ba_result`) and the
        keyframe's post-BA pose as a gather. No host read: the gate and the
        revert of a rejected init are device selects, as JAX's `_sel`. With
        a mesh the BA is sharded over it (`dist_ba.PrimaryBA`, driven from
        the host)."""
        f, s = self.fe, self.s
        dev = f.device
        pyr_r = f._build_pyramid(f._undistort_right(img_r.to(torch.float32)))
        feat_in = fe.empty_feat_state(s.max_features, dev) if is_init else feat
        T_in = se3.identity(device=dev) if is_init else T_cw
        # init vs steady extractor budget (reference system.cpp:115-129)
        budget = s.n_init_features if is_init else s.n_new_features
        feat2, m2, slot, gid, n_created, n_stereo = f._keyframe_core(
            pyr_l, pyr_r, feat_in, T_in, m, budget=budget)
        desc = dval = None
        if self.loop_desc:
            desc, dval = loopclosing.loop_describe(
                pyr_l.levels[0], feat2.xy, feat2.valid, s.loop_desc_scales,
                s.scale_factor,
                screen_threshold=(s.min_th_fast if s.loop_screen_fast
                                  else 0.0),
                pattern=loopclosing.pattern_from_settings(s))
        if is_init:
            # init gates: enough stereo-matched features (init_good,
            # reference frontend.cpp:433-437) AND enough triangulated
            # landmarks (Min.Init.Landmark.Num, :452-488); a rejected init
            # keeps the carried state
            accept = ((n_created >= s.min_init_landmarks)
                      & (n_stereo >= s.init_good))

            def sel(new, old):
                return torch.where(accept, new, old)

            minus1 = self._no_kf[1]
            return KeyframeOut(
                accept, fe.FeatState(*map(sel, feat2, feat)),
                mapmod.MapState(*map(sel, m2, m)), sel(T_in, T_cw),
                sel(se3.identity(device=dev), rel_motion), T_in,
                sel(slot, minus1), sel(gid, minus1), pyr_r.levels[0], desc,
                dval, None)
        # a steady keyframe is always accepted; the sliding-window BA rides
        # steady keyframes only (the reference backend starts after init)
        T2, trip = T_in, None
        if self.enable_backend:
            prob = mapmod.ba_problem_from_map(m2)
            res = (self.dist(prob) if self.dist is not None else
                   ba.local_ba(prob, f._fx, f._fy, f._cx, f._cy, f._baseline,
                               hold=self.after_correction))
            m2 = mapmod.apply_ba_result(m2, res.kf_T_cw, res.lm_pos,
                                        res.obs_valid)
            T2 = torch.index_select(m2.kf_pose, 0,
                                    slot.reshape(1).to(torch.int64))[0]
            trip = torch.stack([res.rounds, res.iterations])
        return KeyframeOut(torch.ones((), dtype=torch.bool, device=dev),
                           feat2, m2, T2, rel_motion, T_in, slot, gid,
                           pyr_r.levels[0], desc, dval, trip)

    def _keyframe(self, img_r: torch.Tensor, pyr_l: fe.Pyr, out: fe.TrackOut,
                  m: mapmod.MapState, is_init: bool) -> KeyframeOut:
        """keyframe_branch on a frame: a steady keyframe through the
        canvas's keyframe graph (built here at its first one) unless the
        engine is eager or has a mesh; an init frame eagerly. A steady
        keyframe's BA clears `after_correction`, outside the graph."""
        args = (img_r, pyr_l, out.feat, out.T_cw, out.rel_motion, m)
        if self.eager or is_init or self.dist is not None:
            k = self.keyframe_branch(*args, is_init=is_init)
        else:
            key = tuple(img_r.shape)
            graph = self.kf_graphs.get(key)
            if graph is None:
                graph = self.kf_graphs[key] = graphs.KeyframeGraph(
                    self.keyframe_branch, *args)
            k = graph(*args)
        if not is_init and self.enable_backend:
            self.after_correction.zero_()
        return k

    @property
    def tracking_path(self) -> str:
        """How the tracking branch runs: "eager", "graph" (a CUDA graph
        replayed) or "static buffers" (the graph's function on its
        buffers, uncaptured: the CPU)."""
        if self.eager:
            return "eager"
        return "graph" if self.fe.device.type == "cuda" else "static buffers"

    @property
    def keyframe_path(self) -> str:
        """How a steady keyframe's branch runs: tracking_path's words, and
        "eager" with a mesh."""
        return "eager" if self.dist is not None else self.tracking_path

    @property
    def ba_mode(self) -> str:
        """How a steady keyframe's local BA runs (BA_MODES)."""
        return "graph" if self.keyframe_path == "graph" else "fixed trip"

    def close(self) -> None:
        """Release the tracking and keyframe graphs (their memory pools);
        the next frame of each branch builds a new one."""
        for graph in (*self.graphs.values(), *self.kf_graphs.values()):
            graph.close()
        self.graphs.clear()
        self.kf_graphs.clear()

    # ------------------------------------------------------------------
    def _step(self, carry: EngineCarry, img_l: torch.Tensor,
              img_r: Callable[[], torch.Tensor], frame: int = -1,
              timing: Optional[ChunkTiming] = None
              ) -> Tuple[EngineCarry, _Frame]:
        """One engine frame (JAX `Engine._step`, engine.py:116-237): track
        on GOOD/BAD; one keyframe path for INITING and TRACKING_BAD, with
        the init or steady detection budget and the init gate chosen per
        frame; a rejected init reverts to the carried state; BA rides
        steady keyframes only; LOST dead-ends (recovery is a host decision
        between chunks, and needs loop closing). The one copy of the
        per-frame status machine: `run_chunk` loops it over a chunk and
        `System.run_step` runs it on one frame.

        `img_r` returns the right image; it is called only on frames that
        run the keyframe path, so run_step pads and uploads the right eye
        only there.

        The host reads of a frame, each of them a branch choice the next
        frame depends on (the JAX step's `lax.cond` predicates on the
        device):
        - a tracked frame: `int(out.n_inliers)`, whose status picks the
          branch (it replays the tracking graph, `_track`);
        - an init frame: the init gate's `accept`, one scalar: the status
          after the frame (its keyframe branch runs eagerly).
        A steady keyframe (a tracked frame whose status turned BAD)
        replays the keyframe graph (`_keyframe`) and reads nothing more:
        its flag, slot and gid stay on the device in `_Frame`, and within
        a chunk `run_chunk` stacks them unread. `System.run_step` reads a
        keyframe's record in one packed copy afterwards.

        The frame is a span `engine.frame` in the recorder, with `frame`
        (its index in the System's stream) and the branch as its tag
        ("init", "track", "track+keyframe" or "lost"); `timing` (while the
        recorder traces) takes its device events and its BA's trip.

        Reference: FrontEnd::GrabSteroImage status dispatch
        (frontend.cpp:49-67), SteroInit (:430-446), Track (:79-128),
        InsertKeyFrame (:546-576) + Backend::OptimizeActiveMap
        (backend.cpp:78-245)."""
        with profiling.TRACE.span("engine.frame", frame) as span:
            c2, fr = self._frame(carry, img_l, img_r, frame, timing)
            span.tag = ("init" if carry.status == fe.INITING
                        else "lost" if carry.status == fe.LOST
                        else "track+keyframe" if fr.keyframe else "track")
        return c2, fr

    def _frame(self, carry: EngineCarry, img_l: torch.Tensor,
               img_r: Callable[[], torch.Tensor], frame: int,
               timing: Optional[ChunkTiming]) -> Tuple[EngineCarry, _Frame]:
        """`_step`'s body, its parts spans of the recorder."""
        f = self.fe
        s = self.s
        dev = f.device
        status = carry.status
        is_init = status == fe.INITING
        is_track = status in (fe.TRACKING_GOOD, fe.TRACKING_BAD)
        rec = profiling.TRACE
        times = None
        if timing is not None:
            times = [frame, timing.event(), None, None]
            timing.frames.append(times)

        # ---- tracking (only for GOOD/BAD; INITING/LOST pass through). u8
        # frames (camera-native, 4x fewer bytes to upload) are promoted on
        # the device; the right eye is undistorted only where it is used
        n_inl = 0
        if is_track:
            with rec.span("engine.track", frame):
                t0 = timing.event() if timing is not None else None
                pyr_l, out = self._track(carry, img_l)
                if timing is not None:
                    times[2] = (t0, timing.event())
            # the one host read of a tracked frame: the status picks the
            # branch, as the JAX step's lax.cond does on the device
            with rec.span("engine.read", frame):
                n_inl = int(out.n_inliers)
            status_t = (fe.TRACKING_GOOD if n_inl > s.tracking_good
                        else fe.TRACKING_BAD if n_inl > s.tracking_bad
                        else fe.LOST)
        else:
            pyr_l = f._build_pyramid(
                f._undistort_left(img_l.to(torch.float32)))
            out = fe.TrackOut(carry.feat, carry.T_cw, carry.rel_motion,
                              torch.zeros((), dtype=torch.int32, device=dev))
            status_t = status
        need_kf = is_init or (is_track and status_t == fe.TRACKING_BAD)

        # ---- keyframe machinery (one path for init + steady)
        feat_f, m_f, T_f, rel_f = out.feat, carry.m, out.T_cw, out.rel_motion
        kf_flag, kf_slot, kf_gid = self._no_kf
        keyframe = ran_ba = False
        desc = dval = img_r0 = None
        T_kf = out.T_cw
        if need_kf:
            right = img_r()
            with rec.span("engine.keyframe", frame):
                t0 = timing.event() if timing is not None else None
                k = self._keyframe(right, pyr_l, out, carry.m, is_init)
                if timing is not None:
                    times[3] = (t0, timing.event())
            # an init frame's one host read: the gate sets the status
            keyframe = True
            if is_init:
                with rec.span("engine.read", frame):
                    keyframe = bool(k.accept)
            feat_f, m_f, T_f, rel_f = k.feat, k.m, k.T_cw, k.rel_motion
            kf_flag, kf_slot, kf_gid = k.accept, k.kf_slot, k.kf_gid
            T_kf, img_r0 = k.T_kf, k.img_r
            if keyframe:
                desc, dval = k.desc, k.dval
            if k.ba_trip is not None:
                self.ba_trips.append(k.ba_trip)
                if timing is not None:
                    timing.trips.append(k.ba_trip)
                    timing.modes.append(self.ba_mode)
            ran_ba = self.enable_backend and not is_init

        # ---- the post-frame state (an init reject keeps the carried one)
        status_f = ((fe.TRACKING_GOOD if keyframe else fe.INITING) if is_init
                    else status_t)
        c2 = EngineCarry(pyr_l, feat_f, T_f, rel_f, m_f, status_f)
        return c2, _Frame(T_f, T_kf, img_r0, status_f, out.n_inliers, n_inl,
                          keyframe, kf_flag, kf_slot, kf_gid, feat_f, ran_ba,
                          ran_ba and self.dist is not None, desc, dval)

    # ------------------------------------------------------------------
    def run_chunk(self, carry: EngineCarry, imgs_l: torch.Tensor,
                  imgs_r: torch.Tensor, frame0: int = -1,
                  timing: Optional[ChunkTiming] = None):
        """Run the per-frame step over [K, H, W] stereo stacks (u8 or f32)
        on the device. Returns (carry, outs: FrameOut, packed: the f32
        vector of pack_readback, n_ba: local BAs run, n_dist_ba: of them,
        sharded over the mesh). `frame0`: the first frame's index in the
        System's stream, for the recorder (-1: none); `timing` takes the
        chunk's device events, the last after pack_readback."""
        frames: List[_Frame] = []
        for k in range(imgs_l.shape[0]):
            carry, fr = self._step(carry, imgs_l[k], lambda k=k: imgs_r[k],
                                   frame0 + k if frame0 >= 0 else -1, timing)
            frames.append(fr)
        dev = self.fe.device
        no_desc = torch.zeros((self._desc_rows, 8), dtype=torch.int32,
                              device=dev)
        no_dval = torch.zeros((self._desc_rows,), dtype=torch.bool,
                              device=dev)
        # the statuses are the host's; the keyframe records stay unread
        status = torch.tensor([fr.status for fr in frames],
                              dtype=torch.int32).to(dev)
        outs = FrameOut(
            T_cw=torch.stack([fr.T_cw for fr in frames]),
            status=status,
            n_inliers=torch.stack([fr.n_inliers.to(torch.int32)
                                   for fr in frames]),
            kf_flag=torch.stack([fr.kf_flag for fr in frames]),
            kf_slot=torch.stack([fr.kf_slot for fr in frames]),
            kf_gid=torch.stack([fr.kf_gid for fr in frames]),
            feat=fe.FeatState(*[torch.stack(v) for v in
                                zip(*[fr.feat for fr in frames])]),
            desc=torch.stack([no_desc if fr.desc is None else fr.desc
                              for fr in frames]),
            dval=torch.stack([no_dval if fr.dval is None else fr.dval
                              for fr in frames]))
        packed = pack_readback(carry, outs)
        if timing is not None:
            timing.end = timing.event()
        return (carry, outs, packed, sum(fr.ran_ba for fr in frames),
                sum(fr.ran_dist_ba for fr in frames))


PER_FRAME_PACK = 17          # 12 pose + status + n_inliers + kf_flag/slot/gid


def pack_readback(carry: EngineCarry, outs: FrameOut) -> torch.Tensor:
    """Flatten everything the host needs per chunk into ONE f32 vector on
    the device, so the host makes a single device-to-host copy. Layout (the
    JAX package's, engine.py:249-283):

      [K*17]  per frame: T_cw (12) | status | n_inliers | kf_flag | kf_slot
              | kf_gid
      [1]     carry.status after the chunk
      [W]     map.kf_gid   (window keyframe ids, for record refresh)
      [W]     map.kf_valid
      [12W]   map.kf_pose flattened

    int fields ride as f32 (ids stay well under 2^24)."""
    K = outs.T_cw.shape[0]
    f32 = torch.float32
    per = torch.cat([
        outs.T_cw.reshape(K, 12),
        outs.status[:, None].to(f32),
        outs.n_inliers[:, None].to(f32),
        outs.kf_flag[:, None].to(f32),
        outs.kf_slot[:, None].to(f32),
        outs.kf_gid[:, None].to(f32),
    ], dim=1)
    m = carry.m
    tail = torch.cat([
        torch.tensor([carry.status], dtype=f32).to(m.kf_pose.device),
        m.kf_gid.to(f32),
        m.kf_valid.to(f32),
        m.kf_pose.reshape(-1),
    ])
    return torch.cat([per.reshape(-1), tail])


def fresh_carry(settings, frontend: fe.Frontend,
                m: mapmod.MapState) -> EngineCarry:
    """Initial carry: INITING status, zero pyramid placeholder."""
    dev = frontend.device
    zero = torch.zeros((frontend.h, frontend.w), dtype=torch.float32,
                       device=dev)
    return EngineCarry(
        pyr_last=frontend._build_pyramid(zero),
        feat=fe.empty_feat_state(settings.max_features, dev),
        T_cw=se3.identity(device=dev), rel_motion=se3.identity(device=dev),
        m=m, status=fe.INITING)
