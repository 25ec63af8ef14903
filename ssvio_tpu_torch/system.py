"""System facade: construction, wiring, the per-frame step API and the
chunk API (port of `ssvio_tpu/system.py`).

Construct from a Settings object (or a reference-format YAML path), then
drive with `run_step(left, right, timestamp)` one frame at a time, or with
`run_chunk` / `dispatch_chunk` + `collect_chunk` K frames at a time through
the chunked engine (`engine.py`), fed by `prefetcher()`. Both run the
engine's one per-frame step, so they give the same answers; they differ
only in when the host records the frames. Local BA runs right after each
steady keyframe insertion, on the System's device: the current CUDA
device unless the caller passes one (device="cpu" for the CPU; without a
CUDA device, no device raises).

Loop closing (`loopclosing.py`, on by default as Settings.loop_closing_open)
ingests every keyframe: at once on the per-frame path, at the chunk's
collect on the chunk path, where its candidates are verified at the next
collect (or at `finish()`). A correction is a gauge event of the
keyframe records (`self.records`, `records.py`), and collect_chunk
re-gauges the read-back poses of a chunk that was in flight by the events
since its dispatch. After a correction the next steady
keyframe's local BA runs all its rounds (`Engine.after_correction`),
where the reference and the JAX package stop at the first round that
meets the inlier ratio. A LOST frame relocalizes against the keyframe
database when Settings.relocalization_open is set: the next run_step
frame, or the chunk's last frame at its collect.

With a mesh (`parallel.dist_ba.Mesh`, this process its rank 0) the local
BA of every steady keyframe, on both paths, is sharded over the mesh's
landmark axis (engine.py; the other ranks run `dist_ba.serve` until
`close()`), and `stats["n_dist_ba"]` counts those BAs. A relocalization's
BA stays on this rank, as the JAX System's does.

On a CUDA device the tracking branch of every tracked frame, on both paths
and after a relocalization or a checkpoint load alike, replays the
engine's tracking graph (`graphs.TrackGraph`), and the keyframe branch of
every steady keyframe its keyframe graph (`graphs.KeyframeGraph`; eager
with a mesh); `eager=True` runs both op by op instead (the counterpart of
`jax.disable_jit`). `close()` releases the graphs' memory.

`dispatch_chunk` and `collect_chunk` are spans of the port's recorder
(`utils/profiling.py`), as are the engine's frames, numbered by their
index in the stream; while the recorder traces, a chunk's frames are
timed on the device at dispatch and read at collect
(`engine.ChunkTiming`).
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ssvio_tpu_torch import engine as eng
from ssvio_tpu_torch import frontend as fe
from ssvio_tpu_torch import map as mapmod
from ssvio_tpu_torch.config import Settings
from ssvio_tpu_torch.loopclosing import LoopClosing, LoopEvent
from ssvio_tpu_torch.ops import ba, se3
from ssvio_tpu_torch.records import KeyframeRecords
from ssvio_tpu_torch.utils import profiling


class ChunkHandle(NamedTuple):
    """What dispatch_chunk hands to collect_chunk."""
    packed: torch.Tensor          # pack_readback's vector, on the host
    ready: Optional[torch.cuda.Event]   # its device-to-host copy is done
    outs: eng.FrameOut            # per-frame outputs (device)
    timestamps: List[float]
    n_frames: int
    n_ba: int                     # local BAs the chunk ran
    n_dist_ba: int                # of them, sharded over the mesh
    gauge_idx: int                # records.gauge_index() at dispatch
    m: mapmod.MapState            # the map after the chunk (loop ingest)
    last_l: torch.Tensor          # the chunk's last images, padded, for
    last_r: torch.Tensor          # relocalization and the viewer
    timing: Optional[eng.ChunkTiming] = None   # while tracing


class System:
    def __init__(self, settings: Settings | str,
                 enable_backend: Optional[bool] = None,
                 enable_loop_closing: Optional[bool] = None, mesh=None,
                 device=None, eager: bool = False):
        if isinstance(settings, str):
            settings = Settings.from_yaml(settings)
        self.s = settings
        self.enable_backend = (settings.backend_open if enable_backend is None
                               else enable_backend)
        enable_loop = (settings.loop_closing_open if enable_loop_closing is None
                       else enable_loop_closing)
        # the GPU unless the caller asks for the CPU (device="cpu")
        self.device = fe.resolve_device(device)
        # host-to-device copies of chunks ride their own stream, so an
        # upload overlaps the compute of the chunk before it
        self._upload_stream = (torch.cuda.Stream(self.device)
                               if self.device.type == "cuda" else None)
        # padded device image dims (pyramid levels need /2^L)
        div = 2 ** (settings.lk_levels + 1)
        self.w = -(-settings.image_width // div) * div
        self.h = -(-settings.image_height // div) * div
        self.frontend = fe.Frontend(settings, self.w, self.h,
                                    settings.image_width, settings.image_height,
                                    device=self.device)
        # the per-frame step, shared by run_step and the chunk API; with
        # loop closing its keyframe branch emits the loop descriptors
        self._engine = eng.Engine(self.frontend, self.enable_backend,
                                  mesh=mesh, loop_desc=enable_loop,
                                  eager=eager)
        self.loopclosing: Optional[LoopClosing] = None
        self.reset()
        if enable_loop:
            self.loopclosing = self._new_loopclosing()

    def _new_loopclosing(self) -> LoopClosing:
        f = self.frontend
        return LoopClosing(self.s, f._fx, f._fy, f._cx, f._cy,
                           device=self.device, eager=self._engine.eager)

    def reset(self, keep_vocab: bool = False):
        """Return to the fresh INITING state. keep_vocab carries the
        trained BoW vocabulary into the fresh loop-closing database (as a
        pretrained vocabulary would be loaded)."""
        self.map = mapmod.empty_map(self.s.max_window, self.s.max_landmarks,
                                    self.device)
        self.status = fe.INITING
        self.T_cw = se3.identity(device=self.device)
        self.rel_motion = se3.identity(device=self.device)
        self.feat = fe.empty_feat_state(self.s.max_features, self.device)
        self.last_pyr = None
        # the latest pair for the viewer's stereo pane (viz.py): level 0 of
        # the left pyramid and, on frames that built it, of the right one
        self.last_stereo = None
        self.frame_id = -1
        self._in_flight = 0         # frames dispatched, not yet collected
        # tracking health: the median tracked inlier count of the last 30
        # frames (run_step) or of the latest chunk, and the run's typical
        # health, the median of at most 512 of those (trimmed by 256); the
        # loop closer's health gate reads both
        self.track_health = None
        self.track_health_typical = None
        self._health_window = []
        self._health_history = []
        self._lost_since_kf = False  # a LOST gap since the last keyframe
        self.trajectory = []        # (timestamp, frame_id, T_wc [3,4] np)
        self.records = KeyframeRecords()
        self.stats = {"n_keyframes": 0, "n_ba": 0, "n_dist_ba": 0,
                      "n_loops": 0, "warnings": []}
        self._engine.after_correction.zero_()
        if self.loopclosing is not None:
            old = self.loopclosing
            self.loopclosing = lc = self._new_loopclosing()
            # the verification's graphs: their shapes and intrinsics are
            # the System's, so a capture serves every drive
            lc._graphs = old._graphs
            if keep_vocab and old.vocab is not None:
                lc.vocab = old.vocab
                lc._vocab_levels = old._vocab_levels
                lc._vocab_loaded = old._vocab_loaded
                lc.bow_db = torch.zeros((lc.cap, old.vocab.n_words),
                                        dtype=torch.float32,
                                        device=self.device)

    # ------------------------------------------------------------------
    def _pad(self, img) -> torch.Tensor:
        """Edge-pad one image to the [h, w] device dims on the device.
        Accepts a numpy array or a tensor (on any device)."""
        img = torch.as_tensor(np.array(img) if not torch.is_tensor(img)
                              else img).to(self.device, torch.float32)
        return self._pad_on_device(img[None])[0]

    def _pad_on_device(self, imgs: torch.Tensor) -> torch.Tensor:
        """Edge-pad a [K, h, w] stack on its device to [K, self.h, self.w]."""
        K, h, w = imgs.shape
        if (h, w) == (self.h, self.w):
            return imgs
        if h > self.h or w > self.w:
            raise ValueError(f"images of shape {(h, w)} do not fit the "
                             f"engine canvas {(self.h, self.w)}")
        rows = torch.clamp(torch.arange(self.h, device=imgs.device), max=h - 1)
        cols = torch.clamp(torch.arange(self.w, device=imgs.device), max=w - 1)
        return imgs[:, rows][:, :, cols]

    # ------------------------------------------------------------------
    def _carry(self) -> eng.EngineCarry:
        """The SLAM state as the engine's carry."""
        pyr_last = self.last_pyr
        if pyr_last is None:
            # fresh start: the zero placeholder (never tracked against: the
            # status is INITING)
            pyr_last = eng.fresh_carry(self.s, self.frontend,
                                       self.map).pyr_last
        return eng.EngineCarry(pyr_last=pyr_last, feat=self.feat,
                               T_cw=self.T_cw, rel_motion=self.rel_motion,
                               m=self.map, status=self.status)

    def _install(self, carry: eng.EngineCarry):
        self.last_pyr = carry.pyr_last
        self.feat = carry.feat
        self.T_cw = carry.T_cw
        self.rel_motion = carry.rel_motion
        self.map = carry.m
        self.status = carry.status

    def _add_health(self, value: float):
        self._health_history.append(value)
        if len(self._health_history) > 512:
            del self._health_history[:256]
        self.track_health_typical = float(np.median(self._health_history))

    @torch.no_grad()
    def run_step(self, left, right, timestamp: float = 0.0) -> np.ndarray:
        """Process one stereo pair ([H, W] numpy arrays or tensors): one
        frame of the engine's step (engine.py), recorded at once, then loop
        closing for a keyframe. A frame entered in LOST relocalizes instead
        when loop closing and Settings.relocalization_open are on. Returns
        the camera pose T_wc [3,4] np.

        Host reads: the step's (`Engine._step`: a tracked frame's inlier
        count, an init frame's gate), one packed read of a keyframe's
        record (`_step_frame`), and the returned pose."""
        self.frame_id += 1
        if (self.status == fe.LOST and self.loopclosing is not None
                and self.s.relocalization_open):
            f = self.frontend
            pyr_l = f._build_pyramid(f._undistort_left(self._pad(left)))
            self._try_relocalize(pyr_l, right, timestamp)
            self.last_pyr = pyr_l
            self.last_stereo = (pyr_l.levels[0], None)
        else:
            self._step_frame(left, right, timestamp)
        T_wc = se3.inverse(self.T_cw).cpu().numpy()
        self.trajectory.append((timestamp, self.frame_id, T_wc))
        return T_wc

    def _step_frame(self, left, right, timestamp: float):
        tracked = self.status in (fe.TRACKING_GOOD, fe.TRACKING_BAD)
        carry, fr = self._engine._step(self._carry(), self._pad(left),
                                       lambda: self._pad(right),
                                       self.frame_id)
        self._install(carry)
        self.last_stereo = (carry.pyr_last.levels[0], fr.img_r)
        if tracked:
            n_inl = fr.inliers
            self._health_window = (self._health_window + [n_inl])[-30:]
            self.track_health = float(np.median(self._health_window))
            self._add_health(float(n_inl))
        if not fr.keyframe:
            return
        # a keyframe's record in one read: its gid, the pose it was
        # inserted at and the window after the frame
        m = carry.m
        W = self.s.max_window
        rec = torch.cat([fr.kf_gid.reshape(1).to(torch.float32),
                         fr.T_kf.reshape(-1), m.kf_gid.to(torch.float32),
                         m.kf_valid.to(torch.float32),
                         m.kf_pose.reshape(-1)]).cpu().numpy()
        gid = int(rec[0])
        # the record and its odometry edge take the pose the keyframe was
        # inserted at, as the JAX System's run_step does; the BA refresh
        # below moves the record, not the edge
        self.records.add(gid, timestamp, rec[1:13].reshape(3, 4).copy(),
                         self.frame_id)
        self.stats["n_keyframes"] += 1
        if fr.ran_ba:
            self.stats["n_ba"] += 1
            self.stats["n_dist_ba"] += fr.ran_dist_ba
            self.records.refresh(rec[13:13 + W].astype(np.int32),
                                 rec[13 + W:13 + 2 * W] > 0.5,
                                 rec[13 + 2 * W:].reshape(W, 3, 4))
        if self.loopclosing is not None:
            self._count_event(self.loopclosing.process_keyframe(
                self, gid, carry.pyr_last, self.feat, self.map, self.T_cw,
                desc=(fr.desc, fr.dval)))

    def _count_event(self, ev: Optional[LoopEvent]):
        if ev is not None and ev.corrected:
            self.stats["n_loops"] += 1
            self.stats["n_fused"] = self.stats.get("n_fused", 0) + ev.n_fused
            # the window was moved and fused: the next steady keyframe's
            # local BA runs all its rounds (Engine.after_correction)
            self._engine.after_correction.fill_(True)

    # ------------------------------------------------------------------
    def _pad_stack(self, imgs) -> torch.Tensor:
        """Edge-pad K host images into ONE contiguous host buffer [K, h, w]
        (page-locked when the System is on a GPU, so its upload can run
        asynchronously). uint8 input stays uint8 (4x fewer bytes to upload;
        the engine promotes to f32 on the device); anything else becomes
        f32. Raises ValueError on an empty chunk or an image larger than
        the engine canvas."""
        arrs = [np.asarray(im.cpu() if torch.is_tensor(im) else im)
                for im in imgs]
        if not arrs:
            raise ValueError("empty chunk: no images to upload")
        u8 = arrs[0].dtype == np.uint8
        for a in arrs:
            if a.ndim != 2 or a.shape[0] > self.h or a.shape[1] > self.w:
                raise ValueError(f"image of shape {a.shape} does not fit the "
                                 f"engine canvas {(self.h, self.w)}")
        buf = torch.empty((len(arrs), self.h, self.w),
                          dtype=torch.uint8 if u8 else torch.float32,
                          pin_memory=self.device.type == "cuda")
        out = buf.numpy()
        for a, o in zip(arrs, out):
            h, w = a.shape
            o[:h, :w] = a
            if w < self.w:
                o[:h, w:] = o[:h, w - 1:w]
            if h < self.h:
                o[h:, :] = o[h - 1:h, :]
        return buf

    def _upload(self, lefts, rights):
        """Pad both eyes into host buffers and copy them to the device; on
        a GPU the copies are queued on the upload stream. Returns (imgs_l,
        imgs_r, done): `done` is a CUDA event recorded after the copies
        (None off the GPU)."""
        host_l, host_r = self._pad_stack(lefts), self._pad_stack(rights)
        if self._upload_stream is None:
            return host_l.to(self.device), host_r.to(self.device), None
        with torch.cuda.stream(self._upload_stream):
            imgs_l = host_l.to(self.device, non_blocking=True)
            imgs_r = host_r.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._upload_stream)
        return imgs_l, imgs_r, done

    def upload_chunk(self, lefts, rights):
        """Pad + upload K stereo pairs; returns device stacks [K, h, w] to
        pass to run_chunk / dispatch_chunk. The copies run on a side
        stream; the current stream waits for them on the device, not the
        host."""
        imgs_l, imgs_r, done = self._upload(lefts, rights)
        if done is not None:
            torch.cuda.current_stream(self.device).wait_event(done)
        return imgs_l, imgs_r

    def prefetcher(self, depth: int = 2) -> "ChunkPrefetcher":
        """Background-thread chunk uploader, so that padding and uploading
        chunk k+1 overlap the compute of chunk k. Usage:

            pf = system.prefetcher()
            pf.submit(L0, R0); pf.submit(L1, R1)
            while ...:
                h = system.dispatch_chunk(*pf.get())
                pf.submit(Lk, Rk)            # upload rides behind compute
                out = system.collect_chunk(prev); prev = h
            pf.close()
        """
        return ChunkPrefetcher(self, depth)

    def _device_stack(self, imgs) -> torch.Tensor:
        """A chunk's images for one eye as a [K, h, w] stack on the device:
        a stack already there (upload_chunk, or made on the device) is used
        as it is, edge-padded on the device if it is smaller than the
        canvas; anything else is padded on the host and uploaded."""
        if torch.is_tensor(imgs) and imgs.device == self.device \
                and imgs.ndim == 3:
            if imgs.is_cuda:
                # it may come from the upload stream: keep its memory
                # from being reused while this stream still reads it
                imgs.record_stream(torch.cuda.current_stream(self.device))
            return self._pad_on_device(imgs)
        return self._pad_stack(imgs).to(self.device, non_blocking=True)

    @torch.no_grad()
    def run_chunk(self, lefts, rights, timestamps=None) -> np.ndarray:
        """Process K stereo pairs in one dispatch of the chunked engine
        (engine.py). Returns T_wc [K, 3, 4]. Gives what K run_step calls
        give."""
        return self.collect_chunk(self.dispatch_chunk(lefts, rights,
                                                      timestamps))

    @profiling.spanned("system.dispatch_chunk")
    @torch.no_grad()
    def dispatch_chunk(self, lefts, rights, timestamps=None) -> ChunkHandle:
        """Run one chunk on the device and start the copy of its packed
        readback to the host, without waiting for it. Returns a handle for
        collect_chunk. The SLAM state after the chunk is installed at once,
        so the next chunk can be dispatched before this one is collected:
        the host's bookkeeping for chunk k then overlaps the device work
        of chunk k+1.

        `lefts`/`rights`: sequences of [H, W] images (numpy arrays or
        tensors; uint8 stays uint8 until the device) or [K, h, w] device
        stacks from upload_chunk / the prefetcher."""
        K = len(lefts)
        if K == 0:
            raise ValueError("dispatch_chunk() called with an empty chunk")
        if len(rights) != K:
            raise ValueError(f"{K} left images but {len(rights)} right ones")
        if timestamps is None:
            timestamps = [0.0] * K
        imgs_l = self._device_stack(lefts)
        imgs_r = self._device_stack(rights)
        gauge_idx = self.records.gauge_index()
        timing = (eng.ChunkTiming(self.device) if profiling.tracing()
                  else None)
        carry, outs, packed, n_ba, n_dist = self._engine.run_chunk(
            self._carry(), imgs_l, imgs_r,
            self.frame_id + 1 + self._in_flight, timing)
        self._in_flight += K
        self._install(carry)
        # the chunk's last pair: relocalization reads it at collect, after
        # the caller may have reused its stack, so loop closing keeps a copy;
        # otherwise only the viewer reads it (last_stereo), from a view
        last_l, last_r = imgs_l[K - 1], imgs_r[K - 1]
        if self.loopclosing is not None:
            last_l, last_r = last_l.clone(), last_r.clone()
        if timing is not None:
            timing.fetch()
        ready = None
        if packed.is_cuda:
            host = torch.empty(packed.shape, dtype=packed.dtype,
                               pin_memory=True)
            host.copy_(packed, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
            packed = host
        return ChunkHandle(packed, ready, outs, list(timestamps), K, n_ba,
                           n_dist, gauge_idx, carry.m, last_l, last_r,
                           timing)

    @profiling.spanned("system.collect_chunk")
    @torch.no_grad()
    def collect_chunk(self, handle: ChunkHandle) -> np.ndarray:
        """Wait for a dispatched chunk's readback and record its frames
        (trajectory, keyframe records, odometry edges), re-gauged by the
        loop corrections applied since its dispatch. Then loop closing:
        the candidates deferred at the previous collect are verified, this
        chunk's keyframes are ingested (their candidates deferred to the
        next collect), and a chunk that ended LOST relocalizes on its last
        frame. Returns T_wc [K, 3, 4]."""
        if handle.ready is not None:
            handle.ready.synchronize()
        if handle.timing is not None:
            handle.timing.record()
        packed = handle.packed.numpy()
        K = handle.n_frames
        self._in_flight = max(0, self._in_flight - K)
        P = eng.PER_FRAME_PACK
        per = packed[:K * P].reshape(K, P)
        T_cw_k = per[:, :12].reshape(K, 3, 4).copy()
        statuses = per[:, 12].astype(np.int32)
        kf_flag = per[:, 14] > 0.5
        kf_gid_k = per[:, 16].astype(np.int32)
        tail = packed[K * P:]
        W = self.s.max_window
        tail_gids = tail[1:1 + W].astype(np.int32)
        tail_valid = tail[1 + W:1 + 2 * W] > 0.5
        kf_pose_tail = tail[1 + 2 * W:1 + 14 * W].reshape(W, 3, 4).copy()

        # re-gauge by the corrections applied while this chunk was in
        # flight: its poses and window, as the live window received them.
        # The handle's map predates them; the ingest's snapshot refresh
        # then writes pre-correction positions into still-active rows, and
        # a later post-correction snapshot refreshes them again (the JAX
        # package measured re-gauging that map instead: worse)
        T_cw_k = self.records.regauge(T_cw_k, handle.gauge_idx)
        kf_pose_tail = self.records.regauge(kf_pose_tail, handle.gauge_idx)

        # tracking health: median inlier count of the chunk's tracked
        # frames (INITING/LOST report none)
        tracked = np.isin(statuses, (fe.TRACKING_GOOD, fe.TRACKING_BAD))
        if tracked.any():
            self.track_health = float(np.median(
                per[:, 13][tracked].astype(np.float32)))
            self._add_health(self.track_health)

        T_wc_k = np.empty_like(T_cw_k)
        lost_since_kf = self._lost_since_kf
        for i in range(K):
            self.frame_id += 1
            R = T_cw_k[i, :, :3]
            T_wc_k[i, :, :3] = R.T
            T_wc_k[i, :, 3] = -R.T @ T_cw_k[i, :, 3]
            # INITING retries report identity, as run_step records it
            self.trajectory.append((handle.timestamps[i], self.frame_id,
                                    T_wc_k[i]))
            if statuses[i] == fe.LOST:
                lost_since_kf = True
            if kf_flag[i] and statuses[i] != fe.LOST:
                # a keyframe after a LOST gap has no measured motion to its
                # predecessor: no odometry edge across the gap
                self.records.add(int(kf_gid_k[i]), handle.timestamps[i],
                                 T_cw_k[i].copy(), self.frame_id,
                                 odometry_edge=not lost_since_kf)
                self.stats["n_keyframes"] += 1
                lost_since_kf = False
        self._lost_since_kf = lost_since_kf
        self.stats["n_ba"] += handle.n_ba
        self.stats["n_dist_ba"] += handle.n_dist_ba
        self.records.refresh(tail_gids, tail_valid, kf_pose_tail)
        self.last_stereo = (handle.last_l, handle.last_r)
        if self.loopclosing is None:
            return T_wc_k

        # the chunk's keyframe poses and the gauge index, captured together
        # BEFORE polling: poll may apply corrections (new gauge events)
        gauge_idx_now = self.records.gauge_index()
        idxs, gids, T_list = [], [], []
        for i in np.nonzero(kf_flag)[0]:
            gid = int(kf_gid_k[i])
            if gid not in self.records.by_gid:
                self._warn(f"loop closing skipped keyframe gid={gid}: no "
                           "host record")
                continue
            idxs.append(int(i))
            gids.append(gid)
            T_list.append(np.asarray(self.records.pose(gid)))
        # candidates deferred at the previous collect first, then this
        # chunk's keyframes (the handle's map is the one their features
        # link into; the window gids come from the readback)
        self._poll_loopclosing()
        if idxs:
            o = handle.outs
            ix = torch.as_tensor(idxs, device=o.desc.device)
            batch = (o.desc[ix], o.dval[ix], o.feat.xy[ix], o.feat.valid[ix],
                     o.feat.lm_slot[ix], o.feat.lm_gid[ix], o.kf_gid[ix])
            active = [int(g) for g, v in zip(tail_gids, tail_valid) if v]
            self.loopclosing.process_keyframes_batch(
                self, gids, T_list, batch, handle.m, active, defer=True,
                gauge_idx=gauge_idx_now)

        # LOST at the chunk's end: relocalize on its last frame (the chunk
        # dead-ends on LOST; recovery is a host decision between chunks).
        # A chunk already dispatched from the LOST state runs as it is.
        if int(tail[0]) == fe.LOST and self.s.relocalization_open:
            f = self.frontend
            pyr_last = f._build_pyramid(f._undistort_left(
                handle.last_l.to(torch.float32)))
            if self._try_relocalize(pyr_last, handle.last_r,
                                    handle.timestamps[K - 1]):
                self.last_pyr = pyr_last
            else:
                self._warn(f"relocalization failed at frame "
                           f"{self.frame_id}; still LOST")
        return T_wc_k

    def _poll_loopclosing(self):
        if self.loopclosing is not None:
            for ev in self.loopclosing.poll(self):
                self._count_event(ev)

    def finish(self):
        """Flush deferred work at sequence end: the loop-closing candidates
        the last collect_chunk deferred are verified here. Call it after
        the last collect_chunk, as the JAX package's bench.py and
        scripts/run_kitti.py do."""
        self._poll_loopclosing()

    def close(self):
        """Release the engine's graphs and the loop closer's verification
        graphs, and with a mesh stop the ranks that serve its local BA
        (they return from dist_ba.serve); the System's BA cannot run after
        it."""
        self._engine.close()
        if self.loopclosing is not None:
            self.loopclosing.close()
        if self._engine.dist is not None:
            self._engine.dist.close()

    # ------------------------------------------------------------------
    def _try_relocalize(self, pyr_l: fe.Pyr, right, timestamp) -> bool:
        """Relocalize a LOST frame: a PnP fix against the keyframe database
        (loopclosing.relocalize on fresh detections), then a keyframe at
        the recovered pose (stereo match and triangulation as at init, the
        init detection budget), with no odometry edge across the gap, local
        BA when the backend is on, and the keyframe's loop ingest."""
        f = self.frontend
        det = f.detect_features(pyr_l.levels[0])
        fix = self.loopclosing.relocalize(pyr_l, det.xy, det.valid)
        if fix is None:
            return False
        T_reloc, _ = fix
        pyr_r = f._build_pyramid(f._undistort_right(self._pad(right)))
        feat, m, kf_slot, kf_gid, n_created, _ = f._keyframe_core(
            pyr_l, pyr_r, fe.empty_feat_state(self.s.max_features,
                                              self.device),
            T_reloc, self.map, budget=self.s.n_init_features)
        if int(n_created) < self.s.min_init_landmarks:
            return False            # too little structure to resume
        kf_gid = int(kf_gid)
        self.feat, self.map, self.T_cw = feat, m, T_reloc
        self.rel_motion = se3.identity(device=self.device)
        self.status = fe.TRACKING_GOOD
        self.stats["n_relocalizations"] = \
            self.stats.get("n_relocalizations", 0) + 1
        self.records.add(kf_gid, timestamp, T_reloc.cpu().numpy(),
                         self.frame_id, odometry_edge=False)
        self.stats["n_keyframes"] += 1
        if self.enable_backend:
            res = ba.local_ba(mapmod.ba_problem_from_map(self.map), f._fx,
                              f._fy, f._cx, f._cy, f._baseline)
            self.map = mapmod.apply_ba_result(self.map, res.kf_T_cw,
                                              res.lm_pos, res.obs_valid)
            self.T_cw = self.map.kf_pose[int(kf_slot)]
            self.stats["n_ba"] += 1
            self._refresh_keyframe_records()
        self._count_event(self.loopclosing.process_keyframe(
            self, kf_gid, pyr_l, self.feat, self.map, self.T_cw))
        return True

    def _refresh_keyframe_records(self):
        """The records take the live window's poses (read from the
        device)."""
        m = self.map
        self.records.refresh(m.kf_gid.cpu().numpy(), m.kf_valid.cpu().numpy(),
                             m.kf_pose.cpu().numpy())

    # ------------------------------------------------------------------
    # loop-closing hooks (called by loopclosing.LoopClosing)
    def _warn(self, msg: str):
        """Append to the stats warnings channel (bounded at 1000)."""
        w = self.stats.setdefault("warnings", [])
        if len(w) < 1000:
            w.append(msg)

    def apply_loop_correction(self, loopclosing, corrected_map, C,
                              relink=None):
        """Install the rigidly re-anchored, fused active map and move the
        current pose by the same right-multiplied C (reference
        CorrectActivateKeyframeAndMappoint, loopclosing.cpp:378-456).

        `C` is already expressed in the live gauge (_complete_loop). On the
        per-frame path this makes T_cw the corrected keyframe pose. C is a
        gauge event of the records, so collect_chunk re-gauges a chunk
        that was in flight. `relink` = (slot_remap, pre-fusion lm_gid,
        post-fusion lm_gid): the live features follow their fused
        landmarks."""
        self.map = corrected_map
        if relink is not None:
            self.feat = loopclosing.remap_feat(self.feat, *relink)
        C = np.asarray(C, np.float32)
        self.T_cw = se3.compose(self.T_cw, torch.as_tensor(
            C, device=self.device))
        self.records.add_gauge_event(C)
        self._refresh_keyframe_records()

    def active_gids(self):
        kf_gid = self.map.kf_gid.cpu().numpy()
        kf_valid = self.map.kf_valid.cpu().numpy()
        return [int(g) for g, v in zip(kf_gid, kf_valid) if v]

    def keyframe_trajectory(self):
        """(timestamps [K], poses T_wc [K,3,4]) of the keyframes."""
        return self.records.trajectory()

    def frame_trajectory(self):
        ts = np.array([t for t, _, _ in self.trajectory])
        poses = np.stack([p for _, _, p in self.trajectory]) if self.trajectory \
            else np.zeros((0, 3, 4))
        return ts, poses

    def save_trajectory_tum(self, path: str, keyframes_only: bool = True):
        from ssvio_tpu_torch.dataio import tum
        ts, poses = (self.keyframe_trajectory() if keyframes_only
                     else self.frame_trajectory())
        tum.save_tum(path, ts, poses)


class ChunkPrefetcher:
    """One worker thread that pads + uploads chunks ahead of the compute
    loop (see System.prefetcher). FIFO: get() returns uploads in submit
    order. The worker waits on the upload's CUDA event before it hands a
    chunk over, so a chunk from get() is resident on the device."""

    def __init__(self, system: System, depth: int = 2):
        self._sys = system
        self._ex = ThreadPoolExecutor(max_workers=1)
        self._q = collections.deque()
        self.depth = depth

    def _upload(self, lefts, rights):
        imgs_l, imgs_r, done = self._sys._upload(lefts, rights)
        if done is not None:
            done.synchronize()
        return imgs_l, imgs_r

    def submit(self, lefts, rights):
        if len(self._q) >= self.depth:
            raise RuntimeError(
                f"ChunkPrefetcher depth={self.depth} exceeded: {len(self._q)} "
                "chunks already in flight. Each submitted chunk holds device "
                "memory until get(); call get() before submitting more.")
        if not len(lefts):
            raise ValueError("submit() called with an empty chunk")
        self._q.append(self._ex.submit(self._upload, lefts, rights))

    def get(self):
        """Device stacks (imgs_l, imgs_r) of the oldest submitted chunk."""
        return self._q.popleft().result()

    def __len__(self):
        return len(self._q)

    def close(self):
        """Shut down the worker; re-raise any upload exception so a failed
        prefetch never vanishes silently."""
        pending, self._q = list(self._q), collections.deque()
        self._ex.shutdown(wait=True)
        for fut in pending:
            fut.result()
