"""System facade: construction, wiring and the per-frame step API (port of
`ssvio_tpu/system.py`, its `run_step` path).

Construct from a Settings object (or a reference-format YAML path), drive
with `run_step(left, right, timestamp)`, export the trajectory in TUM
format. Local BA runs right after each keyframe insertion, on the System's
device. What is not ported yet raises NotImplementedError naming its
ROADMAP item: loop closing and relocalization (Queue 1 #12), the chunked
scan API (#10) and landmark-sharded BA over a mesh (#14).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ssvio_tpu_torch import frontend as fe
from ssvio_tpu_torch import map as mapmod
from ssvio_tpu_torch.config import Settings
from ssvio_tpu_torch.ops import ba, se3


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to ssvio_tpu_torch yet (ROADMAP Queue 1 {item})")


class System:
    def __init__(self, settings: Settings | str,
                 enable_backend: Optional[bool] = None,
                 enable_loop_closing: Optional[bool] = None, mesh=None,
                 device=None):
        if isinstance(settings, str):
            settings = Settings.from_yaml(settings)
        self.s = settings
        self.enable_backend = (settings.backend_open if enable_backend is None
                               else enable_backend)
        enable_loop = (settings.loop_closing_open if enable_loop_closing is None
                       else enable_loop_closing)
        if enable_loop:
            raise _not_ported("Loop closing (enable_loop_closing=True or "
                              "Settings.loop_closing_open)", "#12")
        if mesh is not None:
            raise _not_ported("Landmark-sharded BA over a device mesh", "#14")
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        # padded device image dims (pyramid levels need /2^L)
        div = 2 ** (settings.lk_levels + 1)
        self.w = -(-settings.image_width // div) * div
        self.h = -(-settings.image_height // div) * div
        self.frontend = fe.Frontend(settings, self.w, self.h,
                                    settings.image_width, settings.image_height,
                                    device=self.device)
        self.reset()

    def reset(self):
        """Return to the fresh INITING state."""
        self.map = mapmod.empty_map(self.s.max_window, self.s.max_landmarks,
                                    self.device)
        self.status = fe.INITING
        self.T_cw = se3.identity(device=self.device)
        self.rel_motion = se3.identity(device=self.device)
        self.feat = fe.empty_feat_state(self.s.max_features, self.device)
        self.last_pyr = None
        self.frame_id = -1
        self.track_health = None
        self._health_window = []
        self.trajectory = []        # (timestamp, frame_id, T_wc [3,4] np)
        self.keyframes = []         # dicts: gid, frame_id, timestamp, T_cw (np)
        self._rec_by_gid = {}       # gid -> record dict (same objects)
        self.kf_rel_edges = []      # (gid_prev, gid, Z [3,4]) odometry edges
        self.stats = {"n_keyframes": 0, "n_ba": 0, "n_loops": 0}

    # ------------------------------------------------------------------
    def _pad(self, img) -> torch.Tensor:
        """Edge-pad one image to the [h, w] device dims on the device.
        Accepts a numpy array or a tensor (on any device)."""
        img = torch.as_tensor(np.array(img) if not torch.is_tensor(img)
                              else img).to(self.device, torch.float32)
        h, w = img.shape
        if (h, w) == (self.h, self.w):
            return img
        rows = torch.clamp(torch.arange(self.h, device=self.device), max=h - 1)
        cols = torch.clamp(torch.arange(self.w, device=self.device), max=w - 1)
        return img[rows][:, cols]

    # ------------------------------------------------------------------
    @torch.no_grad()
    def run_step(self, left, right, timestamp: float = 0.0) -> np.ndarray:
        """Process one stereo pair ([H, W] numpy arrays or tensors). Returns
        the camera pose T_wc [3,4] np."""
        self.frame_id += 1
        pyr_l = self.frontend.build_pyramid(
            self.frontend.undistort_left(self._pad(left)))

        if self.status == fe.INITING:
            pyr_r = self.frontend.build_pyramid(
                self.frontend.undistort_right(self._pad(right)))
            self._try_init(pyr_l, pyr_r, timestamp)
        elif self.status in (fe.TRACKING_GOOD, fe.TRACKING_BAD):
            out = self.frontend.track_step(
                self.last_pyr, pyr_l, self.feat, self.T_cw, self.rel_motion,
                self.map.lm_pos, self.map.lm_valid, self.map.lm_gid)
            n_inl = int(out.n_inliers)
            self._health_window = (self._health_window + [n_inl])[-30:]
            self.track_health = float(np.median(self._health_window))
            self.feat = out.feat
            self.T_cw = out.T_cw
            self.rel_motion = out.rel_motion
            if n_inl > self.s.tracking_good:
                self.status = fe.TRACKING_GOOD
            elif n_inl > self.s.tracking_bad:
                self.status = fe.TRACKING_BAD
                pyr_r = self.frontend.build_pyramid(
                    self.frontend.undistort_right(self._pad(right)))
                self._insert_keyframe(pyr_l, pyr_r, timestamp)
            else:
                # the reference marks LOST and dead-ends (frontend.cpp:62-66);
                # the JAX package's relocalization needs loop closing
                self.status = fe.LOST
        # LOST: dead end, as the JAX package does without a loop closer

        self.last_pyr = pyr_l
        T_wc = se3.inverse(self.T_cw).cpu().numpy()
        self.trajectory.append((timestamp, self.frame_id, T_wc))
        return T_wc

    def run_chunk(self, *args, **kwargs):
        raise _not_ported("The chunked scan API (run_chunk)", "#10")

    def dispatch_chunk(self, *args, **kwargs):
        raise _not_ported("The chunked scan API (dispatch_chunk)", "#10")

    def collect_chunk(self, *args, **kwargs):
        raise _not_ported("The chunked scan API (collect_chunk)", "#10")

    # ------------------------------------------------------------------
    def _try_init(self, pyr_l, pyr_r, timestamp):
        """Stereo init (reference SteroInit, frontend.cpp:430-446): the init
        extractor budget (n_init_features) + init_good stereo gate; a
        rejected attempt keeps the old map and retries next frame."""
        empty = fe.empty_feat_state(self.s.max_features, self.device)
        feat, m, _, kf_gid, n_created, n_stereo = self.frontend.keyframe_step(
            pyr_l, pyr_r, empty, se3.identity(device=self.device), self.map,
            budget=self.s.n_init_features)
        if (n_created >= self.s.min_init_landmarks
                and n_stereo >= self.s.init_good):
            self.feat = feat
            self.map = m
            self.T_cw = se3.identity(device=self.device)
            self.rel_motion = se3.identity(device=self.device)
            self.status = fe.TRACKING_GOOD
            self._record_keyframe(kf_gid, timestamp)

    def _insert_keyframe(self, pyr_l, pyr_r, timestamp):
        feat, m, kf_slot, kf_gid, _, _ = self.frontend.keyframe_step(
            pyr_l, pyr_r, self.feat, self.T_cw, self.map,
            budget=self.s.n_new_features)
        self.feat = feat
        self.map = m
        self._record_keyframe(kf_gid, timestamp)
        if self.enable_backend:
            fr = self.frontend
            res = ba.local_ba(mapmod.ba_problem_from_map(self.map), fr._fx,
                              fr._fy, fr._cx, fr._cy, fr._baseline)
            self.map = mapmod.apply_ba_result(self.map, res.kf_T_cw,
                                              res.lm_pos, res.obs_valid)
            self.stats["n_ba"] += 1
            # the current pose rides the optimized keyframe
            self.T_cw = self.map.kf_pose[kf_slot]
            self._refresh_keyframe_records()

    # ------------------------------------------------------------------
    def _record_keyframe(self, kf_gid: int, timestamp: float):
        T_cw_np = self.T_cw.cpu().numpy()
        rec = {"gid": kf_gid, "frame_id": self.frame_id,
               "timestamp": timestamp, "T_cw": T_cw_np}
        self.keyframes.append(rec)
        self._rec_by_gid[kf_gid] = rec
        if len(self.keyframes) > 1:
            prev = self.keyframes[-2]
            Z = se3.compose_np(T_cw_np, se3.inverse_np(prev["T_cw"]))
            self.kf_rel_edges.append((prev["gid"], kf_gid, Z))
        self.stats["n_keyframes"] += 1

    def _refresh_keyframe_records(self):
        """Pull BA-updated poses for keyframes still in the window, looked
        up by gid (distance-based eviction can keep an old keyframe)."""
        kf_gid = self.map.kf_gid.cpu().numpy()
        kf_valid = self.map.kf_valid.cpu().numpy()
        kf_pose = self.map.kf_pose.cpu().numpy()
        for i, g in enumerate(kf_gid):
            if kf_valid[i]:
                rec = self._rec_by_gid.get(int(g))
                if rec is not None:
                    rec["T_cw"] = kf_pose[i]

    # ------------------------------------------------------------------
    def pose_of_gid(self, gid: int) -> np.ndarray:
        """Current T_cw of a keyframe by global id (host records)."""
        rec = self._rec_by_gid.get(gid)
        if rec is None:
            raise KeyError(gid)
        return rec["T_cw"]

    def active_gids(self):
        kf_gid = self.map.kf_gid.cpu().numpy()
        kf_valid = self.map.kf_valid.cpu().numpy()
        return [int(g) for g, v in zip(kf_gid, kf_valid) if v]

    def keyframe_trajectory(self):
        """(timestamps [K], poses T_wc [K,3,4]) of the keyframes."""
        ts = np.array([k["timestamp"] for k in self.keyframes])
        poses = np.stack([se3.inverse_np(k["T_cw"]) for k in self.keyframes]) \
            if self.keyframes else np.zeros((0, 3, 4))
        return ts, poses

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
