"""Front-end: stereo VO tracking state machine on fixed-shape state (port of
`ssvio_tpu/frontend.py`).

The INITING / TRACKING_GOOD / TRACKING_BAD / LOST machine (reference
frontend.hpp:25-31), projection-seeded LK against the last frame with a
forward-backward gate, 4x10 pose-only LM, keyframe creation with masked
re-detection, stereo LK both ways, triangulation and map insertion
(reference src/ssvio/frontend.cpp). The JAX package jits these steps; here
they run eagerly on the Frontend's device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ssvio_tpu_torch import map as mapmod
from ssvio_tpu_torch.config import Settings
from ssvio_tpu_torch.ops import (ba, camera, fast, lk, pyramid, sampling, se3,
                                 triangulation)

# status codes (reference frontend.hpp:25-31)
INITING, TRACKING_GOOD, TRACKING_BAD, LOST = 0, 1, 2, 3


class Pyr(NamedTuple):
    """Image pyramid + its Sobel gradients, built once per image and shared
    by the forward, backward and stereo tracks that use it as template."""
    levels: Tuple[torch.Tensor, ...]
    gx: Tuple[torch.Tensor, ...]
    gy: Tuple[torch.Tensor, ...]

    @property
    def grads(self):
        return (self.gx, self.gy)


class FeatState(NamedTuple):
    """Current-frame feature set, fixed capacity N. A feature's landmark
    link is live only while MapState.lm_gid[lm_slot] still equals lm_gid
    (slot recycling guard)."""
    xy: torch.Tensor        # [N, 2] (level-0 pixel coords)
    lm_slot: torch.Tensor   # [N] int32 landmark slot in MapState (-1 none)
    lm_gid: torch.Tensor    # [N] int32 landmark generation id (-1 none)
    valid: torch.Tensor     # [N] bool
    octave: torch.Tensor    # [N] int32 detection octave (0 = base scale)


def empty_feat_state(n: int, device=None) -> FeatState:
    return FeatState(xy=torch.zeros((n, 2), dtype=torch.float32, device=device),
                     lm_slot=torch.full((n,), -1, dtype=torch.int32, device=device),
                     lm_gid=torch.full((n,), -1, dtype=torch.int32, device=device),
                     valid=torch.zeros((n,), dtype=torch.bool, device=device),
                     octave=torch.zeros((n,), dtype=torch.int32, device=device))


class TrackOut(NamedTuple):
    feat: FeatState
    T_cw: torch.Tensor
    rel_motion: torch.Tensor
    n_inliers: torch.Tensor


def _link(lm_slot: torch.Tensor, m_size: int) -> torch.Tensor:
    """Landmark slots clipped into range, as indices (jnp clamps gathers)."""
    return torch.clamp(lm_slot, 0, m_size - 1).long()


class Frontend:
    """Runs the per-frame steps eagerly on `device`."""

    def __init__(self, settings: Settings, width: int, height: int,
                 real_width: int | None = None, real_height: int | None = None,
                 device=None):
        s = settings
        self.s = s
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        self.w, self.h = width, height            # padded device dims
        self.rw = real_width or width             # true sensor dims (gates)
        self.rh = real_height or height
        self.n_feat = s.max_features
        self.lk_params = lk.LKParams(window=s.lk_window, levels=s.lk_levels,
                                     iters=s.lk_iters, eps=s.lk_eps,
                                     kernel=s.lk_kernel, backend=s.lk_backend)
        lk._check_params(self.lk_params)
        # stereo disparities exceed temporal flow: one extra pyramid level
        self.lk_params_stereo = self.lk_params._replace(levels=s.lk_levels + 1)
        self.lk_params_back = self.lk_params
        self.rig = camera.StereoRig.from_settings(s, self.device)
        fxl = self.rig.intr_left
        self._fx, self._fy = fxl.fx, fxl.fy
        self._cx, self._cy = fxl.cx, fxl.cy
        self._baseline = self.rig.baseline
        self._dist_l = (s.cam_left.k1, s.cam_left.k2,
                        s.cam_left.p1, s.cam_left.p2)
        self._dist_r = (s.cam_right.k1, s.cam_right.k2,
                        s.cam_right.p1, s.cam_right.p2)
        self.need_undistortion = bool(s.need_undistortion) and any(
            c != 0.0 for c in self._dist_l + self._dist_r)

    # ------------------------------------------------------------------
    def _undistort_left(self, img: torch.Tensor) -> torch.Tensor:
        """Image-space undistortion of a left frame (identity when the rig
        has no distortion or Camera.NeedUndistortion is off)."""
        if not self.need_undistortion:
            return img
        return camera.undistort_image(self.rig.intr_left, self._dist_l,
                                      img.to(torch.float32))

    def _undistort_right(self, img: torch.Tensor) -> torch.Tensor:
        if not self.need_undistortion:
            return img
        return camera.undistort_image(self.rig.intr_right, self._dist_r,
                                      img.to(torch.float32))

    # ------------------------------------------------------------------
    def _build_pyramid(self, img: torch.Tensor) -> Pyr:
        img = img.to(torch.float32)
        levels = pyramid.build_lk_pyramid(img, self.s.lk_levels + 1)
        grads = [pyramid.sobel_gradients(l) for l in levels]
        return Pyr(levels=tuple(levels), gx=tuple(g[0] for g in grads),
                   gy=tuple(g[1] for g in grads))

    # ------------------------------------------------------------------
    def _track_step(self, pyr_last: Pyr, pyr_cur: Pyr, feat: FeatState,
                   T_last, rel_motion, lm_pos, lm_valid, lm_gid) -> TrackOut:
        """LK vs last frame (projection-seeded) + FB gate + pose-only LM."""
        T_guess = se3.compose(rel_motion, T_last)
        lm_idx = _link(feat.lm_slot, lm_pos.shape[0])
        has_lm = (feat.valid & (feat.lm_slot >= 0) & lm_valid[lm_idx]
                  & (lm_gid[lm_idx] == feat.lm_gid))
        p_w = lm_pos[lm_idx]
        seed = camera.world2pixel(self.rig.intr_left, T_guess, p_w)
        in_img = sampling.in_bounds(seed, self.rh, self.rw, border=8.0)
        seed = torch.where((has_lm & in_img)[:, None], seed, feat.xy)

        new_xy, ok, _ = lk.track(pyr_last.levels, pyr_cur.levels, feat.xy,
                                 seed, has_lm, self.lk_params,
                                 compute_err=False, grads_prev=pyr_last.grads)
        # forward-backward gate; the backward track is seeded at the landed
        # position itself (zero flow) so it must find its own way home
        xy_back, ok_b, _ = lk.track(pyr_cur.levels, pyr_last.levels, new_xy,
                                    new_xy, has_lm & ok, self.lk_params_back,
                                    compute_err=False, grads_prev=pyr_cur.grads)
        fb = torch.linalg.norm(xy_back - feat.xy, dim=-1)
        in_real = sampling.in_bounds(new_xy, self.rh, self.rw, border=1.0)
        tracked = has_lm & ok & ok_b & (fb < 0.6) & in_real

        # the optimizer starts from T_last, not the extrapolated prior (the
        # prior seeds LK above; see the JAX package for the measurement)
        res = ba.pose_only_optimize(T_last, p_w, new_xy, tracked,
                                    self._fx, self._fy, self._cx, self._cy)
        feat_out = FeatState(xy=new_xy, lm_slot=feat.lm_slot,
                             lm_gid=feat.lm_gid, valid=tracked & res.inlier,
                             octave=feat.octave)
        rel = se3.compose(res.T_cw, se3.inverse(T_last))
        return TrackOut(feat_out, res.T_cw, rel, res.n_inliers)

    # ------------------------------------------------------------------
    def _detect_merge(self, img, feat: FeatState, max_new_per_cell: int = 4,
                     budget: int | None = None):
        """Masked re-detection + compaction merge into the fixed feature set.

        Existing valid features are compacted to the front (stable order);
        fresh FAST detections, blocked within +-10 px of existing ones
        (reference frontend.cpp:304-312), fill the remaining slots, at most
        `budget` of them. Returns (FeatState, is_new [N] bool)."""
        N = self.n_feat
        dev = self.device
        occ = fast.build_occupancy(self.h, self.w, feat.xy, feat.valid, radius=10)
        yy = torch.arange(self.h, device=dev)[:, None]
        xx = torch.arange(self.w, device=dev)[None, :]
        border = (xx < 16) | (xx >= self.rw - 16) | (yy < 16) | (yy >= self.rh - 16)
        n_oct = self.s.detect_octaves or self.s.n_levels
        if n_oct > 1:
            orb_pyr = pyramid.build_orb_pyramid(img, n_oct, self.s.scale_factor)
            det_xy, _, det_oct, det_valid = fast.detect_multiscale(
                orb_pyr, self.s.scale_factor, max_kps=N,
                cell=self.s.grid_cell,
                ini_threshold=float(self.s.ini_th_fast),
                min_threshold=float(self.s.min_th_fast),
                occupancy=occ | border, kps_per_cell=max_new_per_cell)
        else:
            det_xy, _, det_valid = fast.detect_grid(
                img, max_kps=N, cell=self.s.grid_cell,
                ini_threshold=float(self.s.ini_th_fast),
                min_threshold=float(self.s.min_th_fast),
                occupancy=occ | border, kps_per_cell=max_new_per_cell)
            det_oct = torch.zeros((N,), dtype=torch.int32, device=dev)

        # valid first, stable (argsort of the bool cast to int)
        order = torch.argsort((~feat.valid).to(torch.int32), stable=True)
        ex_xy = feat.xy[order]
        ex_lm = feat.lm_slot[order]
        ex_gid = feat.lm_gid[order]
        ex_oct = feat.octave[order]
        ex_valid = feat.valid[order]
        n_exist = torch.sum(ex_valid.to(torch.int32))
        new_rank = torch.arange(N, device=dev) - n_exist   # which new det
        cap = N if budget is None else min(budget, N)
        take_new = (new_rank >= 0) & (new_rank < cap) & ~ex_valid
        new_idx = torch.clamp(new_rank, 0, N - 1)
        new_ok = take_new & det_valid[new_idx]
        minus1 = torch.full_like(ex_lm, -1)
        xy = torch.where(new_ok[:, None], det_xy[new_idx], ex_xy)
        lm_slot = torch.where(new_ok, minus1, torch.where(ex_valid, ex_lm, minus1))
        lm_gid = torch.where(new_ok, minus1, torch.where(ex_valid, ex_gid, minus1))
        octave = torch.where(new_ok, det_oct[new_idx],
                             torch.where(ex_valid, ex_oct, torch.zeros_like(ex_oct)))
        return FeatState(xy=xy, lm_slot=lm_slot, lm_gid=lm_gid,
                         valid=ex_valid | new_ok, octave=octave), new_ok

    # ------------------------------------------------------------------
    def _stereo_match(self, pyr_l: Pyr, pyr_r: Pyr, feat: FeatState, T_cw,
                     lm_pos, lm_gid):
        """Left->right LK, projection-seeded where a landmark exists, with a
        right->left forward-backward check (reference FindFeaturesInRight,
        frontend.cpp:346-428)."""
        lm_idx = _link(feat.lm_slot, lm_pos.shape[0])
        has_lm = (feat.valid & (feat.lm_slot >= 0)
                  & (lm_gid[lm_idx] == feat.lm_gid))
        p_cr = camera.right_from_left_cam(self.rig,
                                          se3.transform(T_cw, lm_pos[lm_idx]))
        seed = camera.camera2pixel(self.rig.intr_right, p_cr)
        in_img = sampling.in_bounds(seed, self.rh, self.rw, border=8.0)
        seed = torch.where((has_lm & in_img)[:, None], seed, feat.xy)
        xy_r, ok, err = lk.track(pyr_l.levels, pyr_r.levels, feat.xy, seed,
                                 feat.valid, self.lk_params_stereo,
                                 grads_prev=pyr_l.grads)
        xy_back, ok_b, _ = lk.track(pyr_r.levels, pyr_l.levels, xy_r, xy_r,
                                    ok & feat.valid, self.lk_params_stereo,
                                    compute_err=False, grads_prev=pyr_r.grads)
        fb = torch.linalg.norm(xy_back - feat.xy, dim=-1)
        # rectified epipolar sanity: |dy| small, disparity positive
        dy = torch.abs(xy_r[:, 1] - feat.xy[:, 1])
        disp = feat.xy[:, 0] - xy_r[:, 0]
        ok = ok & ok_b & (fb < 0.6) & feat.valid & (dy < 2.0) & (disp > 0.1) \
            & (err < 25.0)
        return xy_r, ok

    # ------------------------------------------------------------------
    def _keyframe_step(self, pyr_l: Pyr, pyr_r: Pyr, feat: FeatState, T_cw,
                      m: mapmod.MapState, budget: int | None = None):
        """Re-detect, stereo-match, triangulate new landmarks, insert KF.

        Returns (feat', map', kf_slot, kf_gid, n_landmarks_created,
        n_stereo); the last four are ints."""
        feat2, is_new = self._detect_merge(pyr_l.levels[0], feat, budget=budget)
        # generation check: a stale slot link must not register observations
        lm_idx2 = _link(feat2.lm_slot, m.lm_pos.shape[0])
        link_live = (feat2.lm_slot >= 0) & (m.lm_gid[lm_idx2] == feat2.lm_gid) \
            & m.lm_valid[lm_idx2]
        minus1 = torch.full_like(feat2.lm_slot, -1)
        feat2 = feat2._replace(
            lm_slot=torch.where(link_live, feat2.lm_slot, minus1),
            lm_gid=torch.where(link_live, feat2.lm_gid, minus1))
        xy_r, has_r = self._stereo_match(pyr_l, pyr_r, feat2, T_cw, m.lm_pos,
                                        m.lm_gid)

        p_cam, tri_ok = triangulation.triangulate_stereo_rectified(
            feat2.xy, xy_r, self._fx, self._fy, self._cx, self._cy,
            self._baseline, min_disparity=0.5)
        max_z = self.s.max_depth_factor * float(self.s.baseline)
        depth_ok = (p_cam[:, 2] > 0.5) & (p_cam[:, 2] < max_z)
        new_lm = is_new & has_r & tri_ok & depth_ok
        p_w = camera.camera2world(T_cw, p_cam)

        m2, kf_slot, kf_gid = mapmod.insert_keyframe(
            m, T_cw, feat2.lm_slot, feat2.xy, xy_r, has_r, feat2.valid)
        m3, lm_slots = mapmod.add_landmarks(
            m2, kf_slot, kf_gid, p_w, feat2.xy, xy_r, has_r, new_lm)
        new_gid = m3.lm_gid[_link(lm_slots, m3.lm_gid.shape[0])]
        created = lm_slots >= 0
        feat3 = FeatState(xy=feat2.xy,
                          lm_slot=torch.where(created, lm_slots, feat2.lm_slot),
                          lm_gid=torch.where(created, new_gid, feat2.lm_gid),
                          valid=feat2.valid & ((feat2.lm_slot >= 0) | created),
                          octave=feat2.octave)
        return (feat3, m3, kf_slot, kf_gid, int(torch.sum(created)),
                int(torch.sum(has_r)))

    # the JAX package jits the steps above under these public names; here
    # they run eagerly, so the public names are the same functions
    undistort_left = _undistort_left
    undistort_right = _undistort_right
    build_pyramid = _build_pyramid
    track_step = _track_step
    keyframe_step = _keyframe_step
