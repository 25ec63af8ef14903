"""Device-resident map state: SLAM-as-tensors (port of `ssvio_tpu/map.py`).

A fixed-size ACTIVE window of keyframe slots `[W]`, landmark slots `[M]`
and a dense observation table `[M, W, C]` (C = left/right eye) that IS the
BA problem layout. Eviction follows the reference's distance heuristic
(map.cpp:89-140) and landmarks that lose all active observations leave the
active map (map.cpp:142-160).

The functions are pure, as in the JAX package: they return a new MapState
and never write into the one they are given (a rejected stereo init drops
the returned map). JAX scatters with `mode="drop"` route dead rows out of
range; here rows are masked before indexing, since torch raises on an
out-of-range index. Duplicate scatter indices have no defined winner in
either framework.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ssvio_tpu_torch.ops import se3


class MapState(NamedTuple):
    """Active-window map. W = kf slot capacity, M = landmark capacity."""
    kf_pose: torch.Tensor     # [W, 3, 4] T_cw
    kf_gid: torch.Tensor      # [W] int32 global keyframe id (-1 = empty)
    kf_valid: torch.Tensor    # [W] bool
    lm_pos: torch.Tensor      # [M, 3]
    lm_valid: torch.Tensor    # [M] bool
    lm_gid: torch.Tensor      # [M] int32 global landmark id (-1 = empty)
    lm_first_kf: torch.Tensor # [M] int32 global KF id of first observation
    obs_uv: torch.Tensor      # [M, W, 2, 2]
    obs_valid: torch.Tensor   # [M, W, 2]
    next_lm_gid: torch.Tensor # [] int32 monotonic landmark id counter
    next_kf_gid: torch.Tensor # [] int32 monotonic keyframe id counter


def empty_map(window: int, max_landmarks: int, device=None) -> MapState:
    W, M = window, max_landmarks

    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=device)

    return MapState(
        kf_pose=se3.identity((W,), device=device),
        kf_gid=full((W,), -1, torch.int32),
        kf_valid=full((W,), False, torch.bool),
        lm_pos=full((M, 3), 0.0, torch.float32),
        lm_valid=full((M,), False, torch.bool),
        lm_gid=full((M,), -1, torch.int32),
        lm_first_kf=full((M,), -1, torch.int32),
        obs_uv=full((M, W, 2, 2), 0.0, torch.float32),
        obs_valid=full((M, W, 2), False, torch.bool),
        next_lm_gid=full((), 0, torch.int32),
        next_kf_gid=full((), 0, torch.int32),
    )


def _choose_evict_slot(m: MapState, new_pose: torch.Tensor,
                       dist_th: float = 0.2) -> torch.Tensor:
    """Reference eviction heuristic (map.cpp:89-140): among valid slots,
    nearest-to-new if its distance < dist_th else farthest-from-new.
    (torch.argmin/argmax return the first extremum, as jnp's do.)"""
    centers = se3.translation(se3.inverse(m.kf_pose))          # [W, 3]
    new_center = se3.translation(se3.inverse(new_pose))
    d = torch.linalg.norm(centers - new_center[None], dim=-1)
    d_valid = torch.where(m.kf_valid, d, torch.full_like(d, 1e9))
    near = torch.argmin(d_valid)
    far = torch.argmax(torch.where(m.kf_valid, d, torch.full_like(d, -1e9)))
    return torch.where(d_valid[near] < dist_th, near, far)


def insert_keyframe(m: MapState, T_cw: torch.Tensor,
                    feat_lm_slot: torch.Tensor,   # [N] landmark slot (-1 none)
                    feat_uv_l: torch.Tensor,      # [N, 2]
                    feat_uv_r: torch.Tensor,      # [N, 2]
                    feat_has_r: torch.Tensor,     # [N] bool
                    feat_valid: torch.Tensor,     # [N] bool
                    ) -> Tuple[MapState, int, int]:
    """Insert a keyframe: pick a slot (evicting per heuristic if full),
    register this KF's observations of existing landmarks, GC landmarks
    that lost all active observations.

    Returns (new_map, kf_slot, kf_gid) with the slot and gid as ints."""
    any_free = not bool(torch.all(m.kf_valid))
    if any_free:
        slot = int(torch.argmin(m.kf_valid.to(torch.int32)))
    else:
        slot = int(_choose_evict_slot(m, T_cw))
    kf_gid = int(m.next_kf_gid)

    obs_valid = m.obs_valid.clone()
    obs_valid[:, slot, :] = False           # eviction clears the slot
    kf_pose = m.kf_pose.clone()
    kf_pose[slot] = T_cw
    kf_gid_arr = m.kf_gid.clone()
    kf_gid_arr[slot] = kf_gid
    kf_valid = m.kf_valid.clone()
    kf_valid[slot] = True

    # observations of existing landmarks; rows without one are dropped
    has_lm = feat_valid & (feat_lm_slot >= 0)
    has_r = has_lm & feat_has_r
    obs_uv = m.obs_uv.clone()
    rows_l = feat_lm_slot[has_lm].long()
    rows_r = feat_lm_slot[has_r].long()
    obs_uv[rows_l, slot, 0] = feat_uv_l[has_lm]
    obs_uv[rows_r, slot, 1] = feat_uv_r[has_r]
    obs_valid[rows_l, slot, 0] = True
    obs_valid[rows_r, slot, 1] = True

    lm_active = torch.any(obs_valid.flatten(1), dim=1)
    return m._replace(kf_pose=kf_pose, kf_gid=kf_gid_arr, kf_valid=kf_valid,
                      obs_uv=obs_uv, obs_valid=obs_valid,
                      lm_valid=m.lm_valid & lm_active,
                      next_kf_gid=m.next_kf_gid + 1), slot, kf_gid


def add_landmarks(m: MapState, kf_slot: int, kf_gid: int,
                  p_w: torch.Tensor,        # [K, 3] new landmark positions
                  uv_l: torch.Tensor,       # [K, 2] observing uv (this KF)
                  uv_r: torch.Tensor,       # [K, 2]
                  has_r: torch.Tensor,      # [K] bool
                  new_valid: torch.Tensor,  # [K] bool
                  ) -> Tuple[MapState, torch.Tensor]:
    """Allocate landmark slots for newly triangulated points (free slots in
    index order) and register their first observation. Returns (new_map,
    lm_slot [K] int32, -1 if not allocated)."""
    M = m.lm_valid.shape[0]
    free_order = torch.argsort(m.lm_valid.to(torch.int32), stable=True)
    n_free = torch.sum(~m.lm_valid)
    want_rank = torch.cumsum(new_valid.to(torch.int32), 0) - 1   # [K]
    can = new_valid & (want_rank < n_free) & (want_rank < M)
    slot = torch.where(can, free_order[torch.clamp(want_rank, 0, M - 1)],
                       torch.full_like(free_order[:1], -1)).to(torch.int32)

    rows = slot[can].long()
    rows_r = slot[can & has_r].long()
    lm_pos = m.lm_pos.clone()
    lm_pos[rows] = p_w[can]
    lm_valid = m.lm_valid.clone()
    lm_valid[rows] = True
    lm_gid = m.lm_gid.clone()
    lm_gid[rows] = (m.next_lm_gid + want_rank[can]).to(torch.int32)
    lm_first = m.lm_first_kf.clone()
    lm_first[rows] = kf_gid
    obs_uv = m.obs_uv.clone()
    obs_uv[rows, kf_slot, 0] = uv_l[can]
    obs_uv[rows_r, kf_slot, 1] = uv_r[can & has_r]
    obs_valid = m.obs_valid.clone()
    obs_valid[rows, kf_slot, 0] = True
    obs_valid[rows_r, kf_slot, 1] = True
    n_new = torch.sum(can.to(torch.int32))
    return m._replace(lm_pos=lm_pos, lm_valid=lm_valid, lm_gid=lm_gid,
                      lm_first_kf=lm_first, obs_uv=obs_uv,
                      obs_valid=obs_valid,
                      next_lm_gid=(m.next_lm_gid + n_new).to(torch.int32)), slot


def ba_problem_from_map(m: MapState, fix_oldest: bool = True):
    """View the active map as a LocalBAProblem.

    Landmarks first observed by a keyframe no longer in the window are held
    FIXED (reference backend.cpp:118-126); the oldest in-window KF is the
    gauge anchor."""
    from ssvio_tpu_torch.ops import ba
    window_gids = torch.where(m.kf_valid, m.kf_gid,
                              torch.full_like(m.kf_gid, 2 ** 30))
    kf_fixed = torch.zeros_like(m.kf_valid)
    if fix_oldest:
        kf_fixed[torch.argmin(window_gids)] = True
    first_in_window = torch.any(
        m.lm_first_kf[:, None]
        == torch.where(m.kf_valid, m.kf_gid, torch.full_like(m.kf_gid, -2))[None],
        dim=1)
    return ba.LocalBAProblem(
        kf_T_cw=m.kf_pose, kf_valid=m.kf_valid, kf_fixed=kf_fixed,
        lm_pos=m.lm_pos, lm_valid=m.lm_valid,
        lm_fixed=m.lm_valid & ~first_in_window,
        obs_uv=m.obs_uv, obs_valid=m.obs_valid)


def apply_ba_result(m: MapState, kf_T_cw: torch.Tensor, lm_pos: torch.Tensor,
                    obs_valid: torch.Tensor) -> MapState:
    """Write back BA results; landmarks that lost every observation to
    outlier detachment leave the active map (reference backend.cpp:207-244)."""
    lm_active = torch.any(obs_valid.flatten(1), dim=1)
    return m._replace(kf_pose=kf_T_cw, lm_pos=lm_pos, obs_valid=obs_valid,
                      lm_valid=m.lm_valid & lm_active)
