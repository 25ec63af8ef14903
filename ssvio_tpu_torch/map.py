"""Device-resident map state: SLAM-as-tensors (port of `ssvio_tpu/map.py`).

A fixed-size ACTIVE window of keyframe slots `[W]`, landmark slots `[M]`
and a dense observation table `[M, W, C]` (C = left/right eye) that IS the
BA problem layout. Eviction follows the reference's distance heuristic
(map.cpp:89-140) and landmarks that lose all active observations leave the
active map (map.cpp:142-160).

The functions are pure, as in the JAX package: they return a new MapState
and never write into the one they are given (a rejected stereo init drops
the returned map).

No function on the keyframe path reads a device value on the host, so the
keyframe branch is captured into a CUDA graph (`graphs.KeyframeGraph`):
the window slot and keyframe id come out as device scalars
(`insert_keyframe_device`), and every scatter has a fixed shape. JAX's
scatters route a dead lane out of range with `mode="drop"`; here a dead
lane writes a scratch row one past the end of a copy of the table, which
is then cut off (`_put_rows`). A
dead lane must never go to a clamped real row: with repeated indices a
non-accumulating `index_put_` on CUDA has no defined winner, and a dead
lane could overwrite a real observation. Duplicate live indices have no
defined winner in either framework.
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
    # d_valid[near] is its minimum (indexing by a 0-d tensor reads the host)
    return torch.where(torch.amin(d_valid) < dist_th, near, far)


def _put_rows(t: torch.Tensor, rows: torch.Tensor, value, *cols
              ) -> torch.Tensor:
    """A copy of `t` with t[rows, *cols] = value, where a row index equal
    to len(t) is a dead lane: it writes a scratch row past the end, which
    the result leaves out. `cols` are index tensors that broadcast with
    `rows`; `value` a tensor that broadcasts to the indexed shape, or a
    Python scalar."""
    buf = torch.cat([t, t.new_zeros((1, *t.shape[1:]))])
    value = (value.to(t.dtype) if torch.is_tensor(value)
             else t.new_full((), value))
    buf.index_put_((rows, *cols), value)
    return buf[:-1]


def _slot_index(slot, device) -> torch.Tensor:
    """A window slot (int or 0-d tensor) as a 1-element int64 index."""
    if not torch.is_tensor(slot):
        return torch.full((1,), slot, dtype=torch.int64, device=device)
    return slot.reshape(1).to(torch.int64)


def insert_keyframe_device(m: MapState, T_cw: torch.Tensor,
                           feat_lm_slot: torch.Tensor,  # [N] lm slot (-1 none)
                           feat_uv_l: torch.Tensor,     # [N, 2]
                           feat_uv_r: torch.Tensor,     # [N, 2]
                           feat_has_r: torch.Tensor,    # [N] bool
                           feat_valid: torch.Tensor,    # [N] bool
                           ) -> Tuple[MapState, torch.Tensor, torch.Tensor]:
    """Insert a keyframe: pick a slot (the first free one, else evicting
    per heuristic), register this KF's observations of existing landmarks,
    GC landmarks that lost all active observations. The slot is chosen by
    a device select, as JAX's `jnp.where(any_free, ...)` chooses it.

    Returns (new_map, kf_slot, kf_gid), the last two int32 0-d tensors."""
    M = m.lm_valid.shape[0]
    any_free = ~torch.all(m.kf_valid)
    free_slot = torch.argmin(m.kf_valid.to(torch.int32))
    slot = torch.where(any_free, free_slot,
                       _choose_evict_slot(m, T_cw)).to(torch.int32)
    kf_gid = m.next_kf_gid
    s1 = _slot_index(slot, slot.device)

    # eviction clears the slot's old observations (a free slot has none)
    obs_valid = m.obs_valid.index_fill(1, s1, False)
    kf_pose = m.kf_pose.index_copy(0, s1, T_cw[None])
    kf_gid_arr = m.kf_gid.index_copy(0, s1, kf_gid.reshape(1))
    kf_valid = m.kf_valid.index_fill(0, s1, True)

    # observations of existing landmarks; a feature without one is a dead
    # lane (row M)
    has_lm = feat_valid & (feat_lm_slot >= 0)
    dead = torch.full_like(feat_lm_slot, M)
    rows_l = torch.where(has_lm, feat_lm_slot, dead).long()
    rows_r = torch.where(has_lm & feat_has_r, feat_lm_slot, dead).long()
    eye_l = torch.zeros_like(s1)
    eye_r = torch.ones_like(s1)
    obs_uv = _put_rows(m.obs_uv, rows_l, feat_uv_l, s1, eye_l)
    obs_uv = _put_rows(obs_uv, rows_r, feat_uv_r, s1, eye_r)
    obs_valid = _put_rows(obs_valid, rows_l, True, s1, eye_l)
    obs_valid = _put_rows(obs_valid, rows_r, True, s1, eye_r)

    lm_active = torch.any(obs_valid.flatten(1), dim=1)
    return m._replace(kf_pose=kf_pose, kf_gid=kf_gid_arr, kf_valid=kf_valid,
                      obs_uv=obs_uv, obs_valid=obs_valid,
                      lm_valid=m.lm_valid & lm_active,
                      next_kf_gid=kf_gid + 1), slot, kf_gid


def add_landmarks(m: MapState, kf_slot, kf_gid,
                  p_w: torch.Tensor,        # [K, 3] new landmark positions
                  uv_l: torch.Tensor,       # [K, 2] observing uv (this KF)
                  uv_r: torch.Tensor,       # [K, 2]
                  has_r: torch.Tensor,      # [K] bool
                  new_valid: torch.Tensor,  # [K] bool
                  ) -> Tuple[MapState, torch.Tensor]:
    """Allocate landmark slots for newly triangulated points (free slots in
    index order) and register their first observation. `kf_slot` and
    `kf_gid` are ints or 0-d tensors (insert_keyframe_device's). Returns
    (new_map, lm_slot [K] int32, -1 if not allocated)."""
    M = m.lm_valid.shape[0]
    dev = m.lm_valid.device
    free_order = torch.argsort(m.lm_valid.to(torch.int32), stable=True)
    n_free = torch.sum(~m.lm_valid)
    want_rank = torch.cumsum(new_valid.to(torch.int32), 0) - 1   # [K]
    can = new_valid & (want_rank < n_free) & (want_rank < M)
    slot = torch.where(can, free_order[torch.clamp(want_rank, 0, M - 1)],
                       torch.full_like(free_order[:1], -1)).to(torch.int32)

    # unallocated lanes are dead (row M)
    dead = torch.full_like(slot, M)
    rows = torch.where(can, slot, dead).long()
    rows_r = torch.where(can & has_r, slot, dead).long()
    s1 = _slot_index(kf_slot, dev)
    eye_l = torch.zeros_like(s1)
    eye_r = torch.ones_like(s1)
    n_new = torch.sum(can.to(torch.int32))
    return m._replace(
        lm_pos=_put_rows(m.lm_pos, rows, p_w),
        lm_valid=_put_rows(m.lm_valid, rows, True),
        lm_gid=_put_rows(m.lm_gid, rows, m.next_lm_gid + want_rank),
        lm_first_kf=_put_rows(m.lm_first_kf, rows, kf_gid),
        obs_uv=_put_rows(_put_rows(m.obs_uv, rows, uv_l, s1, eye_l),
                         rows_r, uv_r, s1, eye_r),
        obs_valid=_put_rows(_put_rows(m.obs_valid, rows, True, s1, eye_l),
                            rows_r, True, s1, eye_r),
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
        # a select, not kf_fixed[argmin] = True (a 0-d index reads the host)
        kf_fixed = torch.arange(kf_fixed.shape[0], device=kf_fixed.device) \
            == torch.argmin(window_gids)
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
