"""Loop closing: place recognition, relocalization, map correction and
pose-graph optimization (port of `ssvio_tpu/loopclosing.py`).

The keyframe database is a set of fixed-capacity tensors on the loop
closer's device (BoW vectors, multi-octave descriptors as int32 bits,
keypoints, landmark snapshots), doubled when it fills. Per keyframe:
`loop_describe` (the engine emits it in its keyframe branch), a store into
the database, the BoW transform and a score against every older row. A
candidate that passes the host gates (database warm-up, closure gap, score)
is verified: the multi-scale Hamming match, PnP-RANSAC and the correction
magnitude, then the health, drift-rate and acceptance-window gates. An
accepted correction moves the active map rigidly, fuses the matched
landmarks into the loop keyframe's, and runs PGO over the host keyframe
records. `relocalize` reuses the database for a LOST frame.

What differs from the JAX package, by mechanism only:
- The ingests run eagerly on the device; JAX jits them. `mode="drop"`
  scatters become masked index writes (rows -1 are skipped), as `map.py`
  does them, and they write into the database tensors the class owns. A
  map the class did not make is never written: `_fuse_impl` returns a new
  MapState of cloned tensors.
- A verification (`_verify`) runs in three stages with no host read (the
  match and the sample draw; the hypotheses' polish and scores; the LO
  pick, the pose-only refinement and the correction magnitude), which on
  a CUDA device replay CUDA graphs (`VerifyGraphs`: captured once, when
  the vocabulary is first trained, and handed from one loop closer to the
  next by `System.reset`), and the two DLT fits between them, which run
  op by op (CUDA's `eigh` and `svd` wait for the device). JAX jits it
  whole. `eager=True` runs the stages op by op (`_verify_impl`).
- The database row counter is a host int (JAX keeps a device mirror so its
  jitted ingest needs no upload).
- PnP-RANSAC draws its hypotheses from a `torch.Generator` seeded 17 (JAX:
  `PRNGKey(17)`, split per call); a verification draws their uniforms op
  by op and hands them to its first stage. The optional
  `sample_idx_fn(valid, n_hypotheses)` gives the [n_hypotheses, 6] sample
  indices instead (to the verification and to `pnp_ransac` in
  `relocalize`); the parity tests use it to give the port the samples
  JAX's key chain draws. It is None on the main path.

The ingest (`process_keyframes_batch`), the deferred verifications
(`poll`) and each candidate's verification (`loopclosing.verify`, its
host read and any correction included) are spans of the port's recorder
(`utils/profiling.py`); inside a verification, an accepted correction
(`loopclosing.correct`) and its PGO (`loopclosing.pgo`). Counters:
`loopclosing.verify_attempted` / `loopclosing.verify_accepted`, the
verifications that replayed the graphs (`loopclosing.verify_replays`)
and the graphs' captures (`loopclosing.verify_captures`), and a PGO's
keyframes and edges (`pgo.keyframes`, `pgo.edges`).
"""

from __future__ import annotations

import functools
import os
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ssvio_tpu_torch import frontend as fe
from ssvio_tpu_torch import graphs
from ssvio_tpu_torch import map as mapmod
from ssvio_tpu_torch.config import Settings
from ssvio_tpu_torch.ops import bow, fast, orb, pgo, pnp, pyramid, sampling, se3
from ssvio_tpu_torch.utils import profiling


class LoopEvent(NamedTuple):
    cur_gid: int
    loop_gid: int
    score: float
    n_matches: int
    n_inliers: int
    error: float
    corrected: bool
    n_fused: int = 0    # mappoints deduplicated/adopted at this closure


def _round_pow2(n: int, lo: int = 64) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def fe_feat_view(xy, valid, lm_slot, lm_gid) -> fe.FeatState:
    """FeatState view over batch rows (octave is unused downstream of loop
    matching and fusion)."""
    return fe.FeatState(xy=xy, lm_slot=lm_slot, lm_gid=lm_gid, valid=valid,
                        octave=torch.zeros(xy.shape[0], dtype=torch.int32,
                                           device=xy.device))


@functools.lru_cache()
def _pattern_from_path(path: Optional[str]):
    return None if not path else orb.load_pattern_file(path)


def pattern_from_settings(s: Settings):
    """External BRIEF pattern (Settings.brief_pattern_path) or None."""
    return _pattern_from_path(getattr(s, "brief_pattern_path", None))


def loop_describe(img0: torch.Tensor, xy: torch.Tensor, valid: torch.Tensor,
                  S: int, sf: float, screen_threshold: float = 0.0,
                  pattern=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-octave loop descriptors for one keyframe.

    A geometric sf^l ladder of `S` octaves of img0 [H, W]; at each octave
    the image is blurred (sigma 2, radius 3), every keypoint xy [F, 2]
    (level-0 coordinates) is scaled to the octave, oriented with the
    row-integral IC angle and described with the pooled BRIEF pattern (with
    `pattern`, an external [256, 4] table, the classic 512-endpoint steered
    BRIEF). A row is valid where the keypoint is and lies 22 px inside the
    octave's image.

    screen_threshold > 0 adds the per-octave FAST re-screen: at octaves
    >= 1 a keypoint keeps its row only where the unblurred octave image
    still has a FAST-9 corner at its position. Octave 0 is not screened,
    as in the JAX package (those positions were corners at detection and
    have since been tracked to sub-pixel positions a re-check often
    rejects).

    Returns (desc [S * F, 8] int32, dval [S * F] bool), octave-major."""
    ladder = pyramid.build_orb_pyramid(img0, S, sf)
    descs, vals = [], []
    for l in range(S):
        img = pyramid.blur(ladder[l], sigma=2.0, radius=3)
        xy_l = xy / (sf ** l)
        h, w = img.shape
        inb = sampling.in_bounds(xy_l, h, w, border=22.0)
        if screen_threshold > 0 and l >= 1:
            inb = inb & fast.fast_check_sparse(ladder[l], xy_l,
                                               screen_threshold)
        ang = orb.ic_angle_integral(img, xy_l)
        if pattern is not None:
            d = orb.compute_descriptors(img, xy_l, ang, pattern=pattern)
        else:
            d = orb.compute_descriptors_pool(img, xy_l, ang)
        descs.append(d)
        vals.append(valid & inb)
    return torch.cat(descs, 0), torch.cat(vals, 0)


def transform_rows(vocab: bow.Vocabulary, descs: torch.Tensor,
                   dvals: torch.Tensor, levels: int) -> torch.Tensor:
    """`bow.transform` of B descriptor sets at once (JAX: `vmap` of it):
    descs [B, N, 8], dvals [B, N] -> [B, n_words]. The tree descent runs
    once over all B * N descriptors; the term counts are whole numbers."""
    B, N = dvals.shape
    nw = vocab.n_words
    w = bow.words_of(vocab, descs.reshape(B * N, -1), dvals.reshape(-1),
                     levels).reshape(B, N)
    tf = torch.zeros((B * nw,), dtype=torch.float32, device=descs.device)
    base = torch.arange(B, device=descs.device)[:, None] * nw
    tf.index_add_(0, (base + torch.clamp(w, min=0)).reshape(-1),
                  (w >= 0).to(torch.float32).reshape(-1))
    v = tf.reshape(B, nw) * vocab.word_weight
    return v / torch.clamp(torch.sum(torch.abs(v), dim=-1, keepdim=True),
                           min=1e-12)


def _kept(rows: torch.Tensor):
    """(mask, rows as long indices) of the lanes with rows >= 0."""
    keep = rows >= 0
    return keep, rows[keep].long()


def match(desc_cur, val_cur, desc_loop, val_loop, F: int, S: int,
          max_dist: int = 0):
    """Multi-scale brute-force Hamming: the [S F, S F] distance matrix
    reduced over both octave axes to [F, F], then best match, mutual
    check and a threshold. max_dist 0 selects the reference's adaptive
    gate max(2 min_d, 30) (loopclosing.cpp:122); a positive value is a
    fixed cutoff (relocalization uses 64). argmin takes the first of
    equal distances, as jnp.argmin does. Returns (best_j [F] int32,
    dist [F] int32, ok [F] bool). No host read."""
    d = orb.hamming_distance(desc_cur[:, None, :], desc_loop[None, :, :])
    big = 1 << 20
    d = torch.where(val_cur[:, None] & val_loop[None, :], d,
                    torch.full_like(d, big))
    d = d.reshape(S, F, S, F).amin(dim=(0, 2))
    best_j = torch.argmin(d, dim=1)
    best = torch.amin(d, dim=1)
    thresh = (max_dist if max_dist > 0
              else torch.clamp(2 * torch.min(best), min=30))
    back = torch.argmin(d, dim=0)
    mutual = back[best_j] == torch.arange(F, device=d.device)
    ok = (best <= thresh) & (best < big) & mutual
    return best_j.to(torch.int32), best.to(torch.int32), ok


# ----------------------------------------------------------------------
# the verification of one candidate, in stages: the match and the sample
# draw, the hypotheses' polish and scores, the LO pick and the pose-only
# refinement with the correction magnitude. Between them the two DLT fits
# (pnp.minimal_fit, pnp.refit) run op by op: they wait for the device.
# ----------------------------------------------------------------------

N_HYP = 128              # PnP-RANSAC hypotheses a verification draws
SAMPLE = 6               # points a hypothesis
REPROJ_TH = 5.991        # px^2 of the inlier test
# the recorder's counters: verifications that replayed the graphs, and
# captures of a VerifyGraphs
VERIFY_REPLAYS = "loopclosing.verify_replays"
VERIFY_CAPTURES = "loopclosing.verify_captures"


def _stage_match(F, S, cam, desc_cur, val_cur, desc_loop, val_loop, has_loop,
                 pos_loop, feat_xy, uniforms):
    """The match, kept where the loop feature carries a landmark
    (ComputeCorrectPose :149-174), the matched landmarks, the features'
    normalised coordinates and the hypotheses' samples drawn with
    `uniforms` [N_HYP, F]. Returns (best_j, ok, p_w, xn, idx)."""
    best_j, _, ok = match(desc_cur, val_cur, desc_loop, val_loop, F, S)
    bj = best_j.long()
    ok = ok & has_loop[bj]
    return (best_j, ok, pos_loop[bj], pnp.normalized(feat_xy, *cam),
            pnp.sample_indices(ok, N_HYP, SAMPLE, uniforms=uniforms))


def _stage_polish(cam, T_dlt, p_w, feat_xy, ok, idx):
    """pnp.polish_and_score of the hypotheses' DLT poses."""
    return pnp.polish_and_score(T_dlt, p_w, feat_xy, ok, idx, *cam, REPROJ_TH)


def _stage_finish(cam, T_lo, T_hyp, inl, scores, p_w, feat_xy, ok, T_cw):
    """pnp.select_and_refine, then the correction magnitude. Returns
    (pack [16] f32: n_matches, pnp_ok, n_inliers, err, T_corr (12 flat);
    inlier [F] bool: matched and a PnP inlier)."""
    res = pnp.select_and_refine(T_lo, T_hyp, inl, scores, p_w, feat_xy, ok,
                                *cam, REPROJ_TH, min_inliers=10,
                                sample_size=SAMPLE)
    err = torch.linalg.norm(se3.log(se3.compose(T_cw,
                                                se3.inverse(res.T_cw))))
    f32 = torch.float32
    pack = torch.cat([
        torch.stack([torch.sum(ok.to(torch.int32)).to(f32), res.ok.to(f32),
                     res.n_inliers.to(f32), err.to(f32)]),
        res.T_cw.reshape(-1).to(f32)])
    return pack, ok & res.inlier


class VerifyStages(NamedTuple):
    """The three stages of a verification, as functions of tensors
    (op by op) or as their graphs (VerifyGraphs.stages)."""
    match: Callable
    polish: Callable
    finish: Callable


def verify_stages(F: int, S: int, fx, fy, cx, cy) -> VerifyStages:
    """The stages op by op, for F features and S octaves."""
    cam = (fx, fy, cx, cy)
    return VerifyStages(functools.partial(_stage_match, F, S, cam),
                        functools.partial(_stage_polish, cam),
                        functools.partial(_stage_finish, cam))


class VerifyGraphs:
    """The three stages of a verification as `graphs.VerifyGraph`s on
    `device`, for F features, S octaves and the intrinsics the stages bake
    in, built from zero inputs: a capture does not depend on the inputs'
    values. On a CUDA device each is captured here (a capture counts one
    VERIFY_CAPTURES), and a verification replays all three; on the CPU
    they run the same functions on the same buffers. A call copies its
    inputs in and returns clones, so the database's tensors, which `_grow`
    replaces, are never read by a graph: the verification copies the rows
    it reads into the match's inputs. `close()` releases the graphs."""

    def __init__(self, F: int, S: int, fx, fy, cx, cy, device):
        dev = torch.device(device)
        plain = verify_stages(F, S, fx, fy, cx, cy)

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        i32, b, i64 = torch.int32, torch.bool, torch.int64
        desc, dval = z(S * F, orb.DESC_WORDS, dtype=i32), z(S * F, dtype=b)
        xy, p_w, ok = z(F, 2), z(F, 3), z(F, dtype=b)
        hyp = z(N_HYP, 3, 4)
        self.stages = VerifyStages(
            graphs.VerifyGraph(plain.match, desc, dval, desc, dval,
                               z(F, dtype=b), p_w, xy, z(N_HYP, F)),
            graphs.VerifyGraph(plain.polish, hyp, p_w, xy, ok,
                               z(N_HYP, SAMPLE, dtype=i64)),
            graphs.VerifyGraph(plain.finish, hyp, hyp, z(N_HYP, F, dtype=b),
                               z(N_HYP, dtype=i64), p_w, xy, ok, z(3, 4)))
        self.captured = dev.type == "cuda"
        if self.captured:
            profiling.TRACE.add(VERIFY_CAPTURES)

    def close(self) -> None:
        for g in self.stages:
            g.close()


class LoopClosing:
    """Host-side owner of the keyframe database on its device (the GPU
    unless the caller passes device="cpu"; `frontend.resolve_device`).

    Of the System it is handed it uses `map`, `records` (the keyframe
    records, their odometry edges and gauge events; `records.py`),
    `active_gids()`, `track_health` and `track_health_typical`,
    `apply_loop_correction` and `_warn`."""

    GROUP = 4      # max keyframes per ingest call (a 32-frame chunk makes
                   # ~2-4 keyframes; one group covers it)

    def __init__(self, settings: Settings, fx: float, fy: float, cx: float,
                 cy: float, device=None,
                 sample_idx_fn: Optional[Callable] = None,
                 eager: bool = False):
        s = settings
        self.s = s
        self.device = fe.resolve_device(device)
        dev = self.device
        self._fx, self._fy, self._cx, self._cy = fx, fy, cx, cy
        self.cap = s.max_keyframes_db
        self.F = s.max_features
        self.S = s.loop_desc_scales
        FS = self.F * self.S

        def full(shape, v, dtype):
            return torch.full(shape, v, dtype=dtype, device=dev)

        self.bow_db = full((self.cap, s.vocab_k ** s.vocab_levels), 0.0,
                           torch.float32)
        self.desc_db = full((self.cap, FS, orb.DESC_WORDS), 0, torch.int32)
        self.desc_valid = full((self.cap, FS), False, torch.bool)
        self.kp_xy = full((self.cap, self.F, 2), 0.0, torch.float32)
        self.lm_pos = full((self.cap, self.F, 3), 0.0, torch.float32)
        self.lm_has = full((self.cap, self.F), False, torch.bool)
        self.lm_gid_db = full((self.cap, self.F), -1, torch.int32)
        self.db_gid = np.full((self.cap,), -1, np.int64)   # host mirror
        # device mirror of db_gid: the ingest scoring's age gate reads it
        self.db_gid_dev = full((self.cap,), -1, torch.int32)
        self.row_of_gid = {}
        self.n = 0

        self.vocab: Optional[bow.Vocabulary] = None
        self._vocab_levels = s.vocab_levels   # depth of the CURRENT tree
        self._vocab_loaded = False            # pretrained file: never retrain
        if s.vocab_path:
            # pretrained vocabulary in the ORB-SLAM text format (reference
            # loopclosing.cpp:32-34)
            if not os.path.exists(s.vocab_path):
                raise FileNotFoundError(
                    f"Settings.vocab_path (DBOW2.VOC.Path) = {s.vocab_path!r}"
                    " does not exist; unset it to self-train the vocabulary")
            self.vocab = bow.load_orbvoc_text(s.vocab_path).to(dev)
            self._vocab_levels = bow.tree_depth(self.vocab)
            self._vocab_loaded = True
            self.bow_db = full((self.cap, self.vocab.n_words), 0.0,
                               torch.float32)
        self.last_closed_gid = -(10 ** 9)
        # drift-rate gate anchor (gid, residual): the residual against the
        # map is zero at gid 0 by definition of the starting gauge, so the
        # gate is armed from the first verification
        self._residual_anchor: Optional[tuple] = (0, 0.0)
        self._large_hist: List[tuple] = []
        self.loop_edges: List[tuple] = []   # (gid_i, gid_j, Z [3,4] np)
        self.events: List[LoopEvent] = []
        self.last_loop_gid: Optional[int] = None
        # deferred candidates (process_keyframes_batch(defer=True)), each
        # (pack, rows, gids, (xys, valids, slots, fgids), T_list, gauge_idx)
        self._pending: list = []
        self._gen = torch.Generator(device=dev).manual_seed(17)
        self.sample_idx_fn = sample_idx_fn
        # the verification's graphs (VerifyGraphs), built when the
        # vocabulary is first trained or at the first verification, or
        # handed over by System.reset; `eager` verifies op by op instead
        self.eager = eager
        self._graphs: Optional[VerifyGraphs] = None

    # ------------------------------------------------------------------
    def _grow(self, system):
        """Double the database capacity, keeping every stored row. The
        reference's database is unbounded (loopclosing.cpp:657-669); the
        growth is reported through the system's warnings channel."""
        pad = self.cap

        def more(t, v):
            return torch.cat([t, torch.full((pad,) + t.shape[1:], v,
                                            dtype=t.dtype, device=t.device)])

        self.bow_db = more(self.bow_db, 0.0)
        self.desc_db = more(self.desc_db, 0)
        self.desc_valid = more(self.desc_valid, False)
        self.kp_xy = more(self.kp_xy, 0.0)
        self.lm_pos = more(self.lm_pos, 0.0)
        self.lm_has = more(self.lm_has, False)
        self.lm_gid_db = more(self.lm_gid_db, -1)
        self.db_gid = np.concatenate([self.db_gid,
                                      np.full((pad,), -1, np.int64)])
        self.db_gid_dev = more(self.db_gid_dev, -1)
        self.cap = 2 * pad
        system._warn(f"loop keyframe database grown to {self.cap} rows")

    # ------------------------------------------------------------------
    # descriptor extraction (reference ProcessNewKeyframe :596-634)
    # ------------------------------------------------------------------
    def _describe(self, img0: torch.Tensor, xy: torch.Tensor,
                  valid: torch.Tensor):
        return loop_describe(
            img0.to(torch.float32), xy, valid, self.S, self.s.scale_factor,
            screen_threshold=(self.s.min_th_fast if self.s.loop_screen_fast
                              else 0.0),
            pattern=pattern_from_settings(self.s))

    # ------------------------------------------------------------------
    # batched ingest
    # ------------------------------------------------------------------
    @classmethod
    def _ingest_impl_nv(cls, desc_db, desc_valid, kp_xy, db_lm_pos,
                        db_lm_has, db_lm_gid, db_gid_dev, n: int, gids,
                        descs, dvals, xys, valids, f_lm_slot, f_lm_gid,
                        m_lm_pos, m_lm_gid, m_lm_valid, refresh_rows):
        """Warm-up ingest (no vocabulary yet: no transform, no scoring) of
        B keyframes at rows n .. n+B-1, after refreshing the landmark
        snapshots of `refresh_rows`: their landmarks snapshotted and stored
        with their descriptors (the engine's keyframe branch computed
        them), and their gids in db_gid_dev. Writes into the database
        tensors and returns the six, db_gid_dev and n + B."""
        nb = gids.shape[0]
        rows = torch.arange(n, n + nb, device=gids.device)
        db_lm_pos = cls._refresh_rows_impl(db_lm_pos, db_lm_gid,
                                           refresh_rows, m_lm_pos,
                                           m_lm_gid, m_lm_valid)
        M = m_lm_pos.shape[0]
        idx = torch.clamp(f_lm_slot, 0, M - 1).long()             # [B, F]
        lm_has = (valids & (f_lm_slot >= 0) & m_lm_valid[idx]
                  & (m_lm_gid[idx] == f_lm_gid))
        lm_p = m_lm_pos[idx]
        lm_g = torch.where(lm_has, m_lm_gid[idx],
                           torch.full_like(m_lm_gid[idx], -1))
        desc_db[rows] = descs
        desc_valid[rows] = dvals
        kp_xy[rows] = xys
        db_lm_pos[rows] = lm_p
        db_lm_has[rows] = lm_has
        db_lm_gid[rows] = lm_g
        db_gid_dev[rows] = gids.to(torch.int32)
        return (desc_db, desc_valid, kp_xy, db_lm_pos, db_lm_has, db_lm_gid,
                db_gid_dev, n + nb)

    @classmethod
    def _ingest_impl_v(cls, desc_db, desc_valid, kp_xy, db_lm_pos,
                       db_lm_has, db_lm_gid, bow_db, db_gid_dev, n: int,
                       descs, dvals, xys, valids, f_lm_slot, f_lm_gid,
                       m_lm_pos, m_lm_gid, m_lm_valid, vocab, gids,
                       refresh_rows, min_age: int, levels: int):
        """Full ingest: the warm-up's (`_ingest_impl_nv`), the BoW
        transform of the group, and each keyframe scored against the whole
        database under the age gate db_gid <= gid - min_age (DetectLoop
        parity, loopclosing.cpp:72-103; in-group pairs gate on the mirror
        updated here). Returns the database tensors, n + B and a [2, B]
        pack (best_row, best_score) that stays on the device."""
        nb = gids.shape[0]
        *db, db_gid_dev, n_next = cls._ingest_impl_nv(
            desc_db, desc_valid, kp_xy, db_lm_pos, db_lm_has, db_lm_gid,
            db_gid_dev, n, gids, descs, dvals, xys, valids, f_lm_slot,
            f_lm_gid, m_lm_pos, m_lm_gid, m_lm_valid, refresh_rows)
        rows = torch.arange(n, n_next, device=gids.device)
        vs = transform_rows(vocab, descs, dvals, levels)      # [B, n_words]
        bow_db[rows] = vs
        best_rows, best_scores = [], []
        # one query at a time (JAX: lax.map), so the [cap, n_words] score
        # broadcast is never materialised B times; argmax takes the first
        # of equal scores, as jnp.argmax does
        for i in range(nb):
            age_ok = (db_gid_dev >= 0) & (db_gid_dev <= gids[i] - min_age)
            sc = bow.score_l1_database(vs[i], bow_db, age_ok)
            best = torch.argmax(sc)
            best_rows.append(best)
            best_scores.append(sc[best])
        pack = torch.stack([torch.stack(best_rows).to(torch.float32),
                            torch.stack(best_scores)])
        return (*db, bow_db, db_gid_dev, n_next, pack)

    # ------------------------------------------------------------------
    # snapshot freshness: a row's landmark positions are frozen at ingest,
    # but local BA keeps refining them while the keyframe is in the window;
    # loop PnP must see the live positions (the reference's mappoints are
    # live objects, loopclosing.cpp:149-174), so every ingest refreshes
    # the rows of the window's keyframes
    # ------------------------------------------------------------------
    @staticmethod
    def _refresh_rows_impl(db_pos, db_gid, rows, m_lm_pos, m_lm_gid,
                           m_lm_valid):
        """db_pos [cap, F, 3] <- live positions of the landmarks of `rows`
        [R] (-1 skipped) that are in the active map, found by gid (the
        first map slot holding it). Writes into db_pos and returns it."""
        keep, r = _kept(rows)
        for row in r:
            gids = db_gid[row]                                     # [F]
            eq = ((m_lm_gid[None, :] == gids[:, None])
                  & m_lm_valid[None, :] & (gids[:, None] >= 0))    # [F, M]
            found = torch.any(eq, dim=1)
            live = m_lm_pos[torch.argmax(eq.to(torch.uint8), dim=1)]
            db_pos[row] = torch.where(found[:, None], live, db_pos[row])
        return db_pos

    def _refresh_rows_of(self, active_gids) -> np.ndarray:
        """[max_window] int32 database rows of the window's keyframes (-1
        padded), from the host gid list."""
        rows = [self.row_of_gid[int(g)] for g in active_gids
                if int(g) in self.row_of_gid]
        R = self.s.max_window
        return np.asarray((rows + [-1] * R)[:R], np.int32)

    # ------------------------------------------------------------------
    # matching (reference MatchFeatures :105-145)
    # ------------------------------------------------------------------
    def _match_impl(self, desc_cur, val_cur, desc_loop, val_loop,
                    max_dist: int = 0):
        """`match` at the database's F and S."""
        return match(desc_cur, val_cur, desc_loop, val_loop, self.F, self.S,
                     max_dist)

    def _sample_idx(self, valid: torch.Tensor, n_hypotheses: int):
        return (None if self.sample_idx_fn is None
                else self.sample_idx_fn(valid, n_hypotheses))

    # ------------------------------------------------------------------
    def _verify_run(self, stages: VerifyStages, desc_db, desc_valid,
                    db_lm_has, db_lm_pos, row: int, brow: int, feat_xy,
                    T_cw):
        """Match + PnP-RANSAC + correction magnitude for one candidate,
        through `stages` (op by op or replayed), with the two DLT fits op
        by op between them. The uniforms behind the samples are drawn
        here from the loop closer's generator, as pnp_ransac would draw
        them; with sample_idx_fn set the samples are its answer instead
        (and nothing is drawn). Returns (pack [16] f32: n_matches, pnp_ok,
        n_inliers, err, T_corr (12 flat); best_j [F] int32; inlier [F]
        bool)."""
        N = feat_xy.shape[0]
        if self.sample_idx_fn is None:
            u = pnp.draw_uniforms(N_HYP, N, self._gen)
        else:
            u = torch.zeros((N_HYP, N), device=self.device)
        best_j, ok, p_w, xn, idx = stages.match(
            desc_db[row], desc_valid[row], desc_db[brow], desc_valid[brow],
            db_lm_has[brow], db_lm_pos[brow], feat_xy, u)
        if self.sample_idx_fn is not None:
            idx = self.sample_idx_fn(ok, N_HYP).to(self.device).long()
        T_hyp, inl, scores, w_lo = stages.polish(
            pnp.minimal_fit(p_w, xn, idx), p_w, feat_xy, ok, idx)
        pack, inlier = stages.finish(pnp.refit(p_w, xn, w_lo), T_hyp, inl,
                                     scores, p_w, feat_xy, ok, T_cw)
        return pack, best_j, inlier

    def _verify_impl(self, desc_db, desc_valid, db_lm_has, db_lm_pos,
                     row: int, brow: int, feat_xy, T_cw):
        """_verify_run op by op."""
        return self._verify_run(
            verify_stages(self.F, self.S, self._fx, self._fy, self._cx,
                          self._cy),
            desc_db, desc_valid, db_lm_has, db_lm_pos, row, brow, feat_xy,
            T_cw)

    def verify_graphs(self) -> VerifyGraphs:
        """The verification's graphs, built at the first call (on a CUDA
        device: captured) unless a System handed them over."""
        if self._graphs is None:
            self._graphs = VerifyGraphs(self.F, self.S, self._fx, self._fy,
                                       self._cx, self._cy, self.device)
        return self._graphs

    def _verify(self, row: int, brow: int, feat_xy, T_cw):
        """_verify_run on the database through the graphs (op by op when
        the loop closer is eager); counts VERIFY_REPLAYS where replayed."""
        if self.eager:
            return self._verify_impl(self.desc_db, self.desc_valid,
                                     self.lm_has, self.lm_pos, row, brow,
                                     feat_xy, T_cw)
        vg = self.verify_graphs()
        out = self._verify_run(vg.stages, self.desc_db, self.desc_valid,
                               self.lm_has, self.lm_pos, row, brow, feat_xy,
                               T_cw)
        if vg.captured:
            profiling.TRACE.add(VERIFY_REPLAYS)
        return out

    def close(self) -> None:
        """Release the verification's graphs."""
        if self._graphs is not None:
            self._graphs.close()
            self._graphs = None

    @staticmethod
    def _move_rows_impl(db_pos, rows, Cinv):
        """Rigidly move the landmark snapshots of `rows` (-1 skipped) by
        Cinv. Writes into db_pos and returns it."""
        keep, r = _kept(rows)
        db_pos[r] = se3.transform(Cinv, db_pos[r])
        return db_pos

    @staticmethod
    def _apply_row_deltas_impl(db_pos, rows, T_deltas):
        """Per-row SE3 re-anchors (PGO write-back): p' = T_delta p for each
        row's snapshot (-1 skipped). Writes into db_pos and returns it."""
        keep, r = _kept(rows)
        db_pos[r] = se3.transform(T_deltas[keep][:, None], db_pos[r])
        return db_pos

    # ------------------------------------------------------------------
    # active-map rigid correction (reference
    # CorrectActivateKeyframeAndMappoint :378-456): every active keyframe
    # pose is right-multiplied by C; landmarks move as p' = C^-1 p
    # ------------------------------------------------------------------
    @staticmethod
    def _correct_active_impl(kf_pose, lm_pos, lm_valid, C):
        kf_new = se3.compose(kf_pose, C)
        lm_new = torch.where(lm_valid[:, None],
                             se3.transform(se3.inverse(C), lm_pos), lm_pos)
        return kf_new, lm_new

    # ------------------------------------------------------------------
    # current <-> loop mappoint fusion (loopclosing.cpp:428-453)
    # ------------------------------------------------------------------
    @staticmethod
    def _fuse_impl(m: mapmod.MapState, feat, best_j, ok, loop_pos,
                   loop_gid_arr, loop_has, loop_kf_gid):
        """Fuse matched landmarks into the (rigidly corrected) active map.

        Per accepted match (current feature i -> loop feature j):
        * MERGE: the loop landmark is still in the active map (its gid is
          in m.lm_gid): the current duplicate's observation rows move onto
          the resident slot (resident rows win) and the duplicate retires.
        * ADOPT: the loop landmark left the window: the current slot takes
          its identity (gid, and lm_first_kf = the loop keyframe, so local
          BA holds it fixed) and keeps its live position (the JAX
          package's docstring gives the measurement behind this).

        Returns (a new MapState of cloned tensors, slot_remap [M] int32,
        pre-fusion lm_gid [M], n_merged, n_adopted)."""
        M = m.lm_valid.shape[0]
        cur = feat.lm_slot                                        # [F]
        cur_c = torch.clamp(cur, 0, M - 1).long()
        live = (feat.valid & (cur >= 0) & m.lm_valid[cur_c]
                & (m.lm_gid[cur_c] == feat.lm_gid))
        bj = best_j.long()
        g_loop = loop_gid_arr[bj]                                 # [F]
        can = ok & live & loop_has[bj] & (g_loop >= 0)

        eq = (m.lm_gid[None, :] == g_loop[:, None]) & m.lm_valid[None, :]
        in_map = torch.any(eq, dim=1) & can
        tgt = torch.argmax(eq.to(torch.uint8), dim=1)           # first slot
        case_a = in_map & (tgt != cur_c)      # merge duplicate -> resident
        case_b = can & ~in_map                # adopt the loop identity

        # MERGE: union of observation rows, then retire the duplicate
        cur_obs_v = m.obs_valid[cur_c]                            # [F, W, 2]
        tgt_obs_v = m.obs_valid[tgt]
        fill = cur_obs_v & ~tgt_obs_v
        merged_uv = torch.where(fill[..., None], m.obs_uv[cur_c],
                                m.obs_uv[tgt])
        merged_v = tgt_obs_v | cur_obs_v
        a_tgt, a_cur = tgt[case_a], cur_c[case_a]
        obs_uv = m.obs_uv.clone()
        obs_uv[a_tgt] = merged_uv[case_a]
        obs_valid = m.obs_valid.clone()
        obs_valid[a_tgt] = merged_v[case_a]
        obs_valid[a_cur] = False
        lm_valid = m.lm_valid.clone()
        lm_valid[a_cur] = False

        # ADOPT (identity only; the position stays live)
        b_cur = cur_c[case_b]
        lm_gid = m.lm_gid.clone()
        lm_gid[b_cur] = g_loop[case_b]
        lm_first = m.lm_first_kf.clone()
        lm_first[b_cur] = int(loop_kf_gid)

        remap = torch.arange(M, dtype=torch.int32, device=cur.device)
        remap[a_cur] = a_tgt.to(torch.int32)
        return (m._replace(lm_valid=lm_valid, lm_gid=lm_gid,
                           lm_first_kf=lm_first, obs_uv=obs_uv,
                           obs_valid=obs_valid),
                remap, m.lm_gid, torch.sum(case_a.to(torch.int32)),
                torch.sum(case_b.to(torch.int32)))

    @staticmethod
    def remap_feat(feat, remap, old_gid, new_gid):
        """Re-link a FeatState through a fusion remap: features whose
        landmark link was live before the fusion follow their landmark to
        its new slot and gid; stale links are left as they are."""
        M = remap.shape[0]
        s = torch.clamp(feat.lm_slot, 0, M - 1).long()
        live = (feat.lm_slot >= 0) & (feat.lm_gid == old_gid[s])
        ns = remap[s]
        ng = new_gid[torch.clamp(ns, 0, M - 1).long()]
        return feat._replace(lm_slot=torch.where(live, ns, feat.lm_slot),
                             lm_gid=torch.where(live, ng, feat.lm_gid))

    # ------------------------------------------------------------------
    def process_keyframe(self, system, kf_gid: int, pyr_l, feat,
                         m: mapmod.MapState, T_cw,
                         desc=None) -> Optional[LoopEvent]:
        """Ingest ONE keyframe and maybe detect and correct a loop (the
        per-frame path's wrapper over process_keyframes_batch). `desc`:
        the keyframe's (desc, dval) where the engine computed them; else
        they are described here from the pyramid's level 0."""
        if desc is None:
            if hasattr(pyr_l, "levels"):
                pyr_l = pyr_l.levels
            img0 = pyr_l[0] if isinstance(pyr_l, (list, tuple)) else pyr_l
            desc = self._describe(img0, feat.xy, feat.valid)
        d, dv = desc
        batch = (d[None], dv[None], feat.xy[None], feat.valid[None],
                 feat.lm_slot[None], feat.lm_gid[None],
                 torch.tensor([kf_gid], dtype=torch.int32,
                              device=feat.xy.device))
        active = [int(g) for g, v in zip(m.kf_gid.tolist(),
                                         m.kf_valid.tolist()) if v]
        T = T_cw.detach().cpu().numpy() if torch.is_tensor(T_cw) \
            else np.asarray(T_cw)
        evs = self.process_keyframes_batch(system, [int(kf_gid)], [T],
                                           batch, m, active)
        return evs[-1] if evs else None

    @profiling.spanned("loopclosing.poll")
    def poll(self, system) -> List[LoopEvent]:
        """Resolve the candidates deferred by process_keyframes_batch
        (defer=True), at the next chunk collect. The keyframe pose and the
        gauge index ride in the pending entry: the correction is computed
        in that known gauge and re-expressed in the live one (see
        _complete_loop)."""
        events: List[LoopEvent] = []
        pending, self._pending = self._pending, []
        for entry in pending:
            events += self._resolve(system, *entry)
        return events

    def _resolve(self, system, pack, rows, gids_host, feats, T_group,
                 gauge_idx) -> List[LoopEvent]:
        """The gates of one scored group (DetectLoop :72-103 +
        InsertNewKeyFrame :657-669; row + 1 = the database size as of the
        keyframe's ingest), then _complete_loop for each keyframe that
        passes them. The host gates come first: no device read when no
        keyframe can pass."""
        s = self.s

        def gated(i):
            return (rows[i] + 1 > s.loop_db_min_size
                    and gids_host[i] - self.last_closed_gid
                    >= s.loop_min_gap)

        events: List[LoopEvent] = []
        if not any(gated(i) for i in range(len(rows))):
            return events
        pack = pack.cpu().numpy()
        xys, valids, slots, fgids = feats
        for i in range(len(rows)):
            best_score = float(pack[1][i])
            if not gated(i) or best_score < s.loop_threshold_higher:
                continue
            ev = self._complete_loop(
                system, gids_host[i], rows[i],
                fe_feat_view(xys[i], valids[i], slots[i], fgids[i]),
                T_group[i], int(pack[0][i]), best_score, gauge_idx)
            if ev is not None:
                events.append(ev)
        return events

    @profiling.spanned("loopclosing.process_keyframes_batch")
    def process_keyframes_batch(self, system, kf_gids, T_list, batch,
                                m: mapmod.MapState, active_gids,
                                defer: bool = False,
                                gauge_idx: Optional[int] = None
                                ) -> List[LoopEvent]:
        """Ingest keyframes and run loop detection and correction.

        kf_gids / T_list: host lists (gid, pre-correction T_cw [3, 4] np)
        per keyframe. batch: (desc [B, S F, 8] int32, dval [B, S F],
        xy [B, F, 2], valid [B, F], lm_slot [B, F], lm_gid [B, F], gids [B]
        int32) on the device. m: the map the keyframes' landmark links
        refer to; active_gids: its window's keyframe gids (host). Groups of
        GROUP keyframes are stored and scored at once; with `defer` their
        candidates wait for poll() (the chunk path: reading the scores
        would wait on the device). Returns the LoopEvents appended."""
        s = self.s
        events: List[LoopEvent] = []
        B_all = len(kf_gids)
        if not B_all:
            return events
        # the gauge index T_list's poses were captured at, once for the
        # whole batch (see _complete_loop)
        if gauge_idx is None:
            gauge_idx = system.records.gauge_index()
        refresh_rows = self._refresh_rows_of(active_gids)

        for g0 in range(0, B_all, self.GROUP):
            gids_host = [int(g) for g in kf_gids[g0:g0 + self.GROUP]]
            nb = len(gids_host)
            group_batch = (batch if (g0 == 0 and nb == B_all)
                           else tuple(a[g0:g0 + nb] for a in batch))
            while self.n + nb > self.cap:
                self._grow(system)
            rows = list(range(self.n, self.n + nb))
            descs, dvals, xys, valids, slots, fgids, gids_dev = group_batch
            self.db_gid[rows] = gids_host
            for i, g in enumerate(gids_host):
                self.row_of_gid[g] = rows[i]
            n0 = self.n
            rr = torch.as_tensor(refresh_rows if g0 == 0
                                 else np.full_like(refresh_rows, -1),
                                 device=self.device)
            if self.vocab is None:
                (self.desc_db, self.desc_valid, self.kp_xy, self.lm_pos,
                 self.lm_has, self.lm_gid_db, self.db_gid_dev,
                 self.n) = self._ingest_impl_nv(
                    self.desc_db, self.desc_valid, self.kp_xy, self.lm_pos,
                    self.lm_has, self.lm_gid_db, self.db_gid_dev, n0,
                    gids_dev, descs, dvals, xys, valids, slots, fgids,
                    m.lm_pos, m.lm_gid, m.lm_valid, rr)
                pack = None
            else:
                (self.desc_db, self.desc_valid, self.kp_xy, self.lm_pos,
                 self.lm_has, self.lm_gid_db, self.bow_db, self.db_gid_dev,
                 self.n, pack) = self._ingest_impl_v(
                    self.desc_db, self.desc_valid, self.kp_xy, self.lm_pos,
                    self.lm_has, self.lm_gid_db, self.bow_db,
                    self.db_gid_dev, n0, descs, dvals, xys, valids, slots,
                    fgids, m.lm_pos, m.lm_gid, m.lm_valid, self.vocab,
                    gids_dev, rr, min_age=int(s.loop_min_age),
                    levels=self._vocab_levels)

            # vocabulary self-training at warm-up (the database cannot fire
            # before loop_db_min_size anyway, reference loopclosing.cpp:48)
            if self.vocab is None:
                if self.n >= s.loop_db_min_size:
                    self._train_vocab(s.vocab_levels)
                continue
            # deepen once the database outgrows the warm-up tree; a loaded
            # vocabulary is never retrained
            if (s.vocab_retrain_at and not self._vocab_loaded
                    and self._vocab_levels < s.vocab_deep_levels
                    and self.n >= s.vocab_retrain_at):
                self._train_vocab(s.vocab_deep_levels)

            entry = (pack, rows, gids_host, (xys, valids, slots, fgids),
                     [np.asarray(T) for T in T_list[g0:g0 + nb]], gauge_idx)
            if defer:
                self._pending.append(entry)
            else:
                events += self._resolve(system, *entry)
        return events

    # ------------------------------------------------------------------
    def _correction_window(self, centres: np.ndarray):
        """(min, max) acceptance bounds on |log C|. The reference hardcodes
        (1, 15) (loopclosing.cpp:224-234); with loop_correction_autoscale
        both are clamped against the extent of the keyframes' centres
        [n, 3] (the 5-95 percentile span per axis): min <= 0.5% and max
        <= 50% of it."""
        s = self.s
        lo, hi = s.loop_correction_min, s.loop_correction_max
        if not s.loop_correction_autoscale:
            return lo, hi
        if len(centres) >= 2:
            extent = float(np.linalg.norm(np.percentile(centres, 95, axis=0)
                                          - np.percentile(centres, 5, axis=0)))
            lo = min(lo, max(0.005 * extent, 1e-3))
            hi = min(hi, max(0.5 * extent, 10 * lo))
        return lo, hi

    # ------------------------------------------------------------------
    @profiling.spanned("loopclosing.verify")
    def _complete_loop(self, system, kf_gid: int, row: int, feat, T_cw,
                       best_row: int, best_score: float,
                       gauge_idx: int = 0) -> Optional[LoopEvent]:
        """Verify one scored candidate and maybe correct (reference
        ComputeCorrectPose + LoopCorrect, loopclosing.cpp:147-376).

        `T_cw` is the keyframe's pose in the gauge at index `gauge_idx`
        of the records, so C_raw = T_cw^-1 T_corr is a gauge change from
        that gauge; the gates and the correction use C_live, what C_raw
        still owes the live map (`records.owed`). The correction reads and
        replaces system.map, the live map (under dispatch-ahead, a chunk
        ahead of this keyframe).

        A span `loopclosing.verify` of the recorder, with the counter
        `loopclosing.verify_attempted`; an accepted correction is its child
        span `loopclosing.correct` (counter `loopclosing.verify_accepted`),
        and the PGO that ends it the grandchild `loopclosing.pgo`."""
        s = self.s
        profiling.TRACE.add("loopclosing.verify_attempted")
        loop_gid = int(self.db_gid[best_row])
        T_np = np.asarray(T_cw.detach().cpu() if torch.is_tensor(T_cw)
                          else T_cw, np.float32)

        # ---- match + PnP (MatchFeatures :105-145, ComputeCorrectPose
        # :147-243), one host read
        pack_dev, best_j, pnp_inlier = self._verify(
            row, best_row, feat.xy, torch.as_tensor(T_np, device=self.device))
        pack = pack_dev.cpu().numpy()
        n_matches = int(pack[0])
        pnp_ok = pack[1] > 0.5
        n_inliers = int(pack[2])
        if n_matches < 10:
            return self._log(kf_gid, loop_gid, best_score, n_matches, 0,
                             0.0, False)
        if not pnp_ok:
            return self._log(kf_gid, loop_gid, best_score, n_matches,
                             n_inliers, 0.0, False)
        T_corr = pack[4:].reshape(3, 4)

        # the net correction in the live gauge (see docstring)
        recs = system.records
        C_live = recs.owed(se3.compose_np(se3.inverse_np(T_np), T_corr),
                           gauge_idx)
        xi = se3.log(torch.as_tensor(C_live, dtype=torch.float32)).numpy()
        err = float(np.linalg.norm(xi))

        # tracking-health gate: no re-anchor while the front end is below
        # loop_health_min_frac of its own typical health
        health, typical = system.track_health, system.track_health_typical
        if (s.loop_health_min_frac > 0 and health is not None
                and typical is not None
                and health < s.loop_health_min_frac * typical):
            return self._log(kf_gid, loop_gid, best_score, n_matches,
                             n_inliers, err, False)

        T_loop = np.asarray(recs.pose(loop_gid))
        Z_loop = se3.compose_np(T_corr, se3.inverse_np(T_loop))
        self.last_closed_gid = kf_gid

        # acceptance window on the net correction (:224-234, scene-scaled)
        lo, hi = self._correction_window(recs.centres())
        # drift-rate plausibility: since the last resolved verification
        # the residual can only have grown by odometry drift; a larger one
        # is re-admitted once 3 consecutive verifications agree on the
        # twist within 30% (Settings.loop_drift_per_kf)
        anchor = self._residual_anchor
        if s.loop_drift_per_kf > 0 and anchor is not None:
            a_gid, a_err = anchor
            rate_hi = a_err + s.loop_drift_per_kf * max(kf_gid - a_gid, 1) + lo
            if err >= rate_hi:
                hist = [(g, x) for (g, x) in self._large_hist
                        if kf_gid - g <= 6 * s.loop_min_gap]
                hist.append((kf_gid, xi))
                self._large_hist = hist
                agree = [x for (_, x) in hist[-3:]
                         if np.linalg.norm(x - xi) < 0.3 * err]
                if len(hist) < 3 or len(agree) < 3:
                    hi = min(hi, rate_hi)       # not yet corroborated
        # a loop edge for accepted corrections and for consistent (below
        # min) verifications, never for a rejected large one (the JAX
        # package documents the deviation from the reference)
        if err <= lo:
            self.loop_edges.append((loop_gid, kf_gid, Z_loop))
            self._residual_anchor = (kf_gid, err)
            self._large_hist = []
        if not (lo < err < hi):
            return self._log(kf_gid, loop_gid, best_score, n_matches,
                             n_inliers, err, False)
        self.loop_edges.append((loop_gid, kf_gid, Z_loop))
        self.last_loop_gid = loop_gid       # PGO fixes only this loop KF
        self._residual_anchor = (kf_gid, 0.0)
        self._large_hist = []
        n_fused = self._correct(system, feat, best_j, pnp_inlier, best_row,
                                loop_gid, C_live)
        return self._log(kf_gid, loop_gid, best_score, n_matches, n_inliers,
                         err, True, n_fused)

    @profiling.spanned("loopclosing.correct")
    def _correct(self, system, feat, best_j, pnp_inlier, best_row: int,
                 loop_gid: int, C_live: np.ndarray) -> int:
        """An accepted correction (the reference's LoopCorrect): the
        active map re-anchored rigidly by C_live, its matched landmarks
        fused into the loop keyframe's, the result installed into the
        System, then PGO. Returns the landmarks fused."""
        s = self.s
        profiling.TRACE.add("loopclosing.verify_accepted")
        m = system.map
        C = torch.as_tensor(C_live, dtype=torch.float32, device=self.device)
        kf_new, lm_new = self._correct_active_impl(m.kf_pose, m.lm_pos,
                                                   m.lm_valid, C)
        # the loop keyframe's snapshot, read before the active rows move
        loop_lm_pos = self.lm_pos[best_row].clone()
        loop_lm_gid = self.lm_gid_db[best_row].clone()
        loop_lm_has = self.lm_has[best_row].clone()
        active_rows = [self.row_of_gid[g] for g in system.active_gids()
                       if g in self.row_of_gid]
        if active_rows:
            R = s.max_window
            self.lm_pos = self._move_rows_impl(
                self.lm_pos,
                torch.tensor((active_rows + [-1] * R)[:R], dtype=torch.int32,
                             device=self.device),
                se3.inverse(C))

        # fuse matched current landmarks into the loop keyframe's (PnP
        # inliers only, like the reference's match_inliers set)
        m_f, remap, old_gid, n_merged, n_adopted = self._fuse_impl(
            m._replace(kf_pose=kf_new, lm_pos=lm_new), feat, best_j,
            pnp_inlier, loop_lm_pos, loop_lm_gid, loop_lm_has, loop_gid)
        n_fused = int(n_merged) + int(n_adopted)
        system.apply_loop_correction(self, m_f, C_live,
                                     relink=(remap, old_gid, m_f.lm_gid))
        self._pose_graph_optimize(system)
        return n_fused

    # ------------------------------------------------------------------
    def relocalize(self, pyr_l, xy: torch.Tensor, valid: torch.Tensor):
        """Global relocalization of a LOST frame against the database: BoW
        scoring over every stored row (no age or gap gates), the score gate
        Loop.Threshold.Lower, the Hamming-64 match against the best row's
        landmark snapshot and PnP-RANSAC with 1024 hypotheses (fresh
        detections against stored tracks give inlier ratios of ~0.3-0.5).
        The reference leaves recovery as a TODO (frontend.cpp:62-66).
        Returns (T_cw [3, 4] tensor, n_inliers) or None."""
        s = self.s
        if self.vocab is None or self.n == 0:
            return None
        if hasattr(pyr_l, "levels"):
            pyr_l = pyr_l.levels
        img0 = pyr_l[0] if isinstance(pyr_l, (list, tuple)) else pyr_l
        desc, dval = self._describe(img0, xy, valid)
        v = bow.transform(self.vocab, desc, dval, self._vocab_levels)
        row_ok = torch.as_tensor(self.db_gid[:self.cap] >= 0,
                                 device=self.device)
        scores = bow.score_l1_database(v, self.bow_db, row_ok)
        best_row = int(torch.argmax(scores))
        if float(scores[best_row]) < s.loop_threshold_lower:
            return None
        best_j, _, ok = self._match_impl(desc, dval, self.desc_db[best_row],
                                         self.desc_valid[best_row], 64)
        bj = best_j.long()
        ok = ok & self.lm_has[best_row][bj]
        if int(ok.sum()) < s.reloc_min_inliers:
            return None
        p_w = self.lm_pos[best_row][bj]
        res = pnp.pnp_ransac(p_w, xy, ok, self._fx, self._fy, self._cx,
                             self._cy, generator=self._gen,
                             n_hypotheses=1024, reproj_threshold=5.991,
                             min_inliers=s.reloc_min_inliers,
                             sample_idx=self._sample_idx(ok, 1024))
        if not bool(res.ok):
            return None
        return res.T_cw, int(res.n_inliers)

    # ------------------------------------------------------------------
    def _log(self, *args) -> LoopEvent:
        ev = LoopEvent(*args)
        self.events.append(ev)
        return ev

    # ------------------------------------------------------------------
    def _train_vocab(self, levels: int):
        """(Re)train the vocabulary at `levels` depth from every stored
        keyframe's valid descriptors (`bow.train`, host numpy, seed 7),
        reallocate the BoW database for its word count and back-fill every
        stored row, 32 at a time."""
        s = self.s
        dv = self.desc_valid[:self.n].cpu().numpy()
        dd = np.ascontiguousarray(self.desc_db[:self.n].cpu().numpy()) \
            .view(np.uint32)
        docs = [dd[i][dv[i]] for i in range(self.n)]
        self.vocab = bow.train(docs, k=s.vocab_k, levels=levels,
                               seed=7).to(self.device)
        self._vocab_levels = levels
        if not self.eager:
            # the warm-up's moment: the database can verify from now on
            self.verify_graphs()
        # the word count is the tree's actual leaf count (<= k^L)
        self.bow_db = torch.zeros((self.cap, self.vocab.n_words),
                                  dtype=torch.float32, device=self.device)
        G = 32
        for i0 in range(0, self.n, G):
            i1 = min(i0 + G, self.n)
            self.bow_db[i0:i1] = transform_rows(
                self.vocab, self.desc_db[i0:i1], self.desc_valid[i0:i1],
                levels)

    # ------------------------------------------------------------------
    # pose-graph optimization over the host keyframe records (reference
    # PoseGraphOptimization :458-594)
    # ------------------------------------------------------------------
    @profiling.spanned("loopclosing.pgo")
    def _pose_graph_optimize(self, system):
        recs = system.records
        gids, T_old = recs.gids(), recs.poses()
        n = len(gids)
        P = _round_pow2(n)
        poses = np.zeros((P, 3, 4), np.float32)
        poses[:, :, :3] = np.eye(3)
        for i, T in enumerate(T_old):
            poses[i] = T
        gid_to_idx = {g: i for i, g in enumerate(gids)}
        pose_valid = np.zeros(P, bool)
        pose_valid[:n] = True

        # fixed: the first keyframe, the active window and the CURRENT
        # closure's loop keyframe (reference :480-487 fixes only the
        # latest loop keyframe)
        fixed = np.zeros(P, bool)
        fixed[0] = True
        for g in system.active_gids():
            if g in gid_to_idx:
                fixed[gid_to_idx[g]] = True
        last_loop = self.last_loop_gid
        if last_loop is not None and last_loop in gid_to_idx:
            fixed[gid_to_idx[last_loop]] = True

        # records store (gid_prev, gid_cur, Z = T_cur T_prev^-1); the PGO
        # residual log(Z^-1 X_i X_j^-1) vanishes at Z = X_i X_j^-1, so the
        # edge is (i = CUR, j = PREV)
        edges = [(gid_to_idx[b], gid_to_idx[a], Z)
                 for (a, b, Z) in recs.odometry_edges + self.loop_edges
                 if a in gid_to_idx and b in gid_to_idx]
        profiling.TRACE.add("pgo.keyframes", n)
        profiling.TRACE.add("pgo.edges", len(edges))
        E = _round_pow2(len(edges))
        ei = np.zeros(E, np.int32)
        ej = np.zeros(E, np.int32)
        eZ = np.zeros((E, 3, 4), np.float32)
        eZ[:, :, :3] = np.eye(3)
        ev = np.zeros(E, bool)
        for q, (a, b, Z) in enumerate(edges):
            ei[q], ej[q], eZ[q], ev[q] = a, b, Z, True

        def t(a):
            return torch.as_tensor(a, device=self.device)

        prob = pgo.PGOProblem(
            poses=t(poses), pose_valid=t(pose_valid), pose_fixed=t(fixed),
            edge_i=t(ei), edge_j=t(ej), edge_Z=t(eZ), edge_valid=t(ev),
            edge_weight=torch.ones((E,), dtype=torch.float32,
                                   device=self.device))
        opt = pgo.optimize(prob, iters=20).cpu().numpy()

        # write back (the window was held fixed, so the live map keeps its
        # poses, reference :488-500), and re-anchor each stored keyframe's
        # landmark snapshot: p_cam = T_old p is invariant -> p' = T_new^-1
        # p_cam (:564-588), every row in one call
        recs.set_poses(opt)
        rows_d, deltas = [], []
        for g, T_o, T_new in zip(gids, T_old, opt):
            row = self.row_of_gid.get(g)
            if row is not None and not np.allclose(T_o, T_new, atol=1e-7):
                deltas.append(se3.compose_np(se3.inverse_np(T_new), T_o))
                rows_d.append(row)
        if rows_d:
            R = _round_pow2(len(rows_d), lo=16)
            rows_a = np.full((R,), -1, np.int32)
            rows_a[:len(rows_d)] = rows_d
            T_a = np.tile(np.eye(3, 4, dtype=np.float32), (R, 1, 1))
            T_a[:len(rows_d)] = np.stack(deltas)
            self.lm_pos = self._apply_row_deltas_impl(
                self.lm_pos, torch.as_tensor(rows_a, device=self.device),
                torch.as_tensor(T_a, device=self.device))
