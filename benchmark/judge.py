"""What decides `correct`: samples of the timed path's own outputs, drawn
from the seed while the window runs (references to tensors the program
has already made: no copy and no host read inside the window), judged
after the window has closed against the plain reference
(`benchmark/reference.py`).

Four numbers, each against the limit of the cell
(`benchmark/limits/<workload>.json`):
- `track_gap_median`: the median, over sampled tracked frames, of the cost
  gap of a frame's pose against the optimum of its pose-only problem (its
  inlier tracks and the landmarks they link to, the map the frame was
  tracked against), which the reference solves from the frame's previous
  pose. The widest of those gaps (`track_gap`) is printed and not
  compared: it swings with the few tracks whose inlier flag the last
  round of the program's solve changed, and reaches what the control's
  does;
- `ba_gap`: the widest cost gap of a sampled window after a steady
  keyframe's local BA (every pose and landmark of the window) against the
  window problem's optimum;
- `status_errors`: sampled tracked frames whose status is not the one
  their inlier count calls for (GOOD above tracking_good, BAD above
  tracking_bad, else LOST), the count taken by the reference at the
  frame's pose, or whose reported inlier count differs from it;
- `rpe_m`: the drive as the program tracked it against the renderer's
  ground truth, independent of the program's own masks and state: the
  root mean square, over every pair of frames RPE_STEP apart in the
  frames collected in the window (a drive cut by the window's end
  included), of the translational error of the relative motion between
  them, in metres. It answers for what the three above take as given:
  LK's tracks, detection, triangulation and the outlier gates.

The same solvers in TF32 are the control of the first three
(`evaluate(..., control=True)`); the faults a test plants are read the
same way (`faults=True`). That control cannot reach `rpe_m`, which it
would have to replay the whole drive for; its upper reading is the
program with every LK call in the window returning where it started
(`benchmark/calibrate.py --fault lk_start`).
"""

from __future__ import annotations

import random
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from benchmark import reference as ref

# tracking statuses as the program reports them (frontend.TRACKING_GOOD ...)
TRACKING_GOOD, TRACKING_BAD, LOST = 1, 2, 3
TRACKED = (TRACKING_GOOD, TRACKING_BAD)
CHUNKS_KEPT = 12          # sampled chunks of an offline window
FRAMES_PER_CHUNK = 4      # tracked frames judged per sampled chunk
FRAMES_KEPT = 48          # sampled frames of a live window
NUMBERS = ("track_gap_median", "ba_gap", "status_errors", "rpe_m")
RPE_STEP = 10             # frames between the two poses of a motion


def status_for(n_inliers: int, tracking_good: int, tracking_bad: int) -> int:
    """The status a tracked frame's inlier count calls for."""
    if n_inliers > tracking_good:
        return TRACKING_GOOD
    return TRACKING_BAD if n_inliers > tracking_bad else LOST


def motion_errors(est: np.ndarray, gt: np.ndarray, step: int) -> np.ndarray:
    """The translational errors (m) of the relative motion between frames
    i and i + step, for every such pair of [K, 3, 4] T_wc poses: the
    distance between the estimated and the true translation of the
    motion, each in the frame of its pose i (so no alignment is needed)."""
    if len(est) <= step:
        return np.zeros(0)

    def rel(T):
        R, t = T[:, :, :3], T[:, :, 3]
        return np.einsum("nji,nj->ni", R[:-step], t[step:] - t[:-step])

    return np.linalg.norm(rel(est) - rel(gt), axis=1)


def frame_ate(est_T_wc: np.ndarray, gt_T_wc: np.ndarray) -> float:
    """RMS of the position error after the rigid alignment (Kabsch, no
    scale) of the estimated positions to the ground truth."""
    P, Q = est_T_wc[:, :, 3], gt_T_wc[:, :, 3]
    pc, qc = P.mean(0), Q.mean(0)
    U, _, Vt = np.linalg.svd((P - pc).T @ (Q - qc))
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    Rm = Vt.T @ np.diag([1.0, 1.0, d]) @ U.T
    err = (P - pc) @ Rm.T + qc - Q
    return float(np.sqrt((err * err).sum(1).mean()))


class TrackSample(NamedTuple):
    T_prev: torch.Tensor      # [3, 4] T_cw before the frame
    T_cw: torch.Tensor        # [3, 4] the frame's pose
    xy: torch.Tensor          # [N, 2] its tracks after the frame
    valid: torch.Tensor       # [N] its inlier tracks
    lm_slot: torch.Tensor     # [N]
    lm_gid: torch.Tensor      # [N]
    lm_pos: torch.Tensor      # [M, 3] the map it was tracked against
    lm_valid: torch.Tensor    # [M]
    lm_gids: torch.Tensor     # [M]
    status: int
    n_inliers: Optional[int]  # as the program reported it (None: not read)


class Reservoir:
    """Keeps k items of a stream, each with the same chance, drawn from a
    seeded generator; `want()` says before an item is made whether it
    would be kept, so nothing is made for an item that would not be."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng = k, rng
        self.items: List = []
        self.seen = 0
        self._slot = None

    def want(self) -> bool:
        self.seen += 1
        if len(self.items) < self.k:
            self._slot = len(self.items)
        else:
            j = self.rng.randrange(self.seen)
            self._slot = j if j < self.k else None
        return self._slot is not None

    def put(self, item) -> None:
        """Keep `item` in the slot `want()` chose; None keeps nothing."""
        if item is None:
            pass
        elif self._slot == len(self.items):
            self.items.append(item)
        elif self._slot is not None:
            self.items[self._slot] = item
        self._slot = None


class Judge:
    """Collects samples during a window; `evaluate` judges them."""

    def __init__(self, settings, seed: int, baseline: float):
        self.s = settings
        self.seed = seed
        self.rng = random.Random(seed)
        self.cam = ref.Camera(settings.cam_left.fx, settings.cam_left.fy,
                              settings.cam_left.cx, settings.cam_left.cy,
                              baseline)
        self.chunks = Reservoir(CHUNKS_KEPT, self.rng)
        self.frames = Reservoir(FRAMES_KEPT, self.rng)
        self.segments: List[tuple] = []      # (est, gt) of each drive

    def trajectory(self, est_T_wc: np.ndarray, gt_T_wc: np.ndarray) -> None:
        """The poses [K, 3, 4] T_wc that the program gave the first K
        frames of a drive in the window, and their ground truth."""
        if len(est_T_wc):
            self.segments.append((np.asarray(est_T_wc, np.float64),
                                  np.asarray(gt_T_wc, np.float64)))

    # ---------------------------------------------------------------- offline
    def offline_chunk(self, handle, statuses, n_inliers, kf_flags) -> None:
        """A collected chunk: its handle (the outputs on the device and
        the map after it) and its frames' statuses, inlier counts and
        keyframe flags as read back. Frames after the chunk's last
        keyframe were tracked against the handle's map."""
        if not self.chunks.want():
            return
        kfs = [i for i, f in enumerate(kf_flags) if f]
        last = kfs[-1] if kfs else -1
        track = [i for i in range(max(1, last + 1), len(statuses))
                 if statuses[i - 1] in TRACKED and not kf_flags[i]]
        track = sorted(self.rng.sample(track, min(FRAMES_PER_CHUNK,
                                                  len(track))))
        o, m = handle.outs, handle.m
        frames = [TrackSample(o.T_cw[i - 1], o.T_cw[i], o.feat.xy[i],
                              o.feat.valid[i], o.feat.lm_slot[i],
                              o.feat.lm_gid[i], m.lm_pos, m.lm_valid,
                              m.lm_gid, int(statuses[i]), int(n_inliers[i]))
                  for i in track]
        steady_ba = last >= 1 and statuses[last - 1] in TRACKED
        self.chunks.put((frames, m if steady_ba else None))

    # ------------------------------------------------------------------- live
    def live_before(self, system):
        """Before a run_step: the state to keep if this frame is sampled
        (None when it is not)."""
        if not self.frames.want():
            return None
        return (system.T_cw, system.status, system.stats["n_keyframes"],
                system.stats["n_loops"])

    def live_after(self, system, before) -> None:
        """After the run_step of a sampled frame: a tracked frame that made
        no keyframe is judged by its pose; a steady keyframe's window by
        its BA (unless a loop correction moved the map in between)."""
        if before is None:
            return
        T_prev, status0, n_kf, n_loops = before
        made_kf = system.stats["n_keyframes"] > n_kf
        item = None
        if status0 in TRACKED and not made_kf:
            f, m = system.feat, system.map
            item = ([TrackSample(T_prev, system.T_cw, f.xy, f.valid,
                                 f.lm_slot, f.lm_gid, m.lm_pos, m.lm_valid,
                                 m.lm_gid, int(system.status), None)], None)
        elif status0 in TRACKED and system.stats["n_loops"] == n_loops:
            item = ([], system.map)
        self.frames.put(item)

    # --------------------------------------------------------------- judging
    def _items(self):
        for res in (self.chunks, self.frames):
            for item in res.items:
                if item is not None:
                    yield item

    def _track_batch(self, samples: List[TrackSample]):
        """The pose-only problems of `samples` in float64, and their
        previous and reported poses."""
        def stack(f):
            return torch.stack([f(s) for s in samples])
        p, mask = [], []
        for s in samples:
            slot = s.lm_slot.long().clamp(0, s.lm_pos.shape[0] - 1)
            live = (s.valid & (s.lm_slot >= 0) & s.lm_valid[slot]
                    & (s.lm_gids[slot] == s.lm_gid))
            p.append(s.lm_pos[slot])
            mask.append(live)
        prob = ref.TrackProblem(torch.stack(p).to(ref.F64),
                                stack(lambda s: s.xy).to(ref.F64),
                                torch.stack(mask))
        T_prev = stack(lambda s: s.T_prev).to(ref.F64)
        T_cw = stack(lambda s: s.T_cw).to(ref.F64)
        return prob, T_prev, T_cw

    def evaluate(self, control: bool = False, faults: bool = False) -> Dict:
        """The numbers of the samples (NUMBERS), the sample counts, and
        with `control` / `faults` the same numbers for the control's
        answers and for planted faults."""
        out: Dict = {}
        items = list(self._items())
        tracks = [s for frames, _ in items for s in frames]
        maps = [m for _, m in items if m is not None]
        out["n_track"], out["n_windows"] = len(tracks), len(maps)
        out["n_rpe"] = sum(max(0, len(e) - RPE_STEP) for e, _ in self.segments)
        if tracks:
            out.update(self._judge_tracks(tracks, control, faults))
        if maps:
            out.update(self._judge_windows(maps, control, faults))
        if out["n_rpe"]:
            errs = np.concatenate([motion_errors(e, g, RPE_STEP)
                                   for e, g in self.segments])
            out["rpe_m"] = float(np.sqrt(np.mean(errs ** 2)))
            steps = np.concatenate([motion_errors(e, g, 1)
                                    for e, g in self.segments])
            out["rpe1_m"] = float(np.sqrt(np.mean(steps ** 2)))
        out["frame_ate_m"] = [frame_ate(e, g) for e, g in self.segments
                              if len(e) >= 3]
        return out

    def _judge_tracks(self, tracks, control, faults) -> Dict:
        cam = self.cam
        prob, T_prev, T_cw = self._track_batch(tracks)
        R0, t0 = T_prev[..., :3], T_prev[..., 3]
        F_prog, chi2, ok = ref.track_cost(prob, T_cw[..., :3], T_cw[..., 3],
                                          cam)
        with ref.precision("f64"):
            R, t = ref.solve_track(prob, R0, t0, cam)
        F_ref, _, _ = ref.track_cost(prob, R, t, cam)

        def widest_and_median(F):
            g = sorted(ref.gap(a, b) for a, b in zip(F, F_ref))
            return g[-1], g[len(g) // 2]

        counts = ((chi2 < ref.CHI2_TRACK) & ok).sum(-1).tolist()
        errors = 0
        for s, n in zip(tracks, counts):
            if status_for(n, self.s.tracking_good,
                          self.s.tracking_bad) != s.status:
                errors += 1
            elif s.n_inliers is not None and s.n_inliers != n:
                errors += 1
        out = {"status_errors": errors}
        out["track_gap"], out["track_gap_median"] = widest_and_median(F_prog)
        if control:
            with ref.precision("tf32") as dt:
                pc = ref.TrackProblem(prob.p.to(dt), prob.uv.to(dt),
                                      prob.mask)
                Rc, tc = ref.solve_track(pc, R0.to(dt), t0.to(dt), cam)
            F_c, _, _ = ref.track_cost(prob, Rc.to(ref.F64), tc.to(ref.F64),
                                       cam)
            out["control.track_gap"], out["control.track_gap_median"] = \
                widest_and_median(F_c)
        if faults:
            # a step that returns its state unchanged: the previous pose
            F_u, _, _ = ref.track_cost(prob, R0, t0, cam)
            out["fault.unchanged.track_gap"], \
                out["fault.unchanged.track_gap_median"] = widest_and_median(F_u)
            # half of the tracks left out: the optimum of the other half
            half = prob.mask & (torch.cumsum(prob.mask.long(), -1) % 2 == 0)
            with ref.precision("f64"):
                Rh, th = ref.solve_track(prob._replace(mask=half), R0, t0,
                                         cam)
            F_h, _, _ = ref.track_cost(prob, Rh, th, cam)
            out["fault.half.track_gap"], out["fault.half.track_gap_median"] = \
                widest_and_median(F_h)
            # an answer altered where it is made: the pose 5 cm to the side
            shift = torch.tensor([0.05, 0.0, 0.0], dtype=ref.F64,
                                 device=t0.device)
            F_a, _, _ = ref.track_cost(prob, T_cw[..., :3],
                                       T_cw[..., 3] + shift, cam)
            out["fault.altered.track_gap"] = widest_and_median(F_a)[0]
        return out

    def _judge_windows(self, maps, control, faults) -> Dict:
        cam = self.cam
        gaps, gaps_c, gaps_u, gaps_h = [], [], [], []
        for k, m in enumerate(maps):
            prob, rows = ref.window_from_map(
                m.kf_gid, m.kf_valid, m.lm_valid, m.lm_first_kf,
                m.obs_uv.to(ref.F64), m.obs_valid, cam.baseline)
            T = m.kf_pose.to(ref.F64)
            R, t, p = T[..., :3], T[..., 3], m.lm_pos[rows].to(ref.F64)
            F_prog = ref.window_cost(prob, R, t, p, cam)
            start = ref.perturb(prob, R, t, p, self.seed * 1009 + k)
            with ref.precision("f64"):
                sol = ref.solve_window(prob, *start, cam)
            F_ref = ref.window_cost(prob, *sol, cam)
            gaps.append(ref.gap(F_prog, F_ref))
            if control:
                with ref.precision("tf32") as dt:
                    pc = prob._replace(e_shift=prob.e_shift.to(dt),
                                       uv=prob.uv.to(dt))
                    sol_c = ref.solve_window(pc, *(x.to(dt) for x in start),
                                             cam)
                F_c = ref.window_cost(prob, *(x.to(ref.F64) for x in sol_c),
                                      cam)
                gaps_c.append(ref.gap(F_c, F_ref))
            if faults:
                # the BA returns its input unchanged
                gaps_u.append(ref.gap(ref.window_cost(prob, *start, cam),
                                      F_ref))
                # half of the landmarks left out of the solve
                lf = prob.lm_free & (torch.arange(
                    len(rows), device=rows.device) % 2 == 0)
                with ref.precision("f64"):
                    sol_h = ref.solve_window(prob._replace(lm_free=lf),
                                             *start, cam)
                gaps_h.append(ref.gap(ref.window_cost(prob, *sol_h, cam),
                                      F_ref))
        out = {"ba_gap": max(gaps), "ba_gap_median": sorted(gaps)[len(gaps) // 2]}
        if control:
            out["control.ba_gap"] = max(gaps_c)
        if faults:
            out["fault.unchanged.ba_gap"] = max(gaps_u)
            out["fault.half.ba_gap"] = max(gaps_h)
        return out


def verdict(numbers: Dict, limits: Dict) -> tuple:
    """(correct, [(name, value, limit)]): every number of NUMBERS at or
    under its limit; a number with no sample is not correct."""
    rows, ok = [], True
    for name in NUMBERS:
        value = numbers.get(name)
        limit = limits[name]
        rows.append((name, value, limit))
        if value is None or not value <= limit:
            ok = False
    return ok, rows
