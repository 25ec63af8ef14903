"""Absolute pose error (APE/ATE) with SE(3) Umeyama alignment.

Implements the reference's evaluation protocol (reference README.md:50-59:
evo APE over TUM trajectories, SE(3) Umeyama alignment) so accuracy can be
gated hermetically against BASELINE.md bounds without the external evo tool.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (optionally similarity) alignment dst ~ s R src + t.

    src, dst: [N, 3]. Returns (s, R [3,3], t [3]).
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = np.trace(np.diag(D) @ S) / var_s
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ape_translation(est_xyz: np.ndarray, gt_xyz: np.ndarray,
                    align: bool = True, with_scale: bool = False) -> Dict[str, float]:
    """evo-style APE translation stats after Umeyama alignment.

    est_xyz, gt_xyz: [N, 3] associated positions (same indices).
    Returns dict with rmse/mean/median/min/max (metres).
    """
    est = np.asarray(est_xyz, dtype=np.float64)
    gt = np.asarray(gt_xyz, dtype=np.float64)
    assert est.shape == gt.shape and est.ndim == 2 and est.shape[1] == 3
    if align:
        s, R, t = umeyama_alignment(est, gt, with_scale)
        est = (s * (R @ est.T)).T + t
    err = np.linalg.norm(est - gt, axis=1)
    return {
        "rmse": float(np.sqrt(np.mean(err ** 2))),
        "mean": float(np.mean(err)),
        "median": float(np.median(err)),
        "min": float(np.min(err)),
        "max": float(np.max(err)),
    }


def keyframe_drift(est_xyz: np.ndarray, gt_xyz: np.ndarray) -> Dict[str, float]:
    """The loop bench's accuracy metrics (bench.py:334-346) of a keyframe
    trajectory: the ATE rmse, and the end drift, the last keyframe's error
    with the gauge fixed on the first quarter of the keyframes (at least
    4), where drift is still negligible. A global alignment would mostly
    measure the unobservable gauge; this measures the accumulated drift
    that loop closing is meant to remove.

    est_xyz, gt_xyz: [K, 3] associated keyframe positions (metres)."""
    q = max(4, len(gt_xyz) // 4)
    _, R, t = umeyama_alignment(est_xyz[:q], gt_xyz[:q])
    end = est_xyz[-1] @ R.T + t
    return {"ate_rmse_m": ape_translation(est_xyz, gt_xyz)["rmse"],
            "end_drift_m": float(np.linalg.norm(end - gt_xyz[-1]))}


def associate_by_timestamp(ts_a: np.ndarray, ts_b: np.ndarray,
                           max_diff: float = 0.02):
    """Greedy nearest-timestamp association. Returns (idx_a, idx_b)."""
    ia, ib = [], []
    j = 0
    for i, t in enumerate(ts_a):
        while j + 1 < len(ts_b) and abs(ts_b[j + 1] - t) <= abs(ts_b[j] - t):
            j += 1
        if abs(ts_b[j] - t) <= max_diff:
            ia.append(i)
            ib.append(j)
    return np.array(ia, dtype=np.int64), np.array(ib, dtype=np.int64)
