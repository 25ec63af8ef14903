"""The host's keyframe records and the gauge they are written in, owned
here for the System, the loop closer and the checkpoint.

A record is a dict {gid, frame_id, timestamp, T_cw [3, 4] np}, kept in
insertion order and indexed by gid. An odometry edge (gid_prev, gid, Z)
holds Z = T_cw T_cw_prev^-1 of two consecutive records as inserted: local
BA moves a record (`refresh`), never its edge; PGO rewrites the records.

The gauge: a loop correction moves the live map rigidly, every T_cw to
T_cw C (`add_gauge_event`). A pose taken before it (by a chunk in flight,
or a keyframe whose verification was deferred) is in the old gauge.
`gauge_index()` names the gauge of now; `regauge(T, i)` carries poses
taken at index i into the live gauge, the events since i right-composed
in order (a rigid C cancels in an edge's Z); `owed(C, i)` is what a
correction C computed in gauge i still owes the live map:
regauge(T, i) owed(C, i) = T C.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ssvio_tpu_torch.ops import se3


class KeyframeRecords:
    def __init__(self):
        self.keyframes: List[dict] = []
        self.by_gid: Dict[int, dict] = {}          # the same dicts
        self.odometry_edges: List[tuple] = []
        self.gauge_events: List[np.ndarray] = []   # C [3, 4], in order

    def add(self, gid: int, timestamp: float, T_cw: np.ndarray,
            frame_id: int, odometry_edge: bool = True):
        """Record a keyframe at pose T_cw, with an odometry edge to the
        previous record unless odometry_edge is False."""
        rec = {"gid": gid, "frame_id": frame_id, "timestamp": timestamp,
               "T_cw": T_cw}
        self.keyframes.append(rec)
        self.by_gid[gid] = rec
        if odometry_edge and len(self.keyframes) > 1:
            prev = self.keyframes[-2]
            Z = se3.compose_np(T_cw, se3.inverse_np(prev["T_cw"]))
            self.odometry_edges.append((prev["gid"], gid, Z))

    def refresh(self, kf_gid, kf_valid, kf_pose):
        """The window's poses (host arrays) for the records of its valid
        keyframes, by gid: distance-based eviction can keep an old one."""
        for g, valid, T in zip(kf_gid, kf_valid, kf_pose):
            rec = self.by_gid.get(int(g)) if valid else None
            if rec is not None:
                rec["T_cw"] = T

    def pose(self, gid: int) -> np.ndarray:
        """T_cw of a keyframe by gid (KeyError where none is recorded)."""
        return self.by_gid[gid]["T_cw"]

    def gids(self) -> List[int]:
        return [rec["gid"] for rec in self.keyframes]

    def poses(self) -> List[np.ndarray]:
        return [rec["T_cw"] for rec in self.keyframes]

    def set_poses(self, poses):
        """The records take the poses [>= n, 3, 4], in order."""
        for rec, T in zip(self.keyframes, poses):
            rec["T_cw"] = T

    def centres(self) -> np.ndarray:
        """The keyframes' camera centres in the world, [n, 3]."""
        return np.stack([-T[:, :3].T @ T[:, 3] for T in self.poses()]) \
            if self.keyframes else np.zeros((0, 3))

    def trajectory(self):
        """(timestamps [n], poses T_wc [n, 3, 4]) of the keyframes."""
        ts = np.array([rec["timestamp"] for rec in self.keyframes])
        poses = np.stack([se3.inverse_np(T) for T in self.poses()]) \
            if self.keyframes else np.zeros((0, 3, 4))
        return ts, poses

    # ------------------------------------------------------------------
    def gauge_index(self) -> int:
        return len(self.gauge_events)

    def regauge(self, T_cw: np.ndarray, since: int) -> np.ndarray:
        """Poses [..., 3, 4] taken at gauge index `since`, in the live
        gauge."""
        for C in self.gauge_events[since:]:
            T_cw = se3.compose_np(T_cw, C)
        return T_cw

    def owed(self, C: np.ndarray, since: int) -> np.ndarray:
        """What the correction C, computed in the gauge at index `since`,
        still owes the live map: (C_since+1 ... C_now)^-1 C."""
        moved = self.regauge(np.eye(3, 4, dtype=C.dtype), since)
        return se3.compose_np(se3.inverse_np(moved), C)

    def add_gauge_event(self, C: np.ndarray):
        self.gauge_events.append(C)

    # ------------------------------------------------------------------
    def state(self) -> dict:
        """The records and odometry edges under a checkpoint's JSON keys
        (both packages')."""
        return {"keyframes": [
                    {"gid": int(k["gid"]), "frame_id": int(k["frame_id"]),
                     "timestamp": float(k["timestamp"]),
                     "T_cw": np.asarray(k["T_cw"]).tolist()}
                    for k in self.keyframes],
                "kf_rel_edges": [
                    {"a": int(a), "b": int(b), "Z": np.asarray(Z).tolist()}
                    for a, b, Z in self.odometry_edges]}

    def load(self, state: dict):
        """The records, their gid index (which the JAX package's loader
        leaves empty) and the odometry edges of a checkpoint's state()."""
        self.keyframes = [dict(k, T_cw=np.asarray(k["T_cw"], np.float32))
                          for k in state["keyframes"]]
        self.by_gid = {k["gid"]: k for k in self.keyframes}
        self.odometry_edges = [(e["a"], e["b"], np.asarray(e["Z"], np.float32))
                               for e in state["kf_rel_edges"]]
