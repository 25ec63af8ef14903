"""Save and resume a SLAM session (port of `ssvio_tpu/utils/checkpoint.py`).

The engine's state round-trips through one compressed .npz with the JAX
package's keys: the map window, the feature state, the pose and relative
motion, the status, the host keyframe records and odometry edges, the
trajectory, and the last image (level 0 of the last pyramid, from which
the pyramid is rebuilt on load). Because the keys are the same, a
checkpoint carries a session from the JAX package to the port and back.
Loop-closing state (database, vocabulary) is not saved, as in the JAX
package.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ssvio_tpu_torch import frontend as fe
from ssvio_tpu_torch.map import MapState


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def save_checkpoint(system, path: str) -> None:
    """Serialize a System's SLAM state to `path` (.npz)."""
    meta = {
        "status": int(system.status),
        "frame_id": int(system.frame_id),
        "stats": {k: v for k, v in system.stats.items() if k != "track_ms"},
        **system.records.state(),
    }
    arrays = {f: _np(v) for f, v in zip(MapState._fields, system.map)}
    feat = system.feat
    arrays.update(
        T_cw=_np(system.T_cw), rel_motion=_np(system.rel_motion),
        feat_xy=_np(feat.xy), feat_lm_slot=_np(feat.lm_slot),
        feat_lm_gid=_np(feat.lm_gid), feat_valid=_np(feat.valid),
        feat_octave=_np(feat.octave),
        trajectory_ts=np.asarray([t for t, _, _ in system.trajectory]),
        trajectory_fid=np.asarray([f for _, f, _ in system.trajectory]),
        trajectory_T=(np.stack([T for _, _, T in system.trajectory])
                      if system.trajectory else np.zeros((0, 3, 4))),
        meta_json=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8))
    if system.last_pyr is not None:
        arrays["last_img"] = _np(system.last_pyr.levels[0])
    np.savez_compressed(path, **arrays)


def load_checkpoint(system, path: str) -> None:
    """Restore state saved by save_checkpoint (by either package) into a
    System of the same capacities; its tensors go to the System's device.
    The next run_step / run_chunk continues the session."""
    z = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(z["meta_json"]).decode())
    dev = system.device

    def t(key):
        return torch.as_tensor(np.array(z[key]), device=dev)

    system.map = MapState(*[t(f) for f in MapState._fields])
    system.T_cw = t("T_cw")
    system.rel_motion = t("rel_motion")
    system.feat = fe.FeatState(
        xy=t("feat_xy"), lm_slot=t("feat_lm_slot"), lm_gid=t("feat_lm_gid"),
        valid=t("feat_valid"),
        # checkpoints older than the octave field
        octave=(t("feat_octave") if "feat_octave" in z else
                torch.zeros(z["feat_valid"].shape, dtype=torch.int32,
                            device=dev)))
    system.status = int(meta["status"])
    system.frame_id = int(meta["frame_id"])
    system.stats.update(meta["stats"])
    system.records.load(meta)
    system.trajectory = [
        (float(ts), int(f), np.asarray(T))
        for ts, f, T in zip(z["trajectory_ts"], z["trajectory_fid"],
                            z["trajectory_T"])]
    system.last_pyr = (system.frontend._build_pyramid(t("last_img"))
                       if "last_img" in z else None)
