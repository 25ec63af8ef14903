"""TUM trajectory format export/import.

Capability parity with the reference's trajectory export
(reference src/ui/pangolin_window_impl.cpp:362-395): keyframe poses T_wc
sorted by id, written as `t x y z qx qy qz qw` lines.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _rotmat_to_quat_np(R: np.ndarray) -> np.ndarray:
    """[N,3,3] -> [N,4] (x,y,z,w) via scipy for host-side export."""
    from scipy.spatial.transform import Rotation
    return Rotation.from_matrix(R).as_quat()  # xyzw


def save_tum(path: str, timestamps: np.ndarray, poses_wc: np.ndarray) -> None:
    """Write TUM-format trajectory. poses_wc: [N, 3, 4] camera-to-world."""
    poses_wc = np.asarray(poses_wc, dtype=np.float64)
    R = poses_wc[:, :3, :3]
    t = poses_wc[:, :3, 3]
    q = _rotmat_to_quat_np(R)
    with open(path, "w") as f:
        for i in range(len(poses_wc)):
            f.write(f"{timestamps[i]:.6f} {t[i,0]:.7f} {t[i,1]:.7f} {t[i,2]:.7f} "
                    f"{q[i,0]:.7f} {q[i,1]:.7f} {q[i,2]:.7f} {q[i,3]:.7f}\n")


def load_tum(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read TUM trajectory -> (timestamps [N], poses_wc [N, 3, 4])."""
    from scipy.spatial.transform import Rotation
    data = np.loadtxt(path, dtype=np.float64)
    if data.ndim == 1:
        data = data[None]
    ts = data[:, 0]
    t = data[:, 1:4]
    q = data[:, 4:8]  # xyzw
    R = Rotation.from_quat(q).as_matrix()
    poses = np.concatenate([R, t[:, :, None]], axis=2)
    return ts, poses
