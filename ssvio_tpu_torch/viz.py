"""Host-side visualization: trajectory / map snapshots and live view (port
of `ssvio_tpu/viz.py`).

The reference's Pangolin UI (reference src/ui/pangolin_window_impl.cpp):
3D map view with keyframe frusta and the landmark cloud
(RenderMapFrameAndMapPoint :251-281, DrawFrame :311-360), the current
stereo image pair (:174-228), the per-axis orientation plot (:291-297),
and TUM trajectory export (SaveTrajectoryTUM :362-395, in dataio/tum.py
and System.save_trajectory_tum).

Visualization is host work: the viewer reads the System's state (tensors
are copied to numpy first) and never runs on the device. Two modes:
- `snapshot(...)`: a matplotlib figure (headless `Agg`) written to a PNG.
- `LiveViewer`: an interactive window (matplotlib), updated per call.
matplotlib is imported inside the functions: the GPU's host has none, and
importing this module must not need it.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _matplotlib(headless: bool):
    import matplotlib
    if headless or not os.environ.get("DISPLAY"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _frustum_segments(T_wc: np.ndarray, scale: float = 0.6) -> np.ndarray:
    """Line segments [16, 2, 3] of a camera frustum at pose T_wc [3,4]
    (the wireframe the reference draws per keyframe, DrawFrame :311-360)."""
    w, h, z = 0.5 * scale, 0.3 * scale, 0.4 * scale
    c = np.zeros(3)
    tl, tr = np.array([-w, -h, z]), np.array([w, -h, z])
    bl, br = np.array([-w, h, z]), np.array([w, h, z])
    pts = [(c, tl), (c, tr), (c, bl), (c, br),
           (tl, tr), (tr, br), (br, bl), (bl, tl)]
    R, t = T_wc[:, :3], T_wc[:, 3]
    return np.array([[R @ a + t, R @ b + t] for a, b in pts])


def plot_map(ax, kf_poses_wc: np.ndarray, cloud: Optional[np.ndarray] = None,
             trajectory: Optional[np.ndarray] = None,
             gt: Optional[np.ndarray] = None, frustum_every: int = 5):
    """Draw the map top-down (x-z plane, KITTI convention y = down)."""
    if cloud is not None and len(cloud):
        ax.scatter(cloud[:, 0], cloud[:, 2], s=0.5, c=-cloud[:, 1],
                   cmap="viridis", alpha=0.5, label=None)
    if trajectory is not None and len(trajectory):
        ax.plot(trajectory[:, 0], trajectory[:, 2], "b-", lw=1.2,
                label="estimate")
    if gt is not None and len(gt):
        ax.plot(gt[:, 0], gt[:, 2], "k--", lw=1.0, alpha=0.7,
                label="ground truth")
    for i in range(0, len(kf_poses_wc), max(1, frustum_every)):
        for a, b in _frustum_segments(kf_poses_wc[i]):
            ax.plot([a[0], b[0]], [a[2], b[2]], "g-", lw=0.4, alpha=0.6)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    if trajectory is not None or gt is not None:
        ax.legend(loc="best", fontsize=8)


def plot_stereo(ax_l, ax_r, system):
    """Latest stereo pair with tracked features overlaid (the reference's
    live image textures + keypoints, pangolin_window_impl.cpp:174-228).
    No-op (hidden axes) when no frame has been processed yet."""
    for ax in (ax_l, ax_r):
        ax.set_xticks([])
        ax.set_yticks([])
    if system.last_stereo is None:
        ax_l.set_visible(False)
        ax_r.set_visible(False)
        return
    img_l, img_r = system.last_stereo
    rw, rh = system.frontend.rw, system.frontend.rh
    L = _host(img_l).astype(np.float32)[:rh, :rw]
    ax_l.imshow(L, cmap="gray", vmin=0, vmax=255)
    xy = _host(system.feat.xy)
    valid = _host(system.feat.valid)
    if valid.any():
        ax_l.scatter(xy[valid, 0], xy[valid, 1], s=3, c="lime",
                     marker="o", linewidths=0)
    ax_l.set_title(f"left — {int(valid.sum())} tracked", fontsize=8)
    if img_r is not None:
        R = _host(img_r).astype(np.float32)[:rh, :rw]
        ax_r.imshow(R, cmap="gray", vmin=0, vmax=255)
        ax_r.set_title("right", fontsize=8)
    else:
        ax_r.set_visible(False)


def snapshot(system, path: str, gt_poses_wc: Optional[np.ndarray] = None,
             title: Optional[str] = None):
    """Render the current system state (latest stereo pair with tracked
    features + map/trajectory) to an image file."""
    plt = _matplotlib(headless=True)
    ts, kf_wc = system.keyframe_trajectory()
    _, frame_wc = system.frame_trajectory()
    cloud = cloud_of(system)

    fig = plt.figure(figsize=(8, 10))
    gs = fig.add_gridspec(2, 2, height_ratios=[1, 2.6])
    ax_l = fig.add_subplot(gs[0, 0])
    ax_r = fig.add_subplot(gs[0, 1])
    ax = fig.add_subplot(gs[1, :])
    plot_stereo(ax_l, ax_r, system)
    plot_map(ax, kf_wc, cloud=cloud,
             trajectory=frame_wc[:, :, 3] if len(frame_wc) else None,
             gt=gt_poses_wc[:, :, 3] if gt_poses_wc is not None else None)
    ax.set_title(title or f"ssvio_tpu_torch map — {len(kf_wc)} keyframes, "
                          f"{len(cloud)} active landmarks")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def cloud_of(system) -> np.ndarray:
    """Active landmark cloud [M, 3] (the reference renders active
    mappoints, RenderMapFrameAndMapPoint :251-281)."""
    lm = _host(system.map.lm_pos)
    valid = _host(system.map.lm_valid)
    return lm[valid]


def euler_of(T_wc: np.ndarray) -> np.ndarray:
    """(yaw, pitch, roll) from a [3,4] pose — the reference plots these live
    (pangolin_window_impl.cpp:291-297)."""
    R = T_wc[:3, :3]
    yaw = np.arctan2(R[0, 2], R[2, 2])
    pitch = np.arcsin(np.clip(-R[1, 2], -1.0, 1.0))
    roll = np.arctan2(R[1, 0], R[1, 1])
    return np.array([yaw, pitch, roll])


class LiveViewer:
    """Interactive per-keyframe viewer (optional; the reference's render
    thread analog). Call `update(system)` from the driver loop."""

    def __init__(self, update_every: int = 1):
        self.plt = _matplotlib(headless=False)
        self.fig = self.plt.figure(figsize=(12, 8))
        gs = self.fig.add_gridspec(2, 2, height_ratios=[1, 2])
        self.ax_l = self.fig.add_subplot(gs[0, 0])
        self.ax_r = self.fig.add_subplot(gs[0, 1])
        self.ax_map = self.fig.add_subplot(gs[1, 0])
        self.ax_euler = self.fig.add_subplot(gs[1, 1])
        self.update_every = update_every
        self._n = 0
        self._eulers: list = []

    def update(self, system, gt_poses_wc: Optional[np.ndarray] = None):
        self._n += 1
        _, frame_wc = system.frame_trajectory()
        if len(frame_wc):
            self._eulers.append(euler_of(frame_wc[-1]))
        if self._n % self.update_every:
            return
        self.ax_map.clear()
        ts, kf_wc = system.keyframe_trajectory()
        plot_map(self.ax_map, kf_wc, cloud=cloud_of(system),
                 trajectory=frame_wc[:, :, 3] if len(frame_wc) else None,
                 gt=gt_poses_wc[:, :, 3] if gt_poses_wc is not None else None)
        self.ax_l.clear()
        self.ax_r.clear()
        self.ax_l.set_visible(True)
        self.ax_r.set_visible(True)
        plot_stereo(self.ax_l, self.ax_r, system)
        self.ax_euler.clear()
        e = np.array(self._eulers)
        for i, name in enumerate(("yaw", "pitch", "roll")):
            self.ax_euler.plot(e[:, i], label=name, lw=0.8)
        self.ax_euler.legend(loc="best", fontsize=8)
        self.ax_euler.set_xlabel("frame")
        self.ax_euler.set_ylabel("rad")
        self.plt.pause(0.001)

    def close(self):
        self.plt.close(self.fig)
