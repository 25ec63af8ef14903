"""The work a traced slice asked of the device, counted from the
settings, the engine's canvas and the frames' kinds, the same whatever
implements it: the bytes the LK pyramid levels need (each input read
once) and the least time they take at the card's published bandwidth.
"""

from __future__ import annotations

from typing import Iterable, Tuple

H100_HBM_BYTES_S = 3.35e12      # NVIDIA H100 SXM data sheet, 80 GB HBM3
PLANES = 4                      # prev, its x and y gradients, cur (float32)
F32 = 4


def lk_level_bytes(h: int, w: int, level: int, n_points: int,
                   window: int) -> int:
    """The bytes one LK level needs: the four float32 planes of the level,
    or the points' windows in them where those are fewer."""
    plane = PLANES * F32 * (h >> level) * (w >> level)
    return min(plane, PLANES * F32 * n_points * window * window)


def lk_frame_bytes(settings, h: int, w: int, tracked: bool, keyframe: bool,
                   n_points: int) -> int:
    """A frame's LK bytes: a tracked frame tracks its points forward and
    back over lk_levels levels; a keyframe matches them to the right image
    forward and back over lk_levels + 1."""
    total = 0
    if tracked:
        total += 2 * sum(lk_level_bytes(h, w, l, n_points, settings.lk_window)
                         for l in range(settings.lk_levels))
    if keyframe:
        total += 2 * sum(lk_level_bytes(h, w, l, n_points, settings.lk_window)
                         for l in range(settings.lk_levels + 1))
    return total


def lk_least_seconds(settings, h: int, w: int,
                     frames: Iterable[Tuple[bool, bool, int]]) -> float:
    """The least time of the LK levels of `frames`, each (tracked,
    keyframe, points), at the published HBM bandwidth."""
    return sum(lk_frame_bytes(settings, h, w, t, k, n)
               for t, k, n in frames) / H100_HBM_BYTES_S
