"""Loop closing, first part: the per-keyframe descriptor ladder (port of
`ssvio_tpu/loopclosing.py::loop_describe` and `pattern_from_settings`).

The `LoopClosing` class of the JAX package (database ingest, deferred
verification, the gates, map fusion, `relocalize`) and the engine's
`loop_desc` branch are the next slice of the port; the ops they stand on
are here already: `ops/orb.py`, `ops/fast.py::fast_check_sparse`,
`ops/bow.py`, `ops/pnp.py` and `ops/pgo.py`.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from ssvio_tpu_torch.config import Settings
from ssvio_tpu_torch.ops import fast, orb, pyramid, sampling


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
