"""Batched image sampling primitives (port of `ssvio_tpu/ops/sampling.py`).

Out-of-bounds positions clamp to the border; callers gate validity
separately so clamped taps never influence accepted results.
"""

from __future__ import annotations

import torch


def gather_nn(img: torch.Tensor, pts_xy: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbor sample. img [H, W]; pts_xy [..., 2] (x, y) -> [...]."""
    h, w = img.shape
    x = torch.clamp(torch.round(pts_xy[..., 0]).long(), 0, w - 1)
    y = torch.clamp(torch.round(pts_xy[..., 1]).long(), 0, h - 1)
    return img.reshape(-1)[y * w + x]


def gather_bilinear(img: torch.Tensor, pts_xy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample. img [H, W]; pts_xy [..., 2] (x, y) -> [...] float32."""
    h, w = img.shape
    x = pts_xy[..., 0]
    y = pts_xy[..., 1]
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = torch.clamp(x0f.long(), 0, w - 1)
    y0 = torch.clamp(y0f.long(), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    flat = img.reshape(-1)
    top = flat[y0 * w + x0] * (1 - fx) + flat[y0 * w + x1] * fx
    bot = flat[y1 * w + x0] * (1 - fx) + flat[y1 * w + x1] * fx
    return top * (1 - fy) + bot * fy


def in_bounds(pts_xy: torch.Tensor, h: int, w: int,
              border: float = 0.0) -> torch.Tensor:
    """[..., 2] -> [...] bool, True if inside [border, dim-1-border]."""
    x, y = pts_xy[..., 0], pts_xy[..., 1]
    return ((x >= border) & (x <= w - 1 - border) &
            (y >= border) & (y <= h - 1 - border))
