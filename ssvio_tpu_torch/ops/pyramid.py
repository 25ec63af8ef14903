"""Image pyramids: Gaussian blur + downsampling (port of
`ssvio_tpu/ops/pyramid.py`).

- LK pyramid: power-of-two downsampling, `lk_levels` (+1 for stereo) deep.
- ORB detection pyramid: geometric `scale_factor` over `n_levels` octaves.

The blur is 2r+1 shifted weighted adds per direction on an edge-padded
image, as in the JAX package (a shift-add, not a convolution), so no cuDNN
convolution and no TF32 question arises here.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch


def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _edge_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Indices of an edge-padded axis: [-lo, n + hi) clamped into [0, n)."""
    return torch.clamp(torch.arange(-lo, n + hi, device=device), 0, n - 1)


def blur(img: torch.Tensor, sigma: float = 2.0, radius: int = 3) -> torch.Tensor:
    """Separable Gaussian blur of [H, W] with edge padding."""
    k = gaussian_kernel1d(sigma, radius)
    h, w = img.shape
    p = img[:, _edge_index(w, radius, radius, img.device)]
    x = sum(float(k[i]) * p[:, i:i + w] for i in range(2 * radius + 1))
    p = x[_edge_index(h, radius, radius, img.device)]
    return sum(float(k[i]) * p[i:i + h] for i in range(2 * radius + 1))


def _bilinear_resize_weights(src: int, dst: int, scale: float
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Precomputed (i0, i1, frac) for 1-D bilinear resampling at fixed scale."""
    coords = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    coords = np.clip(coords, 0.0, src - 1.0)
    i0 = np.floor(coords).astype(np.int64)
    i1 = np.minimum(i0 + 1, src - 1).astype(np.int64)
    frac = (coords - i0).astype(np.float32)
    return i0, i1, frac


@functools.lru_cache(maxsize=None)
def _resize_tables(h: int, w: int, out_h: int, out_w: int,
                   device: torch.device) -> Tuple[torch.Tensor, ...]:
    """resize_bilinear's index and weight tables on `device`, built once
    per (source, destination, device): a copy from pageable host memory
    on every call would be a host-to-device transfer that a CUDA graph
    cannot capture."""
    yi0, yi1, yf = _bilinear_resize_weights(h, out_h, h / out_h)
    xi0, xi1, xf = _bilinear_resize_weights(w, out_w, w / out_w)
    return (torch.from_numpy(yi0).to(device), torch.from_numpy(yi1).to(device),
            torch.from_numpy(xi0).to(device), torch.from_numpy(xi1).to(device),
            torch.from_numpy(yf).to(device)[:, None],
            torch.from_numpy(xf).to(device)[None, :])


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Static-shape bilinear resize of [H, W] -> [out_h, out_w]."""
    h, w = img.shape
    yi0, yi1, xi0, xi1, yf, xf = _resize_tables(h, w, out_h, out_w,
                                                img.device)
    top = img[yi0][:, xi0] * (1 - xf) + img[yi0][:, xi1] * xf
    bot = img[yi1][:, xi0] * (1 - xf) + img[yi1][:, xi1] * xf
    return top * (1 - yf) + bot * yf


def build_lk_pyramid(img: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """Power-of-two pyramid with light anti-alias blur per level (even rows
    and columns of the blurred level; dims must stay even)."""
    pyr = [img]
    cur = img
    for _ in range(1, levels):
        cur = blur(cur, sigma=1.0, radius=2)[::2, ::2].contiguous()
        pyr.append(cur)
    return pyr


def orb_pyramid_shapes(h: int, w: int, n_levels: int, scale_factor: float
                       ) -> List[Tuple[int, int]]:
    shapes = []
    for l in range(n_levels):
        s = scale_factor ** l
        shapes.append((max(16, int(round(h / s))), max(16, int(round(w / s)))))
    return shapes


def build_orb_pyramid(img: torch.Tensor, n_levels: int, scale_factor: float
                      ) -> List[torch.Tensor]:
    """Geometric-scale pyramid for multi-octave detection (reference
    ComputePyramid, orbextractor.cpp:993-1027), cascaded from the previous
    level after a light blur."""
    h, w = img.shape
    shapes = orb_pyramid_shapes(h, w, n_levels, scale_factor)
    pyr = [img]
    for l in range(1, n_levels):
        prev = blur(pyr[-1], sigma=0.8, radius=2)
        oh, ow = shapes[l]
        pyr.append(resize_bilinear(prev, oh, ow))
    return pyr


def sobel_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """3x3 Sobel gradients / 8 (intensity units per pixel), edge-padded.
    Returns (gx, gy), same shape as img."""
    h, w = img.shape
    p = img[_edge_index(h, 1, 1, img.device)][:, _edge_index(w, 1, 1, img.device)]
    gx = ((p[1:-1, 2:] - p[1:-1, :-2]) * 2 +
          (p[:-2, 2:] - p[:-2, :-2]) +
          (p[2:, 2:] - p[2:, :-2])) * 0.125
    gy = ((p[2:, 1:-1] - p[:-2, 1:-1]) * 2 +
          (p[2:, :-2] - p[:-2, :-2]) +
          (p[2:, 2:] - p[:-2, 2:])) * 0.125
    return gx, gy
