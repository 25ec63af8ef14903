"""FAST corner detection — dense, branch-free, whole-image (port of
`ssvio_tpu/ops/fast.py`).

The ring test runs for every pixel at once as 16 shifted-image comparisons;
arc contiguity is a bitmask test (pack the 16 comparisons, duplicate them
as m | m << 16, and AND 8 shifts). Grid-cell top-K selection stands in for
the reference's quad-tree spread.

Selection order matches `lax.top_k`, which returns the lower index first
among equal values: every top-k here is a STABLE descending sort, since
`torch.topk` leaves the order of ties unspecified (and it differs between
CPU and CUDA). The bit masks are int64 (torch has few uint32 ops); the
16-bit ring doubled to 32 bits fits without sign trouble.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ssvio_tpu_torch.ops import pyramid as pyrmod

# Bresenham circle of radius 3 — the 16-point FAST ring (dy, dx), from
# 12 o'clock clockwise (FAST-9/16)
RING_OFFSETS = np.array([
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
], dtype=np.int32)

ARC_LEN = 9  # FAST-9: need >= 9 contiguous ring pixels brighter/darker


def _shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = img[y + dy, x + dx], edge-padded."""
    h, w = img.shape
    rows = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    cols = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img[rows][:, cols]


def _has_contiguous_run(mask_bits: torch.Tensor, run: int) -> torch.Tensor:
    """mask_bits: int64 [...] with 16 ring bits set. True if any circular
    window of `run` consecutive bits is all ones."""
    m = mask_bits | (mask_bits << 16)  # unwrap the circle
    acc = m
    for s in range(1, run):
        acc = acc & (m >> s)
    return acc != 0


def _arc_mask(cmp: torch.Tensor) -> torch.Tensor:
    bits = torch.zeros(cmp.shape[1:], dtype=torch.int64, device=cmp.device)
    for i in range(16):
        bits = bits | (cmp[i].to(torch.int64) << i)
    return _has_contiguous_run(bits, ARC_LEN)


def fast_score_maps(img: torch.Tensor, thresholds) -> list:
    """FAST-9 response maps of [H, W], one per threshold, sharing the 16
    ring shifts. Score = max over (bright, dark) of the sum of
    |ring - center| - t over the qualifying ring pixels; non-corners 0."""
    center = img
    ring = torch.stack([_shift2d(img, int(dy), int(dx))
                        for dy, dx in RING_OFFSETS])
    h, w = img.shape
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    border = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    out = []
    for threshold in thresholds:
        t = float(threshold)
        brighter = ring > (center + t)[None]          # [16, H, W]
        darker = ring < (center - t)[None]
        diff = torch.abs(ring - center[None]) - t
        bright_score = torch.sum(torch.where(brighter, diff, zero), dim=0)
        dark_score = torch.sum(torch.where(darker, diff, zero), dim=0)
        score = torch.maximum(torch.where(_arc_mask(brighter), bright_score, zero),
                              torch.where(_arc_mask(darker), dark_score, zero))
        out.append(torch.where(border, score, zero))  # ring reads padding
    return out


def fast_check_sparse(img: torch.Tensor, xy: torch.Tensor,
                      threshold: float) -> torch.Tensor:
    """Per-keypoint FAST-9 ring test at given (sub)pixel positions, the
    sparse form of the dense detector's test (the loop ladder's per-octave
    re-screen): rounds xy [N, 2] to pixels, gathers the 16-point ring and
    the centre, and runs the same bitmask contiguous-arc test. Points
    within 3 px of the border fail. Returns [N] bool."""
    h, w = img.shape
    ix = torch.round(xy[..., 0]).long()
    iy = torch.round(xy[..., 1]).long()
    inb = (ix >= 3) & (ix < w - 3) & (iy >= 3) & (iy < h - 3)
    ixc = torch.clamp(ix, 3, w - 4)
    iyc = torch.clamp(iy, 3, h - 4)
    center = img[iyc, ixc]                                   # [N]
    ring = torch.stack([img[iyc + int(dy), ixc + int(dx)]
                        for dy, dx in RING_OFFSETS])         # [16, N]
    t = float(threshold)
    return inb & (_arc_mask(ring > (center + t)[None])
                  | _arc_mask(ring < (center - t)[None]))


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep scores that are >= every neighbor of their 3x3 neighborhood."""
    neigh = torch.stack([_shift2d(score, dy, dx)
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                         if not (dy == 0 and dx == 0)])
    is_max = score >= torch.max(neigh, dim=0).values
    return torch.where(is_max, score, torch.zeros_like(score))


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k` over the last axis: descending, lower index first among
    ties (stable sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _pad_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad the leading axis to n rows."""
    if t.shape[0] >= n:
        return t
    return torch.cat([t, t.new_zeros((n - t.shape[0], *t.shape[1:]))])


def detect_grid(img: torch.Tensor, max_kps: int, cell: int = 32,
                ini_threshold: float = 20.0, min_threshold: float = 7.0,
                occupancy: torch.Tensor | None = None,
                kps_per_cell: int = 4,
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Grid-distributed FAST detection over a full image with the
    reference's two-threshold fallback per cell (orbextractor.cpp:616-627),
    top `kps_per_cell` NMS survivors per cell, then the global top
    `max_kps` by response. `occupancy` [H, W] bool blocks pixels.

    Returns (xy [max_kps, 2] float32, response [max_kps], valid [max_kps])."""
    h, w = img.shape
    raw_hi, raw_lo = fast_score_maps(img, [ini_threshold, min_threshold])
    score_hi = nms3x3(raw_hi)
    score_lo = nms3x3(raw_lo)
    if occupancy is not None:
        score_hi = torch.where(occupancy, 0.0, score_hi)
        score_lo = torch.where(occupancy, 0.0, score_lo)

    H = -(-h // cell) * cell
    W = -(-w // cell) * cell
    score_hi = F.pad(score_hi, (0, W - w, 0, H - h))
    score_lo = F.pad(score_lo, (0, W - w, 0, H - h))
    ny, nx = H // cell, W // cell

    def cells(s):
        return s.reshape(ny, cell, nx, cell).permute(0, 2, 1, 3) \
            .reshape(ny * nx, cell * cell)

    c_hi = cells(score_hi)
    c_lo = cells(score_lo)
    use_lo = torch.max(c_hi, dim=1, keepdim=True).values <= 0.0
    c = torch.where(use_lo, c_lo, c_hi)

    vals, idx = top_k(c, kps_per_cell)                   # [C, k]
    cell_ids = torch.arange(ny * nx, device=img.device)
    py = ((cell_ids // nx) * cell)[:, None] + idx // cell
    px = ((cell_ids % nx) * cell)[:, None] + idx % cell
    flat_vals = vals.reshape(-1)
    k = min(max_kps, flat_vals.shape[0])
    top_vals, top_idx = top_k(flat_vals, k)
    sel_y = py.reshape(-1)[top_idx]
    sel_x = px.reshape(-1)[top_idx]
    valid = top_vals > 0.0
    xy = torch.stack([sel_x.to(torch.float32), sel_y.to(torch.float32)], dim=-1)
    return (_pad_rows(xy, max_kps), _pad_rows(top_vals, max_kps),
            _pad_rows(valid, max_kps))


def detect_multiscale(pyr, scale_factor: float, max_kps: int,
                      cell: int = 32, ini_threshold: float = 20.0,
                      min_threshold: float = 7.0,
                      occupancy: torch.Tensor | None = None,
                      kps_per_cell: int = 4, dedupe_cell: int = 4,
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """Scale-covariant grid FAST over a geometric pyramid (reference
    ComputeKeyPointsOctTree, orbextractor.cpp:572-676): per-octave
    detect_grid with a budget proportional to 1/scale^l, keypoints mapped
    to level 0, cross-octave duplicates resolved by a scatter-max over a
    `dedupe_cell`-px level-0 grid (first index wins exact ties).

    Returns (xy0 [max_kps, 2], response [max_kps], octave [max_kps] int32,
    valid [max_kps])."""
    L = len(pyr)
    h0, w0 = pyr[0].shape
    dev = pyr[0].device
    inv = np.array([scale_factor ** -l for l in range(L)])
    budgets = [max(8, int(round(max_kps * wl))) for wl in inv / inv.sum()]

    xs, rs, os_, vs = [], [], [], []
    for l in range(L):
        img = pyr[l]
        s = float(scale_factor ** l)
        occ_l = None
        if occupancy is not None:
            if l == 0:
                occ_l = occupancy
            else:
                hl, wl = img.shape
                occ_l = pyrmod.resize_bilinear(
                    occupancy.to(torch.float32), hl, wl) > 0.25
        xy_l, resp_l, val_l = detect_grid(
            img, max_kps=budgets[l], cell=cell,
            ini_threshold=ini_threshold, min_threshold=min_threshold,
            occupancy=occ_l, kps_per_cell=kps_per_cell)
        xs.append(xy_l * s)
        rs.append(resp_l)
        os_.append(torch.full((budgets[l],), l, dtype=torch.int32, device=dev))
        vs.append(val_l)
    xy0 = torch.cat(xs)
    resp = torch.where(torch.cat(vs), torch.cat(rs), 0.0)
    octv = torch.cat(os_)

    # cross-octave dedupe: best response per dedupe_cell wins
    gx = torch.clamp(xy0[:, 0].to(torch.int64) // dedupe_cell, 0,
                     w0 // dedupe_cell)
    gy = torch.clamp(xy0[:, 1].to(torch.int64) // dedupe_cell, 0,
                     h0 // dedupe_cell)
    nx = w0 // dedupe_cell + 1
    gi = gy * nx + gx
    order_eps = torch.arange(resp.shape[0], dtype=resp.dtype, device=dev) * 1e-6
    keyed = torch.where(resp > 0, resp - order_eps, 0.0)
    gbest = torch.zeros(((h0 // dedupe_cell + 1) * nx,), dtype=resp.dtype,
                        device=dev).scatter_reduce(0, gi, keyed, "amax")
    win = (keyed >= gbest[gi]) & (resp > 0)
    resp_d = torch.where(win, resp, 0.0)

    k = min(max_kps, resp_d.shape[0])
    top_vals, top_idx = top_k(resp_d, k)
    out_xy = xy0[top_idx]
    out_oct = octv[top_idx]
    valid = top_vals > 0.0
    return (_pad_rows(out_xy, max_kps), _pad_rows(top_vals, max_kps),
            _pad_rows(out_oct, max_kps), _pad_rows(valid, max_kps))


def build_occupancy(h: int, w: int, xy: torch.Tensor, valid: torch.Tensor,
                    radius: int = 10) -> torch.Tensor:
    """Rasterize feature positions into a blocked mask dilated to +-radius
    (the reference masks a 20x20 rect around each feature,
    frontend.cpp:304-312): scatter-add + separable box max."""
    ix = torch.clamp(torch.round(xy[:, 0]).long(), 0, w - 1)
    iy = torch.clamp(torch.round(xy[:, 1]).long(), 0, h - 1)
    base = torch.zeros((h, w), dtype=torch.float32, device=xy.device)
    base.index_put_((iy, ix), valid.to(torch.float32), accumulate=True)
    p = F.pad(base, (0, 0, radius, radius))
    occ = p[0:h]
    for i in range(1, 2 * radius + 1):
        occ = torch.maximum(occ, p[i:i + h])
    p = F.pad(occ, (radius, radius))
    occ = p[:, 0:w]
    for i in range(1, 2 * radius + 1):
        occ = torch.maximum(occ, p[:, i:i + w])
    return occ > 0.0
