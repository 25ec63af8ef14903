"""Oriented BRIEF (ORB-style) descriptors, batched over keypoints (port of
`ssvio_tpu/ops/orb.py`).

Intensity-centroid orientation over a radius-15 circular patch, then a
256-pair steered binary test packed into 32 bytes, and popcount Hamming
matching. The sampling patterns are procedural and seeded (numpy), the
tables of the JAX package bit for bit; no external table is needed.

Descriptors are [N, 8] **int32** holding the bits of the JAX package's
uint32 words: torch's uint32 has almost no ops. `interop.descriptors`
converts with a view, so bit k of word w means the same on both sides.
Shifts on int32 are arithmetic, so the popcount masks every shifted value
to clear the sign extension. The [Na, Nb, 8] broadcast of a distance matrix
is never materialised: the popcount is accumulated word by word, 8 passes
of [Na, Nb], which gives the same integers.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ssvio_tpu_torch.ops import sampling

PATCH_RADIUS = 15          # IC-angle circular patch radius
DESC_BITS = 256
DESC_WORDS = 8             # 32-bit words per descriptor


@functools.lru_cache()
def brief_pattern(seed: int = 1234) -> np.ndarray:
    """[256, 4] int8 sampling pairs (x1, y1, x2, y2) in a 31x31 patch:
    Gaussian i.i.d. pairs (sigma = patch/5 = 6.2) clipped to +-13 so that
    rotated taps stay inside the window at any angle."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, 6.2, size=(DESC_BITS * 4, 2))
    pts = np.clip(np.round(pts), -13, 13).astype(np.int8)
    pairs = pts.reshape(DESC_BITS * 2, 4)
    # drop degenerate pairs (identical endpoints), keep the first 256
    good = pairs[(pairs[:, 0] != pairs[:, 2]) | (pairs[:, 1] != pairs[:, 3])]
    assert len(good) >= DESC_BITS
    return good[:DESC_BITS]


@functools.lru_cache()
def _ic_angle_offsets() -> Tuple[np.ndarray, np.ndarray]:
    """Circular-patch tap offsets [(K, 2) int32 (dx, dy)] and as float32."""
    r = PATCH_RADIUS
    ys, xs = np.mgrid[-r:r + 1, -r:r + 1]
    mask = (xs ** 2 + ys ** 2) <= r ** 2
    offs = np.stack([xs[mask], ys[mask]], axis=-1).astype(np.int32)
    return offs, offs.astype(np.float32)


def ic_angle(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation per keypoint: atan2(m01, m10) over
    the circular radius-15 patch. img [H, W] float32; xy [N, 2] -> [N]."""
    _, offs_f = _ic_angle_offsets()
    offs = torch.from_numpy(offs_f).to(img.device)
    vals = sampling.gather_nn(img, xy[:, None, :] + offs)       # [N, K]
    m10 = torch.sum(vals * offs[None, :, 0], dim=1)
    m01 = torch.sum(vals * offs[None, :, 1], dim=1)
    return torch.atan2(m01, m10)


@functools.lru_cache()
def _moment_kernel() -> np.ndarray:
    """[2, 1, 31, 31] kernel of the (m10, m01) patch moments, for a
    cross-correlation: moment(x) = sum_o img(x + o) k(o) with k(o) = o."""
    r = PATCH_RADIUS
    ys, xs = np.mgrid[-r:r + 1, -r:r + 1]
    mask = (xs ** 2 + ys ** 2) <= r ** 2
    kx = np.where(mask, xs, 0).astype(np.float32)
    ky = np.where(mask, ys, 0).astype(np.float32)
    return np.stack([kx, ky])[:, None]


def ic_angle_conv(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """ic_angle via two whole-image moment convolutions and one gather per
    keypoint per moment. `conv2d` is a cross-correlation, as XLA's conv is,
    so the kernel is not flipped. Equal to ic_angle up to summation order
    where the full patch is in bounds; border keypoints differ (zero pad
    against clamp) and descriptor validity excludes them."""
    k = torch.from_numpy(_moment_kernel()).to(img.device)
    m = F.conv2d(img[None, None], k, padding=PATCH_RADIUS)
    c = torch.round(xy)
    m10 = sampling.gather_nn(m[0, 0], c)
    m01 = sampling.gather_nn(m[0, 1], c)
    return torch.atan2(m01, m10)


@functools.lru_cache()
def _circle_rows() -> Tuple[np.ndarray, np.ndarray]:
    """Per-row (dy, halfwidth) of the radius-15 circular patch: the tap set
    of _ic_angle_offsets, row by row."""
    r = PATCH_RADIUS
    dys = np.arange(-r, r + 1, dtype=np.int32)
    ws = np.floor(np.sqrt(float(r * r) - dys.astype(np.float64) ** 2) + 1e-9
                  ).astype(np.int32)
    return dys, ws


def ic_angle_integral(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """ic_angle via row-wise integral images: 4 gathers per patch row
    instead of one per tap (124 against ~709 a keypoint).

      S(dy)  = sum_{|dx| <= w(dy)} img[cy + dy, cx + dx]  (prefix-sum diff)
      Sx(dy) = sum (cx + dx) img[...]                     (first-moment prefix)
      m01 = sum dy S(dy),  m10 = sum (Sx(dy) - cx S(dy))

    The float32 prefix sums reach ~4e8 at KITTI width and their differences
    depend on the order of `cumsum`, which differs between XLA, torch on
    the CPU and torch's scan on the card: the angle agrees with ic_angle
    and with the JAX package within a tolerance, not bit for bit."""
    H, W = img.shape
    dev = img.device
    z = torch.zeros((H, 1), dtype=img.dtype, device=dev)
    II = torch.cat([z, torch.cumsum(img, dim=1)], dim=1)         # [H, W+1]
    xs = torch.arange(W, dtype=img.dtype, device=dev)
    Ix = torch.cat([z, torch.cumsum(img * xs[None, :], dim=1)], dim=1)
    dys, ws = _circle_rows()
    dys_d = torch.from_numpy(dys).to(dev).long()
    ws_d = torch.from_numpy(ws).to(dev).long()
    c = torch.round(xy).long()
    cy = torch.clamp(c[:, 1:2] + dys_d[None, :], 0, H - 1)       # [N, 31]
    lo = torch.clamp(c[:, 0:1] - ws_d[None, :], 0, W)
    hi = torch.clamp(c[:, 0:1] + ws_d[None, :] + 1, 0, W)
    base = cy * (W + 1)
    fII = II.reshape(-1)
    fIx = Ix.reshape(-1)
    S = fII[base + hi] - fII[base + lo]
    Sx = fIx[base + hi] - fIx[base + lo]
    m01 = torch.sum(S * dys_d.to(img.dtype)[None, :], dim=1)
    m10 = torch.sum(Sx - c[:, 0:1].to(img.dtype) * S, dim=1)
    return torch.atan2(m01, m10)


def load_pattern_file(path: str) -> np.ndarray:
    """Load an external 256-pair BRIEF sampling pattern: 1024
    whitespace-separated integers (x1 y1 x2 y2 per pair, any line
    structure; '#' and '//' comments and ',' or ';' separators tolerated),
    as ORB-SLAM's `bit_pattern_31_` initializer prints. Returns [256, 4]
    int8."""
    nums = []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].split("//")[0]
            for tok in line.replace(",", " ").replace(";", " ").split():
                nums.append(int(tok))
    arr = np.asarray(nums, np.int32)
    if arr.size != DESC_BITS * 4:
        raise ValueError(
            f"BRIEF pattern file {path!r} holds {arr.size} ints; need "
            f"{DESC_BITS * 4} (256 pairs x 4 coords)")
    if np.abs(arr).max() > 15:
        raise ValueError(
            "pattern coordinates must lie in [-15, 15] (a 31x31 patch)")
    return arr.reshape(DESC_BITS, 4).astype(np.int8)


@functools.lru_cache()
def _bit_weights() -> np.ndarray:
    """[32] int32 with bit k set in entry k (entry 31 is -2^31): any sum of
    a subset stays inside int32, so packing cannot overflow in any order."""
    return (np.uint32(1) << np.arange(32, dtype=np.uint32)).view(np.int32)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[N, 256] bool -> [N, 8] int32, bit k of word w = bits[:, 32 w + k]
    (little-endian within words, as the JAX package packs uint32)."""
    w = torch.from_numpy(_bit_weights()).to(bits.device)
    b = bits.reshape(-1, DESC_WORDS, 32).to(torch.int32)
    return torch.sum(b * w[None, None, :], dim=-1, dtype=torch.int32)


def _rotated_taps(px, py, xy, angle):
    """Pattern points (px, py) [P] rotated by each keypoint's angle and
    moved to its position: [N, P, 2]."""
    ca = torch.cos(angle)[:, None]
    sa = torch.sin(angle)[:, None]
    x = px[None, :] * ca - py[None, :] * sa
    y = px[None, :] * sa + py[None, :] * ca
    return torch.stack([xy[:, None, 0] + x, xy[:, None, 1] + y], dim=-1)


def compute_descriptors(img_blurred: torch.Tensor, xy: torch.Tensor,
                        angle: torch.Tensor, seed: int = 1234,
                        pattern: np.ndarray | None = None) -> torch.Tensor:
    """Steered-BRIEF descriptors with 512 independent endpoints.

    img_blurred [H, W] float32, pre-blurred; xy [N, 2] in this image's
    scale; angle [N] radians; `pattern` an optional [256, 4] table
    (load_pattern_file), else the seeded procedural one. Returns [N, 8]
    int32 (256 bits, little-endian within words)."""
    pat_np = brief_pattern(seed) if pattern is None else np.asarray(pattern)
    pat = torch.from_numpy(pat_np.astype(np.float32)).to(img_blurred.device)
    v1 = sampling.gather_nn(img_blurred,
                            _rotated_taps(pat[:, 0], pat[:, 1], xy, angle))
    v2 = sampling.gather_nn(img_blurred,
                            _rotated_taps(pat[:, 2], pat[:, 3], xy, angle))
    return _pack_bits(v1 < v2)


@functools.lru_cache()
def brief_pool_pattern(seed: int = 4321) -> Tuple[np.ndarray, np.ndarray]:
    """Pool-style BRIEF pattern: 256 sample points and 256 index pairs
    drawn from them (one gather per bit instead of two), seeded, with no
    duplicate and no self pairs. Returns (points [256, 2] int8, pairs
    [256, 2] int32)."""
    rng = np.random.default_rng(seed)
    pts = np.clip(np.round(rng.normal(0.0, 6.2, size=(DESC_BITS, 2))),
                  -13, 13).astype(np.int8)
    pairs = np.zeros((DESC_BITS, 2), np.int32)
    seen = set()
    k = 0
    while k < DESC_BITS:
        a, b = rng.integers(0, DESC_BITS, 2)
        if a == b or (pts[a] == pts[b]).all():
            continue
        key = (min(a, b), max(a, b))
        if key in seen:
            continue
        seen.add(key)
        pairs[k] = (a, b)
        k += 1
    return pts, pairs


def compute_descriptors_pool(img_blurred: torch.Tensor, xy: torch.Tensor,
                             angle: torch.Tensor, seed: int = 4321
                             ) -> torch.Tensor:
    """Steered BRIEF with the pooled pattern: one 256-tap gather per
    keypoint; the pair comparisons index the pooled values. Same contract
    and packing as compute_descriptors."""
    pts, pairs = brief_pool_pattern(seed)
    dev = img_blurred.device
    pat = torch.from_numpy(pts.astype(np.float32)).to(dev)
    v = sampling.gather_nn(img_blurred,
                           _rotated_taps(pat[:, 0], pat[:, 1], xy, angle))
    ia = torch.from_numpy(pairs[:, 0]).to(dev).long()
    ib = torch.from_numpy(pairs[:, 1]).to(dev).long()
    return _pack_bits(v[:, ia] < v[:, ib])


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each int32 word (SWAR). `>>` on int32 is arithmetic, so
    each shifted value is masked; the masks of the first two steps clear
    the sign extension, after which the word is non-negative until the
    multiply, whose top byte is masked again."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def hamming_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Popcount Hamming distance between packed descriptors: a [..., 8],
    b [..., 8] int32 (broadcastable) -> [...] int32, accumulated word by
    word so that the broadcast [..., 8] is never held."""
    d = _popcount32(a[..., 0] ^ b[..., 0])
    for w in range(1, DESC_WORDS):
        d = d + _popcount32(a[..., w] ^ b[..., w])
    return d


def match_brute_force(desc_a: torch.Tensor, desc_b: torch.Tensor,
                      valid_a: torch.Tensor, valid_b: torch.Tensor,
                      max_dist_abs: int = 30, ratio_vs_min: float = 2.0):
    """Brute-force Hamming matching with the reference's acceptance rule:
    keep a->b nearest matches with d <= max(ratio * min_d, abs_th) that are
    mutual. Among equal distances the first index wins on both axes, as
    `jnp.argmin` has it.

    Returns (idx_b [Na] int32, dist [Na] int32, ok [Na] bool)."""
    d = hamming_distance(desc_a[:, None, :], desc_b[None, :, :])  # [Na, Nb]
    big = 512
    d = torch.where(valid_a[:, None] & valid_b[None, :], d,
                    torch.full_like(d, big))
    idx_b = torch.argmin(d, dim=1)
    best = torch.amin(d, dim=1)
    min_d = torch.min(best)
    thresh = torch.clamp((ratio_vs_min * min_d).to(torch.int32),
                         min=max_dist_abs)
    back = torch.argmin(d, dim=0)                                 # [Nb]
    mutual = back[idx_b] == torch.arange(d.shape[0], device=d.device)
    ok = (best <= thresh) & (best < big) & mutual & valid_a
    return idx_b.to(torch.int32), best.to(torch.int32), ok
