// The per-keypoint KLT solve shared by the two LK level kernels
// (lk_level.cu: bounds of the padded level; lk_patch.cu: bounds of a
// per-keypoint patch box). Included by both; not a translation unit.
//
// Work layout: one warp per keypoint. Lane `l` owns window pixels
// p = l + 32 k (k < kPixPerLane, p < win*win) and keeps the template T and
// the Sobel windows Gx, Gy of those pixels in registers for the whole loop.
// Each iteration samples the current window straight from global memory
// (the planes stay resident in L2), reduces the two residual sums with
// __shfl_xor_sync and solves the 2x2 system in every lane. A xor butterfly
// adds v_i + v_j in lane i and v_j + v_i in lane j, which are equal, so
// every lane ends with bit-identical sums: the step, the convergence test
// and the loop exit are warp-uniform.
//
// Coordinates: a window is addressed by its top-left in a local frame whose
// origin sits at integer plane coordinates (ox, oy); the local top-left is
// clipped to [0, lim_x] x [0, lim_y] before sampling and the search freezes
// when it leaves that box. Reads at or beyond the true plane dims (H, W)
// return 0, the value of the TPU wrappers' zero padding.

#pragma once

#include <cuda_runtime.h>

namespace ssvio_lk {

constexpr int kWarpsPerBlock = 4;
constexpr int kPixPerLane = 4;          // win * win <= 128
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load(const float* __restrict__ plane, int y,
                                      int x, int H, int W) {
  return (y < H && x < W) ? __ldg(plane + (size_t)y * W + x) : 0.f;
}

// Bilinear sample at integer origin (x, y) + fraction (fx, fy), in the TPU
// kernels' blend order (lk_pallas.py:_blend).
__device__ __forceinline__ float bilinear(const float* __restrict__ plane,
                                          int y, int x, float fx, float fy,
                                          int H, int W) {
  const float s00 = load(plane, y, x, H, W);
  const float s01 = load(plane, y, x + 1, H, W);
  const float s10 = load(plane, y + 1, x, H, W);
  const float s11 = load(plane, y + 1, x + 1, H, W);
  return (1.f - fy) * (1.f - fx) * s00 + (1.f - fy) * fx * s01 +
         fy * (1.f - fx) * s10 + fy * fx * s11;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

__device__ __forceinline__ float clip_floor(float v, float lim) {
  // fmaxf/fminf map NaN to the bound, as a clamp of garbage must stay
  // inside the plane
  return fminf(fmaxf(floorf(v), 0.f), lim);
}

struct Frame {         // a local window frame: integer origin + clip box
  int ox, oy;
  float lim_x, lim_y;
};

// One keypoint's level: template window at local top-left (tx, ty) of
// frame `ft` in `prev`/`gx`/`gy`, search from local (lx, ly) of frame `fc`
// in `cur`. Returns the final local top-left in (lx, ly) and the gradient
// gate in `good`. Called by all 32 lanes of a warp with equal arguments.
__device__ __forceinline__ void klt_solve(
    const float* __restrict__ prev, const float* __restrict__ gx,
    const float* __restrict__ gy, const float* __restrict__ cur, int H, int W,
    int lane, int win, int iters, float eps, float min_eig, Frame ft,
    float tx, float ty, Frame fc, bool frozen0, float& lx, float& ly,
    bool& good) {
  const int npix = win * win;
  int prow[kPixPerLane], pcol[kPixPerLane];
#pragma unroll
  for (int k = 0; k < kPixPerLane; ++k) {
    const int p = lane + 32 * k;
    prow[k] = p < npix ? p / win : -1;  // -1: lane holds no pixel here
    pcol[k] = p < npix ? p % win : 0;
  }

  // --- template + gradient windows at the previous position
  const float btx = clip_floor(tx, ft.lim_x);
  const float bty = clip_floor(ty, ft.lim_y);
  const float ftx = tx - btx, fty = ty - bty;
  const int itx = ft.ox + (int)btx, ity = ft.oy + (int)bty;
  float T[kPixPerLane], Gx[kPixPerLane], Gy[kPixPerLane];
  float sxx = 0.f, sxy = 0.f, syy = 0.f;
#pragma unroll
  for (int k = 0; k < kPixPerLane; ++k) {
    T[k] = Gx[k] = Gy[k] = 0.f;
    if (prow[k] >= 0) {
      const int y = ity + prow[k], x = itx + pcol[k];
      T[k] = bilinear(prev, y, x, ftx, fty, H, W);
      Gx[k] = bilinear(gx, y, x, ftx, fty, H, W);
      Gy[k] = bilinear(gy, y, x, ftx, fty, H, W);
      sxx += Gx[k] * Gx[k];
      sxy += Gx[k] * Gy[k];
      syy += Gy[k] * Gy[k];
    }
  }
  const float gxx = warp_sum(sxx), gxy = warp_sum(sxy), gyy = warp_sum(syy);
  const float det = gxx * gyy - gxy * gxy;
  const float trace = gxx + gyy;
  const float me =
      (trace - sqrtf(fmaxf(trace * trace - 4.f * det, 0.f))) * 0.5f;
  good = (me / (float)npix) > min_eig;
  const float inv_det = fabsf(det) > 1e-9f ? 1.f / det : 0.f;

  // --- iterate from the guess; each keypoint exits on its own
  bool frozen = frozen0 || lx < 0.f || ly < 0.f || lx > fc.lim_x ||
                ly > fc.lim_y || !good;
  for (int it = 0; it < iters && !frozen; ++it) {
    const float bx = clip_floor(lx, fc.lim_x);
    const float by = clip_floor(ly, fc.lim_y);
    const float fx = lx - bx, fy = ly - by;
    const int ix = fc.ox + (int)bx, iy = fc.oy + (int)by;
    float sbx = 0.f, sby = 0.f;
#pragma unroll
    for (int k = 0; k < kPixPerLane; ++k) {
      if (prow[k] >= 0) {
        const float d =
            T[k] - bilinear(cur, iy + prow[k], ix + pcol[k], fx, fy, H, W);
        sbx += d * Gx[k];
        sby += d * Gy[k];
      }
    }
    sbx = warp_sum(sbx);
    sby = warp_sum(sby);
    const float dx = (gyy * sbx - gxy * sby) * inv_det;
    const float dy = (gxx * sby - gxy * sbx) * inv_det;
    lx += dx;
    ly += dy;
    frozen = dx * dx + dy * dy < eps * eps || lx < 0.f || ly < 0.f ||
             lx > fc.lim_x || ly > fc.lim_y;
  }
}

}  // namespace ssvio_lk
