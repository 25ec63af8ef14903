// The per-keypoint KLT solve, its window samplers and the level kernel
// shared by every LK kernel of the port (lk_level.cu: kernel #1, bounds of
// the padded level; lk_patch.cu: kernel #2, bounds of a per-keypoint patch
// box; lk_level_sw.cu, lk_level_pk.cu, lk_level_mm.cu: kernels #3-#5, the
// JAX package's other samplers of kernel #1's function). Included by each;
// not a translation unit.
//
// Work layout: one warp per keypoint. Lane `l` owns window pixels
// p = l + 32 k (k < kPixPerLane, p < win*win) and keeps the template T and
// the Sobel windows Gx, Gy of those pixels in registers for the whole loop.
// Each iteration samples the current window, reduces the two residual sums
// with __shfl_xor_sync and solves the 2x2 system in every lane. A xor
// butterfly adds v_i + v_j in lane i and v_j + v_i in lane j, which are
// equal, so every lane ends with bit-identical sums: the step, the
// convergence test and the loop exit are warp-uniform.
//
// Coordinates: a window is addressed by its top-left in a local frame whose
// origin sits at integer plane coordinates (ox, oy); the local top-left is
// clipped to [0, lim_x] x [0, lim_y] before sampling and the search freezes
// when it leaves that box. Reads at or beyond the true plane dims (H, W)
// return 0, the value of the TPU wrappers' zero padding.
//
// Samplers. The solve is generic over how a window is sampled, as the JAX
// package's `_make_serial_vmem_kernel(..., make_sample)` serves every VMEM
// kernel, so the loop logic (gate, step, freeze, exit) has one copy. A
// Sampler is built per warp as Sampler(H, W, lane, win, smem) over
// Sampler::kSmemBytes of the warp's own shared memory, reads planes of
// Sampler::Elem, and has window(plane, iy, ix, fx, fy, out): called by all 32
// lanes of a warp with equal arguments, it leaves in out[k] the sample of
// the lane's window pixel p = lane + 32 k at integer top-left (ix, iy) plus
// fraction (fx, fy), and 0 where p >= win * win (zeros add nothing to the
// sums). Three live here: GlobalSampler (kernels #1, #2), StagedSampler
// (#3), SeparableSampler (#4, and #5 in float32); #5's bf16 tensor-core
// sampler is in lk_level_mm.cu.

#pragma once

#include <cuda_runtime.h>

namespace ssvio_lk {

constexpr int kWarpsPerBlock = 4;
constexpr int kPixPerLane = 4;          // win * win <= 128
constexpr int kMaxWin = 11;             // the largest win with that
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load(const float* __restrict__ plane, int y,
                                      int x, int H, int W) {
  return (y < H && x < W) ? __ldg(plane + (size_t)y * W + x) : 0.f;
}

// The four-corner blend in the TPU kernels' order (lk_pallas.py:_blend).
__device__ __forceinline__ float blend(float s00, float s01, float s10,
                                       float s11, float fx, float fy) {
  return (1.f - fy) * (1.f - fx) * s00 + (1.f - fy) * fx * s01 +
         fy * (1.f - fx) * s10 + fy * fx * s11;
}

// Bilinear sample at integer origin (x, y) + fraction (fx, fy).
__device__ __forceinline__ float bilinear(const float* __restrict__ plane,
                                          int y, int x, float fx, float fy,
                                          int H, int W) {
  return blend(load(plane, y, x, H, W), load(plane, y, x + 1, H, W),
               load(plane, y + 1, x, H, W), load(plane, y + 1, x + 1, H, W),
               fx, fy);
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

constexpr int round_up32(int b) { return (b + 31) / 32 * 32; }

// The lane's window pixels p = lane + 32 k: row pr[k] (-1: p >= win * win)
// and column pc[k]. Every sampler derives from it.
struct LanePixels {
  int pr[kPixPerLane], pc[kPixPerLane];
  __device__ LanePixels(int lane, int win) {
#pragma unroll
    for (int k = 0; k < kPixPerLane; ++k) {
      const int p = lane + 32 * k;
      pr[k] = p < win * win ? p / win : -1;
      pc[k] = p < win * win ? p % win : 0;
    }
  }
};

// Kernels #1 and #2: each lane reads the four corners of its pixels from
// global memory (the planes stay resident in L2).
struct GlobalSampler : LanePixels {
  using Elem = float;
  static constexpr int kSmemBytes = 0;
  int H, W;
  __device__ GlobalSampler(int H_, int W_, int lane, int win, unsigned char*)
      : LanePixels(lane, win), H(H_), W(W_) {}
  __device__ __forceinline__ void window(const float* __restrict__ plane,
                                         int iy, int ix, float fx, float fy,
                                         float out[kPixPerLane]) const {
#pragma unroll
    for (int k = 0; k < kPixPerLane; ++k)
      out[k] = pr[k] >= 0 ? bilinear(plane, iy + pr[k], ix + pc[k], fx, fy,
                                     H, W)
                          : 0.f;
  }
};

// Copies the (win+1) x (win+1) integer window at (ix, iy) into the warp's
// tile, row after row over the lanes (576 B at win 11), once per window.
__device__ __forceinline__ void stage_window(float* __restrict__ tile,
                                             const float* __restrict__ plane,
                                             int iy, int ix, int H, int W,
                                             int lane, int w1) {
  __syncwarp();                         // every lane is done with the tile
  for (int q = lane; q < w1 * w1; q += 32) {
    const int r = q / w1;
    tile[q] = load(plane, iy + r, ix + q - r * w1, H, W);
  }
  __syncwarp();
}

// Kernel #3: the staged window, blended from shared memory with the
// expression of `bilinear`, so the values are kernel #1's.
struct StagedSampler : LanePixels {
  using Elem = float;
  static constexpr int kSmemBytes =
      round_up32((kMaxWin + 1) * (kMaxWin + 1) * 4);
  int H, W, lane, w1;
  float* tile;
  __device__ StagedSampler(int H_, int W_, int lane_, int win,
                           unsigned char* smem)
      : LanePixels(lane_, win), H(H_), W(W_), lane(lane_), w1(win + 1),
        tile(reinterpret_cast<float*>(smem)) {}
  __device__ __forceinline__ void window(const float* __restrict__ plane,
                                         int iy, int ix, float fx, float fy,
                                         float out[kPixPerLane]) const {
    stage_window(tile, plane, iy, ix, H, W, lane, w1);
#pragma unroll
    for (int k = 0; k < kPixPerLane; ++k) {
      const float* s = tile + pr[k] * w1 + pc[k];
      out[k] = pr[k] >= 0 ? blend(s[0], s[1], s[w1], s[w1 + 1], fx, fy)
                          : 0.f;
    }
  }
};

// Kernel #4 (and #5 in float32): separable. Rows are y-blended into a
// win x (win+1) tile, r = (1-fy) s[i][j] + fy s[i+1][j], then x-blended,
// (1-fx) r[i][j] + fx r[i][j+1]: the rounding order of the JAX package's
// two-hot products By @ slab (@ Bx^T), each output a sum of two products.
struct SeparableSampler : LanePixels {
  using Elem = float;
  static constexpr int kTileFloats = (kMaxWin + 1) * (kMaxWin + 1);
  static constexpr int kSmemBytes =
      round_up32((kTileFloats + kMaxWin * (kMaxWin + 1)) * 4);
  int H, W, lane, win, w1;
  float* tile;
  float* rows;
  __device__ SeparableSampler(int H_, int W_, int lane_, int win_,
                              unsigned char* smem)
      : LanePixels(lane_, win_), H(H_), W(W_), lane(lane_), win(win_),
        w1(win_ + 1), tile(reinterpret_cast<float*>(smem)),
        rows(tile + kTileFloats) {}
  __device__ __forceinline__ void window(const float* __restrict__ plane,
                                         int iy, int ix, float fx, float fy,
                                         float out[kPixPerLane]) const {
    stage_window(tile, plane, iy, ix, H, W, lane, w1);
    for (int q = lane; q < win * w1; q += 32)
      rows[q] = (1.f - fy) * tile[q] + fy * tile[q + w1];
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kPixPerLane; ++k) {
      const float* s = rows + pr[k] * w1 + pc[k];
      out[k] = pr[k] >= 0 ? (1.f - fx) * s[0] + fx * s[1] : 0.f;
    }
  }
};

struct Frame {         // a local window frame: integer origin + clip box
  int ox, oy;
  float lim_x, lim_y;
};

// One keypoint's level: template window at local top-left (tx, ty) of
// frame `ft` in `prev`/`gx`/`gy`, search from local (lx, ly) of frame `fc`
// in `cur`. Returns the final local top-left in (lx, ly) and the gradient
// gate in `good`. Called by all 32 lanes of a warp with equal arguments.
//
// kLockstep: the warps of a block iterate together until every one is
// frozen or `iters` is reached (__syncthreads_or over "still active", the
// group `cond` of lk_pallas_variants.py:353-358); a frozen warp samples
// nothing and keeps its position, so each keypoint's answer is the one it
// gets alone. Every warp of the block must call the solve.
template <bool kLockstep, class Sampler>
__device__ __forceinline__ void klt_solve(
    const Sampler& smp, const typename Sampler::Elem* __restrict__ prev,
    const typename Sampler::Elem* __restrict__ gx,
    const typename Sampler::Elem* __restrict__ gy,
    const typename Sampler::Elem* __restrict__ cur, int win, int iters,
    float eps, float min_eig, Frame ft, float tx, float ty, Frame fc,
    bool frozen0, float& lx, float& ly, bool& good) {
  // --- template + gradient windows at the previous position
  const float btx = clip_floor(tx, ft.lim_x);
  const float bty = clip_floor(ty, ft.lim_y);
  const float ftx = tx - btx, fty = ty - bty;
  const int itx = ft.ox + (int)btx, ity = ft.oy + (int)bty;
  float T[kPixPerLane], Gx[kPixPerLane], Gy[kPixPerLane];
  smp.window(prev, ity, itx, ftx, fty, T);
  smp.window(gx, ity, itx, ftx, fty, Gx);
  smp.window(gy, ity, itx, ftx, fty, Gy);
  float sxx = 0.f, sxy = 0.f, syy = 0.f;
#pragma unroll
  for (int k = 0; k < kPixPerLane; ++k) {
    sxx += Gx[k] * Gx[k];
    sxy += Gx[k] * Gy[k];
    syy += Gy[k] * Gy[k];
  }
  const float gxx = warp_sum(sxx), gxy = warp_sum(sxy), gyy = warp_sum(syy);
  const float det = gxx * gyy - gxy * gxy;
  const float trace = gxx + gyy;
  const float me =
      (trace - sqrtf(fmaxf(trace * trace - 4.f * det, 0.f))) * 0.5f;
  good = (me / (float)(win * win)) > min_eig;
  const float inv_det = fabsf(det) > 1e-9f ? 1.f / det : 0.f;

  // --- iterate from the guess; each keypoint exits on its own
  bool frozen = frozen0 || lx < 0.f || ly < 0.f || lx > fc.lim_x ||
                ly > fc.lim_y || !good;
  for (int it = 0; it < iters; ++it) {
    if (kLockstep) {
      if (!__syncthreads_or(!frozen)) break;
      if (frozen) continue;
    } else if (frozen) {
      break;
    }
    const float bx = clip_floor(lx, fc.lim_x);
    const float by = clip_floor(ly, fc.lim_y);
    const float fx = lx - bx, fy = ly - by;
    float I[kPixPerLane];
    smp.window(cur, fc.oy + (int)by, fc.ox + (int)bx, fx, fy, I);
    float sbx = 0.f, sby = 0.f;
#pragma unroll
    for (int k = 0; k < kPixPerLane; ++k) {
      const float d = T[k] - I[k];
      sbx += d * Gx[k];
      sby += d * Gy[k];
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

// Kernel #1's function (the JAX package's VMEM kernels): the window's
// top-left stays in [0, Wb - win - 2] x [0, Hb - win - 2] of the padded
// level (Hb, Wb); reads at or beyond the true dims (H, W) return 0. One
// warp per keypoint, kWarps a block. With kLockstep a block is one
// lockstep group, and the spare warps of a ragged last group solve
// keypoint 0 frozen and write nothing.
template <class Sampler, int kWarps, bool kLockstep>
__global__ void __launch_bounds__(32 * kWarps)
level_kernel(const typename Sampler::Elem* __restrict__ prev,
             const typename Sampler::Elem* __restrict__ gx,
             const typename Sampler::Elem* __restrict__ gy,
             const typename Sampler::Elem* __restrict__ cur, int H, int W,
             int Hb, int Wb, const float* __restrict__ pts_prev,
             const float* __restrict__ pts_guess,
             const int* __restrict__ frozen0, float* __restrict__ pts_out,
             int* __restrict__ flag, int n, int win, int iters, float eps,
             float min_eig) {
  __shared__ __align__(128) unsigned char smem[kWarps * Sampler::kSmemBytes
                                               + 32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kp = blockIdx.x * kWarps + warp;
  const bool live = kp < n;
  if (!kLockstep && !live) return;      // uniform across the warp
  const int i = live ? kp : 0;
  const Sampler smp(H, W, lane, win, smem + warp * Sampler::kSmemBytes);

  const float r = (float)(win / 2);
  const Frame level{0, 0, (float)(Wb - win - 2), (float)(Hb - win - 2)};
  float lx = pts_guess[2 * i] - r;
  float ly = pts_guess[2 * i + 1] - r;
  bool good;
  klt_solve<kLockstep>(smp, prev, gx, gy, cur, win, iters, eps, min_eig,
                       level, pts_prev[2 * i] - r, pts_prev[2 * i + 1] - r,
                       level, !live || frozen0[i] > 0, lx, ly, good);
  if (live && lane == 0) {
    pts_out[2 * kp] = lx + r;
    pts_out[2 * kp + 1] = ly + r;
    flag[kp] = good ? 1 : 0;
  }
}

// Host side of a level kernel's plain C entry point: planes are [H, W]
// row-major Sampler::Elem; (Hb, Wb) the padded dims that set the bounds.
// Launches on `stream` without synchronizing; returns cudaGetLastError().
template <class Sampler, int kWarps, bool kLockstep>
int launch_level(const void* prev, const void* gx, const void* gy,
                 const void* cur, int H, int W, int Hb, int Wb,
                 const float* pts_prev, const float* pts_guess,
                 const int* frozen0, float* pts_out, int* flag, int n,
                 int win, int iters, float eps, float min_eig, void* stream) {
  if (n <= 0) return 0;
  if (win < 1 || win > kMaxWin || Hb < H || Wb < W || Hb < win + 2 ||
      Wb < win + 2)
    return (int)cudaErrorInvalidValue;
  using E = typename Sampler::Elem;
  level_kernel<Sampler, kWarps, kLockstep>
      <<<(n + kWarps - 1) / kWarps, 32 * kWarps, 0, (cudaStream_t)stream>>>(
          (const E*)prev, (const E*)gx, (const E*)gy, (const E*)cur, H, W,
          Hb, Wb, pts_prev, pts_guess, frozen0, pts_out, flag, n, win, iters,
          eps, min_eig);
  return (int)cudaGetLastError();
}

}  // namespace ssvio_lk
