// The per-keypoint KLT solve, its window samplers and the level kernel
// shared by every LK kernel of the port (lk_level.cu: kernel #1, bounds of
// the padded level; lk_patch.cu: kernel #2, bounds of a per-keypoint patch
// box; lk_level_sw.cu, lk_level_pk.cu, lk_level_mm.cu: kernels #3-#5, the
// JAX package's other samplers of kernel #1's function). Included by each;
// not a translation unit.
//
// Work layout: one warp per keypoint, 4 warps a block, each keypoint exits
// on its own. Lane `l` keeps the template T and the Sobel windows Gx, Gy of
// its window pixels in registers for the whole loop (kernels #1-#4: pixels
// p = l + 32 k, LanePixels; #5 mm: the mma accumulator layout). Each
// iteration samples the current window, reduces the two residual sums with
// __shfl_xor_sync and solves the 2x2 system in every lane. A xor butterfly
// adds v_i + v_j in lane i and v_j + v_i in lane j, which are equal, so
// every lane ends with bit-identical sums: the step, the convergence test
// and the loop exit are warp-uniform.
//
// What bounds every one of them on an H100: latency. A 512-keypoint level
// is 512 warps, about 4 an SM, and each iteration is one dependent chain:
// sample the window, two 5-step shuffle reductions, a 2x2 solve, the
// convergence test. The level lasts as long as its slowest keypoint's
// chain, so what counts is the time of one iteration. Kernels #1-#3 sample
// from L2 (or, #3, stage each window through shared memory). Kernels #4
// and #5 (SeparableSampler, TensorCoreSampler) stage a search region of
// the `cur` plane in the warp's shared memory once a level, with cp.async
// (Region), and sample every later window that lies inside it from there,
// in registers, with no barrier in the loop; a window that leaves the
// region reads L2 as GlobalSampler does. Both paths read the plane's own
// values, so the function does not depend on where a window was read.
// TMA is not the tool for that copy: it needs a tensor map per plane,
// built on the host (cuTensorMapEncodeTiled), to move one 2-5 KB tile at an
// arbitrary origin per warp, which 32 lanes of cp.async do as well.
//
// No lockstep. The JAX `mm` kernel tracks 8 keypoints in one MXU product
// and iterates the group until all are frozen; a frozen keypoint keeps its
// position (lk_pallas_variants.py:398-400), so each keypoint's answer is
// the one it gets alone. A warp here holds one keypoint and shares nothing,
// so every kernel lets each keypoint exit on its own: the results are the
// group's.
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
// Sampler::Elem, takes win <= Sampler::kMaxWindow, and leaves kPix values a
// lane: window(plane, iy, ix, fx, fy, out), called by all 32 lanes of a
// warp with equal arguments, leaves in out[k] the sample at integer
// top-left (ix, iy) plus fraction (fx, fy) of the window pixel pixel(k)
// names, and 0 where that pixel lies outside the window (zeros add nothing
// to the sums). A sampler with kStaged also has stage(plane, iy, ix), which
// copies the region around that window, and search(...), window() from the
// region where it holds the window, counting in n_outside those it does
// not. GlobalSampler (#1, #2), StagedSampler (#3) and SeparableSampler (#4,
// #5 mm_f32) live here; #5's bf16 TensorCoreSampler is in lk_level_mm.cu.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ssvio_lk {

constexpr int kWarpsPerBlock = 4;
constexpr int kPixPerLane = 4;          // kernels #1-#3: win * win <= 128
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

// The lane's window pixels p = lane + 32 k, k < kPix_: row pr[k] (-1:
// p >= win * win) and column pc[k]. Samplers #1-#4 derive from it; 4
// pixels a lane hold win <= 11, 8 hold win <= 16.
template <int kPix_>
struct LanePixels {
  static constexpr int kPix = kPix_;
  int pr[kPix], pc[kPix];
  __device__ LanePixels(int lane, int win) {
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int p = lane + 32 * k;
      pr[k] = p < win * win ? p / win : -1;
      pc[k] = p < win * win ? p % win : 0;
    }
  }
  __device__ __forceinline__ bool pixel(int k, int& r, int& c) const {
    r = pr[k];
    c = pc[k];
    return pr[k] >= 0;
  }
};

// Kernels #1 and #2: each lane reads the four corners of its pixels from
// global memory (the planes stay resident in L2).
struct GlobalSampler : LanePixels<kPixPerLane> {
  using Elem = float;
  static constexpr bool kStaged = false;
  static constexpr int kMaxWindow = kMaxWin;
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
struct StagedSampler : LanePixels<kPixPerLane> {
  using Elem = float;
  static constexpr bool kStaged = false;
  static constexpr int kMaxWindow = kMaxWin;
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

// cp.async of one 16- or 4-byte unit from global to shared memory; the
// bytes past `src_bytes` (0..kBytes) are zero-filled.
template <int kBytes>
__device__ __forceinline__ void cp_async(unsigned dst, const void* src,
                                         int src_bytes) {
  static_assert(kBytes == 16 || kBytes == 4, "cp.async unit");
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
}

// A kRows x kCols region of a plane of E (float, or bf16 as its bits),
// staged once in the warp's shared memory: at(y, x) is the plane's value at
// (y, x), 0 at or beyond the true dims (H, W) as `load` returns.
template <class E, int kRows, int kCols>
struct Region {
  static constexpr int kBytes = kRows * kCols * (int)sizeof(E);
  static_assert(kCols * sizeof(E) % 16 == 0, "16-byte rows");
  E* buf;
  int y0 = 0, x0 = 0;

  // The region centred on the (w1 x w1) window at (ix, iy), its x origin
  // aligned down to the copy unit: 16 B where every row start is 16-byte
  // aligned (KITTI's 1248-wide level 0, RobotCar's 1280), else 4 B, else
  // (bf16 rows of odd width) element by element. One cp.async.wait_all and
  // one __syncwarp end it.
  __device__ __forceinline__ void stage(const E* __restrict__ plane, int iy,
                                        int ix, int w1, int H, int W,
                                        int lane) {
    y0 = max(iy - (kRows - w1) / 2, 0);
    x0 = max(ix - (kCols - w1) / 2, 0);
    const uintptr_t p = reinterpret_cast<uintptr_t>(plane);
    const int row_bytes = W * (int)sizeof(E);
    if ((p & 15) == 0 && row_bytes % 16 == 0) {
      copy_units<16>(plane, H, W, lane);
    } else if ((p & 3) == 0 && row_bytes % 4 == 0) {
      copy_units<4>(plane, H, W, lane);
    } else {
      for (int q = lane; q < kRows * kCols; q += 32) {
        const int y = y0 + q / kCols, x = x0 + q % kCols;
        buf[q] = (y < H && x < W) ? plane[(size_t)y * W + x] : E(0);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
  }

  template <int kUnit>
  __device__ __forceinline__ void copy_units(const E* __restrict__ plane, int H,
                                       int W, int lane) {
    constexpr int kPer = kUnit / (int)sizeof(E);   // elements a unit
    constexpr int kUnitsRow = kCols / kPer;
    x0 -= x0 % kPer;
    const unsigned base = (unsigned)__cvta_generic_to_shared(buf);
    for (int q = lane; q < kRows * kUnitsRow; q += 32) {
      const int r = q / kUnitsRow;
      const int c = (q - r * kUnitsRow) * kPer;
      const int y = y0 + r, x = x0 + c;
      const int n = y < H ? min(max(W - x, 0), kPer) : 0;
      cp_async<kUnit>(base + (unsigned)((r * kCols + c) * sizeof(E)),
                      n > 0 ? plane + (size_t)y * W + x : plane,
                      n * (int)sizeof(E));
    }
  }

  // True where the w1 x w1 window at (ix, iy) lies inside the region.
  __device__ __forceinline__ bool holds(int iy, int ix, int w1) const {
    return iy >= y0 && ix >= x0 && iy + w1 <= y0 + kRows &&
           ix + w1 <= x0 + kCols;
  }
  __device__ __forceinline__ E at(int y, int x) const {
    return buf[(y - y0) * kCols + (x - x0)];
  }
};

// (1 - f) a + f b as fma(1 - f, a, f b): the contraction nvcc chose for the
// y and x passes of the separable blend when they ran through shared tiles.
// Spelled with intrinsics, which are never contracted, so the value does
// not depend on how ptxas schedules the code around each copy of it (the
// template, staged and L2 windows); measured, letting it choose moved a
// converged track by 3.8e-06 px at one KITTI level.
__device__ __forceinline__ float lerp2(float a, float b, float f) {
  return __fmaf_rn(1.f - f, a, __fmul_rn(f, b));
}

// Kernel #4 (and #5 in float32): separable, blended in registers. Each
// lane y-blends the two columns under its pixel, r = (1-fy) s[i][j] +
// fy s[i+1][j], then x-blends them, (1-fx) r[j] + fx r[j+1]: the rounding
// order of the JAX package's two-hot products By @ slab (@ Bx^T), each
// output a sum of two products, with lerp2's contraction, so the values are
// those of a y pass into a shared tile followed by an x pass, bit for bit,
// wherever the window is read. Template windows read L2; the search
// windows read the staged region (32 x 36 floats, 4.5 KB a warp: +-10 px
// around the first search window at win 11, +-7 at win 16) or L2.
template <int kPix_>
struct SeparableSampler : LanePixels<kPix_> {
  using Elem = float;
  using Reg = Region<float, 32, 36>;
  static constexpr bool kStaged = true;
  static constexpr int kMaxWindow = kPix_ == kPixPerLane ? kMaxWin : 16;
  static constexpr int kSmemBytes = Reg::kBytes;
  static_assert(kMaxWindow * kMaxWindow <= 32 * kPix_, "pixels a lane");
  int H, W, lane, w1;
  Reg reg;
  int n_outside = 0;
  __device__ SeparableSampler(int H_, int W_, int lane_, int win,
                              unsigned char* smem)
      : LanePixels<kPix_>(lane_, win), H(H_), W(W_), lane(lane_),
        w1(win + 1), reg{reinterpret_cast<float*>(smem)} {}

  template <class Src>
  __device__ __forceinline__ void blend_sep(Src s, float fx, float fy,
                                            float out[kPix_]) const {
#pragma unroll
    for (int k = 0; k < kPix_; ++k) {
      const int r = this->pr[k], c = this->pc[k];
      if (r < 0) {
        out[k] = 0.f;
        continue;
      }
      out[k] = lerp2(lerp2(s(r, c), s(r + 1, c), fy),
                     lerp2(s(r, c + 1), s(r + 1, c + 1), fy), fx);
    }
  }
  __device__ __forceinline__ void window(const float* __restrict__ plane,
                                         int iy, int ix, float fx, float fy,
                                         float out[kPix_]) const {
    blend_sep([&](int r, int c) { return load(plane, iy + r, ix + c, H, W); },
              fx, fy, out);
  }
  __device__ __forceinline__ void stage(const float* __restrict__ plane,
                                        int iy, int ix) {
    reg.stage(plane, iy, ix, w1, H, W, lane);
  }
  __device__ __forceinline__ void search(const float* __restrict__ plane,
                                         int iy, int ix, float fx, float fy,
                                         float out[kPix_]) {
    if (reg.holds(iy, ix, w1)) {
      blend_sep([&](int r, int c) { return reg.at(iy + r, ix + c); }, fx, fy,
                out);
    } else {
      ++n_outside;
      window(plane, iy, ix, fx, fy, out);
    }
  }
};

struct Frame {         // a local window frame: integer origin + clip box
  int ox, oy;
  float lim_x, lim_y;
};

// One keypoint's level: template window at local top-left (tx, ty) of
// frame `ft` in `prev`/`gx`/`gy`, search from local (lx, ly) of frame `fc`
// in `cur`. Returns the iterations it ran, the final local top-left in
// (lx, ly) and the gradient gate in `good`. Called by all 32 lanes of a
// warp with equal arguments; each keypoint exits on its own.
template <class Sampler>
__device__ __forceinline__ int klt_solve(
    Sampler& smp, const typename Sampler::Elem* __restrict__ prev,
    const typename Sampler::Elem* __restrict__ gx,
    const typename Sampler::Elem* __restrict__ gy,
    const typename Sampler::Elem* __restrict__ cur, int win, int iters,
    float eps, float min_eig, Frame ft, float tx, float ty, Frame fc,
    bool frozen0, float& lx, float& ly, bool& good) {
  constexpr int kPix = Sampler::kPix;
  // --- template + gradient windows at the previous position
  const float btx = clip_floor(tx, ft.lim_x);
  const float bty = clip_floor(ty, ft.lim_y);
  const float ftx = tx - btx, fty = ty - bty;
  const int itx = ft.ox + (int)btx, ity = ft.oy + (int)bty;
  float T[kPix], Gx[kPix], Gy[kPix];
  smp.window(prev, ity, itx, ftx, fty, T);
  smp.window(gx, ity, itx, ftx, fty, Gx);
  smp.window(gy, ity, itx, ftx, fty, Gy);
  float sxx = 0.f, sxy = 0.f, syy = 0.f;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
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

  // --- iterate from the guess
  bool frozen = frozen0 || lx < 0.f || ly < 0.f || lx > fc.lim_x ||
                ly > fc.lim_y || !good;
  if constexpr (Sampler::kStaged) {
    if (!frozen)
      smp.stage(cur, fc.oy + (int)clip_floor(ly, fc.lim_y),
                fc.ox + (int)clip_floor(lx, fc.lim_x));
  }
  int n_it = 0;
  for (int it = 0; it < iters; ++it) {
    if (frozen) break;
    ++n_it;
    const float bx = clip_floor(lx, fc.lim_x);
    const float by = clip_floor(ly, fc.lim_y);
    const float fx = lx - bx, fy = ly - by;
    float I[kPix];
    if constexpr (Sampler::kStaged)
      smp.search(cur, fc.oy + (int)by, fc.ox + (int)bx, fx, fy, I);
    else
      smp.window(cur, fc.oy + (int)by, fc.ox + (int)bx, fx, fy, I);
    float sbx = 0.f, sby = 0.f;
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
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
  return n_it;
}

// Kernel #1's function (the JAX package's VMEM kernels): the window's
// top-left stays in [0, Wb - win - 2] x [0, Hb - win - 2] of the padded
// level (Hb, Wb); reads at or beyond the true dims (H, W) return 0. One
// warp per keypoint, kWarps a block. With `stats` (may be null) a staged
// sampler's level adds, per keypoint, the search windows read outside its
// region to stats[0] and its iterations to stats[1], and raises stats[2]
// to the most iterations of any keypoint.
template <class Sampler, int kWarps>
__global__ void __launch_bounds__(32 * kWarps)
level_kernel(const typename Sampler::Elem* __restrict__ prev,
             const typename Sampler::Elem* __restrict__ gx,
             const typename Sampler::Elem* __restrict__ gy,
             const typename Sampler::Elem* __restrict__ cur, int H, int W,
             int Hb, int Wb, const float* __restrict__ pts_prev,
             const float* __restrict__ pts_guess,
             const int* __restrict__ frozen0, float* __restrict__ pts_out,
             int* __restrict__ flag, int n, int win, int iters, float eps,
             float min_eig, int* __restrict__ stats) {
  __shared__ __align__(128) unsigned char smem[kWarps * Sampler::kSmemBytes
                                               + 32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kp = blockIdx.x * kWarps + warp;
  if (kp >= n) return;                  // uniform across the warp
  Sampler smp(H, W, lane, win, smem + warp * Sampler::kSmemBytes);

  const float r = (float)(win / 2);
  const Frame level{0, 0, (float)(Wb - win - 2), (float)(Hb - win - 2)};
  float lx = pts_guess[2 * kp] - r;
  float ly = pts_guess[2 * kp + 1] - r;
  bool good;
  const int n_it = klt_solve(smp, prev, gx, gy, cur, win, iters, eps,
                             min_eig, level, pts_prev[2 * kp] - r,
                             pts_prev[2 * kp + 1] - r, level,
                             frozen0[kp] > 0, lx, ly, good);
  if (lane == 0) {
    pts_out[2 * kp] = lx + r;
    pts_out[2 * kp + 1] = ly + r;
    flag[kp] = good ? 1 : 0;
    if constexpr (Sampler::kStaged) {
      if (stats != nullptr) {
        atomicAdd(stats, smp.n_outside);
        atomicAdd(stats + 1, n_it);
        atomicMax(stats + 2, n_it);
      }
    }
  }
}

// Host side of a level kernel's plain C entry point: planes are [H, W]
// row-major Sampler::Elem; (Hb, Wb) the padded dims that set the bounds;
// stats null or int32 [3] (level_kernel). Launches on `stream` without
// synchronizing; returns cudaGetLastError().
template <class Sampler, int kWarps>
int launch_level(const void* prev, const void* gx, const void* gy,
                 const void* cur, int H, int W, int Hb, int Wb,
                 const float* pts_prev, const float* pts_guess,
                 const int* frozen0, float* pts_out, int* flag, int n,
                 int win, int iters, float eps, float min_eig, int* stats,
                 void* stream) {
  if (n <= 0) return 0;
  if (win < 1 || win > Sampler::kMaxWindow || Hb < H || Wb < W ||
      Hb < win + 2 || Wb < win + 2)
    return (int)cudaErrorInvalidValue;
  using E = typename Sampler::Elem;
  level_kernel<Sampler, kWarps>
      <<<(n + kWarps - 1) / kWarps, 32 * kWarps, 0, (cudaStream_t)stream>>>(
          (const E*)prev, (const E*)gx, (const E*)gy, (const E*)cur, H, W,
          Hb, Wb, pts_prev, pts_guess, frozen0, pts_out, flag, n, win, iters,
          eps, min_eig, stats);
  return (int)cudaGetLastError();
}

}  // namespace ssvio_lk
