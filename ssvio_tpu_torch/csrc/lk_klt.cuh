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
// chain, so what counts is the time of one iteration. Every kernel
// (RegionSampler, TensorCoreSampler) stages a search region of the `cur`
// plane in the warp's shared memory once a level, with cp.async (Region),
// and samples every later window that lies inside it from there, in
// registers, with no barrier in the loop; a window that leaves the region,
// and the three template windows, read L2 (L2Sampler). Both paths read the
// plane's own values and blend them with one pinned expression, so the
// function does not depend on where a window was read.
// TMA is not the tool for that copy: it needs a tensor map per plane,
// built on the host (cuTensorMapEncodeTiled), to move one 2-10 KB tile at
// an arbitrary origin per warp, which 32 lanes of cp.async do as well.
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
// to the sums). It also has stage(plane, iy, ix), which copies the region
// around that window, and search(...), window() from the region where it
// holds the window, counting in n_outside those it does not. The float32 samplers are one template over a blend policy
// (FourCornerBlend: kernels #1-#3; SeparableBlend: #4, #5 mm_f32) and the
// pixels a lane: 4 (win <= 11, the path's class), 8 (<= 16), 18 (<= 24);
// #5's bf16 TensorCoreSampler is in lk_level_mm.cu.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace ssvio_lk {

constexpr int kWarpsPerBlock = 4;
constexpr int kPixPerLane = 4;          // the path's class: win * win <= 128
constexpr int kMaxWin = 11;             // the largest win with that
constexpr unsigned kFull = 0xffffffffu;

// The largest window whose win * win pixels kPix pixels a lane hold:
// 4 -> 11, 8 -> 16, 18 -> 24.
__host__ __device__ constexpr int max_window(int kPix) {
  int w = 1;
  while ((w + 1) * (w + 1) <= 32 * kPix) ++w;
  return w;
}

__device__ __forceinline__ float load(const float* __restrict__ plane, int y,
                                      int x, int H, int W) {
  return (y < H && x < W) ? __ldg(plane + (size_t)y * W + x) : 0.f;
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

// Kernel #1's four-corner blend, in the TPU kernels' order
// (lk_pallas.py:_blend): (1-fy)(1-fx) s00 + (1-fy) fx s01 + fy (1-fx) s10
// + fy fx s11, with the FMA contraction nvcc chose for that expression in
// the L2 design of kernel #1 that this sampler replaced (read off its
// SASS: the four weights FMUL'd once a window, then FMUL w01 s01, FFMA
// w00 s00, FFMA w10 s10, FFMA w11 s11). Spelled with intrinsics, which are
// never contracted, so every copy of it (the template, staged and L2
// windows, kernels #1-#3) gives those values bit for bit however ptxas
// schedules the code around it.
struct FourCornerBlend {
  struct Weights {
    float w00, w01, w10, w11;
  };
  static __device__ __forceinline__ Weights weights(float fx, float fy) {
    const float gx = 1.f - fx, gy = 1.f - fy;
    return {__fmul_rn(gy, gx), __fmul_rn(gy, fx), __fmul_rn(fy, gx),
            __fmul_rn(fy, fx)};
  }
  static __device__ __forceinline__ float blend(float s00, float s01,
                                                float s10, float s11,
                                                const Weights& w) {
    return __fmaf_rn(w.w11, s11,
                     __fmaf_rn(w.w10, s10,
                               __fmaf_rn(w.w00, s00, __fmul_rn(w.w01, s01))));
  }
};

// (1 - f) a + f b as fma(1 - f, a, f b): the contraction nvcc chose for the
// y and x passes of the separable blend when they ran through shared tiles
// (kernel #4's first design). Spelled with intrinsics, as FourCornerBlend is;
// measured, letting nvcc choose moved a converged track by 3.8e-06 px at
// one KITTI level.
__device__ __forceinline__ float lerp2(float a, float b, float f) {
  return __fmaf_rn(1.f - f, a, __fmul_rn(f, b));
}

// Kernel #4's blend (and #5's in float32): separable, y first,
// r = (1-fy) s[i][j] + fy s[i+1][j], then (1-fx) r[j] + fx r[j+1]: the
// rounding order of the JAX package's two-hot products By @ slab (@ Bx^T),
// each output a sum of two products, with lerp2's contraction, so the
// values are those of a y pass into a shared tile followed by an x pass.
struct SeparableBlend {
  struct Weights {
    float fx, fy;
  };
  static __device__ __forceinline__ Weights weights(float fx, float fy) {
    return {fx, fy};
  }
  static __device__ __forceinline__ float blend(float s00, float s01,
                                                float s10, float s11,
                                                const Weights& w) {
    return lerp2(lerp2(s00, s10, w.fy), lerp2(s01, s11, w.fy), w.fx);
  }
};

// The lane's window pixels p = lane + 32 k, k < kPix_: row pr[k] and
// column pc[k], and bit k of `in` set where p < win * win. A pixel past the
// window takes row 0, column 0, so the samplers read its corners at a valid
// address and only then select 0 for it: a branch around each pixel would
// make the next pixel's loads wait for this one's blend.
template <int kPix_>
struct LanePixels {
  static constexpr int kPix = kPix_;
  int pr[kPix], pc[kPix];
  unsigned in = 0;
  __device__ LanePixels(int lane, int win) {
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int p = lane + 32 * k;
      const bool inside = p < win * win;
      pr[k] = inside ? p / win : 0;
      pc[k] = inside ? p % win : 0;
      in |= (unsigned)inside << k;
    }
  }
  __device__ __forceinline__ bool inside(int k) const {
    return (in >> k) & 1u;
  }
  __device__ __forceinline__ bool pixel(int k, int& r, int& c) const {
    r = pr[k];
    c = pc[k];
    return inside(k);
  }
};

// Every window from L2: each lane reads the four corners of its pixels
// from global memory (the planes stay resident in L2) and blends them with
// Blend: the template windows and out-of-region windows of RegionSampler.
template <int kPix_, class Blend>
struct L2Sampler : LanePixels<kPix_> {
  using Elem = float;
  static constexpr int kMaxWindow = max_window(kPix_);
  static constexpr int kSmemBytes = 0;
  int H, W;
  __device__ L2Sampler(int H_, int W_, int lane, int win, unsigned char*)
      : LanePixels<kPix_>(lane, win), H(H_), W(W_) {}
  __device__ __forceinline__ void window(const float* __restrict__ plane,
                                         int iy, int ix, float fx, float fy,
                                         float out[kPix_]) const {
    const typename Blend::Weights w = Blend::weights(fx, fy);
#pragma unroll
    for (int k = 0; k < kPix_; ++k) {
      const int y = iy + this->pr[k], x = ix + this->pc[k];
      const float v = Blend::blend(
          load(plane, y, x, H, W), load(plane, y, x + 1, H, W),
          load(plane, y + 1, x, H, W), load(plane, y + 1, x + 1, H, W), w);
      out[k] = this->inside(k) ? v : 0.f;
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

// The float at shared address a + kOff. volatile: it reads what cp.async
// wrote, which the compiler does not see, so it must stay after the wait.
template <int kOff>
__device__ __forceinline__ float ld_shared(unsigned a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1+%2];\n" : "=f"(v) : "r"(a), "n"(kOff));
  return v;
}

// A kRows x kCols region of a plane of E (float, or bf16 as its bits),
// staged once in the warp's shared memory: at(y, x) is the plane's value at
// (y, x), 0 at or beyond the true dims (H, W) as `load` returns.
template <class E, int kRows_, int kCols_>
struct Region {
  static constexpr int kRows = kRows_, kCols = kCols_;
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
  // holds() as two unsigned compares on the window's offsets in the
  // region, leaving in b the window's index in buf.
  __device__ __forceinline__ bool locate(int iy, int ix, int w1,
                                         int& b) const {
    const int dy = iy - y0, dx = ix - x0;
    b = dy * kCols + dx;
    return (unsigned)dy <= (unsigned)(kRows - w1) &&
           (unsigned)dx <= (unsigned)(kCols - w1);
  }
};

// Kernels #1-#3 (FourCornerBlend), #4 and #5 mm_f32 (SeparableBlend):
// the template windows read L2; each warp stages a region of `cur` around
// its first search window once a level and blends every search window
// inside it from there, in registers, L2 outside it. The region is 32 x 36
// floats (4.5 KB a warp) for 4 and 8 pixels a lane: the window has +-10 px
// of search slack around its first position at win 11, +-7 at win 16. For
// 18 (win <= 24) it is 48 x 52 floats (9.75 KB a warp, 39 KB a block):
// +-11 rows at win 24, 11-16 columns. A corner is read with ld.shared at
// the region's shared address + 4 x (the window's index + the pixel's) +
// an immediate (0, 4, 4 kCols, 4 kCols + 4). The region's address is held
// in a register, laundered once through an empty asm: left to itself,
// nvcc recomputed it inside every window from the warp index and the
// block's shared window, an S2R on the chain (measured: keeping it took
// 4-12% off the time of an iteration).
template <int kPix_, class Blend>
struct RegionSampler : L2Sampler<kPix_, Blend> {
  using Reg = std::conditional_t<(kPix_ > 8), Region<float, 48, 52>,
                                 Region<float, 32, 36>>;
  static constexpr int kSmemBytes = Reg::kBytes;
  static_assert(max_window(kPix_) < Reg::kRows, "region rows");
  int lane, w1;
  Reg reg;
  unsigned sbuf;                        // reg.buf as a shared address
  int n_outside = 0;
  __device__ RegionSampler(int H_, int W_, int lane_, int win,
                           unsigned char* smem)
      : L2Sampler<kPix_, Blend>(H_, W_, lane_, win, smem), lane(lane_),
        w1(win + 1), reg{reinterpret_cast<float*>(smem)},
        sbuf((unsigned)__cvta_generic_to_shared(smem)) {
    asm volatile("" : "+r"(sbuf));
  }
  __device__ __forceinline__ void stage(const float* __restrict__ plane,
                                        int iy, int ix) {
    reg.stage(plane, iy, ix, w1, this->H, this->W, lane);
  }
  __device__ __forceinline__ void search(const float* __restrict__ plane,
                                         int iy, int ix, float fx, float fy,
                                         float out[kPix_]) {
    int b;
    if (!reg.locate(iy, ix, w1, b)) {
      ++n_outside;
      this->window(plane, iy, ix, fx, fy, out);
      return;
    }
    const typename Blend::Weights w = Blend::weights(fx, fy);
    const unsigned a0 = sbuf + 4u * (unsigned)b;
#pragma unroll
    for (int k = 0; k < kPix_; ++k) {
      const unsigned a =
          a0 + 4u * (unsigned)(this->pr[k] * Reg::kCols + this->pc[k]);
      const float v = Blend::blend(
          ld_shared<0>(a), ld_shared<4>(a), ld_shared<4 * Reg::kCols>(a),
          ld_shared<4 * Reg::kCols + 4>(a), w);
      out[k] = this->inside(k) ? v : 0.f;
    }
  }
};

template <int kPix>
using FourCornerSampler = RegionSampler<kPix, FourCornerBlend>;
template <int kPix>
using SeparableSampler = RegionSampler<kPix, SeparableBlend>;

struct Frame {         // a local window frame: integer origin + clip box
  int ox, oy;
  float lim_x, lim_y;
};

// One keypoint's level: template window at local top-left (tx, ty) of
// frame `ft` in `prev`/`gx`/`gy`, search from local (lx, ly) of frame `fc`
// in `cur`. Returns the iterations it ran, the final local top-left in
// (lx, ly) and the gradient gate in `good`. Called by all 32 lanes of a
// warp with equal arguments; each keypoint exits on its own. The next
// window's integer top-left is computed as soon as the step is, ahead of
// the convergence test that decides whether it is sampled (measured: 4-8%
// off the time of an iteration).
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
  float bx = clip_floor(lx, fc.lim_x);
  float by = clip_floor(ly, fc.lim_y);
  int ix = fc.ox + (int)bx, iy = fc.oy + (int)by;
  if (!frozen) smp.stage(cur, iy, ix);
  int n_it = 0;
  for (int it = 0; it < iters; ++it) {
    if (frozen) break;
    ++n_it;
    const float fx = lx - bx, fy = ly - by;
    float I[kPix];
    smp.search(cur, iy, ix, fx, fy, I);
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
    bx = clip_floor(lx, fc.lim_x);
    by = clip_floor(ly, fc.lim_y);
    ix = fc.ox + (int)bx;
    iy = fc.oy + (int)by;
    frozen = dx * dx + dy * dy < eps * eps || lx < 0.f || ly < 0.f ||
             lx > fc.lim_x || ly > fc.lim_y;
  }
  return n_it;
}

// Kernel #1's function (the JAX package's VMEM kernels): the window's
// top-left stays in [0, Wb - win - 2] x [0, Hb - win - 2] of the padded
// level (Hb, Wb); reads at or beyond the true dims (H, W) return 0. One
// warp per keypoint, kWarps a block. With `stats` (may be null) the level
// adds, per keypoint, the search windows read outside its
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
    if (stats != nullptr) {
      atomicAdd(stats, smp.n_outside);
      atomicAdd(stats + 1, n_it);
      atomicMax(stats + 2, n_it);
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

// launch_level with the sampler S<kPix> of the smallest pixel class that
// holds win: 4, 8 or 18 pixels a lane (win <= 11, 16, 24).
template <template <int> class S>
int launch_level_by_class(const void* prev, const void* gx, const void* gy,
                          const void* cur, int H, int W, int Hb, int Wb,
                          const float* pts_prev, const float* pts_guess,
                          const int* frozen0, float* pts_out, int* flag,
                          int n, int win, int iters, float eps, float min_eig,
                          int* stats, void* stream) {
#define SSVIO_LEVEL_LAUNCH(P)                                                \
  launch_level<S<P>, kWarpsPerBlock>(prev, gx, gy, cur, H, W, Hb, Wb,       \
                                     pts_prev, pts_guess, frozen0, pts_out, \
                                     flag, n, win, iters, eps, min_eig,     \
                                     stats, stream)
  if (win <= max_window(4)) return SSVIO_LEVEL_LAUNCH(4);
  if (win <= max_window(8)) return SSVIO_LEVEL_LAUNCH(8);
  return SSVIO_LEVEL_LAUNCH(18);
#undef SSVIO_LEVEL_LAUNCH
}

}  // namespace ssvio_lk
