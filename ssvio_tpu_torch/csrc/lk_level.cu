// One pyramid level of forward-additive KLT for N keypoints, for Hopper
// (sm_90a). Replaces ssvio_tpu/ops/lk_pallas.py::lk_level_vmem; the wrapper,
// plain torch version and design note are in ssvio_tpu_torch/ops/lk_cuda.py.
//
// Work layout: one warp per keypoint, kWarpsPerBlock warps per block. Lane
// `l` owns window pixels p = l + 32 k (k < 4, p < win*win) and keeps the
// template T and the Sobel windows Gx, Gy of those pixels in registers for
// the whole loop. Each iteration samples the current window straight from
// global memory (the planes stay resident in L2), reduces the two residual
// sums with __shfl_xor_sync and solves the 2x2 system in every lane. A xor
// butterfly adds v_i + v_j in lane i and v_j + v_i in lane j, which are
// equal, so every lane ends with bit-identical sums: the step, the
// convergence test and the loop exit are warp-uniform.
//
// Bounds equal the TPU kernel's: the window's top-left stays in
// [0, Wb - win - 2] x [0, Hb - win - 2] where (Hb, Wb) are the padded level
// dims; reads at or beyond the true dims (H, W) return 0, the value of the
// TPU wrapper's zero padding. The template window's integer origin is
// clipped into those bounds exactly as lk_pallas.py:208-215 does.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kPixPerLane = 4;          // win * win <= 128
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load(const float* __restrict__ plane, int y,
                                      int x, int H, int W) {
  return (y < H && x < W) ? __ldg(plane + (size_t)y * W + x) : 0.f;
}

// Bilinear sample at integer origin (x, y) + fraction (fx, fy), in the TPU
// kernel's blend order (lk_pallas.py:_blend).
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

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
lk_level_kernel(const float* __restrict__ prev, const float* __restrict__ gx,
                const float* __restrict__ gy, const float* __restrict__ cur,
                int H, int W, int Hb, int Wb,
                const float* __restrict__ pts_prev,
                const float* __restrict__ pts_guess,
                const int* __restrict__ frozen0, float* __restrict__ pts_out,
                int* __restrict__ flag, int n, int win, int iters, float eps,
                float min_eig) {
  const int kp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (kp >= n) return;                  // uniform across the warp

  const float r = (float)(win / 2);
  const float lim_x = (float)(Wb - win - 2);
  const float lim_y = (float)(Hb - win - 2);
  const int npix = win * win;

  int prow[kPixPerLane], pcol[kPixPerLane];
#pragma unroll
  for (int k = 0; k < kPixPerLane; ++k) {
    const int p = lane + 32 * k;
    prow[k] = p < npix ? p / win : -1;  // -1: lane holds no pixel here
    pcol[k] = p < npix ? p % win : 0;
  }

  // --- template + gradient windows at the previous position
  const float tx = pts_prev[2 * kp] - r;
  const float ty = pts_prev[2 * kp + 1] - r;
  const float btx = clip_floor(tx, lim_x);
  const float bty = clip_floor(ty, lim_y);
  const float ftx = tx - btx, fty = ty - bty;
  const int itx = (int)btx, ity = (int)bty;
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
  const bool good = (me / (float)npix) > min_eig;
  const float inv_det = fabsf(det) > 1e-9f ? 1.f / det : 0.f;

  // --- iterate from the guess; each keypoint exits on its own
  float lx = pts_guess[2 * kp] - r;
  float ly = pts_guess[2 * kp + 1] - r;
  bool frozen = frozen0[kp] > 0 || lx < 0.f || ly < 0.f || lx > lim_x ||
                ly > lim_y || !good;
  for (int it = 0; it < iters && !frozen; ++it) {
    const float bx = clip_floor(lx, lim_x);
    const float by = clip_floor(ly, lim_y);
    const float fx = lx - bx, fy = ly - by;
    const int ix = (int)bx, iy = (int)by;
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
             lx > lim_x || ly > lim_y;
  }
  if (lane == 0) {
    pts_out[2 * kp] = lx + r;
    pts_out[2 * kp + 1] = ly + r;
    flag[kp] = good ? 1 : 0;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Planes are [H, W] float32
// row-major; (Hb, Wb) are the padded dims that set the bounds. Launches on
// `stream` without synchronizing and returns cudaGetLastError().
extern "C" int ssvio_lk_level(const float* prev, const float* gx,
                              const float* gy, const float* cur, int H, int W,
                              int Hb, int Wb, const float* pts_prev,
                              const float* pts_guess, const int* frozen0,
                              float* pts_out, int* flag, int n, int win,
                              int iters, float eps, float min_eig,
                              void* stream) {
  if (n <= 0) return 0;
  if (win < 1 || win * win > 32 * kPixPerLane || Hb < H || Wb < W)
    return (int)cudaErrorInvalidValue;
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  lk_level_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      prev, gx, gy, cur, H, W, Hb, Wb, pts_prev, pts_guess, frozen0, pts_out,
      flag, n, win, iters, eps, min_eig);
  return (int)cudaGetLastError();
}
