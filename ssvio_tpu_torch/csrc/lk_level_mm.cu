// Kernel #5: one pyramid level of forward-additive KLT for N keypoints in
// lockstep groups of 8, with the window sampled as two two-hot products,
// for Hopper (sm_90a). Replaces
// ssvio_tpu/ops/lk_pallas_variants.py::lk_level_vmem_mm (factory
// _make_vmem_mm_kernel), flavours 'mm' (bf16 products) and 'mm_f32'; the
// wrapper, plain torch version and design note are in
// ssvio_tpu_torch/ops/lk_variants_cuda.py, the level kernel and the solve in
// lk_klt.cuh.
//
// The TPU kernel tracks MM_KP = 8 keypoints in lockstep and samples each
// window as W = By S Bx^T: S the integer window, By / Bx "two-hot" matrices
// holding (1-f) and f on two neighbouring diagonals, stacked block-diagonal
// for the group on the MXU. Here a thread block is one group, one warp a
// keypoint, and the group iterates until all 8 are frozen or `iters` is
// reached (klt_solve<true>: __syncthreads_or). A frozen keypoint samples
// nothing and keeps its position, so each keypoint's answer is the one it
// gets alone, and the wrapper does not pad N: the spare warps of the last
// group ride along frozen.
//
// 'mm' (TensorCoreSampler): per window, the warp stages the bf16 window at
// its own integer origin (the card has no (8, 128) alignment rule, so the
// 16 x 16 tile holds the (win+1)^2 window and K = 16 is one k-step), builds
// By and Bx in bf16 with bf16(1-f) and bf16(f) rounded separately as the
// JAX kernel does (lk_pallas_variants.py:244, :251), computes R = By S on
// the tensor cores (wmma 16x16x16 bf16 -> f32), rounds R to bf16 (:258),
// and computes W = R Bx^T the same way. Each sampled value is a sum of two
// exact bf16 x bf16 products, rounded once; only how the tensor cores round
// an f32 accumulation can differ from the plain version. The wrapper casts
// the four planes to bf16 before the launch, as JAX's wrapper does
// (:459-460). 'mm_f32' takes SeparableSampler (lk_klt.cuh) in the same
// kernel template: the two-hot products in float32 on the CUDA cores are
// the two-term blends, since the tensor cores take float32 only as TF32.
// The window sums are warp shuffles, not the JAX kernel's A P A^T.
//
// What bounds it on the card: latency, as kernel #1; on top, a group waits
// for its slowest keypoint, and each bf16 window is two dependent mma
// round trips through shared memory. wgmma comes later.

#include <cuda_bf16.h>
#include <mma.h>

#include "lk_klt.cuh"

using namespace ssvio_lk;

namespace {

constexpr int kGroup = 8;      // keypoints a lockstep group (MM_KP)
constexpr int kB = 16;         // the 16 x 16 x 16 bf16 tile (MM_BW)

__device__ __forceinline__ __nv_bfloat16 load_bf16(
    const __nv_bfloat16* __restrict__ plane, int y, int x, int H, int W) {
  return (y < H && x < W) ? plane[(size_t)y * W + x] : __float2bfloat16_rn(0.f);
}

struct TensorCoreSampler : LanePixels {
  using Elem = __nv_bfloat16;
  // S, By, Bx, R (bf16) and the f32 product, per warp
  static constexpr int kSmemBytes = 4 * kB * kB * 2 + kB * kB * 4;
  int H, W, lane, win;
  __nv_bfloat16 *S, *By, *Bx, *R;
  float* P;
  __device__ TensorCoreSampler(int H_, int W_, int lane_, int win_,
                               unsigned char* smem)
      : LanePixels(lane_, win_), H(H_), W(W_), lane(lane_), win(win_),
        S(reinterpret_cast<__nv_bfloat16*>(smem)), By(S + kB * kB),
        Bx(By + kB * kB), R(Bx + kB * kB),
        P(reinterpret_cast<float*>(R + kB * kB)) {}

  __device__ __forceinline__ void window(
      const __nv_bfloat16* __restrict__ plane, int iy, int ix, float fx,
      float fy, float out[kPixPerLane]) const {
    using namespace nvcuda;
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
    const __nv_bfloat16 y0 = __float2bfloat16_rn(1.f - fy);
    const __nv_bfloat16 y1 = __float2bfloat16_rn(fy);
    const __nv_bfloat16 x0 = __float2bfloat16_rn(1.f - fx);
    const __nv_bfloat16 x1 = __float2bfloat16_rn(fx);
    __syncwarp();                       // every lane is done with P
    for (int q = lane; q < kB * kB; q += 32) {
      const int r = q / kB, c = q % kB;
      S[q] = (r <= win && c <= win) ? load_bf16(plane, iy + r, ix + c, H, W)
                                    : zero;
      // row r < win of By (Bx) holds 1-f at column r and f at r + 1
      const bool live = r < win;
      By[q] = live && c == r ? y0 : live && c == r + 1 ? y1 : zero;
      Bx[q] = live && c == r ? x0 : live && c == r + 1 ? x1 : zero;
    }
    __syncwarp();
    wmma::fragment<wmma::matrix_a, kB, kB, kB, __nv_bfloat16, wmma::row_major>
        a;
    wmma::fragment<wmma::matrix_b, kB, kB, kB, __nv_bfloat16, wmma::row_major>
        b;
    wmma::fragment<wmma::matrix_b, kB, kB, kB, __nv_bfloat16, wmma::col_major>
        bt;
    wmma::fragment<wmma::accumulator, kB, kB, kB, float> acc;
    // R = By S, rounded to bf16
    wmma::load_matrix_sync(a, By, kB);
    wmma::load_matrix_sync(b, S, kB);
    wmma::fill_fragment(acc, 0.f);
    wmma::mma_sync(acc, a, b, acc);
    wmma::store_matrix_sync(P, acc, kB, wmma::mem_row_major);
    __syncwarp();
    for (int q = lane; q < kB * kB; q += 32) R[q] = __float2bfloat16_rn(P[q]);
    __syncwarp();
    // W = R Bx^T: Bx stored row-major is Bx^T stored column-major
    wmma::load_matrix_sync(a, R, kB);
    wmma::load_matrix_sync(bt, Bx, kB);
    wmma::fill_fragment(acc, 0.f);
    wmma::mma_sync(acc, a, bt, acc);
    wmma::store_matrix_sync(P, acc, kB, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kPixPerLane; ++k)
      out[k] = pr[k] >= 0 ? P[pr[k] * kB + pc[k]] : 0.f;
  }
};

// The windows a sampler of this kernel takes at n top-lefts tl [n, 2]
// (x, y) of one plane: out [n, win * win] float32, one warp a window. A
// check of the sampler alone: no path launches it.
template <class Sampler>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
windows_kernel(const typename Sampler::Elem* __restrict__ plane, int H,
               int W, const float* __restrict__ tl, float* __restrict__ out,
               int n, int win) {
  __shared__ __align__(128) unsigned char smem[kWarpsPerBlock *
                                               Sampler::kSmemBytes + 32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsPerBlock + warp;
  if (i >= n) return;                   // uniform across the warp
  const Sampler smp(H, W, lane, win, smem + warp * Sampler::kSmemBytes);
  const float bx = floorf(tl[2 * i]), by = floorf(tl[2 * i + 1]);
  float v[kPixPerLane];
  smp.window(plane, (int)by, (int)bx, tl[2 * i] - bx, tl[2 * i + 1] - by, v);
#pragma unroll
  for (int k = 0; k < kPixPerLane; ++k) {
    const int p = lane + 32 * k;
    if (p < win * win) out[(size_t)i * win * win + p] = v[k];
  }
}

}  // namespace

// Plain C entry point of windows_kernel (bound with ctypes): TensorCoreSampler
// on a bf16 plane with use_bf16, else SeparableSampler on a float32 one.
// Top-lefts must lie in [0, W) x [0, H). Returns cudaGetLastError().
extern "C" int ssvio_lk_mm_windows(const void* plane, int H, int W,
                                   const float* tl, float* out, int n,
                                   int win, int use_bf16, void* stream) {
  if (n <= 0) return 0;
  if (win < 1 || win > kMaxWin) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (use_bf16)
    windows_kernel<TensorCoreSampler>
        <<<blocks, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
            (const __nv_bfloat16*)plane, H, W, tl, out, n, win);
  else
    windows_kernel<SeparableSampler>
        <<<blocks, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
            (const float*)plane, H, W, tl, out, n, win);
  return (int)cudaGetLastError();
}

// Plain C entry point (bound with ctypes); see launch_level. With use_bf16
// the planes are bf16 ('mm'), else float32 ('mm_f32').
extern "C" int ssvio_lk_level_mm(const void* prev, const void* gx,
                                 const void* gy, const void* cur, int H, int W,
                                 int Hb, int Wb, const float* pts_prev,
                                 const float* pts_guess, const int* frozen0,
                                 float* pts_out, int* flag, int n, int win,
                                 int iters, float eps, float min_eig,
                                 int use_bf16, void* stream) {
  if (use_bf16)
    return launch_level<TensorCoreSampler, kGroup, true>(
        prev, gx, gy, cur, H, W, Hb, Wb, pts_prev, pts_guess, frozen0,
        pts_out, flag, n, win, iters, eps, min_eig, stream);
  return launch_level<SeparableSampler, kGroup, true>(
      prev, gx, gy, cur, H, W, Hb, Wb, pts_prev, pts_guess, frozen0, pts_out,
      flag, n, win, iters, eps, min_eig, stream);
}
