// One pyramid level of forward-additive KLT for N keypoints, for Hopper
// (sm_90a). Replaces ssvio_tpu/ops/lk_pallas.py::lk_level_vmem; the wrapper,
// plain torch version and design note are in ssvio_tpu_torch/ops/lk_cuda.py,
// the per-keypoint solve in lk_klt.cuh.
//
// Bounds equal the TPU kernel's: the window's top-left stays in
// [0, Wb - win - 2] x [0, Hb - win - 2] where (Hb, Wb) are the padded level
// dims; reads at or beyond the true dims (H, W) return 0, the value of the
// TPU wrapper's zero padding. The template window's integer origin is
// clipped into those bounds exactly as lk_pallas.py:208-215 does.

#include "lk_klt.cuh"

using namespace ssvio_lk;

namespace {

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
  const Frame level{0, 0, (float)(Wb - win - 2), (float)(Hb - win - 2)};
  float lx = pts_guess[2 * kp] - r;
  float ly = pts_guess[2 * kp + 1] - r;
  bool good;
  klt_solve(prev, gx, gy, cur, H, W, lane, win, iters, eps, min_eig, level,
            pts_prev[2 * kp] - r, pts_prev[2 * kp + 1] - r, level,
            frozen0[kp] > 0, lx, ly, good);
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
