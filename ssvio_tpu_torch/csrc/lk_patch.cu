// One pyramid level of forward-additive KLT for N keypoints whose search is
// bounded by a per-keypoint patch box, for Hopper (sm_90a). Replaces
// ssvio_tpu/ops/lk_pallas.py::lk_level_pallas (the HBM-patch kernel, body
// _make_kernel); the wrapper, plain torch version and design note are in
// ssvio_tpu_torch/ops/lk_patch_cuda.py, the per-keypoint solve and the
// sampler (FourCornerSampler) in lk_klt.cuh.
//
// The TPU kernel DMAs, per keypoint, a [pty, 256] template patch at the
// (128, 8)-aligned origin tl_prev and a [pcy, 256] search patch at tl_cur
// from the zero-padded planes, and solves in patch coordinates. What the
// patches set is the function: the template top-left is clipped to
// [0, 256 - win - 1] x [0, pty - win - 1], and the search freezes outside
// [0, 256 - win - 1] x [0, pcy - win - 1] (lk_pallas.py:111-112, 119-120).
// Here a frame carries the patch origin and that box, and the solve works
// in plane coordinates, origin + local; reads beyond the true dims (H, W)
// return 0, the value of the TPU wrapper's zero padding. Outputs stay in
// search-patch coordinates, as the TPU kernel's do.
//
// What bounds it on the card: latency, the dependent chain of one
// iteration, as kernel #1 (lk_level.cu). A 256-wide patch of 40 rows is
// 40 KB, too much to copy per warp, and the search uses little of it. So
// each warp stages kernel #1's region instead: 32 x 36 floats of `cur`
// around its first search window (48 x 52 above win 16), once a level,
// with cp.async (16-byte units on 1280-float rows), and blends every later
// window inside it from shared memory, in registers, with no barrier in
// the loop. The three template windows, and a search window that leaves
// the region, read L2. The blend is kernel #1's pinned FourCornerBlend
// wherever a window is read, so the values are those of this kernel's
// first, all-L2 design bit for bit. 4 pixels a lane for win <= 11 (the
// path's), 8 for <= 16, 18 for <= 24; 18 KB of static shared memory a
// block for the first two, 39 KB for the third.

#include "lk_klt.cuh"

using namespace ssvio_lk;

namespace {

constexpr int kLanes = 256;             // patch width (lk_pallas.LANES)

template <class Sampler>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
lk_patch_kernel(const float* __restrict__ prev, const float* __restrict__ gx,
                const float* __restrict__ gy, const float* __restrict__ cur,
                int H, int W, const int* __restrict__ tl_prev,
                const int* __restrict__ tl_cur,
                const float* __restrict__ localT,
                const float* __restrict__ local0,
                const int* __restrict__ frozen0, float* __restrict__ local_out,
                int* __restrict__ flag, int n, int win, int pty, int pcy,
                int iters, float eps, float min_eig,
                int* __restrict__ stats) {
  __shared__ __align__(128) unsigned char
      smem[kWarpsPerBlock * Sampler::kSmemBytes];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kp = blockIdx.x * kWarpsPerBlock + warp;
  if (kp >= n) return;                  // uniform across the warp

  const float lim_x = (float)(kLanes - win - 1);
  const Frame tmpl{tl_prev[2 * kp], tl_prev[2 * kp + 1], lim_x,
                   (float)(pty - win - 1)};
  const Frame search{tl_cur[2 * kp], tl_cur[2 * kp + 1], lim_x,
                     (float)(pcy - win - 1)};
  float lx = local0[2 * kp];
  float ly = local0[2 * kp + 1];
  bool good;
  Sampler smp(H, W, lane, win, smem + warp * Sampler::kSmemBytes);
  const int n_it =
      klt_solve(smp, prev, gx, gy, cur, win, iters, eps, min_eig, tmpl,
                localT[2 * kp], localT[2 * kp + 1], search, frozen0[kp] > 0,
                lx, ly, good);
  if (lane == 0) {
    local_out[2 * kp] = lx;
    local_out[2 * kp + 1] = ly;
    flag[kp] = good ? 1 : 0;
    if (stats != nullptr) {             // as level_kernel's
      atomicAdd(stats, smp.n_outside);
      atomicAdd(stats + 1, n_it);
      atomicMax(stats + 2, n_it);
    }
  }
}

template <class Sampler>
int launch_patch(const float* prev, const float* gx, const float* gy,
                 const float* cur, int H, int W, const int* tl_prev,
                 const int* tl_cur, const float* localT, const float* local0,
                 const int* frozen0, float* local_out, int* flag, int n,
                 int win, int pty, int pcy, int iters, float eps,
                 float min_eig, int* stats, void* stream) {
  lk_patch_kernel<Sampler>
      <<<(n + kWarpsPerBlock - 1) / kWarpsPerBlock, 32 * kWarpsPerBlock, 0,
         (cudaStream_t)stream>>>(prev, gx, gy, cur, H, W, tl_prev, tl_cur,
                                 localT, local0, frozen0, local_out, flag, n,
                                 win, pty, pcy, iters, eps, min_eig, stats);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Planes are [H, W] float32
// row-major; tl_prev/tl_cur int32 [n, 2] patch origins (x, y) that the
// wrapper aligned and clipped into the padded dims; localT/local0 float32
// [n, 2]. 4, 8 or 18 pixels a lane for win <= 11, 16, 24. `stats`: null,
// or int32 [3] that the level adds to as lk_klt.cuh::level_kernel does
// (search windows read outside the staged region, keypoint-iterations, and
// the most iterations of any keypoint). Launches on `stream` without
// synchronizing and returns cudaGetLastError().
extern "C" int ssvio_lk_patch(const float* prev, const float* gx,
                              const float* gy, const float* cur, int H, int W,
                              const int* tl_prev, const int* tl_cur,
                              const float* localT, const float* local0,
                              const int* frozen0, float* local_out, int* flag,
                              int n, int win, int pty, int pcy, int iters,
                              float eps, float min_eig, int* stats,
                              void* stream) {
  if (n <= 0) return 0;
  if (win < 1 || win > max_window(18) || pty < win + 2 || pcy < win + 2 ||
      kLanes < win + 2)
    return (int)cudaErrorInvalidValue;
#define SSVIO_PATCH_LAUNCH(P)                                              \
  launch_patch<FourCornerSampler<P>>(                                      \
      prev, gx, gy, cur, H, W, tl_prev, tl_cur, localT, local0, frozen0,   \
      local_out, flag, n, win, pty, pcy, iters, eps, min_eig, stats,       \
      stream)
  if (win <= max_window(4)) return SSVIO_PATCH_LAUNCH(4);
  if (win <= max_window(8)) return SSVIO_PATCH_LAUNCH(8);
  return SSVIO_PATCH_LAUNCH(18);
#undef SSVIO_PATCH_LAUNCH
}
