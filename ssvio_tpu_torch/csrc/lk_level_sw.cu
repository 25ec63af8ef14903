// Kernel #3: one pyramid level of forward-additive KLT for N keypoints with
// a staged search, for Hopper (sm_90a). Replaces
// ssvio_tpu/ops/lk_pallas_variants.py::lk_level_vmem_sw (factory
// _make_vmem_sw_kernel); the wrapper, plain torch version and design note
// are in ssvio_tpu_torch/ops/lk_variants_cuda.py, the level kernel, the
// solve and the sampler (FourCornerSampler) in lk_klt.cuh.
//
// On the TPU the point of `sw` was to replace the dynamic sublane roll of
// the serial kernel with a static-slice switch (lk_pallas_variants.py:
// 133-156); Hopper has no such roll, so the switch has no counterpart
// here. The first design staged each (win+1)^2 window through shared
// memory (two __syncwarp a window): kernel #1's values at 1.27x kernel #1's
// device time on an H100 (PERF.md). On this card staging pays once a
// level, not once a window: this kernel is a launch of kernel #1's level
// kernel and region sampler (lk_level.cu), as ymm and pkmm share kernel #4.
// The function, bounds included, and the values are kernel #1's; it keeps
// its own entry point, launch counter and the JAX kernel's window limit,
// 23 (lk_pallas_variants.py:185).

#include "lk_klt.cuh"

using namespace ssvio_lk;

namespace {
constexpr int kMaxWinSw = 23;
}

// Plain C entry point (bound with ctypes); see launch_level. `stats`: null,
// or int32 [3] that the level adds to (level_kernel).
extern "C" int ssvio_lk_level_sw(const float* prev, const float* gx,
                                 const float* gy, const float* cur, int H,
                                 int W, int Hb, int Wb, const float* pts_prev,
                                 const float* pts_guess, const int* frozen0,
                                 float* pts_out, int* flag, int n, int win,
                                 int iters, float eps, float min_eig,
                                 int* stats, void* stream) {
  if (n > 0 && win > kMaxWinSw) return (int)cudaErrorInvalidValue;
  return launch_level_by_class<FourCornerSampler>(
      prev, gx, gy, cur, H, W, Hb, Wb, pts_prev, pts_guess, frozen0, pts_out,
      flag, n, win, iters, eps, min_eig, stats, stream);
}
