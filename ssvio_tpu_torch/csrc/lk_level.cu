// One pyramid level of forward-additive KLT for N keypoints, for Hopper
// (sm_90a). Replaces ssvio_tpu/ops/lk_pallas.py::lk_level_vmem; the wrapper,
// plain torch version and design note are in ssvio_tpu_torch/ops/lk_cuda.py,
// the level kernel and the per-keypoint solve in lk_klt.cuh (sampler:
// GlobalSampler, each lane reading its pixels' corners from L2).
//
// Bounds equal the TPU kernel's: the window's top-left stays in
// [0, Wb - win - 2] x [0, Hb - win - 2] where (Hb, Wb) are the padded level
// dims; reads at or beyond the true dims (H, W) return 0, the value of the
// TPU wrapper's zero padding. The template window's integer origin is
// clipped into those bounds exactly as lk_pallas.py:208-215 does.

#include "lk_klt.cuh"

using namespace ssvio_lk;

// Plain C entry point (bound with ctypes); see launch_level.
extern "C" int ssvio_lk_level(const float* prev, const float* gx,
                              const float* gy, const float* cur, int H, int W,
                              int Hb, int Wb, const float* pts_prev,
                              const float* pts_guess, const int* frozen0,
                              float* pts_out, int* flag, int n, int win,
                              int iters, float eps, float min_eig,
                              void* stream) {
  return launch_level<GlobalSampler, kWarpsPerBlock>(
      prev, gx, gy, cur, H, W, Hb, Wb, pts_prev, pts_guess, frozen0, pts_out,
      flag, n, win, iters, eps, min_eig, nullptr, stream);
}
