// Kernel #3: one pyramid level of forward-additive KLT for N keypoints with
// a staged window, for Hopper (sm_90a). Replaces
// ssvio_tpu/ops/lk_pallas_variants.py::lk_level_vmem_sw (factory
// _make_vmem_sw_kernel); the wrapper, plain torch version and design note
// are in ssvio_tpu_torch/ops/lk_variants_cuda.py, the level kernel, the
// solve and the sampler (StagedSampler) in lk_klt.cuh.
//
// On the TPU the point of `sw` was to replace the dynamic sublane roll of
// the serial kernel with a static-slice switch; Hopper has no such roll.
// Its counterpart here stages the window: each warp copies the
// (win+1) x (win+1) integer window of the plane into its own shared-memory
// tile in one pass over the lanes, then every lane blends its <= 4 pixels
// from the tile with kernel #1's expression. Each window pixel is read from
// L2 once per window instead of up to four times. The function, bounds
// included, is kernel #1's (lk_level.cu); so are the values.
//
// What bounds it on the card: as kernel #1, latency (a dependent chain of
// L2 reads, a shuffle reduction and a 2x2 solve per iteration, 512 warps
// on 132 SMs); the staging adds two __syncwarp per window, and on an H100
// it measured slower than kernel #1's reads from L2 (PERF.md).

#include "lk_klt.cuh"

using namespace ssvio_lk;

// Plain C entry point (bound with ctypes); see launch_level.
extern "C" int ssvio_lk_level_sw(const float* prev, const float* gx,
                                 const float* gy, const float* cur, int H,
                                 int W, int Hb, int Wb, const float* pts_prev,
                                 const float* pts_guess, const int* frozen0,
                                 float* pts_out, int* flag, int n, int win,
                                 int iters, float eps, float min_eig,
                                 void* stream) {
  return launch_level<StagedSampler, kWarpsPerBlock>(
      prev, gx, gy, cur, H, W, Hb, Wb, pts_prev, pts_guess, frozen0, pts_out,
      flag, n, win, iters, eps, min_eig, nullptr, stream);
}
