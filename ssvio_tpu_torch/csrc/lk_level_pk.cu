// Kernel #4: one pyramid level of forward-additive KLT for N keypoints with
// separable window sampling, for Hopper (sm_90a). Replaces
// ssvio_tpu/ops/lk_pallas_variants.py::lk_level_vmem_pk (factory
// _make_vmem_pk_kernel), flavours 'ymm' and 'pkmm'; the wrapper, plain
// torch version and design note are in ssvio_tpu_torch/ops/lk_variants_cuda.py,
// the level kernel, the solve and the sampler (SeparableSampler) in
// lk_klt.cuh.
//
// The TPU kernel samples with a two-hot y-interpolation matmul By @ slab on
// the MXU, then an x blend by a lane roll ('ymm') or a second two-hot
// matmul ('pkmm'). Every output of either is a sum of exactly two non-zero
// products, so both are one function: the separable blend, y first. Here
// each warp stages the (win+1)^2 integer window in shared memory, y-blends
// it into a win x (win+1) tile, then x-blends its pixels. It stays on the
// CUDA cores: tensor cores would take the float32 pixels as TF32 (10
// mantissa bits), another function.
//
// What bounds it on the card: latency, as kernel #1 (dependent L2 reads, a
// shuffle reduction and a 2x2 solve per iteration); the sampling costs two
// __syncwarp more per window than kernel #3 (both measured slower than
// kernel #1 on an H100, PERF.md).

#include "lk_klt.cuh"

using namespace ssvio_lk;

// Plain C entry point (bound with ctypes); see launch_level.
extern "C" int ssvio_lk_level_pk(const float* prev, const float* gx,
                                 const float* gy, const float* cur, int H,
                                 int W, int Hb, int Wb, const float* pts_prev,
                                 const float* pts_guess, const int* frozen0,
                                 float* pts_out, int* flag, int n, int win,
                                 int iters, float eps, float min_eig,
                                 void* stream) {
  return launch_level<SeparableSampler, kWarpsPerBlock, false>(
      prev, gx, gy, cur, H, W, Hb, Wb, pts_prev, pts_guess, frozen0, pts_out,
      flag, n, win, iters, eps, min_eig, stream);
}
