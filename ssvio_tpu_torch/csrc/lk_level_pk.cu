// Kernel #4: one pyramid level of forward-additive KLT for N keypoints with
// separable window sampling, for Hopper (sm_90a). Replaces
// ssvio_tpu/ops/lk_pallas_variants.py::lk_level_vmem_pk (factory
// _make_vmem_pk_kernel), flavours 'ymm' and 'pkmm'; the wrapper, plain
// torch version and design note are in ssvio_tpu_torch/ops/lk_variants_cuda.py,
// the level kernel, the solve, the staged region and the sampler
// (SeparableSampler) in lk_klt.cuh.
//
// The TPU kernel samples with a two-hot y-interpolation matmul By @ slab on
// the MXU, then an x blend by a lane roll ('ymm') or a second two-hot
// matmul ('pkmm'). Every output of either is a sum of exactly two non-zero
// products, so both are one function: the separable blend, y first. It
// stays on the CUDA cores: tensor cores would take the float32 pixels as
// TF32 (10 mantissa bits), another function.
//
// What bounds it on the card: latency. Each keypoint's iteration is one
// dependent chain (sample, two shuffle reductions, a 2x2 solve), and a
// level lasts as long as its slowest keypoint's chain. A design that
// restaged the (win+1)^2 window from L2 into shared memory every iteration
// and y-blended it through a second tile paid three __syncwarp and two
// shared-memory round trips per window, and measured slower than kernel
// #1's direct L2 reads. Here each warp copies a 32 x 36 float region of
// `cur` around its first search window into its own shared memory once a
// level (cp.async, 16-byte units where the rows are 16-byte aligned), and
// every window inside it is blended in registers from there, with no
// barrier in the loop; windows that leave it, and the template windows,
// read L2. The values, and the order of every sum, are those of the
// two-pass blend through shared tiles, bit for bit: its FMA contraction is
// pinned (lk_klt.cuh::lerp2). The sampler is kernel #1's (RegionSampler)
// with the separable blend. 4 pixels a lane for win <= 11 (the path's
// class), 8 for win <= 16 (the JAX kernel's limit).

#include "lk_klt.cuh"

using namespace ssvio_lk;

// Plain C entry point (bound with ctypes); see launch_level. `stats`: null,
// or int32 [3] that the level adds to (level_kernel).
extern "C" int ssvio_lk_level_pk(const float* prev, const float* gx,
                                 const float* gy, const float* cur, int H,
                                 int W, int Hb, int Wb, const float* pts_prev,
                                 const float* pts_guess, const int* frozen0,
                                 float* pts_out, int* flag, int n, int win,
                                 int iters, float eps, float min_eig,
                                 int* stats, void* stream) {
  if (win <= kMaxWin)
    return launch_level<SeparableSampler<kPixPerLane>, kWarpsPerBlock>(
        prev, gx, gy, cur, H, W, Hb, Wb, pts_prev, pts_guess, frozen0,
        pts_out, flag, n, win, iters, eps, min_eig, stats, stream);
  return launch_level<SeparableSampler<2 * kPixPerLane>, kWarpsPerBlock>(
      prev, gx, gy, cur, H, W, Hb, Wb, pts_prev, pts_guess, frozen0, pts_out,
      flag, n, win, iters, eps, min_eig, stats, stream);
}
