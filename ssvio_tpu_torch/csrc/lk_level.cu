// One pyramid level of forward-additive KLT for N keypoints, for Hopper
// (sm_90a). Replaces ssvio_tpu/ops/lk_pallas.py::lk_level_vmem; the wrapper,
// plain torch version and design note are in ssvio_tpu_torch/ops/lk_cuda.py,
// the level kernel, the per-keypoint solve and the sampler
// (FourCornerSampler) in lk_klt.cuh.
//
// Bounds equal the TPU kernel's: the window's top-left stays in
// [0, Wb - win - 2] x [0, Hb - win - 2] where (Hb, Wb) are the padded level
// dims; reads at or beyond the true dims (H, W) return 0, the value of the
// TPU wrapper's zero padding. The template window's integer origin is
// clipped into those bounds exactly as lk_pallas.py:208-215 does.
//
// What bounds it on the card: latency, the dependent chain of one
// iteration (sample the window, two 5-step shuffle reductions, a 2x2
// solve), and a level lasts as long as its longest chain (30 iterations at
// every KITTI level of the path). The kernel's first design read each
// window's four corners from L2, 16 loads a lane, so an L2 round trip sat
// inside every link of the chain. Here each warp copies a region of `cur`
// around its first search window into its own shared memory once a level
// (cp.async, 16-byte units where the rows are 16-byte aligned) and blends
// every search window inside it in registers, with no barrier in the loop;
// a lane reads its pixels' 16 corners with no branch between them, so the
// loads go out back to back. Windows that leave the region, and the three
// template windows, read L2. The values are the L2 design's bit for bit
// wherever a window is read: the blend's FMA contraction is the one nvcc
// chose for it, pinned (lk_klt.cuh::FourCornerBlend). 4 pixels a lane for
// win <= 11 (the path's), 8 for <= 16, 18 for <= 24, the largest window
// the JAX kernel's 32-row slab holds at every row offset
// (lk_pallas.py:281-288).

#include "lk_klt.cuh"

using namespace ssvio_lk;

// Plain C entry point (bound with ctypes); see launch_level. `stats`: null,
// or int32 [3] that the level adds to (level_kernel).
extern "C" int ssvio_lk_level(const float* prev, const float* gx,
                              const float* gy, const float* cur, int H, int W,
                              int Hb, int Wb, const float* pts_prev,
                              const float* pts_guess, const int* frozen0,
                              float* pts_out, int* flag, int n, int win,
                              int iters, float eps, float min_eig,
                              int* stats, void* stream) {
  return launch_level_by_class<FourCornerSampler>(
      prev, gx, gy, cur, H, W, Hb, Wb, pts_prev, pts_guess, frozen0, pts_out,
      flag, n, win, iters, eps, min_eig, stats, stream);
}
