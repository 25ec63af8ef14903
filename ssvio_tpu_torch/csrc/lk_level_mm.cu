// Kernel #5: one pyramid level of forward-additive KLT for N keypoints with
// the window sampled as two two-hot products, for Hopper (sm_90a). Replaces
// ssvio_tpu/ops/lk_pallas_variants.py::lk_level_vmem_mm (factory
// _make_vmem_mm_kernel), flavours 'mm' (bf16 products) and 'mm_f32'; the
// wrapper, plain torch version and design note are in
// ssvio_tpu_torch/ops/lk_variants_cuda.py, the level kernel, the solve and
// the staged region in lk_klt.cuh.
//
// The TPU kernel tracks MM_KP = 8 keypoints in lockstep and samples each
// window as W = By S Bx^T: S the integer window, By / Bx "two-hot" matrices
// holding (1-f) and f on two neighbouring diagonals, stacked block-diagonal
// for the group on the MXU. A frozen keypoint keeps its position, so each
// keypoint's answer is the one it gets alone: here one warp is a keypoint,
// 4 a block, and each exits on its own, as in kernels #1-#4.
//
// What bounds it on the card: latency, the chain of one iteration (sample,
// two shuffle reductions, a 2x2 solve), and the level waits for its slowest
// keypoint, which at bf16 runs about twice the iterations of the float32
// kernels (its windows carry bf16 rounding noise that keeps the step above
// eps). A design with wmma fragments put S, By, Bx, the product and its
// bf16 copy through shared memory every window (four __syncwarp, six round
// trips) and held 8 warps in lockstep with __syncthreads_or; it measured 3x
// kernel #1.
//
// 'mm' (TensorCoreSampler): every operand lives in registers. Per window a
// lane builds its A fragment of By and its B fragment of Bx^T from bf16(1-f)
// and bf16(f), rounded separately as the JAX kernel does
// (lk_pallas_variants.py:244, :251), reads its B fragment of S (bf16) from
// the warp's staged region of `cur` (32 x 40 bf16, 2.5 KB; or L2 outside
// it, and for the template windows), and runs
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 for R = By S; it rounds R's
// accumulators to bf16 (:258) and reuses them in place as the A fragment of
// W = R Bx^T: the C layout of two m16n8 tiles is the A layout of one m16k16
// tile. T, Gx, Gy and the sampled window stay in the accumulator layout (8
// floats a lane cover the 16 x 16 window; rows and columns >= win are 0
// through By and Bx), summed per lane and then by warp_sum. No shared
// memory and no __syncwarp inside an iteration. One k-step per product for
// win <= 15, two at win 16 (S and R are 17 wide). Each sampled value is a
// sum of two exact bf16 x bf16 products, rounded once; only how the tensor
// cores round an f32 accumulation can differ from the plain version, and
// the window sums run in another order. Not wgmma: it takes a 64-row tile
// over a warpgroup and commits asynchronously, built for throughput on
// large tiles, where this is one keypoint's chain of 16 x 16 products and
// latency is the cost. The wrapper casts the four planes to bf16 before
// the launch, as JAX's wrapper does (:459-460).
//
// 'mm_f32' takes SeparableSampler (lk_klt.cuh), kernel #4's: the two-hot
// products in float32 on the CUDA cores are the two-term blends, since the
// tensor cores take float32 only as TF32.

#include <cuda_bf16.h>

#include "lk_klt.cuh"

using namespace ssvio_lk;

namespace {

using bits16 = unsigned short;        // a bf16 as its bits

__device__ __forceinline__ uint32_t pack(bits16 lo, bits16 hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ bits16 bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Entry (i, k) of a two-hot matrix: w0 at k = i, w1 at k = i + 1, rows
// i < win; 0 elsewhere.
__device__ __forceinline__ bits16 hot(int i, int k, int win, bits16 w0,
                                      bits16 w1) {
  return i < win ? (k == i ? w0 : k == i + 1 ? w1 : (bits16)0) : (bits16)0;
}

// c += A B for one m16n8k16 tile: A 16 x 16 bf16 (row), B 16 x 8 bf16
// (col), c 16 x 8 float32, in the fragment layouts of the PTX ISA.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Kernel #5 'mm': W = By S Bx^T on register-resident mma.sync fragments.
// Lane (g, t) = (lane / 4, lane % 4) holds out[4 j + q] = W[g + 8 (q / 2)]
// [8 j + 2 t + q % 2] (pixel()). kK k-steps a product: 1 for win <= 15,
// 2 for win 16.
template <int kK>
struct TensorCoreSampler {
  using Elem = __nv_bfloat16;
  using Reg = Region<bits16, 32, 40>;
  static constexpr int kPix = 8;
  static constexpr int kMaxWindow = kK == 1 ? 15 : 16;
  static constexpr int kNR = kK == 1 ? 2 : 3;     // n8 tiles of R (win + 1)
  static constexpr int kSmemBytes = Reg::kBytes;
  int H, W, lane, win, g, t;
  Reg reg;
  int n_outside = 0;
  __device__ TensorCoreSampler(int H_, int W_, int lane_, int win_,
                               unsigned char* smem)
      : H(H_), W(W_), lane(lane_), win(win_), g(lane_ >> 2), t(lane_ & 3),
        reg{reinterpret_cast<bits16*>(smem)} {}

  __device__ __forceinline__ bool pixel(int k, int& r, int& c) const {
    r = g + 8 * ((k >> 1) & 1);
    c = 8 * (k >> 2) + 2 * t + (k & 1);
    return r < win && c < win;
  }

  // s(k, n): the bits of window entry S[k][n], k, n <= win.
  template <class Src>
  __device__ __forceinline__ void sample(Src s, float fx, float fy,
                                         float out[kPix]) const {
    const bits16 y0 = bf16_bits(1.f - fy), y1 = bf16_bits(fy);
    const bits16 x0 = bf16_bits(1.f - fx), x1 = bf16_bits(fx);
    auto S = [&](int k, int n) -> bits16 {
      return (k <= win && n <= win) ? s(k, n) : (bits16)0;
    };
    // R = By S: A = By [16, 16 kK], B = S [16 kK, 8 kNR]
    float R[kNR][4];
#pragma unroll
    for (int j = 0; j < kNR; ++j) R[j][0] = R[j][1] = R[j][2] = R[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kK; ++ks) {
      const int k0 = 16 * ks + 2 * t;
      const uint32_t a[4] = {
          pack(hot(g, k0, win, y0, y1), hot(g, k0 + 1, win, y0, y1)),
          pack(hot(g + 8, k0, win, y0, y1), hot(g + 8, k0 + 1, win, y0, y1)),
          pack(hot(g, k0 + 8, win, y0, y1), hot(g, k0 + 9, win, y0, y1)),
          pack(hot(g + 8, k0 + 8, win, y0, y1),
               hot(g + 8, k0 + 9, win, y0, y1))};
#pragma unroll
      for (int j = 0; j < kNR; ++j) {
        const int n = 8 * j + g;
        mma_bf16(R[j], a, pack(S(k0, n), S(k0 + 1, n)),
                 pack(S(k0 + 8, n), S(k0 + 9, n)));
      }
    }
    // W = bf16(R) Bx^T: R's accumulators of n-tiles 2 ks, 2 ks + 1 are the
    // A fragment of k-step ks; B = Bx^T [16 kK, 16], two n8 tiles
    float Wt[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < kK; ++ks) {
      const float* lo = R[2 * ks];
      uint32_t a[4] = {pack(bf16_bits(lo[0]), bf16_bits(lo[1])),
                       pack(bf16_bits(lo[2]), bf16_bits(lo[3])), 0u, 0u};
      if (2 * ks + 1 < kNR) {
        const float* hi = R[2 * ks + 1];
        a[2] = pack(bf16_bits(hi[0]), bf16_bits(hi[1]));
        a[3] = pack(bf16_bits(hi[2]), bf16_bits(hi[3]));
      }
      const int k0 = 16 * ks + 2 * t;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = 8 * j + g;
        mma_bf16(Wt[j], a,
                 pack(hot(n, k0, win, x0, x1), hot(n, k0 + 1, win, x0, x1)),
                 pack(hot(n, k0 + 8, win, x0, x1),
                      hot(n, k0 + 9, win, x0, x1)));
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      out[q] = Wt[0][q];
      out[4 + q] = Wt[1][q];
    }
  }

  __device__ __forceinline__ void window(
      const __nv_bfloat16* __restrict__ plane, int iy, int ix, float fx,
      float fy, float out[kPix]) const {
    const bits16* p = reinterpret_cast<const bits16*>(plane);
    sample(
        [&](int k, int n) -> bits16 {
          const int y = iy + k, x = ix + n;
          return (y < H && x < W) ? __ldg(p + (size_t)y * W + x) : (bits16)0;
        },
        fx, fy, out);
  }
  __device__ __forceinline__ void stage(
      const __nv_bfloat16* __restrict__ plane, int iy, int ix) {
    reg.stage(reinterpret_cast<const bits16*>(plane), iy, ix, win + 1, H, W,
              lane);
  }
  __device__ __forceinline__ void search(
      const __nv_bfloat16* __restrict__ plane, int iy, int ix, float fx,
      float fy, float out[kPix]) {
    if (reg.holds(iy, ix, win + 1)) {
      sample([&](int k, int n) { return reg.at(iy + k, ix + n); }, fx, fy,
             out);
    } else {
      ++n_outside;
      window(plane, iy, ix, fx, fy, out);
    }
  }
};

// The windows a sampler of this kernel takes at n top-lefts tl [n, 2]
// (x, y) of one plane: out [n, win * win] float32, one warp a window. With
// `staged` the warp first stages its region around the window and samples
// through search() (the search path), else through window() (the template
// path, L2). A check of the sampler alone: no path launches it.
template <class Sampler>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
windows_kernel(const typename Sampler::Elem* __restrict__ plane, int H,
               int W, const float* __restrict__ tl, float* __restrict__ out,
               int n, int win, int staged) {
  __shared__ __align__(128) unsigned char smem[kWarpsPerBlock *
                                               Sampler::kSmemBytes + 32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsPerBlock + warp;
  if (i >= n) return;                   // uniform across the warp
  Sampler smp(H, W, lane, win, smem + warp * Sampler::kSmemBytes);
  const float bx = floorf(tl[2 * i]), by = floorf(tl[2 * i + 1]);
  const float fx = tl[2 * i] - bx, fy = tl[2 * i + 1] - by;
  float v[Sampler::kPix];
  if (staged) {
    smp.stage(plane, (int)by, (int)bx);
    smp.search(plane, (int)by, (int)bx, fx, fy, v);
  } else {
    smp.window(plane, (int)by, (int)bx, fx, fy, v);
  }
#pragma unroll
  for (int k = 0; k < Sampler::kPix; ++k) {
    int r, c;
    if (smp.pixel(k, r, c)) out[(size_t)i * win * win + r * win + c] = v[k];
  }
}

template <class Sampler>
int launch_windows(const void* plane, int H, int W, const float* tl,
                   float* out, int n, int win, int staged, void* stream) {
  windows_kernel<Sampler><<<(n + kWarpsPerBlock - 1) / kWarpsPerBlock,
                            32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
      (const typename Sampler::Elem*)plane, H, W, tl, out, n, win, staged);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point of windows_kernel (bound with ctypes): TensorCoreSampler
// on a bf16 plane with use_bf16, else SeparableSampler on a float32 one.
// Top-lefts must lie in [0, W) x [0, H). Returns cudaGetLastError().
extern "C" int ssvio_lk_mm_windows(const void* plane, int H, int W,
                                   const float* tl, float* out, int n,
                                   int win, int use_bf16, int staged,
                                   void* stream) {
  if (n <= 0) return 0;
  if (win < 1 || win > 16) return (int)cudaErrorInvalidValue;
  if (use_bf16)
    return win <= 15 ? launch_windows<TensorCoreSampler<1>>(
                           plane, H, W, tl, out, n, win, staged, stream)
                     : launch_windows<TensorCoreSampler<2>>(
                           plane, H, W, tl, out, n, win, staged, stream);
  return win <= kMaxWin
             ? launch_windows<SeparableSampler<kPixPerLane>>(
                   plane, H, W, tl, out, n, win, staged, stream)
             : launch_windows<SeparableSampler<2 * kPixPerLane>>(
                   plane, H, W, tl, out, n, win, staged, stream);
}

// Plain C entry point (bound with ctypes); see launch_level. With use_bf16
// the planes are bf16 ('mm'), else float32 ('mm_f32'). `stats`: null, or
// int32 [3] that the level adds to (level_kernel).
extern "C" int ssvio_lk_level_mm(const void* prev, const void* gx,
                                 const void* gy, const void* cur, int H, int W,
                                 int Hb, int Wb, const float* pts_prev,
                                 const float* pts_guess, const int* frozen0,
                                 float* pts_out, int* flag, int n, int win,
                                 int iters, float eps, float min_eig,
                                 int use_bf16, int* stats, void* stream) {
#define SSVIO_MM_LAUNCH(S)                                                   \
  launch_level<S, kWarpsPerBlock>(prev, gx, gy, cur, H, W, Hb, Wb,          \
                                  pts_prev, pts_guess, frozen0, pts_out,    \
                                  flag, n, win, iters, eps, min_eig, stats, \
                                  stream)
  if (use_bf16)
    return win <= 15 ? SSVIO_MM_LAUNCH(TensorCoreSampler<1>)
                     : SSVIO_MM_LAUNCH(TensorCoreSampler<2>);
  return win <= kMaxWin ? SSVIO_MM_LAUNCH(SeparableSampler<kPixPerLane>)
                        : SSVIO_MM_LAUNCH(SeparableSampler<2 * kPixPerLane>);
#undef SSVIO_MM_LAUNCH
}
