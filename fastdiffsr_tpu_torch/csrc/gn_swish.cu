// K1, pass 2: y = swish((x - mean_c) * inv_c * scale + bias) of an NHWC
// map, cast to x's type, with mean_c and inv_c of GroupNorm taken from
// pass 1's per-channel sums inside the kernel.
//
// Replaces fastdiffsr_tpu/ops/groupnorm.py::_gn_swish_pallas. That kernel
// made two Pallas calls: per-(batch, HW tile) partial channel sums, then,
// after a cross-tile sum and group_stats_to_norm in XLA, a normalise +
// affine + swish pass per tile. Here pass 1 is K2's kernel
// (channel_stats.cu, the same function: per-block partial sums and an
// ordered reduce) and this file is pass 2; the channel->group collapse
// between them is block_group_mean_inv (common.cuh), redone by every block of
// pass 2, so a call is two launches with no PyTorch kernel in between.
//
// Bound on the H100: bytes. Each element costs ~10 flops and one exp,
// far below the ~295 flop/byte ridge; the floor is reading x and writing
// y once, 2*B*H*W*C*sizeof(T) / 3.35 TB/s (pass 1 reads x once more).
//
// Design: a grid over (HW tiles, B). A block first computes its image's
// per-channel mean and inv_std from the channel sums and stages them with
// scale and bias (4*C floats) in shared memory, then walks its tile with
// vector loads and stores: float4 for
// float32 and __nv_bfloat162 for bfloat16 (V channels per access, C % V
// == 0; a scalar path takes other widths). Each product and sum is
// rounded on its own (__fmul_rn / __fadd_rn, no FMA contraction) and
// swish is x * (1 / (1 + e^-x)), the order of operations of the plain
// PyTorch version (ops/groupnorm.py::gn_swish_plain), so that a bfloat16
// output rounds to the same neighbour as the plain version's.

#include "common.cuh"

namespace fdsr {
namespace {

constexpr int kThreads = 256;
constexpr int kElemsPerBlock = 8192;   // elements of x one block covers

__device__ __forceinline__ float gn_swish_one(float v, float mean, float inv,
                                              float scale, float bias) {
  float t = __fmul_rn(__fsub_rn(v, mean), inv);
  t = __fadd_rn(__fmul_rn(t, scale), bias);
  const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-t)));
  return __fmul_rn(t, sig);
}

template <typename T, int V>
struct Vec;

template <>
struct Vec<float, 4> {
  __device__ static void load(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 2> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const __nv_bfloat162 q = *reinterpret_cast<const __nv_bfloat162*>(p);
    v[0] = __low2float(q);
    v[1] = __high2float(q);
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    *reinterpret_cast<__nv_bfloat162*>(p) =
        __halves2bfloat162(__float2bfloat16_rn(v[0]),
                           __float2bfloat16_rn(v[1]));
  }
};

template <typename T>
struct Vec<T, 1> {
  __device__ static void load(const T* p, float* v) { v[0] = to_f32<T>(*p); }
  __device__ static void store(T* p, const float* v) {
    *p = from_f32<T>(v[0]);
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
gn_swish_apply_kernel(const T* __restrict__ x,
                      const float* __restrict__ stats, int groups, float eps,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ y,
                      int HW, int C, int pixels_per_block) {
  extern __shared__ float smem[];
  float* s_mean = smem;
  float* s_inv = smem + C;
  float* s_scale = smem + 2 * C;
  float* s_bias = smem + 3 * C;
  const int b = blockIdx.y;
  block_group_mean_inv(stats + (size_t)b * 2 * C, nullptr, C, 0, HW, groups,
                       eps, s_mean, s_inv);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    s_scale[c] = scale[c];
    s_bias[c] = bias[c];
  }
  __syncthreads();
  const int p0 = blockIdx.x * pixels_per_block;
  const int p1 = min(p0 + pixels_per_block, HW);
  if (p0 >= p1) return;
  const int cv = C / V;                       // vectors per pixel
  const int n_vec = (p1 - p0) * cv;
  const size_t base = ((size_t)b * HW + p0) * C;
  const T* xb = x + base;
  T* yb = y + base;
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    const int c0 = (i % cv) * V;
    float v[V];
    Vec<T, V>::load(xb + (size_t)i * V, v);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = c0 + k;
      v[k] = gn_swish_one(v[k], s_mean[c], s_inv[c], s_scale[c], s_bias[c]);
    }
    Vec<T, V>::store(yb + (size_t)i * V, v);
  }
}

template <typename T, int V>
void launch(const void* x, const float* stats, int groups, float eps,
            const float* scale, const float* bias, void* y, int B, int HW,
            int C, cudaStream_t stream) {
  const int ppb = C < kElemsPerBlock ? kElemsPerBlock / C : 1;
  dim3 grid((HW + ppb - 1) / ppb, B);
  const size_t smem = 4 * (size_t)C * sizeof(float);
  gn_swish_apply_kernel<T, V><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), stats, groups, eps, scale, bias,
      static_cast<T*>(y), HW, C, ppb);
}

}  // namespace
}  // namespace fdsr

extern "C" {

// x, y: (B, HW, C) in float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1).
// stats: (B, 2, C) float32 per-channel (sum, sum of squares) of x over HW;
// groups divides C; scale, bias: (C,) float32. C * 16 bytes must fit the
// 48 KB of shared memory a block gets without opting in (C <= 3072).
int fdsr_gn_swish_apply(const void* x, const float* stats, int groups,
                        float eps, const float* scale, const float* bias,
                        void* y, int B, int HW, int C, int is_bf16,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (C % 2 == 0)
      fdsr::launch<__nv_bfloat16, 2>(x, stats, groups, eps, scale, bias, y, B,
                                     HW, C, s);
    else
      fdsr::launch<__nv_bfloat16, 1>(x, stats, groups, eps, scale, bias, y, B,
                                     HW, C, s);
  } else {
    if (C % 4 == 0)
      fdsr::launch<float, 4>(x, stats, groups, eps, scale, bias, y, B, HW, C,
                             s);
    else
      fdsr::launch<float, 1>(x, stats, groups, eps, scale, bias, y, B, HW, C,
                             s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
