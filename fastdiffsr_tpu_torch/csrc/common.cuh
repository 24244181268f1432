// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel reads and writes NHWC maps in float32 or bfloat16 and does
// its arithmetic in float32. Cross-block reductions never use float
// atomics: a kernel writes per-block partial sums (B, nTiles, 2, C) and
// launch_reduce_partials sums them over the tiles in a fixed order, so a
// result is the same on every run.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fdsr {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous global -> shared copies. The copy reads src_bytes of src and
// zero-fills the rest of the destination (src_bytes = 0: zeros only).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 1 / d for 1 <= d <= 2^126: the reciprocal approximation refined by two
// Newton steps, without the range check and branch of IEEE division (that
// branch kept the elements of a vector from overlapping). It agreed with
// IEEE 1 / d wherever the tests compared them; that it is rounded to
// nearest for every d is not proven.
__device__ __forceinline__ float rcp_newton(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  r = fmaf(r, fmaf(-d, r, 1.f), r);
  return fmaf(r, fmaf(-d, r, 1.f), r);
}

// swish(x) = x * (1 / (1 + e^-x)) with the exact expf, each step rounded on
// its own as the plain PyTorch version computes it; below x = -87 the
// denominator is held at 2^126, where the result is under 1e-35 in size
// either way
__device__ __forceinline__ float swish_exact(float x) {
  return __fmul_rn(x, rcp_newton(fminf(__fadd_rn(1.f, expf(-x)), 0x1p126f)));
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);

template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);

template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The GroupNorm group collapse, on the device, by all threads of a 1-D
// block: on return s_mean[c] and s_inv[c] hold the mean and 1/std of the
// group of channel c of one image, for c < C1 + C2, and the block is
// synchronised. st1 holds (2, C1) float32 per-channel (sum, sum of squares)
// over H,W of the first C1 channels and st2 (2, C2) of the rest (unread
// when C2 = 0), so two maps are normalised as their channel concat without
// building it. hw is the spatial count the sums cover. The same operations
// in the same order as ops/fused_conv.py::group_stats_to_norm, each
// rounded on its own: mean = sum / cnt, var = max(sumsq / cnt - mean^2,
// 0), inv = rsqrt(var + eps). The channel sums are fetched with one load
// per thread, all in flight together, and one thread per group adds them
// up in shared memory: a group has a handful of channels, so every block
// that needs the statistics redoes this instead of reading them from a
// tensor that a chain of small PyTorch kernels would have to fill first.
__device__ __forceinline__ void block_group_mean_inv(
    const float* __restrict__ st1, const float* __restrict__ st2, int C1,
    int C2, int hw, int groups, float eps, float* s_mean, float* s_inv) {
  const int C = C1 + C2;
  const int cg = C / groups;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const bool first = c < C1;
    const float* st = first ? st1 + c : st2 + (c - C1);
    s_mean[c] = st[0];
    s_inv[c] = st[first ? C1 : C2];
  }
  __syncthreads();
  const float cnt = static_cast<float>(hw * cg);
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    float s = 0.f, ss = 0.f;
    for (int k = g * cg; k < (g + 1) * cg; ++k) {
      s = __fadd_rn(s, s_mean[k]);
      ss = __fadd_rn(ss, s_inv[k]);
    }
    const float mean = __fdiv_rn(s, cnt);
    const float var =
        fmaxf(__fsub_rn(__fdiv_rn(ss, cnt), __fmul_rn(mean, mean)), 0.f);
    const float inv = rsqrtf(__fadd_rn(var, eps));
    for (int k = g * cg; k < (g + 1) * cg; ++k) {
      s_mean[k] = mean;
      s_inv[k] = inv;
    }
  }
  __syncthreads();
}

// (B, n_tiles, 2, C) partial sums -> (B, 2, C), summed over tiles in order.
void launch_reduce_partials(const float* partial, float* out, int B,
                            int n_tiles, int C, cudaStream_t stream);

}  // namespace fdsr
