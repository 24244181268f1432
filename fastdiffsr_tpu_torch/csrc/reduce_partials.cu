// K3's second statistics pass: (B, n_tiles, 2, C) per-tile partial sums ->
// (B, 2, C), summed over the tiles in a fixed order. Both K3 kernels
// (fused_conv.cu, fused_conv_wgmma.cu) write per-tile partials in their
// epilogue and launch this after them; K2 (channel_stats.cu) finalises its
// own partials inside its one launch.

#include "common.cuh"

namespace fdsr {
namespace {

constexpr int kChan = 32;      // channels per block (one warp's width)
constexpr int kRedLanes = 16;  // tile lanes per block

// A block sums 32 channels of one (image, moment): lane l of kRedLanes adds
// the tiles l, l + kRedLanes, ... in order, then the lanes are added in
// order. The order is fixed, so the result is the same on every run.
__global__ void __launch_bounds__(kChan * kRedLanes)
reduce_partials_kernel(const float* __restrict__ partial,
                       float* __restrict__ out, int n_tiles, int C) {
  const int c = blockIdx.x * kChan + threadIdx.x;
  const int k = blockIdx.y, b = blockIdx.z;
  float s = 0.f;
  if (c < C) {
    const float* p = partial + ((size_t)b * n_tiles * 2 + k) * C + c;
    for (int t = threadIdx.y; t < n_tiles; t += kRedLanes)
      s += p[(size_t)t * 2 * C];
  }
  __shared__ float red[kRedLanes][kChan + 1];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float tot = 0.f;
#pragma unroll
    for (int l = 0; l < kRedLanes; ++l) tot += red[l][threadIdx.x];
    out[((size_t)b * 2 + k) * C + c] = tot;
  }
}

}  // namespace

void launch_reduce_partials(const float* partial, float* out, int B,
                            int n_tiles, int C, cudaStream_t stream) {
  dim3 grid((C + kChan - 1) / kChan, 2, B);
  dim3 block(kChan, kRedLanes);
  reduce_partials_kernel<<<grid, block, 0, stream>>>(partial, out, n_tiles, C);
}

}  // namespace fdsr
