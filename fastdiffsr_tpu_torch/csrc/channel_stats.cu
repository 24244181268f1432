// K2: per-channel (sum, sum of squares) over H,W of an NHWC map.
//
// Replaces fastdiffsr_tpu/ops/groupnorm.py::channel_stats_pallas, an
// H-tiled Pallas reduction whose grid carried one (b, row-band) per step
// and summed the band partials in XLA afterwards.
//
// Bound on the H100: bytes. Each element is read once and costs two
// flops, far below the ~295 flop/byte ridge, so the floor is
// B*H*W*C*sizeof(T) / 3.35 TB/s.
//
// Design: blocks of 32 channels x 8 pixel lanes. A warp reads 32
// neighbouring channels of one pixel (one coalesced 64 or 128 byte
// segment); each block covers PIXELS_PER_TILE pixels of one image, so the
// grid has enough blocks to fill 132 SMs even at 32x32 maps. Partials per
// (b, tile) go to device memory and a second tiny pass sums them over
// tiles in a fixed order: deterministic, no float atomics.

#include "common.cuh"

namespace fdsr {
namespace {

constexpr int kChan = 32;   // channels per block (one warp's width)
constexpr int kLanes = 8;   // pixel lanes per block
constexpr int kPixelsPerTile = 256;

template <typename T>
__global__ void __launch_bounds__(kChan * kLanes)
channel_stats_kernel(const T* __restrict__ x, float* __restrict__ partial,
                     int HW, int C, int n_tiles) {
  const int tile = blockIdx.x;
  const int c = blockIdx.y * kChan + threadIdx.x;
  const int b = blockIdx.z;
  float s1 = 0.f, s2 = 0.f;
  if (c < C) {
    const int p0 = tile * kPixelsPerTile;
    const int p1 = min(p0 + kPixelsPerTile, HW);
    const T* xb = x + (size_t)b * HW * C + c;
    for (int p = p0 + threadIdx.y; p < p1; p += kLanes) {
      const float v = to_f32<T>(xb[(size_t)p * C]);
      s1 += v;
      s2 += v * v;
    }
  }
  __shared__ float red[2][kLanes][kChan + 1];
  red[0][threadIdx.y][threadIdx.x] = s1;
  red[1][threadIdx.y][threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.y < 2 && c < C) {
    float s = 0.f;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) s += red[threadIdx.y][l][threadIdx.x];
    partial[(((size_t)b * n_tiles + tile) * 2 + threadIdx.y) * C + c] = s;
  }
}

// Second pass of every statistics kernel. A block sums 32 channels of one
// (image, moment): lane l of kRedLanes adds the tiles l, l + kRedLanes, ...
// in order, then the lanes are added in order. The order is fixed, so the
// result is the same on every run.
constexpr int kRedLanes = 16;

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

extern "C" {

int fdsr_channel_stats_tiles(int HW) {
  return (HW + fdsr::kPixelsPerTile - 1) / fdsr::kPixelsPerTile;
}

// x: (B, HW, C) in float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1).
// partial: (B, n_tiles, 2, C) float32 scratch; stats: (B, 2, C) float32.
int fdsr_channel_stats(const void* x, float* partial, float* stats, int B,
                       int HW, int C, int is_bf16, void* stream) {
  const int n_tiles = fdsr_channel_stats_tiles(HW);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(n_tiles, (C + fdsr::kChan - 1) / fdsr::kChan, B);
  dim3 block(fdsr::kChan, fdsr::kLanes);
  if (is_bf16) {
    fdsr::channel_stats_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), partial, HW, C, n_tiles);
  } else {
    fdsr::channel_stats_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), partial, HW, C, n_tiles);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fdsr::launch_reduce_partials(partial, stats, B, n_tiles, C, s);
  return static_cast<int>(cudaGetLastError());
}

const char* fdsr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
