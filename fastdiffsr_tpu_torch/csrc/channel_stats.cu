// K2: per-channel (sum, sum of squares) over H,W of an NHWC map, in float32,
// (B, HW, C) -> (B, 2, C), in one launch.
//
// Replaces fastdiffsr_tpu/ops/groupnorm.py::channel_stats_pallas, an
// H-tiled Pallas reduction whose grid carried one (b, row-band) per step
// and summed the band partials in XLA afterwards.
//
// Bound on the H100: bytes. Each element is read once and costs two
// flops, far below the ~295 flop/byte ridge, so the floor is reading x once
// and writing 8*B*C bytes: (B*H*W*C*sizeof(T) + 8*B*C) / 3.35 TB/s. A map of
// up to 16.8 MB (the 512^2 eval's largest, 256^2 x 64 in float32) stays in
// the 50 MB L2 between the calls of a timing loop, as it does in the
// forward, where the conv before K2 has just written it: there a call can
// take less than this bound.
//
// Design. The launch plan (vector width, blocks per image) is computed in
// Python (ops/groupnorm.py::channel_stats_plan) from the shape alone and
// passed in, so the CPU tests check it and a result is the same on every
// card.
//
// - 16-byte loads. A block takes a slab of 32 channels (grid y walks the
//   slabs). A thread reads V of them of one pixel as one float4 (float32,
//   V = 4) or uint4 (bfloat16, V = 8), so a warp reads 4 or 8 neighbouring
//   pixels' 128 or 64 contiguous bytes; where C is not a multiple of V, or
//   x is not 16-byte aligned, the plan takes V = 1 (scalar loads) in this
//   same kernel. The block's other threads are pixel lanes (32, 64 or 8),
//   and each walks its pixels with kUnroll loads issued before any is
//   summed.
// - A grid sized to the card. The plan gives each (image, slab) n_blocks
//   blocks: about two per SM over the whole grid, at most 128 per (image,
//   slab) (a block per SM in all where that cap would leave fewer), and no
//   more than give every lane a pixel; block k of n sums pixels
//   [k*HW/n, (k+1)*HW/n). So a block streams a long contiguous range, and
//   an image's partials stay few enough for one block to sum them in one
//   round of loads.
// - Fixed-order sums, no float atomics. A thread adds its pixels in order
//   (__fadd_rn / __fmul_rn: no FMA contraction, so the CPU model in
//   tests/torch_k2_model.py reproduces the bits); the block adds its lanes
//   in order and writes its (2, 32) partial to the (B, n_slabs, n_blocks,
//   2, 32) scratch.
// - Finalisation in the last block. After the partial is written, the
//   block synchronises and its thread 0 fences and takes a ticket with an
//   integer atomicAdd on the counter of its (image, slab) (the pattern of
//   cooperative groups' grid sync, without its wait). The block that draws
//   the last ticket fences again and sums that (image, slab)'s partials
//   itself, in block order: lane l of 16 adds blocks l, l + 16, ... (float4
//   loads from L2), then the lanes are added in order. Which block comes
//   last changes from run to run; the order of the sum does not, so every
//   call and every CUDA-graph replay gives the same bits. That block then
//   sets the counter back to 0, so the next call (and the next replay)
//   finds it zeroed. No grid-wide sync, no cooperative launch.
// - The counters are a zero-initialised __device__ array of kCounterSlots
//   slots of kSlotCounters ints each. The wrapper gives every (device,
//   stream) it sees a slot of its own, so calls that may run at once never
//   share a counter. A static array needs no allocation: a buffer that
//   the wrapper allocated while a CUDA graph was being captured could not
//   be zeroed outside the graph.

#include "common.cuh"

namespace fdsr {
namespace {

constexpr int kThreads = 256;
constexpr int kSlab = 32;          // channels per block
constexpr int kUnroll = 8;         // loads in flight per thread
constexpr int kFinalLanes = 16;    // lanes of the last block's sum
constexpr int kCounterSlots = 128;
constexpr int kSlotCounters = 4096;

static_assert(kThreads == kFinalLanes * (2 * kSlab / 4),
              "the last block reads one float4 of a partial row a thread");

__device__ int g_counters[kCounterSlots][kSlotCounters];

// V channels of one pixel as one load, and their float32 values
template <typename T, int V>
struct Loader;

template <>
struct Loader<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ void unpack(Raw r, float (&f)[1]) {
    f[0] = r;
  }
};

template <>
struct Loader<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void unpack(Raw r, float (&f)[4]) {
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
};

template <>
struct Loader<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ void unpack(Raw r, float (&f)[1]) {
    f[0] = __uint_as_float(static_cast<uint32_t>(r) << 16);
  }
};

template <>
struct Loader<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  // element 2i is the low half of word i
  static __device__ __forceinline__ void unpack(Raw r, float (&f)[8]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// grid (n_blocks, n_slabs, B), kThreads threads
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
channel_stats_kernel(const T* __restrict__ x, float* __restrict__ partial,
                     float* __restrict__ stats, int slot, int HW, int C) {
  using L = Loader<T, V>;
  constexpr int SU = kSlab / V;      // channel vectors per slab
  constexpr int PL = kThreads / SU;  // pixel lanes
  constexpr int kRow = 2 * kSlab;    // floats of one block's partial
  constexpr int kRed = 2 * PL * kSlab > kFinalLanes * kRow
                           ? 2 * PL * kSlab : kFinalLanes * kRow;
  __shared__ __align__(16) float red[kRed];
  __shared__ int s_last;
  const int t = threadIdx.x;
  const int blk = blockIdx.x, slab = blockIdx.y, b = blockIdx.z;
  const int n_blocks = gridDim.x, n_slabs = gridDim.y;
  const int u = t % SU, lane = t / SU;
  const int c0 = slab * kSlab;
  const int c = c0 + u * V;

  // 1. this thread's pixels p0 + lane, p0 + lane + PL, ... in order
  float s1[V], s2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s1[e] = s2[e] = 0.f;
  if (c < C) {
    const int p0 = static_cast<int>(static_cast<long long>(blk) * HW /
                                    n_blocks);
    const int p1 = static_cast<int>(static_cast<long long>(blk + 1) * HW /
                                    n_blocks);
    const T* xb = x + static_cast<size_t>(b) * HW * C + c;
    for (int p = p0 + lane; p < p1; p += kUnroll * PL) {
      typename L::Raw r[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
        if (p + j * PL < p1)
          r[j] = L::load(xb + static_cast<size_t>(p + j * PL) * C);
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (p + j * PL < p1) {
          float f[V];
          L::unpack(r[j], f);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            s1[e] = __fadd_rn(s1[e], f[e]);
            s2[e] = __fadd_rn(s2[e], __fmul_rn(f[e], f[e]));
          }
        }
      }
    }
  }

  // 2. the block's partial: lanes added in order
  float* r1 = red + lane * kSlab + u * V;
  float* r2 = red + (PL + lane) * kSlab + u * V;
  if constexpr (V == 1) {
    r1[0] = s1[0];
    r2[0] = s2[0];
  } else {
#pragma unroll
    for (int e = 0; e < V; e += 4) {
      *reinterpret_cast<float4*>(r1 + e) =
          make_float4(s1[e], s1[e + 1], s1[e + 2], s1[e + 3]);
      *reinterpret_cast<float4*>(r2 + e) =
          make_float4(s2[e], s2[e + 1], s2[e + 2], s2[e + 3]);
    }
  }
  __syncthreads();
  // this (image, slab)'s partials: n_blocks rows of (2, kSlab)
  float* rows = partial + (static_cast<size_t>(b) * n_slabs + slab) *
                              n_blocks * kRow;
  if (t < kRow) {
    const int k = t / kSlab, ch = t % kSlab;
    float s = 0.f;
#pragma unroll
    for (int l = 0; l < PL; ++l) s = __fadd_rn(s, red[(k * PL + l) * kSlab + ch]);
    __stcg(rows + static_cast<size_t>(blk) * kRow + t, s);
  }

  // 3. a ticket; the last block of this (image, slab) goes on
  __syncthreads();
  int* counter = &g_counters[slot][b * n_slabs + slab];
  if (t == 0) {
    __threadfence();
    const bool last = atomicAdd(counter, 1) == n_blocks - 1;
    if (last) __threadfence();
    s_last = last;
  }
  __syncthreads();
  if (!s_last) return;

  // 4. the sum over blocks in block order: lane l adds blocks l, l + 16, ...
  const int q = t % (kRow / 4), l = t / (kRow / 4);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = l; i < n_blocks; i += kUnroll * kFinalLanes) {
    float4 v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      if (i + j * kFinalLanes < n_blocks)
        v[j] = __ldcg(reinterpret_cast<const float4*>(
            rows + static_cast<size_t>(i + j * kFinalLanes) * kRow) + q);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      if (i + j * kFinalLanes < n_blocks) {
        acc[0] = __fadd_rn(acc[0], v[j].x);
        acc[1] = __fadd_rn(acc[1], v[j].y);
        acc[2] = __fadd_rn(acc[2], v[j].z);
        acc[3] = __fadd_rn(acc[3], v[j].w);
      }
  }
  *reinterpret_cast<float4*>(red + l * kRow + q * 4) =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();
  if (t < kRow) {
    const int k = t / kSlab, ch = t % kSlab;
    if (c0 + ch < C) {
      float s = 0.f;
#pragma unroll
      for (int l2 = 0; l2 < kFinalLanes; ++l2)
        s = __fadd_rn(s, red[l2 * kRow + t]);
      stats[(static_cast<size_t>(b) * 2 + k) * C + c0 + ch] = s;
    }
  }
  if (t == 0) *counter = 0;
}

template <typename T, int V>
cudaError_t launch(const void* x, float* partial, float* stats, int slot,
                   int B, int HW, int C, int n_blocks, cudaStream_t s) {
  dim3 grid(n_blocks, (C + kSlab - 1) / kSlab, B);
  channel_stats_kernel<T, V><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), partial, stats, slot, HW, C);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fdsr

extern "C" {

int fdsr_channel_stats_threads() { return fdsr::kThreads; }
int fdsr_channel_stats_slab() { return fdsr::kSlab; }
int fdsr_channel_stats_final_lanes() { return fdsr::kFinalLanes; }
int fdsr_channel_stats_unroll() { return fdsr::kUnroll; }
int fdsr_channel_stats_counter_slots() { return fdsr::kCounterSlots; }
int fdsr_channel_stats_slot_counters() { return fdsr::kSlotCounters; }

// x: (B, HW, C) in float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1).
// partial: (B, n_slabs, n_blocks, 2, 32) float32 scratch, n_slabs =
// ceil(C / 32); stats: (B, 2, C) float32. The plan: vec (1, or 16 bytes of
// the type where C % vec == 0 and x is 16-byte aligned) and n_blocks
// (1..HW blocks per image and slab); slot: this stream's counter slot. A
// plan outside these limits launches nothing and returns
// cudaErrorInvalidValue.
int fdsr_channel_stats(const void* x, float* partial, float* stats, int B,
                       int HW, int C, int is_bf16, int vec, int n_blocks,
                       int slot, void* stream) {
  const int wide = is_bf16 ? 8 : 4;
  const long long n_slabs = (static_cast<long long>(C) + fdsr::kSlab - 1) /
                            fdsr::kSlab;
  if (B < 1 || B > 65535 || HW < 1 || C < 1 || n_blocks < 1 ||
      n_blocks > HW || slot < 0 || slot >= fdsr::kCounterSlots ||
      n_slabs > 65535 || B * n_slabs > fdsr::kSlotCounters ||
      !(vec == 1 || (vec == wide && C % vec == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = vec == 1 ? fdsr::launch<__nv_bfloat16, 1>(x, partial, stats, slot, B,
                                                    HW, C, n_blocks, s)
                   : fdsr::launch<__nv_bfloat16, 8>(x, partial, stats, slot, B,
                                                    HW, C, n_blocks, s);
  } else {
    err = vec == 1 ? fdsr::launch<float, 1>(x, partial, stats, slot, B, HW, C,
                                            n_blocks, s)
                   : fdsr::launch<float, 4>(x, partial, stats, slot, B, HW, C,
                                            n_blocks, s);
  }
  return static_cast<int>(err);
}

// The kernel nodes of a CUDA graph (a cudaGraph_t), in *n: how many
// kernels one replay launches.
int fdsr_graph_kernel_nodes(void* graph, int* n) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t count = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &count);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNode_t* nodes = new cudaGraphNode_t[count > 0 ? count : 1];
  err = cudaGraphGetNodes(g, nodes, &count);
  int kernels = 0;
  for (size_t i = 0; err == cudaSuccess && i < count; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    kernels += err == cudaSuccess && type == cudaGraphNodeTypeKernel;
  }
  delete[] nodes;
  *n = kernels;
  return static_cast<int>(err);
}

const char* fdsr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
