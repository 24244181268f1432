// Q1: the W8A8 3x3 convolution (SAME zero padding, stride 1) of an NHWC
// map, quantized as it is loaded, with the dequantizing epilogue:
//
//   q_h = clamp(rint(h / s_a), -127, 127)                 (int8)
//   acc = conv3x3(q_h, q_w)                               (int32)
//   y   = (float(acc) * (s_a * s_w[co])) + bias[co]       (to y's type)
//
// Replaces no Pallas kernel: fastdiffsr_tpu/ops/quant.py::quant_conv3 leaves
// the int8 x int8 -> int32 convolution to XLA (conv_general_dilated with
// preferred_element_type=int32), and PyTorch has no int8 convolution on
// CUDA. The weights arrive quantized and packed by the wrapper
// (ops/quant.py::pack_weights, once per parameter update): (9, Co_pad,
// Ci_pad) int8, tap-major, each output channel's input channels contiguous
// (the K-contiguous columns of mma's "col" B operand), zero-padded to the
// tiles. s_a is read from device memory: the wrapper never waits for it.
//
// Exactness: the epilogue keeps JAX's order of operations with every step
// rounded on its own (__fdiv_rn, rintf rounds half to even like
// torch.round / jnp.round, __int2float_rn, __fmul_rn, __fadd_rn, no FMA
// contraction), and the int32 sums are exact whatever their order, so the
// output is bit-equal to ops/quant.py's plain version on the same inputs.
//
// Bound on the H100: at the UNet's shapes, bytes in float32 (reading h and
// writing y once, 4 bytes an element each way, against 2*9*Ci int8
// operations an output: the 256x256x64->64 call moves 0.54 GB for 77 G
// int8 operations, 0.16 ms against 0.04 ms at 1979 TOP/s), and near the
// ridge in bfloat16 at Ci >= 128.
//
// Design (simple first; a wgmma/TMA pipeline is later work): an implicit
// GEMM on mma.sync.aligned.m16n8k32 s8 x s8 -> s32. A block of 4 warps
// owns an 8 x 16 pixel output tile and N = 64 output channels (8 when
// Co <= 8, the final Block's Co = 3); warp w owns two tile rows (two m16
// fragments, one per row of 16 pixels) and all N columns. For every 32
// input channels the block quantizes the 10 x 18 halo tile of h into
// shared memory (one 32-bit word of four int8 channels per thread and
// step; zeros outside the map and past Ci) and copies the 9 taps' weights
// with cp.async, then runs the 9 taps as shifted views of the halo tile.
// Both shared arrays hold 32 bytes a row (pixel or output channel) and
// swap the row's two 16-byte halves on every other group of four rows, so
// the fragment loads of a warp (8 rows x 4 words) hit 32 distinct banks.

#include "common.cuh"

namespace fdsr {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileH = 2 * kWarps;   // output rows per block, two per warp
constexpr int kTileW = 16;           // output columns: one m16 fragment
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kHaloPix = kHaloH * kHaloW;
constexpr int kKC = 32;              // input channels per step: one mma k
constexpr int kWords = kKC / 4;      // 32-bit words a row holds per step

// word `w` of row `r` of a swizzled 32-byte-row array
__device__ __forceinline__ int swz(int w, int r) {
  return w ^ (((r >> 2) & 1) << 2);
}

__device__ __forceinline__ uint32_t quant1(float v, float s_a) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, s_a)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(r)) & 0xffu;
}

template <typename T>
struct Load4;

template <>
struct Load4<float> {
  __device__ static void get(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
};

template <>
struct Load4<__nv_bfloat16> {
  __device__ static void get(const __nv_bfloat16* p, float* v) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    v[0] = __low2float(lo); v[1] = __high2float(lo);
    v[2] = __low2float(hi); v[3] = __high2float(hi);
  }
};

__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <typename Tin, typename Tout, int NT>
__global__ void __launch_bounds__(kThreads)
quant_conv3_kernel(const Tin* __restrict__ h, const int8_t* __restrict__ wq,
                   const float* __restrict__ s_w,
                   const float* __restrict__ s_a_ptr,
                   const float* __restrict__ bias, Tout* __restrict__ y,
                   int32_t* __restrict__ acc_out, int H, int W, int Ci,
                   int Ci_pad, int Co, int Co_pad, int tiles_w) {
  constexpr int N = NT * 8;
  __shared__ __align__(16) uint32_t sA[kHaloPix * kWords];
  __shared__ __align__(16) uint32_t sB[9 * N * kWords];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, n0 = blockIdx.y * N;
  const int y0 = (blockIdx.x / tiles_w) * kTileH;
  const int x0 = (blockIdx.x % tiles_w) * kTileW;
  const float s_a = *s_a_ptr;
  const Tin* hb = h + static_cast<size_t>(b) * H * W * Ci;

  int acc[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][j][i] = 0;

  for (int k0 = 0; k0 < Ci_pad; k0 += kKC) {
    __syncthreads();   // the previous step's fragments are read
    // the 9 taps' weights of this step: 9*N rows of two 16-byte halves
    for (int i = tid; i < 9 * N * 2; i += kThreads) {
      const int half = i & 1, row = i >> 1;   // row = tap * N + n
      const int tap = row / N, n = row - tap * N;
      const int8_t* src =
          wq + (static_cast<size_t>(tap) * Co_pad + n0 + n) * Ci_pad + k0 +
          half * 16;
      cp_async16(smem_u32(&sB[row * kWords + ((half ^ ((n >> 2) & 1)) << 2)]),
                 src, 16);
    }
    cp_async_commit();
    // the halo tile's 32 channels, quantized as they are loaded
    for (int i = tid; i < kHaloPix * kWords; i += kThreads) {
      const int p = i / kWords, w = i - p * kWords;
      const int yy = y0 - 1 + p / kHaloW, xx = x0 - 1 + p % kHaloW;
      const int c = k0 + w * 4;
      uint32_t q = 0;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W && c < Ci) {
        float v[4];
        Load4<Tin>::get(hb + (static_cast<size_t>(yy) * W + xx) * Ci + c, v);
        q = quant1(v[0], s_a) | (quant1(v[1], s_a) << 8) |
            (quant1(v[2], s_a) << 16) | (quant1(v[3], s_a) << 24);
      }
      sA[p * kWords + swz(w, p)] = q;
    }
    cp_async_wait<0>();
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      uint32_t bf[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = j * 8 + g;
        const uint32_t* row = &sB[(tap * N + n) * kWords];
        bf[j][0] = row[swz(t, n)];
        bf[j][1] = row[swz(4 + t, n)];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int p0 = (2 * warp + mi + dy) * kHaloW + dx;
        const int pa = p0 + g, pb = p0 + 8 + g;
        const uint32_t a0 = sA[pa * kWords + swz(t, pa)];
        const uint32_t a1 = sA[pb * kWords + swz(t, pb)];
        const uint32_t a2 = sA[pa * kWords + swz(4 + t, pa)];
        const uint32_t a3 = sA[pb * kWords + swz(4 + t, pb)];
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_s8(acc[mi][j], a0, a1, a2, a3, bf[j][0], bf[j][1]);
      }
    }
  }

  // epilogue: c0/c1 are row g, columns 2t and 2t+1; c2/c3 row g + 8
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int yy = y0 + 2 * warp + mi;
    if (yy >= H) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int xx = x0 + g + (i >> 1) * 8;
        const int co = n0 + j * 8 + 2 * t + (i & 1);
        if (xx >= W || co >= Co) continue;
        const size_t o =
            ((static_cast<size_t>(b) * H + yy) * W + xx) * Co + co;
        const int a = acc[mi][j][i];
        if (acc_out != nullptr) acc_out[o] = a;
        const float scale = __fmul_rn(s_a, s_w[co]);
        y[o] = from_f32<Tout>(
            __fadd_rn(__fmul_rn(__int2float_rn(a), scale), bias[co]));
      }
    }
  }
}

int co_tile(int Co) { return Co <= 8 ? 8 : 64; }

template <typename Tin, typename Tout>
void launch(const void* h, const int8_t* wq, const float* s_w,
            const float* s_a, const float* bias, void* y, int32_t* acc,
            int B, int H, int W, int Ci, int Ci_pad, int Co, int Co_pad,
            cudaStream_t stream) {
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + kTileH - 1) / kTileH;
  const int n_tile = co_tile(Co);
  dim3 grid(tiles_w * tiles_h, Co_pad / n_tile, B);
  const Tin* hp = static_cast<const Tin*>(h);
  Tout* yp = static_cast<Tout*>(y);
  if (n_tile == 8)
    quant_conv3_kernel<Tin, Tout, 1><<<grid, kThreads, 0, stream>>>(
        hp, wq, s_w, s_a, bias, yp, acc, H, W, Ci, Ci_pad, Co, Co_pad,
        tiles_w);
  else
    quant_conv3_kernel<Tin, Tout, 8><<<grid, kThreads, 0, stream>>>(
        hp, wq, s_w, s_a, bias, yp, acc, H, W, Ci, Ci_pad, Co, Co_pad,
        tiles_w);
}

}  // namespace
}  // namespace fdsr

extern "C" {

// The output-channel tile of a call with Co output channels: the packed
// weights' Co_pad is a multiple of it (ops/quant.py::co_pad mirrors it).
int fdsr_quant_conv3_co_tile(int Co) { return fdsr::co_tile(Co); }

// h: (B, H, W, Ci) float32 (in_bf16 = 0) or bfloat16, contiguous, 16-byte
// aligned, Ci a multiple of 4. wq: (9, Co_pad, Ci_pad) int8, Ci_pad a
// multiple of 32 >= Ci, Co_pad a multiple of the co tile >= Co. s_w, bias:
// (Co,) float32; s_a: one float32 on the device. y: (B, H, W, Co) float32
// (out_bf16 = 0) or bfloat16; acc: (B, H, W, Co) int32 or NULL.
int fdsr_quant_conv3(const void* h, const int8_t* wq, const float* s_w,
                     const float* s_a, const float* bias, void* y,
                     int32_t* acc, int B, int H, int W, int Ci, int Ci_pad,
                     int Co, int Co_pad, int in_bf16, int out_bf16,
                     void* stream) {
  if (B < 1 || H < 1 || W < 1 || Ci < 4 || Ci % 4 != 0 ||
      Ci_pad % fdsr::kKC != 0 || Ci_pad < Ci || Co < 1 || Co_pad < Co ||
      Co_pad % fdsr::co_tile(Co) != 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (in_bf16 && out_bf16)
    fdsr::launch<bf16, bf16>(h, wq, s_w, s_a, bias, y, acc, B, H, W, Ci,
                             Ci_pad, Co, Co_pad, s);
  else if (in_bf16)
    fdsr::launch<bf16, float>(h, wq, s_w, s_a, bias, y, acc, B, H, W, Ci,
                              Ci_pad, Co, Co_pad, s);
  else if (out_bf16)
    fdsr::launch<float, bf16>(h, wq, s_w, s_a, bias, y, acc, B, H, W, Ci,
                              Ci_pad, Co, Co_pad, s);
  else
    fdsr::launch<float, float>(h, wq, s_w, s_a, bias, y, acc, B, H, W, Ci,
                               Ci_pad, Co, Co_pad, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
