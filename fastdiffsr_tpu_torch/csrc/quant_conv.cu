// Q1: the W8A8 3x3 convolution (SAME zero padding, stride 1) of an NHWC
// map, quantized as it is staged, with the dequantizing epilogue:
//
//   q_h = clamp(rint(h / s_a), -127, 127)                 (int8)
//   acc = conv3x3(q_h, q_w)                               (int32)
//   y   = (float(acc) * (s_a * s_w[co])) + bias[co]       (to y's type)
//
// Replaces no Pallas kernel: fastdiffsr_tpu/ops/quant.py::quant_conv3 leaves
// the int8 x int8 -> int32 convolution to XLA (conv_general_dilated with
// preferred_element_type=int32), and PyTorch has no int8 convolution on
// CUDA. The weights arrive quantized and packed by the wrapper
// (ops/quant.py::pack_weights, once per parameter update) in the layout
// the tensor cores read: (Co_pad / BN, Ci_pad / 32, 9, 2, BN, 16) int8,
// i.e. per block of BN output channels and chunk of 32 input channels, per
// tap, two k-halves of BN rows of 16 input channels, zero-padded. s_a is
// read from device memory: the wrapper never waits for it.
//
// Bound on the H100: bytes at Co = 64 (reading h and writing y once
// against 2*9*Ci*Co int8 operations an output: the 256x256x64->64 call at
// batch 16 moves 0.27 GB in bfloat16 for 77 G operations, 0.080 ms against
// 0.039 ms at 1979 TOP/s), near the ridge at the 128-channel shapes in
// bfloat16. What the design does about it (each choice measured on the
// card with tools/torch_q1_lab.py, which times the kernel with one of its
// phases cut out):
//
// - GEMM view, one wgmma per unit and tap: M = the 64 pixels of an 8x8
//   patch of the output tile, N = 64 output channels (8 for Co <= 8, the
//   final Block's Co = 3), K = 9 taps x Ci in chunks of 32 channels (one
//   m64nNk32 s8 x s8 -> s32 per tap). A block has four such (patch, n64)
//   units and covers all of Co up to 256: at Co <= 64 four patches (a
//   16x16 tile, halo 18x18: 1.27 reads a pixel), at Co = 128 two patches
//   with two n64 ranges each (8x16, 1.41), at Co = 256 one patch with four
//   (8x8, 1.56). So every element of h is read from device memory and
//   quantized once per call, plus the halo, whatever Co is (Co > 256 takes
//   a second block row). An n128 unit's 64 accumulators a thread left
//   ptxas too few registers: it spilled them and serialized the wgmmas.
// - Persistent blocks, one an SM (registers bound it), each walking a
//   strided list of tiles as one stream of (tile, chunk) items, so the
//   copies of the next tile's chunks are in flight while this tile's last
//   chunk is multiplied and its outputs stored (a call at Ci = 64 has only
//   two chunks a tile).
// - Warp-specialised: two producer warpgroups stage and quantize, two
//   consumer warpgroups (two units each) multiply and store, coupled by
//   mbarriers over S = 3 stages of quantized A and weights (2 at Co = 256),
//   so the consumers' epilogue runs beside the producers' staging of the
//   next items. With all four warpgroups doing everything between
//   __syncthreads (the first version), the epilogue, the quantization and
//   the wgmmas ran one after another.
// - Staging. The raw halo chunk (32 channels x (TH+2) x (TW+2) pixels,
//   bfloat16 or float32) comes in with one TMA box copy behind an mbarrier
//   into a ring of RS stages (4 in bfloat16, 3 in float32), zeros outside
//   the map and past Ci. Copies issued thread by thread (cp.async) took the
//   producers' issue slots from the quantization: the two ran one after the
//   other, and two dedicated loader warps could not issue them fast enough.
//   cp.async remains for maps TMA cannot describe (row strides not a
//   multiple of 16 bytes, Ci < 32), each producer copying and quantizing
//   its own vectors. A producer quantizes (pixel, 8-channel) vectors into
//   two planes of 16 channels x halo pixels x 16 bytes (int8). Eight
//   neighbouring pixels of a tile row are then one no-swizzle core matrix
//   (128 contiguous bytes), a tap (dy, dx) is a shift of the descriptor's
//   start address by (HW*dy + dx) * 16 bytes, and one k32 spans the two
//   planes (the descriptor's leading offset). Zeros quantize to zero: halo
//   positions outside the map hold the SAME padding of the quantized map,
//   which is what the plain version convolves. The weights of a chunk are
//   one contiguous block of the packed tensor, copied with 16-byte cp.async
//   by the producers; where all chunks fit beside the rings (Ci up to 192
//   at Co = 64 in bfloat16, for instance) they stay resident, copied once
//   per block.
// - No wgmma on a divergent path and no write to the accumulators but the
//   wgmmas' own (a tile's first wgmma starts the sums through its scale-d
//   operand): otherwise ptxas serialized every wgmma with a wait.
// - Quantization without a division per element. r = 1/s_a rounded to
//   nearest (__frcp_rn, once per block); v is clamped to +-128 s_a (exact:
//   a power-of-two product; any |v| >= 128 s_a gives +-127 either way, and
//   the clamp keeps every quotient below overflow); then
//     q0 = RN(v r); q1 = q0 + r RN(v - s_a q0); q2 = q1 + r (v - s_a q1),
//   each step a rounded FMA. q0 is within 1.5 ulp of v / s_a (r is within
//   half an ulp of 1 / s_a, the product rounds once more), so q1 is within
//   half an ulp plus 2^-22 ulp: a faithful rounding. For a faithful q1 the
//   remainder v - s_a q1 is exact, and Markstein's theorem (r within half
//   an ulp of 1 / s_a, q1 within one ulp of v / s_a) makes q2 = RN(v /
//   s_a), the IEEE quotient that the plain version's division gives.
//   Quotients too small for that argument (|v / s_a| < 2^-100 once
//   subnormals appear) quantize to 0 either way. tests/test_torch_q1_
//   tiling.py replays the steps in exact arithmetic against numpy's IEEE
//   division at and next to the rounding ties. The quotient, clamped to
//   +-127, plus 1.5 * 2^23 rounds half to even into the float's low bits,
//   whose low byte is the int8 (rint + clamp, as the plain version rounds).
// - Epilogue: (float(acc) * (s_a * s_w[co])) + bias[co] with
//   __int2float_rn, __fmul_rn and __fadd_rn (no FMA contraction), the
//   int32 sums being exact in any order: the output is bit-equal to
//   ops/quant.py's plain version. A lane stores its two neighbouring
//   channels in one 8- or 4-byte store (a quad covers 32 contiguous bytes
//   of float32 or 16 of bfloat16 a row). Quad shuffles that made 16-byte
//   stores cost more than they saved (0.209 against 0.182 ms at 256x256
//   64->64, batch 16, bfloat16). Where the unit's channels all lie below
//   Co the loop over them has no test inside, so the compiler interleaves
//   the channels' loads, arithmetic and stores (a test per pair kept them
//   one after another: the epilogue alone took 0.148 ms of that call,
//   0.083 without). The int32 accumulators are written too when asked (the
//   training gradient reads them).

#include <cuda.h>

#include <cstdint>

#include "common.cuh"

namespace fdsr {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;        // four warpgroups:
constexpr int kProducers = 256;      // two stage and quantize,
constexpr int kConsumers = 256;      // two multiply and store, two units each
constexpr int kKC = 32;              // input channels per chunk: one k32
constexpr int kSmemMax = 232448;     // per block on the H100
constexpr int kStatic = 4096;        // static shared memory, rounded up

constexpr int align128(int n) { return (n + 127) / 128 * 128; }

// A block of WN * NS output channels in four (patch, WN channels) units: NS
// units share each 8x8 patch, 4 / NS patches make the tile (16x16, 8x16 or
// 8x8).
template <typename Tin, int WN, int NS>
struct Geo {
  static constexpr int BN = WN * NS;
  static constexpr int PATCHES = 4 / NS;
  static constexpr int TH = NS == 1 ? 16 : 8;
  static constexpr int TW = NS == 4 ? 8 : 16;
  static constexpr int HW = TW + 2;
  static constexpr int HPX = (TH + 2) * HW;          // halo pixels
  static constexpr int QB = HPX * 16;                // one int8 plane
  static constexpr int ABYTES = align128(2 * QB);    // one chunk of A
  static constexpr int VECS = HPX * 4;               // (pixel, 8 channels)
  static constexpr int NSLOT = (VECS + kProducers - 1) / kProducers;
  static constexpr int VB = 8 * sizeof(Tin);         // raw bytes a vector
  static constexpr int RAWBYTES = align128(VECS * VB);
  // raw stages: quantized next, landing, issued (and one more landing in
  // bfloat16, whose stages are half as large)
  static constexpr int RS = sizeof(Tin) == 2 ? 4 : 3;
  static constexpr int BCHUNK = 9 * 2 * BN * 16;     // weights of a chunk
  // stages of quantized A (and of streamed weights) between the producers
  // and the consumers
  static constexpr int S = BN == 256 ? 2 : 3;
  static constexpr int FIXED = S * ABYTES + RS * RAWBYTES;
  static constexpr int DYN_MAX = kSmemMax - kStatic;
  static_assert(2 * BN * 4 + 8 * (2 * S + 2 * RS) <= kStatic,
                "static arrays fit");
  static_assert(FIXED + S * BCHUNK + 128 <= DYN_MAX, "S weight chunks fit");
};

template <typename Tin, typename Tout>
struct Args {
  const Tin* h;
  const int8_t* wq;
  const float* s_w;
  const float* s_a;
  const float* bias;
  Tout* y;
  int32_t* acc;
  int H, W, Ci, Co, n_chunks, tiles_w, tiles_img, total_tiles;
  int resident, vec_in, pair_out, tma;
};

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ uint4 ld_shared16(uint32_t src) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(src)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared8(uint32_t dst, uint32_t a,
                                           uint32_t b) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(dst), "r"(a),
               "r"(b)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(bar)
      : "memory");
}

// arrives on `bar` and adds `bytes` to the transactions its phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n"
      "}\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// the 4-d box at (c, x, y, b) of `map` into shared memory at dst; its bytes
// complete a transaction of `bar` (zeros where the box leaves the tensor)
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map,
                                          int c, int x, int y, int b,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(x), "r"(y), "r"(b),
      "r"(bar)
      : "memory");
}

// returns once the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps an accumulator of an asynchronous wgmma in its register up to here
__device__ __forceinline__ void keep(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// Descriptor of a K-major no-swizzle operand: core matrices of 8 rows x 16
// bytes (128 contiguous bytes); `lbo` bytes between the two core matrices
// along k, `sbo` bytes between 8-row groups along m or n.
__device__ __forceinline__ uint64_t desc(uint32_t saddr, uint32_t lbo,
                                         uint32_t sbo) {
  uint64_t d = static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4);
  d |= static_cast<uint64_t>(lbo >> 4) << 16;
  d |= static_cast<uint64_t>(sbo >> 4) << 32;
  return d;
}

// d = A (64 x 32 s8, shared memory, k-major) * B (32 x N s8, shared
// memory, k-major) + (acc ? d : 0), exact in int32
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ __forceinline__ static void mma(int (&d)[4], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
        "{%0, %1, %2, %3}, %4, %5, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(int (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(acc));
  }
};

// clamp(rint(v / s), -127, 127) in the low byte (see the header): r = 1/s
// rounded to nearest, lim = 128 s
__device__ __forceinline__ uint32_t quant1(float v, float s, float r,
                                           float lim) {
  v = fminf(fmaxf(v, -lim), lim);
  float q = __fmul_rn(v, r);
  q = __fmaf_rn(r, __fmaf_rn(-s, q, v), q);
  q = __fmaf_rn(r, __fmaf_rn(-s, q, v), q);
  q = fminf(fmaxf(q, -127.f), 127.f);
  return __float_as_uint(__fadd_rn(q, 12582912.f));
}

// four int8 of quant1 in one word, the first in the low byte
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// the eight raw values of a staged vector, as float32
__device__ __forceinline__ void raw8(uint32_t src, float (&v)[8], float) {
  const uint4 a = ld_shared16(src), b = ld_shared16(src + 16);
  v[0] = __uint_as_float(a.x); v[1] = __uint_as_float(a.y);
  v[2] = __uint_as_float(a.z); v[3] = __uint_as_float(a.w);
  v[4] = __uint_as_float(b.x); v[5] = __uint_as_float(b.y);
  v[6] = __uint_as_float(b.z); v[7] = __uint_as_float(b.w);
}

__device__ __forceinline__ void raw8(uint32_t src, float (&v)[8], bf16) {
  const uint4 a = ld_shared16(src);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// copies the 8 channels c.. of one pixel (valid: inside the map; `left`
// channels of the map remain from c) into the raw stage at dst, zeros
// where there is nothing to read
__device__ __forceinline__ void copy8(uint32_t dst, const float* src,
                                      const float* any, bool valid, int left,
                                      int) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const bool ok = valid && 4 * k < left;
    cp_async16(dst + 16 * k, ok ? src + 4 * k : any, ok ? 16u : 0u);
  }
}

__device__ __forceinline__ void copy8(uint32_t dst, const bf16* src,
                                      const bf16* any, bool valid, int left,
                                      int vec_in) {
  if (vec_in) {   // Ci a multiple of 8: one aligned 16-byte vector
    cp_async16(dst, valid && left > 0 ? src : any,
               valid && left > 0 ? 16u : 0u);
  } else {        // Ci a multiple of 4: two aligned 8-byte halves
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const bool ok = valid && 4 * k < left;
      cp_async8(dst + 8 * k, ok ? src + 4 * k : any, ok ? 8u : 0u);
    }
  }
}

__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  __nv_bfloat162 q = __halves2bfloat162(__float2bfloat16_rn(a),
                                        __float2bfloat16_rn(b));
  return *reinterpret_cast<uint32_t*>(&q);
}

// two neighbouring channels of a row in one 8- or 4-byte store
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(int* p, int a, int b) {
  *reinterpret_cast<int2*>(p) = make_int2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = bf16x2(a, b);
}

// acc (+)= the 9 taps of a staged chunk: A at `abuf` (the patch's first
// pixel in the two planes of 16 channels), B at `bbuf` (the warpgroup's
// first output channel of tap 0); the first chunk of a tile starts the
// sums (wgmma's scale-d), so no other instruction writes the accumulators
// between the wgmmas and their wait (ptxas would serialize them)
template <typename G, int NACC>
__device__ __forceinline__ void mma_taps(int (&acc)[NACC], uint32_t abuf,
                                         uint32_t bbuf, int first) {
#pragma unroll
  for (int t = 0; t < 9; ++t)
    Wgmma<2 * NACC>::mma(
        acc, desc(abuf + ((t / 3) * G::HW + t % 3) * 16, G::QB, G::HW * 16),
        desc(bbuf + t * 2 * G::BN * 16, G::BN * 16, 128), t > 0 || !first);
}

// the accumulator fragment's value of channel 8j + 2 (lane % 4) + e of row
// p, as int32 or dequantized
template <int NACC>
struct AccAt {
  const int (&acc)[NACC];
  int p;
  __device__ __forceinline__ int operator()(int j, int e) const {
    return acc[4 * j + 2 * p + e];
  }
};

template <int NACC>
struct YAt {
  const int (&acc)[NACC];
  int p;
  const float* scale;   // s_a * s_w of the row's first channel (+ 2t)
  const float* bias;
  __device__ __forceinline__ float operator()(int j, int e) const {
    const int n = 8 * j + e;
    return __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * p + e]),
                               scale[n]),
                     bias[n]);
  }
};

// Accumulator element 4j + 2p + e is row 16 (warp % 4) + lane / 4 + 8p of
// the m64, i.e. patch pixel (2 (warp % 4) + p, lane / 4), channel 8j +
// 2 (lane % 4) + e of the warpgroup's WN: stores the two output rows of
// this lane (oy, oy + 1 at column ox) of image b, channels from n0 of the
// block on.
template <typename G, typename Tin, typename Tout, int NACC>
__device__ __forceinline__ void store_tile(const Args<Tin, Tout>& a,
                                           const int (&acc)[NACC],
                                           const float* s_scale,
                                           const float* s_bias, int b,
                                           int oy0, int ox, int n0,
                                           int lane) {
  constexpr int WN = 2 * NACC;
  const int t = lane & 3;
  const int co0 = blockIdx.y * G::BN + n0;
  const int left = a.Co - co0;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int oy = oy0 + p;
    const bool ok = oy < a.H && ox < a.W;
    const size_t pix =
        ok ? (static_cast<size_t>(b) * a.H + oy) * a.W + ox : 0;
    const AccAt<NACC> acc_at{acc, p};
    const YAt<NACC> y_at{acc, p, s_scale + n0 + 2 * t, s_bias + n0 + 2 * t};
    Tout* yrow = a.y + pix * a.Co + co0;
    int32_t* arow = a.acc ? a.acc + pix * a.Co + co0 : nullptr;
    if (!ok) continue;
    if (a.pair_out && left >= WN) {
      // every channel of the range: no test inside the unrolled loop, so
      // the compiler interleaves the pairs' loads, arithmetic and stores
      if (arow) {
#pragma unroll
        for (int j = 0; j < WN / 8; ++j) {
          store2(yrow + 8 * j + 2 * t, y_at(j, 0), y_at(j, 1));
          store2(arow + 8 * j + 2 * t, acc_at(j, 0), acc_at(j, 1));
        }
      } else {
#pragma unroll
        for (int j = 0; j < WN / 8; ++j)
          store2(yrow + 8 * j + 2 * t, y_at(j, 0), y_at(j, 1));
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < WN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        if (c >= left) continue;
        yrow[c] = from_f32<Tout>(y_at(j, e));
        if (arow) arow[c] = acc_at(j, e);
      }
  }
}

template <typename Tin, typename Tout, int WN, int NS>
__global__ void __launch_bounds__(kThreads, 1)
quant_conv3_kernel(const Args<Tin, Tout> a,
                   const __grid_constant__ CUtensorMap map) {
  using G = Geo<Tin, WN, NS>;
  constexpr int BN = G::BN, S = G::S;
  constexpr int NACC = WN / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_scale[BN];
  __shared__ float s_bias[BN];
  __shared__ __align__(8) uint64_t full[S];    // item's A and B staged
  __shared__ __align__(8) uint64_t empty[S];   // item's wgmmas done
  __shared__ __align__(8) uint64_t raw_full[G::RS];    // TMA box landed
  __shared__ __align__(8) uint64_t raw_empty[G::RS];   // box quantized
  // TMA writes to 128-byte aligned shared memory
  const uint32_t a_base = (smem_u32(smem) + 127u) & ~127u;
  const uint32_t raw_base = a_base + S * G::ABYTES;
  const uint32_t b_base = raw_base + G::RS * G::RAWBYTES;

  const int tid = threadIdx.x;
  // the warpgroup's role, uniform across its warps for the compiler
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int cog = blockIdx.y;
  const int n_chunks = a.n_chunks;
  const float s_a = *a.s_a;
  if (tid < BN) {
    const int co = cog * BN + tid;
    s_scale[tid] = co < a.Co ? __fmul_rn(s_a, a.s_w[co]) : 0.f;
    s_bias[tid] = co < a.Co ? a.bias[co] : 0.f;
  }
  if (tid == 0) {
    for (int k = 0; k < S; ++k) {
      mbar_init(smem_u32(&full[k]), kProducers);
      mbar_init(smem_u32(&empty[k]), kConsumers);
    }
    for (int k = 0; k < G::RS; ++k) {
      mbar_init(smem_u32(&raw_full[k]), 1);
      mbar_init(smem_u32(&raw_empty[k]), kProducers);
    }
  }
  __syncthreads();
  const int my_tiles = (a.total_tiles - 1 - blockIdx.x) / gridDim.x + 1;
  const int n_items = my_tiles * n_chunks;

  // (image, first row, first column) of item `it`'s output tile
  auto origin = [&](int it, int& b, int& y0, int& x0) {
    const int tile = blockIdx.x + (it / n_chunks) * gridDim.x;
    b = tile / a.tiles_img;
    const int r = tile - b * a.tiles_img;
    y0 = (r / a.tiles_w) * G::TH;
    x0 = (r % a.tiles_w) * G::TW;
  };
  // the weights of item `it`: a stage of their own, or the chunk's where
  // every chunk stays resident
  auto b_stage = [&](int it) {
    return b_base + (a.resident ? it % n_chunks : it % S) * G::BCHUNK;
  };

  if (wg < 2) {
    // Producers. A thread quantizes the same (halo pixel, 8-channel group)
    // vectors of every chunk; without TMA it also copies them and waits for
    // its own copies, so the raw stages are private to it.
    const float rcp = __frcp_rn(s_a);
    const float lim = __fmul_rn(128.f, s_a);
    auto load_raw = [&](int it) {
      if (it >= n_items) return;
      int b, y0, x0;
      origin(it, b, y0, x0);
      const int c0 = (it % n_chunks) * kKC;
      const uint32_t dst0 = raw_base + (it % G::RS) * G::RAWBYTES;
#pragma unroll
      for (int k = 0; k < G::NSLOT; ++k) {
        const int v = tid + k * kProducers;
        if (k >= G::VECS / kProducers && v >= G::VECS) break;
        const int px = v >> 2, c = c0 + (v & 3) * 8;
        const int gy = y0 - 1 + px / G::HW, gx = x0 - 1 + px % G::HW;
        const bool inside = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
        const size_t off =
            inside
                ? ((static_cast<size_t>(b) * a.H + gy) * a.W + gx) * a.Ci + c
                : 0;
        copy8(dst0 + v * G::VB, a.h + off, a.h, inside, a.Ci - c, a.vec_in);
      }
    };
    auto load_b = [&](int it) {
      if (it >= n_items || (a.resident && it >= n_chunks)) return;
      const int8_t* src =
          a.wq + (static_cast<size_t>(cog) * n_chunks + it % n_chunks) *
                     G::BCHUNK;
      const uint32_t dst = b_stage(it);
      for (int v = tid; v < G::BCHUNK / 16; v += kProducers)
        cp_async16(dst + 16 * v, src + 16 * v, 16u);
    };
    auto quantize = [&](int it) {
      const uint32_t src0 = raw_base + (it % G::RS) * G::RAWBYTES;
      const uint32_t dst0 = a_base + (it % S) * G::ABYTES;
#pragma unroll
      for (int k = 0; k < G::NSLOT; ++k) {
        const int v = tid + k * kProducers;
        if (k >= G::VECS / kProducers && v >= G::VECS) break;
        float f[8];
        raw8(src0 + v * G::VB, f, Tin());
        uint32_t q[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) q[e] = quant1(f[e], s_a, rcp, lim);
        // plane (v & 3) / 2 of 16 channels, half (v & 1) of its 16 bytes
        st_shared8(
            dst0 + ((v >> 1) & 1) * G::QB + (v >> 2) * 16 + (v & 1) * 8,
            pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]));
      }
    };
    // the TMA box of item `it` into its raw stage, issued by one thread
    auto tma_raw = [&](int it) {
      int b, y0, x0;
      origin(it, b, y0, x0);
      const int r = it % G::RS;
      mbar_expect_tx(smem_u32(&raw_full[r]), G::VECS * G::VB);
      tma_load4(raw_base + r * G::RAWBYTES, &map, (it % n_chunks) * kKC,
                x0 - 1, y0 - 1, b, smem_u32(&raw_full[r]));
    };
    // cp.async groups: with TMA one an item, its weights; without, pairs
    // (weights of item j, raw chunk of item j + RS - 1), the raw chunks of
    // items 0 .. RS - 2 ahead of the loop
    constexpr int RAW_AFTER = 2 * (G::RS - 1);   // groups after a raw chunk
#pragma unroll
    for (int k = 0; k < G::RS - 1; ++k) {
      if (a.tma) {
        if (tid == 0 && k < n_items) tma_raw(k);
      } else {
        cp_async_commit();
        load_raw(k);
        cp_async_commit();
      }
    }
    for (int j = 0; j < n_items; ++j) {
      const int s = j % S, r = j % G::RS;
      if (j >= S) mbar_wait(smem_u32(&empty[s]), (j / S - 1) & 1);
      load_b(j);
      cp_async_commit();
      if (a.tma) {
        const int next = j + G::RS - 1;
        if (tid == 0 && next < n_items) {
          // the stage held item j - 1: every producer has quantized it
          if (next >= G::RS)
            mbar_wait(smem_u32(&raw_empty[next % G::RS]),
                      (next / G::RS - 1) & 1);
          tma_raw(next);
        }
        mbar_wait(smem_u32(&raw_full[r]), (j / G::RS) & 1);
      } else {
        load_raw(j + G::RS - 1);
        cp_async_commit();
        cp_async_wait<RAW_AFTER>();   // this thread's copies of item j
      }
      quantize(j);
      if (a.tma) {
        mbar_arrive(smem_u32(&raw_empty[r]));
        cp_async_wait<0>();           // item j's weights
      } else {
        cp_async_wait<1>();
      }
      fence_proxy_async();
      mbar_arrive(smem_u32(&full[s]));
    }
    cp_async_wait<0>();
  } else {
    // Consumers: warpgroup 2 + k owns units 2k and 2k + 1 of the block's
    // four (patch, n64 range) units.
    const int lane = tid & 31, wq = (tid >> 5) & 3;
    const int u0 = 2 * (wg - 2), u1 = u0 + 1;
    const int p0 = u0 % G::PATCHES, n0 = u0 / G::PATCHES;
    const int p1 = u1 % G::PATCHES, n1 = u1 / G::PATCHES;
    const int py0 = (p0 / (G::TW / 8)) * 8, px0 = (p0 % (G::TW / 8)) * 8;
    const int py1 = (p1 / (G::TW / 8)) * 8, px1 = (p1 % (G::TW / 8)) * 8;
    int acc0[NACC], acc1[NACC];   // started by each tile's first wgmma
    auto multiply = [&](int it, int first) {
      const uint32_t abuf = a_base + (it % S) * G::ABYTES;
      const uint32_t bbuf = b_stage(it);
      wgmma_fence();
      mma_taps<G>(acc0, abuf + (py0 * G::HW + px0) * 16,
                  bbuf + n0 * WN * 16, first);
      mma_taps<G>(acc1, abuf + (py1 * G::HW + px1) * 16,
                  bbuf + n1 * WN * 16, first);
      wgmma_commit();
    };
    auto epilogue = [&](int it) {
      int b, y0, x0;
      origin(it, b, y0, x0);
      store_tile<G>(a, acc0, s_scale, s_bias, b, y0 + py0 + 2 * wq,
                    x0 + px0 + (lane >> 2), n0 * WN, lane);
      store_tile<G>(a, acc1, s_scale, s_bias, b, y0 + py1 + 2 * wq,
                    x0 + px1 + (lane >> 2), n1 * WN, lane);
    };
    for (int tile = 0, i = 0; tile < my_tiles; ++tile) {
      for (int c = 0; c < n_chunks; ++c, ++i) {
        mbar_wait(smem_u32(&full[i % S]), (i / S) & 1);
        multiply(i, c == 0);
        wgmma_wait0();
        mbar_arrive(smem_u32(&empty[i % S]));
      }
#pragma unroll
      for (int k = 0; k < NACC; ++k) {
        keep(acc0[k]);
        keep(acc1[k]);
      }
      epilogue(i - 1);
    }
  }
}

int co_tile(int Co) {
  return Co <= 8 ? 8 : Co <= 64 ? 64 : Co <= 128 ? 128 : 256;
}

int tile_rows(int Co) { return co_tile(Co) > 64 ? 8 : 16; }

int tile_cols(int Co) { return co_tile(Co) > 128 ? 8 : 16; }

// cuTensorMapEncodeTiled, found through the runtime (no link to libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The (C, W, H, B) view of an NHWC map whose boxes are one chunk of a halo
// tile: 32 channels x (TW + 2) x (TH + 2) pixels of one image, zeros where
// a box leaves the map.
template <typename G, typename Tin>
cudaError_t halo_map(CUtensorMap* map, const Tin* h, int B, int H, int W,
                     int Ci) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t es = sizeof(Tin);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(Ci),
                              static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {Ci * es, W * Ci * es, H * W * Ci * es};
  const cuuint32_t box[4] = {kKC, G::TW + 2, G::TH + 2, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map,
      sizeof(Tin) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      4, const_cast<Tin*>(h), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename Tin, typename Tout, int WN, int NS>
cudaError_t launch(Args<Tin, Tout> a, int B, int H, int W, int groups,
                   cudaStream_t s) {
  using G = Geo<Tin, WN, NS>;
  auto kernel = quant_conv3_kernel<Tin, Tout, WN, NS>;
  static bool opted_in = false;   // per instantiation
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::DYN_MAX);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  a.tiles_w = (W + G::TW - 1) / G::TW;
  a.tiles_img = ((H + G::TH - 1) / G::TH) * a.tiles_w;
  a.total_tiles = B * a.tiles_img;
  a.resident = G::FIXED + a.n_chunks * G::BCHUNK + 128 <= G::DYN_MAX;
  // TMA takes row strides in multiples of 16 bytes and a box no wider
  // than the map's channels
  a.tma = a.Ci * static_cast<int>(sizeof(Tin)) % 16 == 0 && a.Ci >= kKC;
  CUtensorMap map{};
  if (a.tma) {
    const cudaError_t err = halo_map<G>(&map, a.h, B, H, W, a.Ci);
    if (err != cudaSuccess) return err;
  }
  const int smem =
      G::FIXED + (a.resident ? a.n_chunks : G::S) * G::BCHUNK + 128;
  // blocks an SM holds at this shared memory size, asked once per size
  static int memo_smem[4] = {0, 0, 0, 0}, memo_blocks[4];
  int dev = 0, sms = 0, per_sm = -1;
  for (int k = 0; k < 4; ++k)
    if (memo_smem[k] == smem) per_sm = memo_blocks[k];
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && per_sm < 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    for (int k = 0; k < 4 && err == cudaSuccess; ++k)
      if (memo_smem[k] == 0) {
        memo_smem[k] = smem;
        memo_blocks[k] = per_sm;
        break;
      }
  }
  if (err != cudaSuccess) return err;
  const int blocks = per_sm > 0 ? per_sm * sms : sms;
  dim3 grid(a.total_tiles < blocks ? a.total_tiles : blocks, groups);
  kernel<<<grid, kThreads, smem, s>>>(a, map);
  return cudaGetLastError();
}

template <typename Tin, typename Tout>
cudaError_t dispatch(const void* h, const int8_t* wq, const float* s_w,
                     const float* s_a, const float* bias, void* y,
                     int32_t* acc, int B, int H, int W, int Ci, int Ci_pad,
                     int Co, int Co_pad, cudaStream_t s) {
  Args<Tin, Tout> a{};
  a.h = static_cast<const Tin*>(h);
  a.wq = wq;
  a.s_w = s_w;
  a.s_a = s_a;
  a.bias = bias;
  a.y = static_cast<Tout*>(y);
  a.acc = acc;
  a.H = H;
  a.W = W;
  a.Ci = Ci;
  a.Co = Co;
  a.n_chunks = Ci_pad / kKC;
  a.vec_in = Ci % 8 == 0;
  a.pair_out = Co % 2 == 0;
  const int bn = co_tile(Co), groups = Co_pad / bn;
  switch (bn) {
    case 8:
      return launch<Tin, Tout, 8, 1>(a, B, H, W, groups, s);
    case 64:
      return launch<Tin, Tout, 64, 1>(a, B, H, W, groups, s);
    case 128:
      return launch<Tin, Tout, 64, 2>(a, B, H, W, groups, s);
    default:
      return launch<Tin, Tout, 64, 4>(a, B, H, W, groups, s);
  }
}

}  // namespace
}  // namespace fdsr

extern "C" {

// The output-channel tile of a call with Co output channels (all of Co up
// to 256): the packed weights' Co_pad is a multiple of it
// (ops/quant.py::co_tile mirrors it).
int fdsr_quant_conv3_co_tile(int Co) { return fdsr::co_tile(Co); }

// The rows and columns of a block's output tile: ops/quant.py::tile_shape
// mirrors them.
int fdsr_quant_conv3_tile_rows(int Co) { return fdsr::tile_rows(Co); }
int fdsr_quant_conv3_tile_cols(int Co) { return fdsr::tile_cols(Co); }

// h: (B, H, W, Ci) float32 (in_bf16 = 0) or bfloat16, contiguous, 16-byte
// aligned, Ci a multiple of 4. wq: (Co_pad / co_tile, Ci_pad / 32, 9, 2,
// co_tile, 16) int8, Ci_pad a multiple of 32 >= Ci, Co_pad a multiple of
// the co tile >= Co, 16-byte aligned. s_w, bias: (Co,) float32; s_a: one
// float32 on the device. y: (B, H, W, Co) float32 (out_bf16 = 0) or
// bfloat16; acc: (B, H, W, Co) int32 or NULL; both 16-byte aligned.
int fdsr_quant_conv3(const void* h, const int8_t* wq, const float* s_w,
                     const float* s_a, const float* bias, void* y,
                     int32_t* acc, int B, int H, int W, int Ci, int Ci_pad,
                     int Co, int Co_pad, int in_bf16, int out_bf16,
                     void* stream) {
  auto aligned16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (B < 1 || H < 1 || W < 1 || Ci < 4 || Ci % 4 != 0 ||
      Ci_pad % fdsr::kKC != 0 || Ci_pad < Ci || Co < 1 || Co_pad < Co ||
      Co_pad % fdsr::co_tile(Co) != 0 || Co_pad / fdsr::co_tile(Co) > 65535 ||
      !aligned16(h) || !aligned16(wq) || !aligned16(y) || !aligned16(acc))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using fdsr::bf16;
  cudaError_t err;
  if (in_bf16 && out_bf16)
    err = fdsr::dispatch<bf16, bf16>(h, wq, s_w, s_a, bias, y, acc, B, H, W,
                                     Ci, Ci_pad, Co, Co_pad, s);
  else if (in_bf16)
    err = fdsr::dispatch<bf16, float>(h, wq, s_w, s_a, bias, y, acc, B, H, W,
                                      Ci, Ci_pad, Co, Co_pad, s);
  else if (out_bf16)
    err = fdsr::dispatch<float, bf16>(h, wq, s_w, s_a, bias, y, acc, B, H, W,
                                      Ci, Ci_pad, Co, Co_pad, s);
  else
    err = fdsr::dispatch<float, float>(h, wq, s_w, s_a, bias, y, acc, B, H,
                                       W, Ci, Ci_pad, Co, Co_pad, s);
  return static_cast<int>(err);
}

}  // extern "C"
