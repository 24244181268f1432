// K3 in bfloat16 on Hopper's tensor cores: fused GroupNorm -> Swish ->
// 3x3 conv with a statistics epilogue, as an implicit GEMM on wgmma.
//
//   y     = conv3x3(swish(GN(x) * gamma + beta)) + b_conv
//           [+ shift[b, co]] [+ res]
//   stats = per-channel (sum y, sum y^2) over H,W of the float32
//           accumulator (res included, before the cast to bfloat16)
//
// Replaces fastdiffsr_tpu/ops/fused_conv.py::fused_gn_swish_conv3x3 for
// bfloat16 maps (the float32 maps stay on the CUDA-core kernel of
// fused_conv.cu: IEEE float32 results must not pass through TF32).
//
// Bound on the H100: operations. A call does 2*9*C*Co flops per pixel
// against (C + Co) * 2 bytes, at or above the ~295 flop/byte ridge at the
// UNet's widths, so the floor is flops / 989 TFLOP/s of bf16 tensor-core
// math. What the design does about it:
//
// - GEMM view. M = the 256 pixels of a 16x16 output tile of one image, as
//   four 8x8 patches of 64 pixels, one warpgroup (one m64) each; N = BN
//   output channels, one wgmma wide (128 where Co is a multiple of 128,
//   else 64); K = 9 taps x C input channels, walked in chunks of KC = 16
//   channels. With BN = 64 two blocks share an SM, so one block's
//   prologue and epilogue run beside the other's multiplies: at C = 64
//   a block has only four chunks and is mostly prologue and epilogue.
// - One staged input tile serves all 9 taps. Per chunk the raw 18x18xKC
//   halo tile is copied to shared memory with 16-byte cp.async
//   (zero-filled outside the image). The thread that copied a vector then
//   applies the GroupNorm affine and swish to it in place and rounds to
//   bfloat16; halo positions outside the image keep their zeros (zero
//   padding applies to the normalised map). Each product and sum of that
//   pass rounds on its own (no FMA contraction) and swish is x * (1 / (1 +
//   e^-x)) with the exact expf and a refined reciprocal, as in the plain
//   PyTorch version, so both round the same float32 value to bfloat16:
//   with the approximate ex2.approx / rcp.approx alone (half the
//   arithmetic) one input in a few thousand rounds to the other
//   neighbour, and an output near zero then misses the kernel's
//   tolerance. The reciprocal is rcp.approx refined by two Newton steps
//   (rcp_newton): the compiler's IEEE division carries a range check and a
//   branch per element, which kept the eight elements of a vector from
//   overlapping and cost a third of a normalised layer's time. That the
//   refined value equals IEEE 1/x is not proven for every input; it held
//   on every value that the kernel's tests and the UNet's 23 shapes
//   exercised (no output moved against the IEEE division).
// - A and B both from shared memory, so a wgmma needs no registers but
//   its accumulators and a chunk's 9 wgmmas are started in one go.
//   The staged tile is stored as KC/8 planes of 18x18 pixels x 16 bytes (8
//   channels): eight neighbouring pixels of a tile row are 128 contiguous
//   bytes, a no-swizzle core matrix, and a tap (dy, dx) is a shift of the
//   descriptor's start address by (18*dy + dx) * 16 bytes. The HWIO
//   weights w[tap, c, co] have Co contiguous, i.e. N-major: the chunk's 9
//   x KC x BN weights are copied with 16-byte cp.async into
//   128-byte-swizzled atoms of 8 k-rows x 64 channels, which wgmma reads
//   through a descriptor with the transpose bit. No repacked copy of the
//   weights exists.
// - A ring of three stages and one __syncthreads per chunk: while chunk i
//   is multiplied, the copies of chunk i+2 are started and chunk i+1,
//   which has landed, is transformed. A warp that starts wgmmas waits in
//   their queue for most of their run time, so a warp's own transform
//   runs behind its wgmmas rather than beside them. The warpgroups
//   therefore take turns: the two warpgroups of the tile's upper half
//   start their wgmmas and then stage the next chunk, the lower two stage
//   first and then start theirs, so each pair's copies and transform run
//   beside the other pair's multiply. Warp-specialised variants (two
//   consumer warpgroups with two patches each, two or three producer
//   warpgroups, setmaxnreg) were slower, because the exact swish needs
//   all 16 warps.
// - Two sources (the skip concat) are walked one after the other along K;
//   the concat is never built. The per-channel affine comes from the
//   channel sums of both (block_group_mean_inv in common.cuh), so GroupNorm
//   groups that straddle the boundary are exact.
// - Epilogue. Bias, shift and residual are added to the float32
//   accumulators, per-channel (sum, sum of squares) are reduced by shuffles
//   over a warp's 16 pixels, then over the 16 warps in shared memory in a
//   fixed order. One partial per tile goes to device memory;
//   launch_reduce_partials sums the tiles in order: no float atomics, the
//   same result on every run. Where Co is a multiple of 8 the tile passes
//   through shared memory, so that res is read and y written with 16-byte
//   accesses.
// - Edges. Widths that are not multiples of 8 (the stem's C = 6, the final
//   block's Co = 3) take a scalar load path into the same shared-memory
//   layout, zero-padded; ragged H, W and Co are masked at the store.

#include <cstdint>

#include "common.cuh"

namespace fdsr {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kTH = 16;           // output rows per block, one per warp
constexpr int kTW = 16;           // output columns per block (one m16 row)
constexpr int kIH = kTH + 2;
constexpr int kIW = kTW + 2;
constexpr int kThreads = 512;     // four warpgroups, an 8x8 patch each
constexpr int kStages = 3;        // multiplied, being transformed, landing
constexpr int kMaxC = 1024;       // channels the affine arrays hold
constexpr int kAtom = 1024;       // bytes of a swizzle atom: 8 k-rows x 128 B

struct ConvArgs {
  const bf16* x1;
  const bf16* x2;
  int C1, C2;
  const float* st1;
  const float* st2;
  const float* gamma;
  const float* beta;
  int groups;
  float eps;
  int apply_norm;
  const bf16* w;
  const float* conv_b;
  const float* shift;
  const bf16* res;
  bf16* y;
  float* partial;
  int H, W, Co, tiles_w;
  int vec_in, vec_w, vec_out;
};

// BN output channels and KC input channels per stage
template <int BN, int KC>
struct Geo {
  static constexpr int NH = BN / 64;         // n64 halves of the N tile
  static constexpr int KG = KC / 8;          // 8-channel groups per chunk
  static constexpr int KS = KC / 16;         // k16 steps per chunk
  static constexpr int QB = kIH * kIW * 16;  // bytes of one 8-channel plane
  static constexpr int WBYTES = NH * 9 * KG * kAtom;
  static constexpr int INBYTES = KG * QB;
  static constexpr int STAGE = (WBYTES + INBYTES + 1023) / 1024 * 1024;
  static constexpr int OP = BN * 2 + 16;     // padded bytes per output pixel
  static constexpr int SMEM = kStages * STAGE + 1024;   // + alignment slack
  // the n64 kernel's 32 accumulators leave room for two blocks of 512
  // threads in the register file (64 registers each, which costs it a few
  // dozen bytes of spill: the build's ptxas line says how many), and its
  // stages fit the shared memory twice
  static constexpr int BLOCKS_PER_SM = BN == 64 ? 2 : 1;
  static_assert(kTH * kTW * OP + (kThreads / 32) * 2 * BN * 4 <= kStages * STAGE,
                "the epilogue's tile and partial sums fit the stages");
};

__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void st_shared32(uint32_t dst, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t ld_shared32(uint32_t src) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(src) : "memory");
  return v;
}

__device__ __forceinline__ uint4 ld_shared16(uint32_t src) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(src)
               : "memory");
  return v;
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

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps an accumulator of an asynchronous wgmma in its register up to
// this point
__device__ __forceinline__ void keep(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// Descriptor of a 64 (m) x 16 (k) bf16 tile of A, k contiguous, no swizzle:
// core matrices of 8 rows x 16 bytes (128 contiguous bytes); `lbo` bytes
// between the two core matrices along k, `sbo` bytes between 8-row groups.
__device__ __forceinline__ uint64_t a_desc(uint32_t saddr, uint32_t lbo,
                                           uint32_t sbo) {
  uint64_t d = static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4);
  d |= static_cast<uint64_t>(lbo >> 4) << 16;
  d |= static_cast<uint64_t>(sbo >> 4) << 32;
  return d;
}

// Descriptor of a 16 (k) x 64*NH (n) bf16 tile of B, n contiguous, 128-byte
// swizzle: atoms of 8 k-rows x 128 bytes; kAtom bytes between the two
// atoms along k, `nbo` bytes between the 64-channel halves along n.
__device__ __forceinline__ uint64_t b_desc(uint32_t saddr, uint32_t nbo) {
  uint64_t d = static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4);
  d |= static_cast<uint64_t>(nbo >> 4) << 16;
  d |= static_cast<uint64_t>(kAtom >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;   // 128-byte swizzle
  return d;
}

// d += A (shared memory, 64 x 16, k-major) * B (shared memory, 16 x 64,
// n-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,  %1,  %2,  %3,  %4,  %5,  %6,  %7,  "
      " %8,  %9,  %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// the same with a 16 x 128 tile of B
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,  %1,  %2,  %3,  %4,  %5,  %6,  %7,  "
      " %8,  %9,  %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// swish(v * s + b) of the two bf16 values of one 32-bit word, rounded back
__device__ __forceinline__ uint32_t norm_swish2(uint32_t word, float s0,
                                                float b0, float s1,
                                                float b1) {
  __nv_bfloat162 q = *reinterpret_cast<__nv_bfloat162*>(&word);
  float v0 = __fadd_rn(__fmul_rn(__low2float(q), s0), b0);
  float v1 = __fadd_rn(__fmul_rn(__high2float(q), s1), b1);
  v0 = swish_exact(v0);
  v1 = swish_exact(v1);
  q = __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
  return *reinterpret_cast<uint32_t*>(&q);
}

template <int BN, int KC>
__global__ void __launch_bounds__(kThreads, Geo<BN, KC>::BLOCKS_PER_SM)
fused_conv_wgmma_kernel(const ConvArgs a) {
  using G = Geo<BN, KC>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(16) float s_scale[kMaxC];
  __shared__ __align__(16) float s_bias[kMaxC];
  __shared__ float s_add[BN];

  // swizzle atoms must sit on 1024-byte boundaries of the shared window
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* s_red = reinterpret_cast<float*>(smem_raw + (base - raw) +
                                          kTH * kTW * G::OP);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int C = a.C1 + a.C2;
  const int n_chunks = (C + KC - 1) / KC;
  const int tile = blockIdx.x;
  const int h0 = (tile / a.tiles_w) * kTH;
  const int w0 = (tile % a.tiles_w) * kTW;
  const int co0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const size_t img = static_cast<size_t>(b) * a.H * a.W;

  if (a.apply_norm) {
    const float* st1 = a.st1 + static_cast<size_t>(b) * 2 * a.C1;
    const float* st2 =
        a.C2 ? a.st2 + static_cast<size_t>(b) * 2 * a.C2 : nullptr;
    block_group_mean_inv(st1, st2, a.C1, a.C2, a.H * a.W, a.groups, a.eps,
                         s_scale, s_bias);
    for (int c = tid; c < n_chunks * KC; c += kThreads) {
      float sc = 0.f, bi = 0.f;   // channels that pad the last chunk
      if (c < C) {
        const float mean = s_scale[c], inv = s_bias[c], g = a.gamma[c];
        sc = __fmul_rn(inv, g);
        bi = __fsub_rn(a.beta[c], __fmul_rn(__fmul_rn(mean, inv), g));
      }
      s_scale[c] = sc;
      s_bias[c] = bi;
    }
  }
  if (tid < BN) {   // what the epilogue adds to every pixel of a channel
    const int co = co0 + tid;
    s_add[tid] = co < a.Co ? a.conv_b[co] + (a.shift
                                                 ? a.shift[(size_t)b * a.Co + co]
                                                 : 0.f)
                           : 0.f;
  }
  __syncthreads();

  // The staged tile is a list of 16-byte vectors (pixel, 8-channel group).
  // A thread owns the same few of them in every chunk: it copies them,
  // waits for its own copies and transforms them in place, so one
  // __syncthreads per chunk publishes the finished tile. Their shared
  // memory offsets and image positions are computed once.
  constexpr int NV = kIH * kIW * G::KG;
  constexpr int NSLOT = (NV + kThreads - 1) / kThreads;
  static_assert(kThreads % G::KG == 0, "a thread keeps one channel group");
  const int q8 = (tid % G::KG) * 8;   // first channel of its group in a chunk
  uint32_t in_off[NSLOT];             // byte offset in the staged tile
  int in_pix[NSLOT];                  // pixel index in the image, -1 outside
#pragma unroll
  for (int k = 0; k < NSLOT; ++k) {
    const int v = tid + k * kThreads;
    const int pix = v / G::KG;
    const int iy = pix / kIW, ix = pix % kIW;
    const int gh = h0 + iy - 1, gw = w0 + ix - 1;
    const bool inside =
        v < NV && gh >= 0 && gh < a.H && gw >= 0 && gw < a.W;
    in_off[k] = (q8 / 8) * G::QB + pix * 16;
    in_pix[k] = inside ? gh * a.W + gw : -1;
  }
  // weights: a thread copies the same (k row, 8-channel group) of every
  // tap it is given
  constexpr int VT = KC * 8;            // 16-byte vectors per tap and half
  constexpr int TG = kThreads / VT;     // taps copied side by side
  static_assert(kThreads % VT == 0, "threads split evenly over a tap");
  const int w_r = (tid % VT) / 8;       // k row within the chunk
  const int w_j = tid % 8;              // 8-channel group of the n64 half
  const int w_t0 = tid / VT;
  const uint32_t w_off = (w_r / 8) * kAtom + (w_r % 8) * 128 +
                         ((w_j ^ (w_r % 8)) * 16);

  // copies chunk `chunk` (input halo tile, then weights) into stage `stage`
  auto load_stage = [&](int chunk, int stage) {
    const uint32_t wbase = base + stage * G::STAGE;
    const uint32_t ibase = wbase + G::WBYTES;
    const int c0 = chunk * KC;
    const int gc = c0 + q8;
    if (a.vec_in) {
      const bool first = gc < a.C1;
      const bf16* src = first ? a.x1 + gc : a.x2 + (gc - a.C1);
      const int cs = first ? a.C1 : a.C2;
#pragma unroll
      for (int k = 0; k < NSLOT; ++k) {
        if (tid + k * kThreads >= NV) continue;
        const bool ok = in_pix[k] >= 0 && gc < C;
        cp_async16(ibase + in_off[k],
                   ok ? src + (img + in_pix[k]) * cs : a.x1, ok ? 16u : 0u);
      }
    } else {
#pragma unroll
      for (int k = 0; k < NSLOT; ++k) {
        if (tid + k * kThreads >= NV) continue;
        const size_t p = img + (in_pix[k] >= 0 ? in_pix[k] : 0);
        __align__(16) bf16 t[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int c = gc + e;
          float val = 0.f;
          if (in_pix[k] >= 0 && c < C)
            val = __bfloat162float(c < a.C1 ? a.x1[p * a.C1 + c]
                                            : a.x2[p * a.C2 + (c - a.C1)]);
          t[e] = __float2bfloat16_rn(val);
        }
        st_shared16(ibase + in_off[k], *reinterpret_cast<const uint4*>(t));
      }
    }
    const int wc = c0 + w_r;
#pragma unroll
    for (int h = 0; h < G::NH; ++h) {
      const int gco = co0 + h * 64 + w_j * 8;
      const bool ok = wc < C && gco < a.Co;
      const bf16* src = a.w + static_cast<size_t>(wc) * a.Co + gco;
      const size_t tap_stride = static_cast<size_t>(C) * a.Co;
      for (int t = w_t0; t < 9; t += TG) {
        const uint32_t dst = wbase + (h * 9 + t) * G::KG * kAtom + w_off;
        if (a.vec_w) {
          cp_async16(dst, ok ? src + t * tap_stride : a.w, ok ? 16u : 0u);
        } else {
          __align__(16) bf16 tv[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            tv[e] = (wc < C && gco + e < a.Co)
                        ? src[t * tap_stride + e]
                        : __float2bfloat16_rn(0.f);
          st_shared16(dst, *reinterpret_cast<const uint4*>(tv));
        }
      }
    }
  };

  // GroupNorm affine + swish of this thread's vectors of a staged tile,
  // in place; positions outside the image keep the zeros they were filled
  // with
  auto transform = [&](int chunk, int stage) {
    const uint32_t ibase = base + stage * G::STAGE + G::WBYTES;
    const float4* sc4 =
        reinterpret_cast<const float4*>(s_scale + chunk * KC + q8);
    const float4* bi4 =
        reinterpret_cast<const float4*>(s_bias + chunk * KC + q8);
    const float4 sa = sc4[0], sb = sc4[1], ba = bi4[0], bb = bi4[1];
#pragma unroll
    for (int k = 0; k < NSLOT; ++k) {
      if (in_pix[k] < 0) continue;
      uint4 u = ld_shared16(ibase + in_off[k]);
      u.x = norm_swish2(u.x, sa.x, ba.x, sa.y, ba.y);
      u.y = norm_swish2(u.y, sa.z, ba.z, sa.w, ba.w);
      u.z = norm_swish2(u.z, sb.x, bb.x, sb.y, bb.y);
      u.w = norm_swish2(u.w, sb.z, bb.z, sb.w, bb.w);
      st_shared16(ibase + in_off[k], u);
    }
  };

  // The warpgroup owns an 8 x 8 pixel patch of the tile: row m of its m64
  // is pixel (m / 8, m % 8) of the patch, so the eight rows of a core
  // matrix are eight neighbouring pixels of one tile row, 128 contiguous
  // bytes of a channel-group plane, and a tap is a shift of the start
  // address.
  const int wg = warp >> 2;
  const int py0 = (wg >> 1) * 8, px0 = (wg & 1) * 8;
  float acc[G::NH * 32];
#pragma unroll
  for (int i = 0; i < G::NH * 32; ++i) acc[i] = 0.f;

  constexpr int ST = kStages;
  // Stage ring. In iteration i the tensor cores multiply chunk i (stage
  // i % ST, transformed in the iteration before); every warp also starts
  // its copies of chunk i+ST-1 into the stage that the __syncthreads
  // ending iteration i-1 freed, and transforms its vectors of chunk i+1.
#pragma unroll
  for (int c = 0; c < ST - 1; ++c) {
    if (c < n_chunks) load_stage(c, c);
    cp_async_commit();
  }
  cp_async_wait<ST - 2>();
  if (a.apply_norm) transform(0, 0);
  fence_proxy_async();
  __syncthreads();
  // The two warpgroups of the tile's upper half start their wgmmas first
  // and stage afterwards; the lower two stage first. So each pair's copies
  // and transform run beside the other pair's multiply. (The shuffle makes
  // the role uniform across the warp for the compiler.)
  const bool mma_first = __shfl_sync(0xffffffffu, tid >> 8, 0) == 0;
  for (int i = 0; i < n_chunks; ++i) {
    const int stage = i % ST;
    const int next = (i + 1) % ST;
    const uint32_t wbase = base + stage * G::STAGE;
    const uint32_t abase =
        wbase + G::WBYTES + ((py0 * kIW) + px0) * 16;
    // every wgmma of the chunk is started at once: operands come from
    // shared memory
    auto multiply = [&]() {
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 9; ++t) {
#pragma unroll
        for (int s = 0; s < G::KS; ++s)
          wgmma_ss(acc,
                   a_desc(abase + ((t / 3) * kIW + t % 3) * 16 + 2 * s * G::QB,
                          G::QB, kIW * 16),
                   b_desc(wbase + (t * G::KG + 2 * s) * kAtom,
                          9 * G::KG * kAtom));
      }
      wgmma_commit();
    };
    auto stage_next = [&]() {
      if (i + ST - 1 < n_chunks) load_stage(i + ST - 1, (i + ST - 1) % ST);
      cp_async_commit();
      cp_async_wait<ST - 2>();   // this thread's copies of chunk i+1 landed
      if (a.apply_norm && i + 1 < n_chunks) transform(i + 1, next);
    };
    if (mma_first) {
      multiply();
      stage_next();
    } else {
      stage_next();
      multiply();
    }
    wgmma_wait<0>();
    fence_proxy_async();
    __syncthreads();   // chunk i+1 is transformed; stage i % ST is free
  }
#pragma unroll
  for (int i = 0; i < G::NH * 32; ++i) keep(acc[i]);

  // epilogue. Accumulator element 32*h + 4*j + 2*p + e is row 16*(warp%4)
  // + lane/4 + 8*p of the m64, i.e. patch pixel (2*(warp%4) + p, lane/4),
  // channel 64*h + 8*j + 2*(lane%4) + e. Where Co is a multiple of 8 the
  // tile goes through shared memory (the stages are free now), so that res
  // is read and y written with 16-byte accesses along the channels; other
  // widths (the final block's Co = 3) are read and written directly.
  const int tx = px0 + (lane >> 2);
  const int gw = w0 + tx;
  const int cq = (lane & 3) * 2;
  const bool pair = (a.Co & 1) == 0;   // bf16x2 accesses stay 4-byte aligned
  const bool want_stats = a.partial != nullptr;
  constexpr int OV = BN / 8;           // 16-byte vectors per output pixel
  if (a.vec_out && a.res) {
    for (int v = tid; v < kTH * kTW * OV; v += kThreads) {
      const int tp = v / OV, cv = v % OV;
      const int gh = h0 + tp / kTW, gx = w0 + tp % kTW;
      if (gh < a.H && gx < a.W && co0 + cv * 8 < a.Co)
        st_shared16(base + tp * G::OP + cv * 16,
                    *reinterpret_cast<const uint4*>(
                        a.res + (img + (size_t)gh * a.W + gx) * a.Co + co0 +
                        cv * 8));
    }
    __syncthreads();
  }
#pragma unroll
  for (int h = 0; h < G::NH; ++h) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = co0 + h * 64 + j * 8 + cq;
      float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
      const float add[2] = {s_add[h * 64 + j * 8 + cq],
                            s_add[h * 64 + j * 8 + cq + 1]};
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int ty = py0 + 2 * (warp & 3) + p;
        const int gh = h0 + ty;
        if (gh >= a.H || gw >= a.W || co >= a.Co) continue;
        const size_t o = (img + (size_t)gh * a.W + gw) * a.Co + co;
        float v0 = acc[32 * h + 4 * j + 2 * p] + add[0];
        float v1 = acc[32 * h + 4 * j + 2 * p + 1] + add[1];
        if (a.vec_out) {
          const uint32_t sa = base + (ty * kTW + tx) * G::OP +
                              (h * 64 + j * 8 + cq) * 2;
          if (a.res) {
            uint32_t word = ld_shared32(sa);
            const __nv_bfloat162 r =
                *reinterpret_cast<const __nv_bfloat162*>(&word);
            v0 += __low2float(r);
            v1 += __high2float(r);
          }
          __nv_bfloat162 q = __halves2bfloat162(__float2bfloat16_rn(v0),
                                                __float2bfloat16_rn(v1));
          st_shared32(sa, *reinterpret_cast<const uint32_t*>(&q));
        } else if (pair) {
          if (a.res) {
            const __nv_bfloat162 r =
                *reinterpret_cast<const __nv_bfloat162*>(a.res + o);
            v0 += __low2float(r);
            v1 += __high2float(r);
          }
          *reinterpret_cast<__nv_bfloat162*>(a.y + o) = __halves2bfloat162(
              __float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
        } else {
          if (a.res) v0 += __bfloat162float(a.res[o]);
          a.y[o] = __float2bfloat16_rn(v0);
          if (co + 1 < a.Co) {
            if (a.res) v1 += __bfloat162float(a.res[o + 1]);
            a.y[o + 1] = __float2bfloat16_rn(v1);
          } else {
            v1 = 0.f;
          }
        }
        s1[0] += v0;
        s2[0] += v0 * v0;
        s1[1] += v1;
        s2[1] += v1 * v1;
      }
      if (want_stats) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int m = 4; m < 32; m <<= 1) {
            s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], m);
            s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], m);
          }
        }
        if (lane < 4) {
          const int n = h * 64 + j * 8 + cq;
          s_red[(warp * 2 + 0) * BN + n] = s1[0];
          s_red[(warp * 2 + 0) * BN + n + 1] = s1[1];
          s_red[(warp * 2 + 1) * BN + n] = s2[0];
          s_red[(warp * 2 + 1) * BN + n + 1] = s2[1];
        }
      }
    }
  }
  if (!a.vec_out && !want_stats) return;
  __syncthreads();
  if (a.vec_out) {
    for (int v = tid; v < kTH * kTW * OV; v += kThreads) {
      const int tp = v / OV, cv = v % OV;
      const int gh = h0 + tp / kTW, gx = w0 + tp % kTW;
      if (gh < a.H && gx < a.W && co0 + cv * 8 < a.Co)
        *reinterpret_cast<uint4*>(a.y + (img + (size_t)gh * a.W + gx) * a.Co +
                                  co0 + cv * 8) =
            ld_shared16(base + tp * G::OP + cv * 16);
    }
  }
  if (want_stats && tid < 2 * BN) {
    const int k = tid / BN, n = tid % BN;
    if (co0 + n < a.Co) {
      float s = 0.f;
#pragma unroll
      for (int wp = 0; wp < kThreads / 32; ++wp)
        s += s_red[(wp * 2 + k) * BN + n];
      a.partial[(((size_t)b * gridDim.x + tile) * 2 + k) * a.Co + co0 + n] = s;
    }
  }
}

template <int BN, int KC>
cudaError_t launch(const ConvArgs& a, int B, int n_tiles, cudaStream_t s) {
  using G = Geo<BN, KC>;
  auto kernel = fused_conv_wgmma_kernel<BN, KC>;
  static bool opted_in = false;   // per instantiation
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  dim3 grid(n_tiles, (a.Co + BN - 1) / BN, B);
  kernel<<<grid, kThreads, G::SMEM, s>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fdsr

extern "C" {

int fdsr_fused_conv_wgmma_max_channels() { return fdsr::kMaxC; }

int fdsr_fused_conv_wgmma_tiles(int H, int W) {
  return ((H + fdsr::kTH - 1) / fdsr::kTH) * ((W + fdsr::kTW - 1) / fdsr::kTW);
}

// The bfloat16 tensor-core K3. x1: (B,H,W,C1), x2: (B,H,W,C2) or null with
// C2 = 0. stats1: (B,2,C1), stats2: (B,2,C2) float32 channel sums of x1 and
// x2, gamma, beta: (C1+C2,) float32, all read only when apply_norm. w:
// (3,3,C1+C2,Co) HWIO bfloat16. conv_b: (Co,) float32. shift: (B,Co)
// float32 or null. res: (B,H,W,Co) bfloat16 or null. y: (B,H,W,Co)
// bfloat16. partial: (B, n_tiles, 2, Co) float32 scratch and stats:
// (B,2,Co) float32, both null when no statistics are wanted; n_tiles is
// fdsr_fused_conv_wgmma_tiles(H, W). C1 + C2 <=
// fdsr_fused_conv_wgmma_max_channels().
int fdsr_fused_gn_swish_conv3x3_wgmma(
    const void* x1, const void* x2, int C1, int C2, const float* stats1,
    const float* stats2, const float* gamma, const float* beta, int groups,
    float eps, int apply_norm, const void* w, const float* conv_b,
    const float* shift, const void* res, void* y, float* partial,
    float* stats, int B, int H, int W, int Co, void* stream) {
  using fdsr::bf16;
  if (C1 + C2 > fdsr::kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_w = (W + fdsr::kTW - 1) / fdsr::kTW;
  const int n_tiles = ((H + fdsr::kTH - 1) / fdsr::kTH) * tiles_w;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fdsr::ConvArgs a;
  a.x1 = static_cast<const bf16*>(x1);
  a.x2 = static_cast<const bf16*>(x2);
  a.C1 = C1;
  a.C2 = C2;
  a.st1 = stats1;
  a.st2 = stats2;
  a.gamma = gamma;
  a.beta = beta;
  a.groups = groups;
  a.eps = eps;
  a.apply_norm = apply_norm;
  a.w = static_cast<const bf16*>(w);
  a.conv_b = conv_b;
  a.shift = shift;
  a.res = static_cast<const bf16*>(res);
  a.y = static_cast<bf16*>(y);
  a.partial = partial;
  a.H = H;
  a.W = W;
  a.Co = Co;
  a.tiles_w = tiles_w;
  auto aligned16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  a.vec_in = C1 % 8 == 0 && C2 % 8 == 0 && aligned16(x1) && aligned16(x2);
  a.vec_w = Co % 8 == 0 && aligned16(w);
  a.vec_out = Co % 8 == 0 && aligned16(y) && aligned16(res);
  // one n128 wgmma per tap where Co allows, else n64 with two blocks per SM
  cudaError_t err = Co % 128 == 0 ? fdsr::launch<128, 16>(a, B, n_tiles, s)
                                  : fdsr::launch<64, 16>(a, B, n_tiles, s);
  if (err != cudaSuccess || partial == nullptr) return static_cast<int>(err);
  fdsr::launch_reduce_partials(partial, stats, B, n_tiles, Co, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
