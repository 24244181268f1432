// K3 in IEEE float32 on the CUDA cores: fused GroupNorm -> Swish -> 3x3 conv
// with a statistics epilogue. It takes the float32 maps (validation and the
// float32 checks must not pass through TF32, so no mma / wgmma here); the
// tensor-core kernel of fused_conv_wgmma.cu takes the bfloat16 maps.
//
//   y     = conv3x3(swish(GN(x) * gamma + beta)) + b_conv
//           [+ shift[b, co]] [+ res]
//   stats = per-channel (sum y, sum y^2) over H,W of the float32
//           accumulator (res included)
//
// Replaces fastdiffsr_tpu/ops/fused_conv.py::fused_gn_swish_conv3x3, a
// Pallas kernel that built a (rows*W, 9C) im2col patch of one row band in
// VMEM and fed the MXU one K=9C product per grid step; this port keeps the
// math, not that schedule. The GroupNorm statistics come in as per-channel
// sums (the previous kernel's epilogue); every block collapses them to its
// image's per-channel scale and bias in shared memory
// (block_group_mean_inv in common.cuh). With apply_norm = 0 the prologue
// is the identity (stem and Upsample convs).
//
// Bound on the H100: operations. At the UNet's widths a call does
// 2*9*C*Co flops per pixel against (C + Co) * 4 bytes, far above the
// ridge, so the floor is flops / 67 TFLOP/s of float32 FFMA. The design is
// an SGEMM-style implicit GEMM (M = pixels, N = Co, K = 9*C) that keeps
// the FFMA pipes as busy as it can:
//
// - Register blocking. Each thread owns 8 neighbouring pixels of one tile
//   row x 8 output channels: 64 float32 accumulators. Per (input channel,
//   dy) it reads the 10 input values of its row segment once (two float4
//   and a float2) and uses them for the three dx taps, and per tap it reads
//   its 8 weights as two float4: 9 shared loads for 192 FFMAs. A thread's
//   channels are two runs of four (cg*4 and TCO/2 + cg*4), so the float4
//   weight reads of a warp fall in distinct banks, and the warps are laid
//   out channel group fastest, so the pixel reads are broadcasts or
//   conflict-free: about twice the FFMAs per shared-memory wavefront of
//   the kernel before this one (8 x 4 accumulators, 13 loads per 96
//   FFMAs). The channel loop is unrolled by 2 (by 4 or fully it was
//   slower on the H100).
// - Asynchronous staging. Input channels are walked in stages of KC = 8.
//   Each stage's raw NHWC halo tile (one 16-byte cp.async per pixel and
//   4 channels: channels are contiguous) and its HWIO weights (16-byte
//   copies along Co) go to one of two stage buffers; the copies of stage
//   i+1 are in flight while the FFMAs of stage i run.
// - Transform once per staged element. When a stage has landed, the thread
//   that copied a vector applies x * scale + bias and then swish to it
//   (each product and sum rounded on its own, the exact expf, and the
//   branch-free reciprocal rcp_newton of common.cuh in place of IEEE
//   division, whose range-check branch serialised the elements) and writes
//   it, transposed to channel planes, into one of two compute buffers.
//   Halo positions outside the image are zeroed after the transform (zero
//   padding applies to the normalised map). One __syncthreads per stage.
//   A block covers 128 output channels where Co > 64, so a map is
//   transformed once per 128 of them (twice at Co = 256, not four times).
// - Tiles from the grid. The launcher takes the widest tile whose grid
//   still puts a block on every one of the 132 SMs: 8x16 pixels x 128
//   channels where Co > 64, 16x16 x 64 otherwise (256 threads each, two
//   blocks per SM). Where those leave SMs idle (64^2 and 32^2 maps at
//   batch 1, the validation batch) it takes 8x8 x 64, four times the
//   blocks, whose 256 threads are four groups of 64 that split each
//   stage's 8 channels two apiece; group 0 then adds the other groups'
//   accumulators in a fixed order. So a block has the warps to hide its
//   latencies even where the grid has fewer blocks than SMs. Co <= 8 (the
//   final Block) takes 16x32 pixels x 8 channels. The choice depends on
//   the shape alone, so a result is the same on every card; the tiles
//   count is fdsr_fused_conv_tiles.
// - Epilogue: bias, shift and residual added to the accumulators, float4
//   stores along Co, per-tile (sum, sum of squares) reduced by shuffles and
//   then over the warps in a fixed order; launch_reduce_partials sums the
//   tiles in order. No float atomics: two runs are bit-identical.
// - Edges. Widths that are not multiples of 4 (the stem's C = 6, the final
//   Block's Co = 3) are copied with 4-byte cp.async into the same layout;
//   ragged H, W and Co are zero-filled at the copy and masked at the store.
//   Two sources (the UNet's skip concat) are read as one channel concat
//   without building it; the per-channel affine comes from the channel
//   sums of both, so groups that straddle the boundary are exact.

#include <cstdint>

#include "common.cuh"

namespace fdsr {
namespace {

constexpr int kKC = 8;         // input channels per stage
constexpr int kPX = 8;         // pixels per thread, one row segment
constexpr int kCO = 8;         // output channels per thread
constexpr int kMaxC = 1024;    // channels the affine arrays may hold
constexpr int kSMs = 132;      // the H100 SXM's; fixes the tile choice

struct F32Args {
  const float* x1;
  const float* x2;
  int C1, C2;
  const float* st1;
  const float* st2;
  const float* gamma;
  const float* beta;
  int groups;
  float eps;
  int apply_norm;
  const float* w;
  const float* conv_b;
  const float* shift;
  const float* res;
  float* y;
  float* partial;
  int H, W, Co, tiles_w;
  int vec_in, vec_w, vec_out;
};

// A TH x TW pixel x TCO channel output tile, one thread per 8 pixels x 8
// channels of it in each of KS groups that split every stage's channels
// between them. Sizes in floats.
template <int TH, int TW, int TCO, int KS>
struct Tile {
  static constexpr int SEGS = TW / kPX;           // row segments
  static constexpr int PG = TH * SEGS;            // pixel groups
  static constexpr int CG = TCO / kCO;            // channel groups
  static constexpr int EPI = PG * CG;             // threads of one group
  static constexpr int THREADS = EPI * KS;
  static constexpr int IH = TH + 2, IW = TW + 2;  // halo tile
  static constexpr int NPIX = IH * IW;
  static constexpr int NV = NPIX * kKC / 4;       // 16-byte input vectors
  static constexpr int NWV = 9 * kKC * TCO / 4;   // 16-byte weight vectors
  static constexpr int RS = TW + 4;               // plane row stride
  // a plane per channel, 16-byte aligned and == 4 (mod 8) floats long, so
  // the transform's writes of one channel quad and the next fall in
  // different banks
  static constexpr int PLANE = (IH * RS + 3) / 8 * 8 + 4;
  static constexpr int WST = 9 * kKC * TCO;       // [tap][kc][TCO]
  static constexpr int STAGE = WST + NPIX * kKC;  // weights, raw [pix][kc]
  static constexpr int COMP = kKC * PLANE;        // transformed [kc][iy][RS]
  static constexpr int FIXED = 2 * STAGE + 2 * COMP + TCO;
  // after the loop: the accumulators of groups 1.. and then the
  // statistics scratch [warp][2][TCO] in the stage and compute buffers
  static constexpr int RED = (KS - 1) * EPI * kPX * kCO;
  static size_t smem_bytes(int C) {
    const int cpad = (C + kKC - 1) / kKC * kKC;
    return sizeof(float) * (FIXED + 2 * static_cast<size_t>(cpad));
  }
  static_assert(TW % kPX == 0 && TCO % kCO == 0, "thread tiling");
  static_assert((CG & (CG - 1)) == 0 && CG <= 32, "channel groups in a warp");
  static_assert(EPI % 32 == 0 && kKC % KS == 0, "whole warps and stages");
  static_assert(RED + (EPI / 32) * 2 * TCO <= 2 * STAGE + 2 * COMP,
                "epilogue scratch fits");
};

template <int TH, int TW, int TCO, int KS, int MINB>
__global__ void __launch_bounds__(Tile<TH, TW, TCO, KS>::THREADS, MINB)
fused_conv_f32_kernel(const F32Args a) {
  using G = Tile<TH, TW, TCO, KS>;
  extern __shared__ __align__(16) float smem[];
  const int C = a.C1 + a.C2;
  const int n_chunks = (C + kKC - 1) / kKC;
  const int cpad = n_chunks * kKC;
  float* const s_comp = smem + 2 * G::STAGE;
  float* const s_add = s_comp + 2 * G::COMP;
  float* const s_scale = s_add + TCO;
  float* const s_bias = s_scale + cpad;

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int h0 = (tile / a.tiles_w) * TH;
  const int w0 = (tile % a.tiles_w) * TW;
  const int co0 = blockIdx.y * TCO;
  const int b = blockIdx.z;
  const size_t img = static_cast<size_t>(b) * a.H * a.W;

  // copies chunk `chunk` into stage `st`: the raw halo tile as [pixel][kc]
  // (a thread copies the vectors tid, tid + THREADS, ...: the ones it
  // transforms later) and the weights as [tap][kc][TCO]
  auto load_stage = [&](int chunk, int st) {
    float* const wst = smem + st * G::STAGE;
    const uint32_t raw = smem_u32(wst + G::WST);
    const int c0 = chunk * kKC;
    for (int v = tid; v < G::NV; v += G::THREADS) {
      const int p = v >> 1;
      const int iy = p / G::IW, ix = p - iy * G::IW;
      const int gh = h0 + iy - 1, gw = w0 + ix - 1;
      const bool inside = gh >= 0 && gh < a.H && gw >= 0 && gw < a.W;
      const size_t pix = img + (inside ? gh * a.W + gw : 0);
      const int gc = c0 + (v & 1) * 4;
      if (a.vec_in) {
        const bool ok = inside && gc < C;
        const float* src = gc < a.C1 ? a.x1 + pix * a.C1 + gc
                                     : a.x2 + pix * a.C2 + (gc - a.C1);
        cp_async16(raw + v * 16, ok ? src : a.x1, ok ? 16u : 0u);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = gc + e;
          const bool ok = inside && c < C;
          const float* src = c < a.C1 ? a.x1 + pix * a.C1 + c
                                      : a.x2 + pix * a.C2 + (c - a.C1);
          cp_async4(raw + v * 16 + e * 4, ok ? src : a.x1, ok ? 4u : 0u);
        }
      }
    }
    const uint32_t wdst = smem_u32(wst);
    for (int u = tid; u < G::NWV; u += G::THREADS) {
      const int r = u / (TCO / 4);          // tap * kKC + kc
      const int q = u - r * (TCO / 4);
      const int gc = c0 + (r & (kKC - 1));
      const int gco = co0 + q * 4;
      const float* src =
          a.w + (static_cast<size_t>(r / kKC) * C + gc) * a.Co + gco;
      if (a.vec_w) {
        const bool ok = gc < C && gco < a.Co;
        cp_async16(wdst + u * 16, ok ? src : a.w, ok ? 16u : 0u);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = gc < C && gco + e < a.Co;
          cp_async4(wdst + u * 16 + e * 4, ok ? src + e : a.w, ok ? 4u : 0u);
        }
      }
    }
  };

  // GroupNorm affine + swish of this thread's vectors of stage `st`, written
  // transposed into compute buffer `cb`; outside the image: zeros
  auto transform = [&](int chunk, int st, int cb) {
    const float* raw = smem + st * G::STAGE + G::WST;
    float* comp = s_comp + cb * G::COMP;
    const int c0 = chunk * kKC;
    for (int v = tid; v < G::NV; v += G::THREADS) {
      const int p = v >> 1, q = (v & 1) * 4;
      const int iy = p / G::IW, ix = p - iy * G::IW;
      const int gh = h0 + iy - 1, gw = w0 + ix - 1;
      const bool inside = gh >= 0 && gh < a.H && gw >= 0 && gw < a.W;
      const float4 r = *reinterpret_cast<const float4*>(raw + v * 4);
      float val[4] = {r.x, r.y, r.z, r.w};
      if (a.apply_norm) {
        const float4 sc = *reinterpret_cast<const float4*>(s_scale + c0 + q);
        const float4 bi = *reinterpret_cast<const float4*>(s_bias + c0 + q);
        const float s4[4] = {sc.x, sc.y, sc.z, sc.w};
        const float b4[4] = {bi.x, bi.y, bi.z, bi.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          val[e] = swish_exact(__fadd_rn(__fmul_rn(val[e], s4[e]), b4[e]));
      }
      float* dst = comp + q * G::PLANE + iy * G::RS + ix;
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e * G::PLANE] = inside ? val[e] : 0.f;
    }
  };

  // the first copies run beside the group collapse
  load_stage(0, 0);
  cp_async_commit();
  if (a.apply_norm) {
    const float* st1 = a.st1 + static_cast<size_t>(b) * 2 * a.C1;
    const float* st2 =
        a.C2 ? a.st2 + static_cast<size_t>(b) * 2 * a.C2 : nullptr;
    block_group_mean_inv(st1, st2, a.C1, a.C2, a.H * a.W, a.groups, a.eps,
                         s_scale, s_bias);
    for (int c = tid; c < cpad; c += G::THREADS) {
      float sc = 0.f, bi = 0.f;   // channels that pad the last stage
      if (c < C) {
        const float mean = s_scale[c], inv = s_bias[c], g = a.gamma[c];
        sc = __fmul_rn(inv, g);
        bi = __fsub_rn(a.beta[c], __fmul_rn(__fmul_rn(mean, inv), g));
      }
      s_scale[c] = sc;
      s_bias[c] = bi;
    }
  }
  for (int n = tid; n < TCO; n += G::THREADS) {
    // what the epilogue adds to every pixel of a channel
    const int co = co0 + n;
    s_add[n] = co < a.Co
                   ? a.conv_b[co] +
                         (a.shift ? a.shift[static_cast<size_t>(b) * a.Co + co]
                                  : 0.f)
                   : 0.f;
  }
  __syncthreads();
  cp_async_wait<0>();
  transform(0, 0, 0);
  __syncthreads();

  // thread layout: channel group fastest within a warp; group ks of the
  // KS takes input channels ks * KC / KS .. of every stage (ks is a
  // constant 0 where KS = 1, so that loop keeps its constant bounds)
  const int ks = KS == 1 ? 0 : tid / G::EPI;
  const int cg = tid % G::CG;
  const int pg = (tid % G::EPI) / G::CG;
  const int prow = pg / G::SEGS;
  const int pcol = (pg % G::SEGS) * kPX;
  const int chA = cg * 4;              // local channels chA..+3 and chB..+3
  const int chB = TCO / 2 + cg * 4;

  float acc[kPX][kCO];
#pragma unroll
  for (int i = 0; i < kPX; ++i)
#pragma unroll
    for (int j = 0; j < kCO; ++j) acc[i][j] = 0.f;

  for (int i = 0; i < n_chunks; ++i) {
    const int st = i & 1;
    if (i + 1 < n_chunks) load_stage(i + 1, st ^ 1);
    cp_async_commit();
    const float* cin = s_comp + st * G::COMP + prow * G::RS + pcol;
    const float* wst = smem + st * G::STAGE;
#pragma unroll 2
    for (int c = ks * (kKC / KS); c < (ks + 1) * (kKC / KS); ++c) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float* r = cin + c * G::PLANE + dy * G::RS;
        const float4 x0 = *reinterpret_cast<const float4*>(r);
        const float4 x1 = *reinterpret_cast<const float4*>(r + 4);
        const float2 x2 = *reinterpret_cast<const float2*>(r + 8);
        const float xin[kPX + 2] = {x0.x, x0.y, x0.z, x0.w, x1.x,
                                    x1.y, x1.z, x1.w, x2.x, x2.y};
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* wr = wst + ((dy * 3 + dx) * kKC + c) * TCO;
          const float4 wa = *reinterpret_cast<const float4*>(wr + chA);
          const float4 wb = *reinterpret_cast<const float4*>(wr + chB);
          const float wv[kCO] = {wa.x, wa.y, wa.z, wa.w,
                                 wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int p = 0; p < kPX; ++p)
#pragma unroll
            for (int j = 0; j < kCO; ++j)
              acc[p][j] = fmaf(xin[p + dx], wv[j], acc[p][j]);
        }
      }
    }
    cp_async_wait<0>();   // this thread's copies of chunk i+1 landed
    if (i + 1 < n_chunks) transform(i + 1, st ^ 1, st ^ 1);
    __syncthreads();      // chunk i+1 is staged; buffers of chunk i free
  }

  if (KS > 1) {
    // group 0 adds the other groups' accumulators, in order
    float* red = smem;   // [group - 1][accumulator][thread of the group]
    const int t = tid % G::EPI;
    if (ks > 0) {
#pragma unroll
      for (int p = 0; p < kPX; ++p)
#pragma unroll
        for (int j = 0; j < kCO; ++j)
          red[((ks - 1) * kPX * kCO + p * kCO + j) * G::EPI + t] = acc[p][j];
    }
    __syncthreads();
    if (ks == 0) {
      for (int k = 1; k < KS; ++k)
#pragma unroll
        for (int p = 0; p < kPX; ++p)
#pragma unroll
          for (int j = 0; j < kCO; ++j)
            acc[p][j] += red[((k - 1) * kPX * kCO + p * kCO + j) * G::EPI + t];
    }
  }

  // epilogue (group 0): bias, shift, residual, store, per-tile statistics
  const bool epi = ks == 0;
  const int gh = h0 + prow;
  const int coA = co0 + chA, coB = co0 + chB;
  float add[kCO], s1[kCO], s2[kCO];
#pragma unroll
  for (int j = 0; j < kCO; ++j) {
    add[j] = s_add[j < 4 ? chA + j : chB + j - 4];
    s1[j] = 0.f;
    s2[j] = 0.f;
  }
#pragma unroll
  for (int p = 0; p < kPX; ++p) {
    const int gw = w0 + pcol + p;
    if (!epi || gh >= a.H || gw >= a.W) continue;
    const size_t o = (img + static_cast<size_t>(gh) * a.W + gw) * a.Co;
    float v[kCO];
#pragma unroll
    for (int j = 0; j < kCO; ++j) v[j] = acc[p][j] + add[j];
    if (a.vec_out) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = h ? coB : coA;
        if (co >= a.Co) continue;
        float* vh = v + 4 * h;
        if (a.res) {
          const float4 rr = *reinterpret_cast<const float4*>(a.res + o + co);
          vh[0] += rr.x;
          vh[1] += rr.y;
          vh[2] += rr.z;
          vh[3] += rr.w;
        }
        *reinterpret_cast<float4*>(a.y + o + co) =
            make_float4(vh[0], vh[1], vh[2], vh[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s1[4 * h + e] += vh[e];
          s2[4 * h + e] += vh[e] * vh[e];
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kCO; ++j) {
        const int co = j < 4 ? coA + j : coB + j - 4;
        if (co >= a.Co) continue;
        if (a.res) v[j] += a.res[o + co];
        a.y[o + co] = v[j];
        s1[j] += v[j];
        s2[j] += v[j] * v[j];
      }
    }
  }
  if (a.partial == nullptr) return;
  // over the lanes of one channel group (lane, lane ^ CG, ...), then over
  // the warps in order
#pragma unroll
  for (int j = 0; j < kCO; ++j) {
#pragma unroll
    for (int m = G::CG; m < 32; m <<= 1) {
      s1[j] += __shfl_xor_sync(0xffffffffu, s1[j], m);
      s2[j] += __shfl_xor_sync(0xffffffffu, s2[j], m);
    }
  }
  float* s_red = smem + G::RED;   // [warp][2][TCO]
  const int warp = tid / 32, lane = tid % 32;
  if (epi && lane < G::CG) {
#pragma unroll
    for (int j = 0; j < kCO; ++j) {
      const int n = j < 4 ? chA + j : chB + j - 4;
      s_red[(warp * 2 + 0) * TCO + n] = s1[j];
      s_red[(warp * 2 + 1) * TCO + n] = s2[j];
    }
  }
  __syncthreads();
  for (int t = tid; t < 2 * TCO; t += G::THREADS) {
    const int k = t / TCO, n = t % TCO;
    if (co0 + n >= a.Co) continue;
    float s = 0.f;
#pragma unroll
    for (int wp = 0; wp < G::EPI / 32; ++wp) s += s_red[(wp * 2 + k) * TCO + n];
    a.partial[((static_cast<size_t>(b) * gridDim.x + tile) * 2 + k) * a.Co +
              co0 + n] = s;
  }
}

struct TileShape {
  int th, tw, tco;
};

// the kernel's tiles, widest first; their indices are launch()'s
constexpr TileShape kTiles[4] = {
    {8, 16, 128}, {16, 16, 64}, {8, 8, 64}, {16, 32, 8}};

int cdiv(int n, int d) { return (n + d - 1) / d; }

// Which tile takes a (B, H, W, Co) call: Co <= 8 the narrow tile; else the
// widest tile (128 channels only where Co > 64) whose grid has a block for
// every SM, else the small tile.
int choose_tile(int B, int H, int W, int Co) {
  if (Co <= kCO) return 3;
  for (int t = Co > 64 ? 0 : 1; t < 2; ++t) {
    const TileShape& s = kTiles[t];
    const long long blocks = static_cast<long long>(cdiv(H, s.th)) *
                             cdiv(W, s.tw) * cdiv(Co, s.tco) * B;
    if (blocks >= kSMs) return t;
  }
  return 2;
}

template <int TH, int TW, int TCO, int KS, int MINB>
cudaError_t launch(const F32Args& a, int B, int n_tiles, cudaStream_t s) {
  using G = Tile<TH, TW, TCO, KS>;
  auto kernel = fused_conv_f32_kernel<TH, TW, TCO, KS, MINB>;
  static bool opted_in = false;   // per instantiation
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(G::smem_bytes(kMaxC)));
    if (err != cudaSuccess) return err;
    // all of the SM's L1 / shared split as shared memory: room for two
    // blocks of the 128- and 64-wide tiles (~100 KB each) per SM
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  dim3 grid(n_tiles, cdiv(a.Co, TCO), B);
  kernel<<<grid, G::THREADS, G::smem_bytes(a.C1 + a.C2), s>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fdsr

extern "C" {

int fdsr_fused_conv_max_channels() { return fdsr::kMaxC; }

// output tiles per image of the tile that fdsr_fused_gn_swish_conv3x3 takes
// for this call (the partial statistics' second dimension)
int fdsr_fused_conv_tiles(int B, int H, int W, int Co) {
  const fdsr::TileShape& s = fdsr::kTiles[fdsr::choose_tile(B, H, W, Co)];
  return fdsr::cdiv(H, s.th) * fdsr::cdiv(W, s.tw);
}

// The float32 K3; every tensor is float32. x1: (B,H,W,C1), x2: (B,H,W,C2)
// or null with C2 = 0. stats1: (B,2,C1), stats2: (B,2,C2) channel sums of
// x1 and x2, gamma, beta: (C1+C2,), all read only when apply_norm; C1 + C2
// <= fdsr_fused_conv_max_channels(). w: (3,3,C1+C2,Co) HWIO. conv_b: (Co,).
// shift: (B,Co) or null. res: (B,H,W,Co) or null. y: (B,H,W,Co). partial:
// (B, n_tiles, 2, Co) scratch and stats: (B,2,Co), both null when no
// statistics are wanted; n_tiles is fdsr_fused_conv_tiles(B, H, W, Co).
int fdsr_fused_gn_swish_conv3x3(const float* x1, const float* x2, int C1,
                                int C2, const float* stats1,
                                const float* stats2, const float* gamma,
                                const float* beta, int groups, float eps,
                                int apply_norm, const float* w,
                                const float* conv_b, const float* shift,
                                const float* res, float* y, float* partial,
                                float* stats, int B, int H, int W, int Co,
                                void* stream) {
  if (C1 + C2 > fdsr::kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  const int t = fdsr::choose_tile(B, H, W, Co);
  const fdsr::TileShape& ts = fdsr::kTiles[t];
  const int n_tiles = fdsr::cdiv(H, ts.th) * fdsr::cdiv(W, ts.tw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fdsr::F32Args a;
  a.x1 = x1;
  a.x2 = x2;
  a.C1 = C1;
  a.C2 = C2;
  a.st1 = stats1;
  a.st2 = stats2;
  a.gamma = gamma;
  a.beta = beta;
  a.groups = groups;
  a.eps = eps;
  a.apply_norm = apply_norm;
  a.w = w;
  a.conv_b = conv_b;
  a.shift = shift;
  a.res = res;
  a.y = y;
  a.partial = partial;
  a.H = H;
  a.W = W;
  a.Co = Co;
  a.tiles_w = fdsr::cdiv(W, ts.tw);
  auto aligned16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  a.vec_in = C1 % 4 == 0 && C2 % 4 == 0 && aligned16(x1) && aligned16(x2);
  a.vec_w = Co % 4 == 0 && aligned16(w);
  a.vec_out = Co % 4 == 0 && aligned16(y) && aligned16(res);
  cudaError_t err;
  switch (t) {
    case 0: err = fdsr::launch<8, 16, 128, 1, 2>(a, B, n_tiles, s); break;
    case 1: err = fdsr::launch<16, 16, 64, 1, 2>(a, B, n_tiles, s); break;
    case 2: err = fdsr::launch<8, 8, 64, 4, 2>(a, B, n_tiles, s); break;
    default: err = fdsr::launch<16, 32, 8, 1, 8>(a, B, n_tiles, s); break;
  }
  if (err != cudaSuccess || partial == nullptr) return static_cast<int>(err);
  fdsr::launch_reduce_partials(partial, stats, B, n_tiles, Co, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
