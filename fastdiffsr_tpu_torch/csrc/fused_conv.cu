// K3 on CUDA cores: fused GroupNorm -> Swish -> 3x3 conv with a statistics
// epilogue, in IEEE float32 arithmetic. It takes the float32 maps
// (validation and the float32 checks must not pass through TF32); the
// tensor-core kernel of fused_conv_wgmma.cu takes the bfloat16 maps.
//
//   y     = conv3x3(swish(GN(x) * gamma + beta)) + b_conv
//           [+ shift[b, co]] [+ res]
//   stats = per-channel (sum y, sum y^2) over H,W of the float32
//           accumulator (res included)
//
// Replaces fastdiffsr_tpu/ops/fused_conv.py::fused_gn_swish_conv3x3, a
// Pallas kernel that built a (rows*W, 9C) im2col patch of one row band in
// VMEM and fed the MXU one K=9C product per grid step. Its
// split/chunks/phase switches only pick a TPU patch layout; this port
// keeps the math, not that schedule. The GroupNorm statistics come in as
// per-channel sums (the previous kernel's epilogue); every block collapses
// them to its image's per-channel scale = inv_std * gamma and bias = beta
// - mean * inv_std * gamma in shared memory (block_group_mean_inv in
// common.cuh). With apply_norm = 0 the prologue is the identity (stem and
// Upsample convs).
//
// Bound on the H100: operations. At the UNet's widths a call does
// 2*9*C*Co flops per pixel against (C + Co) * 4 bytes, well above
// the ridge, so the floor is flops / 67 TFLOP/s for float32 without
// tensor cores.
//
// Design (CUDA cores, float32 FMA): a block owns an output
// tile of 8 rows x 16 columns x 64 output channels of one image. It walks
// the input channels in stages of 8; each stage loads the input tile with
// a one-pixel halo into shared memory, applying the GroupNorm affine and
// swish ON LOAD, and zeroes halo positions outside the image AFTER
// normalisation (zero padding applies to the normalised map). The
// stage's 3x3x8x64 weights go to shared memory beside it. Each of the 256
// threads keeps 8 pixels x 4 output channels of float32 accumulators and
// reuses one row of 10 input values across the three column taps. Two
// input sources (the UNet's skip concat) are read as one channel concat
// without building it; the per-channel affine is computed from the channel
// sums of both, so groups that straddle the boundary are exact. Per-tile
// partial statistics go to device memory and are summed over tiles in a
// fixed order by a second pass: no float atomics.

#include "common.cuh"

namespace fdsr {
namespace {

constexpr int kTH = 8;          // output rows per block
constexpr int kTW = 16;         // output columns per block
constexpr int kTCo = 64;        // output channels per block
constexpr int kKC = 8;          // input channels per shared-memory stage
constexpr int kThreads = 256;
constexpr int kPix = 8;         // pixels per thread (one row segment)
constexpr int kCoT = 4;         // output channels per thread
constexpr int kIH = kTH + 2;
constexpr int kIW = kTW + 2;
constexpr int kPixGroups = kThreads / (kTCo / kCoT);   // 16
// channels whose scale and bias fit beside the 32 KB of static tiles in
// the 48 KB a block gets without opting in
constexpr int kMaxC = 1536;

static_assert(kPixGroups * kPix == kTH * kTW, "thread tiling covers tile");
static_assert(kTW == 2 * kPix, "two pixel groups per tile row");

__global__ void __launch_bounds__(kThreads, 2)
fused_conv_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                  int C1, int C2, const float* __restrict__ st1,
                  const float* __restrict__ st2,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta, int groups, float eps,
                  int apply_norm,
                  const float* __restrict__ w,
                  const float* __restrict__ conv_b,
                  const float* __restrict__ shift,
                  const float* __restrict__ res, float* __restrict__ y,
                  float* __restrict__ partial, int H, int W, int Co,
                  int tiles_w) {
  __shared__ float s_in[kKC][kIH][kIW];
  __shared__ __align__(16) float s_w[kKC][9][kTCo];
  __shared__ float s_red[2][kPixGroups][kTCo];
  extern __shared__ float s_aff[];   // scale[C], bias[C] when apply_norm

  const int C = C1 + C2;
  const int tile = blockIdx.x;
  const int h0 = (tile / tiles_w) * kTH;
  const int w0 = (tile % tiles_w) * kTW;
  const int co0 = blockIdx.y * kTCo;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int cg = tid % (kTCo / kCoT);   // output-channel group
  const int pg = tid / (kTCo / kCoT);   // pixel group
  const int prow = pg / 2;
  const int pcol = (pg % 2) * kPix;

  const float* sc = s_aff;
  const float* bi = s_aff + C;
  if (apply_norm) {
    const float* sums1 = st1 + (size_t)b * 2 * C1;
    const float* sums2 = C2 ? st2 + (size_t)b * 2 * C2 : nullptr;
    block_group_mean_inv(sums1, sums2, C1, C2, H * W, groups, eps, s_aff,
                         s_aff + C);
    for (int c = tid; c < C; c += kThreads) {
      const float mean = s_aff[c], inv = s_aff[C + c];
      s_aff[c] = __fmul_rn(inv, gamma[c]);
      s_aff[C + c] =
          __fsub_rn(beta[c], __fmul_rn(__fmul_rn(mean, inv), gamma[c]));
    }
  }   // the first __syncthreads of the channel loop publishes them

  float acc[kPix][kCoT];
#pragma unroll
  for (int i = 0; i < kPix; ++i)
#pragma unroll
    for (int j = 0; j < kCoT; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kKC) {
    __syncthreads();
    for (int i = tid; i < kIH * kIW * kKC; i += kThreads) {
      const int c = i % kKC;
      const int p = i / kKC;
      const int iy = p / kIW, ix = p % kIW;
      const int gh = h0 + iy - 1, gw = w0 + ix - 1, gc = c0 + c;
      float v = 0.f;
      if (gh >= 0 && gh < H && gw >= 0 && gw < W && gc < C) {
        const size_t pix = ((size_t)b * H + gh) * W + gw;
        v = gc < C1 ? x1[pix * C1 + gc] : x2[pix * C2 + (gc - C1)];
        if (apply_norm) {
          // x * scale + bias, then x * sigmoid(x), each product and sum
          // rounded on its own (no FMA contraction), as the plain version
          // computes them
          v = __fadd_rn(__fmul_rn(v, sc[gc]), bi[gc]);
          v = __fmul_rn(v, 1.f / (1.f + expf(-v)));
        }
      }
      s_in[c][iy][ix] = v;
    }
    for (int i = tid; i < 9 * kKC * kTCo; i += kThreads) {
      const int co = i % kTCo;
      const int r = i / kTCo;
      const int c = r % kKC, tap = r / kKC;
      const int gc = c0 + c, gco = co0 + co;
      s_w[c][tap][co] =
          (gc < C && gco < Co) ? w[((size_t)tap * C + gc) * Co + gco] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kKC; ++c) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float xin[kPix + 2];
#pragma unroll
        for (int i = 0; i < kPix + 2; ++i)
          xin[i] = s_in[c][prow + dy][pcol + i];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 wv = *reinterpret_cast<const float4*>(
              &s_w[c][dy * 3 + dx][cg * kCoT]);
#pragma unroll
          for (int i = 0; i < kPix; ++i) {
            const float xv = xin[i + dx];
            acc[i][0] = fmaf(xv, wv.x, acc[i][0]);
            acc[i][1] = fmaf(xv, wv.y, acc[i][1]);
            acc[i][2] = fmaf(xv, wv.z, acc[i][2]);
            acc[i][3] = fmaf(xv, wv.w, acc[i][3]);
          }
        }
      }
    }
  }

  // epilogue: bias, shift, residual, store, per-thread statistics
  const int gh = h0 + prow;
  float s1[kCoT], s2[kCoT];
  float add[kCoT];
#pragma unroll
  for (int j = 0; j < kCoT; ++j) {
    const int gco = co0 + cg * kCoT + j;
    s1[j] = 0.f;
    s2[j] = 0.f;
    add[j] = gco < Co
                 ? conv_b[gco] + (shift ? shift[(size_t)b * Co + gco] : 0.f)
                 : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int gw = w0 + pcol + i;
    if (gh >= H || gw >= W) continue;
    const size_t pix = ((size_t)b * H + gh) * W + gw;
#pragma unroll
    for (int j = 0; j < kCoT; ++j) {
      const int gco = co0 + cg * kCoT + j;
      if (gco >= Co) continue;
      float v = acc[i][j] + add[j];
      if (res) v += res[pix * Co + gco];
      y[pix * Co + gco] = v;
      s1[j] += v;
      s2[j] += v * v;
    }
  }
  if (partial == nullptr) return;
#pragma unroll
  for (int j = 0; j < kCoT; ++j) {
    s_red[0][pg][cg * kCoT + j] = s1[j];
    s_red[1][pg][cg * kCoT + j] = s2[j];
  }
  __syncthreads();
  if (tid < 2 * kTCo) {
    const int k = tid / kTCo, co = tid % kTCo;
    if (co0 + co < Co) {
      float s = 0.f;
#pragma unroll
      for (int p = 0; p < kPixGroups; ++p) s += s_red[k][p][co];
      partial[(((size_t)b * gridDim.x + tile) * 2 + k) * Co + co0 + co] = s;
    }
  }
}

}  // namespace
}  // namespace fdsr

extern "C" {

int fdsr_fused_conv_max_channels() { return fdsr::kMaxC; }

int fdsr_fused_conv_tiles(int H, int W) {
  return ((H + fdsr::kTH - 1) / fdsr::kTH) * ((W + fdsr::kTW - 1) / fdsr::kTW);
}

// The float32 K3; every tensor is float32. x1: (B,H,W,C1), x2: (B,H,W,C2)
// or null with C2 = 0. stats1: (B,2,C1), stats2: (B,2,C2) channel sums of
// x1 and x2, gamma, beta: (C1+C2,), all read only when apply_norm; C1 + C2
// <= fdsr_fused_conv_max_channels(). w: (3,3,C1+C2,Co) HWIO. conv_b: (Co,).
// shift: (B,Co) or null. res: (B,H,W,Co) or null. y: (B,H,W,Co). partial:
// (B, n_tiles, 2, Co) scratch and stats: (B,2,Co), both null when no
// statistics are wanted; n_tiles is fdsr_fused_conv_tiles(H, W).
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
  const size_t aff = apply_norm ? 2 * sizeof(float) * (C1 + C2) : 0;
  const int tiles_w = (W + fdsr::kTW - 1) / fdsr::kTW;
  const int n_tiles = fdsr_fused_conv_tiles(H, W);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(n_tiles, (Co + fdsr::kTCo - 1) / fdsr::kTCo, B);
  fdsr::fused_conv_kernel<<<grid, fdsr::kThreads, aff, s>>>(
      x1, x2, C1, C2, stats1, stats2, gamma, beta, groups, eps, apply_norm, w,
      conv_b, shift, res, y, partial, H, W, Co, tiles_w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return static_cast<int>(err);
  fdsr::launch_reduce_partials(partial, stats, B, n_tiles, Co, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
