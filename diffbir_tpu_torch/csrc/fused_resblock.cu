// Fused ResBlock for Hopper (sm_90a), NCHW, bf16 or fp32, float or int8 conv weights:
//   out = skip(x) + conv2(SiLU(GN2(h1))) + b2,  h1 = conv1(SiLU(GN1(x))) + b1 + e.
//
// Replaces the Pallas TPU kernel diffbir_tpu/ops/fused_resblock.py::_kernel
// (launched by _pallas_fused_resblock), with its rounding points:
//   - GroupNorm statistics in fp32, two-pass per channel (mean, then the
//     centred second moment), folded to groups (var_g = mean_c(var_c +
//     (mu_c - mu_g)^2)); the affine a = rsqrt(var_g + eps) * scale,
//     b = bias - mu_g * a, both cast to the input dtype;
//   - x * a and then + b, each rounded to the input dtype; SiLU in fp32 on
//     that value, rounded back; the conv's zero padding is applied after;
//   - each conv accumulates in fp32; int8 weights enter as their exact
//     values and the per-output-channel scale multiplies the accumulator once;
//     then + bias, + the timestep embedding e (conv1) in fp32;
//   - h1 rounded to the input dtype before GN2's statistics;
//   - the skip in fp32 (x itself, or a 1x1 conv with its own sum, its own
//     scale and its bias); one final cast of skip + h2.
//
// Two entries (ops/fused_resblock.py::resblock_entries picks by dtype):
//
// fused_resblock_tc, bf16 (every serving site), on the tensor cores. The
// TPU kernel holds one whole image in VMEM (up to 100 MB); an H100 has no
// such memory, and GroupNorm needs the whole image's statistics before a
// conv can start (a reduction across blocks), so one call is a chain of
// launches on the caller's stream, with no atomics (a result is the same
// from run to run):
//   1. GN1: gn_stats (a warp per (image, channel): the two-pass moments),
//      then gn_apply (a block per 64 pixels x 64 channels: the group fold,
//      the affine, SiLU) writes y1 = SiLU(GN1(x)) once per element, in bf16
//      and NHWC, through a shared-memory transpose; with a 1x1 skip conv it
//      writes x in NHWC beside it (xt);
//   2. conv 1 (+ a reduce launch when its K is split): h1;
//   3. GN2 on h1, as 1;
//   4. conv 2 (+ reduce): out = skip + conv2 + b2.
// Each conv is an implicit GEMM, M = B*H*W pixels, N = Cout, K = 9 taps x
// Cs channels (+ Cin for the skip segment), on the main loop of
// wgmma_gemm.cuh with 128 x 128 tiles and 64-deep stages ordered by
// 64-channel slice, then tap. Where the trouble is, and what was chosen:
//   - The A operand is made, not copied: GN + SiLU is applied once per
//     element by the GN pass (not per tap and per output tile, as the
//     CUDA-core entry does), and written NHWC, so a [pixels x channels]
//     tile is K-major and every pixel row of a stage is 128 contiguous
//     bytes. The cost is one bf16 write and nine L2 reads of y per
//     element, against a transposing pass inside each conv block.
//   - Taps are shifted windows: a tap's A stage is the M tile's pixel rows
//     shifted by (dy, dx), each copied by cp.async from its own address
//     (16-byte aligned whatever the shift, as rows are whole pixels), zero
//     past the image edge (the zero padding after SiLU) and past M.
//   - B: the int8 weights in their HWIO layout are, per tap, an MN-major
//     [Cs, Cout] int8 matrix: K4's B loader (bytes by cp.async, dequantised
//     by the warps into the swizzled bf16 tile). The float OIHW weights (stride 9 along Cin) are
//     repacked once to HWIO bf16 (ops/fused_resblock.py::tap_major, kept by
//     the ResBlock module per weight version) and copied as they are.
//   - Small grids with long K (the 16^2 and 8^2 sites: 40 and 10 tiles, K
//     up to 9 x 2560): the 3x3's stages are split into parts of at least
//     18 stages (ops/fused_resblock.py::resblock_splits, ~one block per SM)
//     whose fp32 partial sums go to a scratch [parts, Cout, M]; a reduce
//     launch adds them in part order and does the epilogue. Unsplit, the
//     conv's epilogue is in the kernel.
//   - The skip conv is a part of its own (the last along the grid's z), so
//     its sum keeps its own scale in the int8 mode: no second accumulator.
//   - The epilogue writes NCHW: the accumulator tile goes through shared
//     memory transposed ([channel][pixel] fp32, rows 16 bytes longer), so
//     the stores (or the partial sums) run along pixels.
// What bounds it on an H100: 2 B H W Cout (9 Cin + 9 Cout [+ Cin]) flops
// against the bf16 tensor-core peak (0.0305 ms at (320, 320, 64^2), batch
// 2); the GN passes and y's round trip are bytes on top.
//
// fused_resblock, fp32 and bf16, on the CUDA cores: the first version, kept
// for fp32 (the JAX kernel's fp32 products are fp32, which the bf16 tensor
// cores do not give) and as the yardstick the tensor-core entry is timed
// beside; no serving path launches it. Four launches: gn_affine (one block
// per (image, group): the moments and the fold into a, b), conv 1 (an
// implicit GEMM on the 64 x 64 fp32-FMA tile of tile_gemm.cuh whose A loads
// apply GN1 + SiLU for every tap and 64-channel output tile), gn_affine on
// h1, conv 2 with the 1x1 skip conv as a second K segment into its own
// accumulator. It reads the float OIHW and the int8 HWIO weights in place.

#include <algorithm>
#include <atomic>

#include "tile_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using tile::BK;
using tile::BM;
using tile::BN;
using tile::NT;

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();  // red is free again
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) s += red[w];
  return s;
}

constexpr int kMaxGroupChannels = 256;

// One block per (image, group): per-channel mean and centred second moment
// over H*W, then the group fold; writes a, b [B, C] in fp32.
template <typename T>
__global__ void __launch_bounds__(NT) gn_affine_kernel(
    const T* __restrict__ src, const float* __restrict__ gamma, const float* __restrict__ beta,
    float* __restrict__ a_out, float* __restrict__ b_out, int C, int HW, int groups,
    float eps) {
  __shared__ float red[NT / 32];
  __shared__ float mean_c[kMaxGroupChannels];
  __shared__ float var_c[kMaxGroupChannels];
  const int b = blockIdx.x / groups, g = blockIdx.x % groups;
  const int cg = C / groups;
  for (int j = 0; j < cg; ++j) {
    const T* row = src + ((int64_t)b * C + g * cg + j) * HW;
    float s = 0.f;
    for (int i = threadIdx.x; i < HW; i += NT) s += tile::to_f32<T>(row[i]);
    const float mu = block_sum(s, red) / HW;
    float q = 0.f;
    for (int i = threadIdx.x; i < HW; i += NT) {
      const float dv = tile::to_f32<T>(row[i]) - mu;
      q += dv * dv;
    }
    const float var = block_sum(q, red) / HW;
    if (threadIdx.x == 0) {
      mean_c[j] = mu;
      var_c[j] = var;
    }
  }
  __syncthreads();
  float mg = 0.f;
  for (int j = 0; j < cg; ++j) mg += mean_c[j];
  mg /= cg;
  float vg = 0.f;
  for (int j = 0; j < cg; ++j) {
    const float dm = mean_c[j] - mg;
    vg += var_c[j] + dm * dm;
  }
  vg /= cg;
  const float inv = rsqrtf(vg + eps);
  for (int j = threadIdx.x; j < cg; j += NT) {
    const int c = g * cg + j;
    const float a = inv * gamma[c];
    a_out[(int64_t)b * C + c] = a;
    b_out[(int64_t)b * C + c] = beta[c] - mg * a;
  }
}

// weight (co, ci, tap) of a conv with `taps` taps: int8 HWIO
// [taps][Cs][Cout], or float OIHW [Cout][Cs][taps]
template <typename WT, bool QUANT>
__device__ __forceinline__ float wload(const WT* __restrict__ w, int co, int ci, int tap,
                                       int Cs, int Cout, int taps) {
  if (QUANT) return tile::to_f32<WT>(w[((int64_t)tap * Cs + ci) * Cout + co]);
  return tile::to_f32<WT>(w[((int64_t)co * Cs + ci) * taps + tap]);
}

// bs[kk][n] = weight (nb + n, ci0 + kk, tap), zero past Cs or Cout; the
// thread order follows the layout's contiguous axis
template <typename WT, bool QUANT>
__device__ __forceinline__ void load_weights(float (*bs)[BN], const WT* __restrict__ w, int nb,
                                             int ci0, int tap, int Cs, int Cout, int taps) {
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int e = threadIdx.x + p * NT;
    const int kk = QUANT ? e / BN : e % BK;
    const int n = QUANT ? e % BN : e / BK;
    const int ci = ci0 + kk, co = nb + n;
    bs[kk][n] = (ci < Cs && co < Cout) ? wload<WT, QUANT>(w, co, ci, tap, Cs, Cout, taps) : 0.f;
  }
}

// One block: 64 pixels x 64 output channels of one image. STAGE 1 writes
// h1 = conv(SiLU(GN(src))) [* scale] + bias + e; STAGE 2 writes
// skip + conv(SiLU(GN(src))) [* scale] + bias, with skip = x (SKIP false) or
// the 1x1 conv of x [* its scale] + its bias (SKIP true).
template <typename T, bool QUANT, int STAGE, bool SKIP>
__global__ void __launch_bounds__(NT) conv_kernel(
    const T* __restrict__ src, const float* __restrict__ ga, const float* __restrict__ gb,
    const typename std::conditional<QUANT, int8_t, T>::type* __restrict__ w,
    const float* __restrict__ wscale, const T* __restrict__ bias, const T* __restrict__ e,
    const T* __restrict__ x,
    const typename std::conditional<QUANT, int8_t, T>::type* __restrict__ wsk,
    const float* __restrict__ ssk, const T* __restrict__ bsk, T* __restrict__ out, int Cs,
    int Cx, int Cout, int H, int W) {
  using WT = typename std::conditional<QUANT, int8_t, T>::type;
  __shared__ __align__(16) float as[BK][BM];
  __shared__ __align__(16) float bs[BK][BN];
  const int tid = threadIdx.x;
  const int tm = tid % 16, tn = tid / 16;  // 4 pixels x 4 channels each
  const int HW = H * W;
  const int mb = blockIdx.x * BM, nb = blockIdx.y * BN, b = blockIdx.z;
  // the pixel this thread loads for the A slices
  const int m_ld = mb + tid % BM;
  const int h_ld = m_ld / W, w_ld = m_ld % W;
  const T* src_b = src + (int64_t)b * Cs * HW;
  const float* ga_b = ga + (int64_t)b * Cs;
  const float* gb_b = gb + (int64_t)b * Cs;

  float acc[4][4];
  tile::zero(acc);
  for (int ci0 = 0; ci0 < Cs; ci0 += BK) {
    for (int tap = 0; tap < 9; ++tap) {
      const int hh = h_ld + tap / 3 - 1, ww = w_ld + tap % 3 - 1;
      const bool inside = m_ld < HW && hh >= 0 && hh < H && ww >= 0 && ww < W;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int kk = tid / BM + 4 * p;
        const int ci = ci0 + kk;
        float y = 0.f;  // the conv pads SiLU(GN(src)) with zeros
        if (inside && ci < Cs) {
          const float v = tile::to_f32<T>(src_b[(int64_t)ci * HW + hh * W + ww]);
          const float av = tile::round_to<T>(ga_b[ci]), bv = tile::round_to<T>(gb_b[ci]);
          const float t = tile::round_to<T>(tile::round_to<T>(v * av) + bv);
          y = tile::round_to<T>(t * (1.f / (1.f + expf(-t))));
        }
        as[kk][tid % BM] = y;
      }
      load_weights<WT, QUANT>(bs, w, nb, ci0, tap, Cs, Cout, 9);
      __syncthreads();
      tile::fma_tile(as, bs, tm * 4, tn * 4, acc);
      __syncthreads();
    }
  }

  float acc_s[4][4];  // the 1x1 skip conv: its own accumulator and scale
  tile::zero(acc_s);
  if (STAGE == 2 && SKIP) {
    const T* x_b = x + (int64_t)b * Cx * HW;
    for (int ci0 = 0; ci0 < Cx; ci0 += BK) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int kk = tid / BM + 4 * p;
        const int ci = ci0 + kk;
        as[kk][tid % BM] =
            (m_ld < HW && ci < Cx) ? tile::to_f32<T>(x_b[(int64_t)ci * HW + m_ld]) : 0.f;
      }
      load_weights<WT, QUANT>(bs, wsk, nb, ci0, 0, Cx, Cout, 1);
      __syncthreads();
      tile::fma_tile(as, bs, tm * 4, tn * 4, acc_s);
      __syncthreads();
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = nb + tn * 4 + j;
    if (co >= Cout) continue;
    const float sc = QUANT ? wscale[co] : 1.f;
    const float bi = tile::to_f32<T>(bias[co]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = mb + tm * 4 + i;
      if (m >= HW) continue;
      const int64_t o = ((int64_t)b * Cout + co) * HW + m;
      const float hconv = (QUANT ? acc[i][j] * sc : acc[i][j]) + bi;
      if (STAGE == 1) {
        out[o] = tile::from_f32<T>(hconv + tile::to_f32<T>(e[(int64_t)b * Cout + co]));
      } else {
        float skip;
        if (SKIP) {
          const float ss = QUANT ? acc_s[i][j] * ssk[co] : acc_s[i][j];
          skip = ss + tile::to_f32<T>(bsk[co]);
        } else {
          skip = tile::to_f32<T>(x[o]);  // Cx == Cout
        }
        out[o] = tile::from_f32<T>(skip + hconv);
      }
    }
  }
}

struct Args {
  const void *x, *e, *gn1_s, *gn1_b, *w1, *s1, *b1, *gn2_s, *gn2_b, *w2, *s2, *b2, *wsk, *ssk,
      *bsk;
  void *h1, *stats, *out;
  int B, Cin, Cout, H, W, groups;
  float eps;
};

template <typename T, bool QUANT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using WT = typename std::conditional<QUANT, int8_t, T>::type;
  const int HW = a.H * a.W;
  float* st = static_cast<float*>(a.stats);
  float *a1 = st, *c1 = a1 + a.B * a.Cin, *a2 = c1 + a.B * a.Cin, *c2 = a2 + a.B * a.Cout;
  const T* x = static_cast<const T*>(a.x);
  T* h1 = static_cast<T*>(a.h1);
  const dim3 grid((HW + BM - 1) / BM, (a.Cout + BN - 1) / BN, a.B);

  gn_affine_kernel<T><<<a.B * a.groups, NT, 0, stream>>>(
      x, static_cast<const float*>(a.gn1_s), static_cast<const float*>(a.gn1_b), a1, c1, a.Cin,
      HW, a.groups, a.eps);
  conv_kernel<T, QUANT, 1, false><<<grid, NT, 0, stream>>>(
      x, a1, c1, static_cast<const WT*>(a.w1), static_cast<const float*>(a.s1),
      static_cast<const T*>(a.b1), static_cast<const T*>(a.e), nullptr, nullptr, nullptr,
      nullptr, h1, a.Cin, 0, a.Cout, a.H, a.W);
  gn_affine_kernel<T><<<a.B * a.groups, NT, 0, stream>>>(
      h1, static_cast<const float*>(a.gn2_s), static_cast<const float*>(a.gn2_b), a2, c2, a.Cout,
      HW, a.groups, a.eps);
  if (a.wsk != nullptr) {
    conv_kernel<T, QUANT, 2, true><<<grid, NT, 0, stream>>>(
        h1, a2, c2, static_cast<const WT*>(a.w2), static_cast<const float*>(a.s2),
        static_cast<const T*>(a.b2), nullptr, x, static_cast<const WT*>(a.wsk),
        static_cast<const float*>(a.ssk), static_cast<const T*>(a.bsk), static_cast<T*>(a.out),
        a.Cout, a.Cin, a.Cout, a.H, a.W);
  } else {
    conv_kernel<T, QUANT, 2, false><<<grid, NT, 0, stream>>>(
        h1, a2, c2, static_cast<const WT*>(a.w2), static_cast<const float*>(a.s2),
        static_cast<const T*>(a.b2), nullptr, x, nullptr, nullptr, nullptr,
        static_cast<T*>(a.out), a.Cout, a.Cin, a.Cout, a.H, a.W);
  }
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// ---------------------------------------------------------------------------
// tensor-core entry (bf16): GN + SiLU once per element, implicit GEMM on wgmma
// ---------------------------------------------------------------------------
namespace tc {

using namespace wgmma_gemm;
using wgmma_gemm::BK;  // not tile_gemm.cuh's, which the names above bring in
using wgmma_gemm::BM;
using wgmma_gemm::NT;

constexpr int NP = 2;  // 64-column panels of the tile
constexpr int BN = NP * 64;
constexpr int GN_TILE = 64;  // pixels and channels of a GroupNorm-apply block
constexpr int GN_PITCH = GN_TILE + 2;  // bf16 per staged pixel row
constexpr int kMaxTcGroupChannels = 128;

// Per-channel moments of a bf16 NCHW src [B, C, HW], a warp per (image,
// channel), two passes (the mean, then the centred second moment): fp32
// mean and var [B * C].
__global__ void __launch_bounds__(256) gn_stats_kernel(const bf16* __restrict__ src,
                                                       float* __restrict__ mean,
                                                       float* __restrict__ var, int BC, int HW) {
  const int lane = threadIdx.x % 32;
  const int bc = blockIdx.x * 8 + threadIdx.x / 32;
  if (bc >= BC) return;
  const bf16* row = src + static_cast<int64_t>(bc) * HW;
  const bool vec = HW % 8 == 0;  // rows of whole 16-byte chunks (src 16-byte aligned)
  float s = 0.f;
  if (vec) {
    for (int i = 8 * lane; i < HW; i += 256) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + i);
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int q = 0; q < 8; ++q) s += __bfloat162float(e[q]);
    }
  } else {
    for (int i = lane; i < HW; i += 32) s += __bfloat162float(row[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const float mu = s / HW;
  float q2 = 0.f;
  if (vec) {
    for (int i = 8 * lane; i < HW; i += 256) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + i);
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float dv = __bfloat162float(e[q]) - mu;
        q2 += dv * dv;
      }
    }
  } else {
    for (int i = lane; i < HW; i += 32) {
      const float dv = __bfloat162float(row[i]) - mu;
      q2 += dv * dv;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) q2 += __shfl_xor_sync(0xffffffffu, q2, off);
  if (lane == 0) {
    mean[bc] = mu;
    var[bc] = q2 / HW;
  }
}

// One block per (64 pixels, 64 channels, image) of a bf16 NCHW src [B, C,
// HW]: the group fold of each channel's group from the moments (in channel
// order), the affine a, b rounded to bf16, then y = SiLU(bf16(bf16(src * a)
// + b)) rounded to bf16 into the NHWC y [B, HW, C] (and, with xt, src itself
// into the NHWC xt, the skip conv's operand), through a shared-memory
// transpose: reads run along pixels, writes 16 bytes along channels.
__global__ void __launch_bounds__(256) gn_apply_kernel(
    const bf16* __restrict__ src, const float* __restrict__ mean,
    const float* __restrict__ var, const float* __restrict__ gamma,
    const float* __restrict__ beta, bf16* __restrict__ y, bf16* __restrict__ xt, int C, int HW,
    int groups, float eps) {
  __shared__ float a_c[GN_TILE], b_c[GN_TILE];
  __shared__ __align__(16) unsigned short ty[GN_TILE * GN_PITCH], tx[GN_TILE * GN_PITCH];
  const int p0 = blockIdx.x * GN_TILE, c0 = blockIdx.y * GN_TILE, b = blockIdx.z;
  const int tid = threadIdx.x;
  if (tid < GN_TILE && c0 + tid < C) {
    const int c = c0 + tid, cg = C / groups;
    const float* mc = mean + static_cast<int64_t>(b) * C + (c / cg) * cg;
    const float* vc = var + static_cast<int64_t>(b) * C + (c / cg) * cg;
    float mg = 0.f;
    for (int j = 0; j < cg; ++j) mg += mc[j];
    mg /= cg;
    float vg = 0.f;
    for (int j = 0; j < cg; ++j) {
      const float dm = mc[j] - mg;
      vg += vc[j] + dm * dm;
    }
    vg /= cg;
    const float av = rsqrtf(vg + eps) * gamma[c];
    a_c[tid] = tile::round_to<bf16>(av);
    b_c[tid] = tile::round_to<bf16>(beta[c] - mg * av);
  }
  __syncthreads();
  const bf16* base = src + (static_cast<int64_t>(b) * C + c0) * HW + p0;
  const bool vec = HW % 8 == 0;
  for (int i = tid; i < GN_TILE * GN_TILE / 8; i += 256) {
    const int cc = i / 8, q = i % 8;  // channel c0 + cc, pixels p0 + 8q ...
    if (c0 + cc >= C) continue;
    unsigned short v[8];
    const bf16* g = base + static_cast<int64_t>(cc) * HW + 8 * q;
    if (vec && p0 + 8 * q + 8 <= HW) {
      const uint4 u = *reinterpret_cast<const uint4*>(g);
      const unsigned short* e = reinterpret_cast<const unsigned short*>(&u);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = e[k];
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = p0 + 8 * q + k < HW ? __bfloat16_as_ushort(g[k]) : 0;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float t = tile::round_to<bf16>(
          tile::round_to<bf16>(__bfloat162float(__ushort_as_bfloat16(v[k])) * a_c[cc]) + b_c[cc]);
      ty[(8 * q + k) * GN_PITCH + cc] =
          __bfloat16_as_ushort(__float2bfloat16(t * (1.f / (1.f + expf(-t)))));
      tx[(8 * q + k) * GN_PITCH + cc] = v[k];
    }
  }
  __syncthreads();
  for (int i = tid; i < GN_TILE * GN_TILE / 8; i += 256) {
    const int pp = i / 8, k = i % 8;  // pixel p0 + pp, channels c0 + 8k ...
    if (p0 + pp >= HW || c0 + 8 * k >= C) continue;
    const int64_t o = (static_cast<int64_t>(b) * HW + p0 + pp) * C + c0 + 8 * k;
    const uint32_t* ry = reinterpret_cast<const uint32_t*>(ty + pp * GN_PITCH + 8 * k);
    *reinterpret_cast<uint4*>(y + o) = make_uint4(ry[0], ry[1], ry[2], ry[3]);
    if (xt != nullptr) {
      const uint32_t* rx = reinterpret_cast<const uint32_t*>(tx + pp * GN_PITCH + 8 * k);
      *reinterpret_cast<uint4*>(xt + o) = make_uint4(rx[0], rx[1], rx[2], rx[3]);
    }
  }
}

// One conv of a call, as an implicit GEMM C[M = B*H*W pixels, N = Cout] =
// A[M, K] . B[K, N] over the 3x3 taps (K = 9 x Cs, ordered by 64-channel
// slice, then tap) or the skip's 1x1 (K = Cx).
struct Conv {
  const bf16* y;     // the 3x3's operand, NHWC [B, H, W, Cs]
  const void* w;     // HWIO [3, 3, Cs, Cout], bf16 or int8
  const bf16* xt;    // the skip conv's operand, NHWC [B, H, W, Cx] (or null)
  const void* wsk;   // its weight [Cx, Cout] (or null)
  // epilogue: out = (acc [* scale]) + bias (+ e: conv 1), or skip + that
  // (conv 2) with skip = x (NCHW) or (its sum [* ssk]) + bsk
  const float* scale;
  const bf16* bias;
  const bf16* e;
  const bf16* x;
  const float* ssk;
  const bf16* bsk;
  float* part;  // [splits (+ 1), Cout, Mp] partial sums, or null (one K range, no skip conv)
  bf16* out;    // NCHW [B, Cout, H, W]
  int B, H, W, Cs, Cx, Cout, splits, stage;
};

// the output at flat pixel m (image b, pixel p) and channel co from the
// 3x3 sum v and the skip conv's sum vs
template <bool QUANT>
__device__ __forceinline__ float finish(const Conv& a, float v, float vs, int b, int co,
                                        int64_t o) {
  const float h = (QUANT ? v * a.scale[co] : v) + __bfloat162float(a.bias[co]);
  if (a.stage == 1) return h + __bfloat162float(a.e[static_cast<int64_t>(b) * a.Cout + co]);
  const float skip = a.wsk != nullptr
                         ? (QUANT ? vs * a.ssk[co] : vs) + __bfloat162float(a.bsk[co])
                         : __bfloat162float(a.x[o]);
  return skip + h;
}

// out at channel co and flat pixels m .. m + 3 (those below M) from the
// sums v (and the skip conv's vs): one 8-byte store when the four are in one
// image (HW % 4 == 0: m is a multiple of 4), else one store each
template <bool QUANT>
__device__ __forceinline__ void store4(const Conv& a, int co, int m, int M, const float* v,
                                       const float* vs) {
  const int HW = a.H * a.W;
  if (HW % 4 == 0 && m + 4 <= M) {
    const int b = m / HW;
    const int64_t o = (static_cast<int64_t>(b) * a.Cout + co) * HW + m % HW;
    float r[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) r[e] = finish<QUANT>(a, v[e], vs[e], b, co, o + e);
    *reinterpret_cast<uint2*>(a.out + o) = make_uint2(pack_bf16(r[0], r[1]), pack_bf16(r[2], r[3]));
    return;
  }
  for (int e = 0; e < 4 && m + e < M; ++e) {
    const int b = (m + e) / HW;
    const int64_t o = (static_cast<int64_t>(b) * a.Cout + co) * HW + (m + e) % HW;
    a.out[o] = __float2bfloat16(finish<QUANT>(a, v[e], vs[e], b, co, o));
  }
}

// Ring slots: A [BM][BK], then B (float: [BK][BN] bf16 MN-major; int8: BK
// rows of BN bytes, dequantised as K4's into the bf16 tile after the ring);
// the ring then holds the transposed fp32 output tile [BN][BM + 4].
template <bool QUANT>
struct Layout {
  static constexpr uint32_t B_BYTES = QUANT ? BK * BN : BK * BN * 2;
  static constexpr uint32_t STAGE = A_BYTES + B_BYTES;
  static constexpr int SMEM = 1024 + STAGES * STAGE + (QUANT ? BK * BN * 2 : 0);
  static constexpr int PITCH = BM + 4;  // fp32 per staged row: distinct banks per warp
  static_assert(STAGE % 1024 == 0, "slots must keep the swizzle's alignment");
  static_assert(BN * PITCH * 4 <= STAGES * STAGE, "the output tile must fit the ring");
};

// Grid (M tiles, Cout tiles, splits [+ 1]): block z < splits runs its range
// of the 3x3's stages, z == splits the skip conv's; with one block along z
// the epilogue writes out, else the partial sums go to part (the reduce
// launch finishes).
template <bool QUANT>
__global__ void __launch_bounds__(NT, 2) conv_tc_kernel(const Conv a) {
  using WT = typename std::conditional<QUANT, int8_t, bf16>::type;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  uint8_t* const ring_g = smem_raw + (ring - raw);
  const uint32_t bbuf = ring + STAGES * Layout<QUANT>::STAGE;
  const int tid = threadIdx.x;
  const int HW = a.H * a.W, M = a.B * HW;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, z = blockIdx.z;

  // this block's K range: stages [t0, t0 + nt) of the 3x3 (64-channel slice
  // g / 9, tap g % 9) or of the skip conv (slice g)
  const bool skip = z == a.splits;
  const int Ca = skip ? a.Cx : a.Cs;
  const int taps = skip ? 1 : 9;
  const bf16* asrc = skip ? a.xt : a.y;
  const WT* wsrc = static_cast<const WT*>(skip ? a.wsk : a.w);
  const int total = taps * ((Ca + BK - 1) / BK);
  const int per = skip ? total : (total + a.splits - 1) / a.splits;
  const int t0 = skip ? 0 : z * per;
  const int nt = min(per, total - t0);

  // the 4 A rows this thread copies (rows tid / 8 + 32 n, chunk tid % 8):
  // their pixel (-1 past M) and its row and column
  constexpr int AROWS = BM * (BK / 8) / NT;
  const int ac = tid % 8;
  int pix[AROWS], ph[AROWS], pw[AROWS];
#pragma unroll
  for (int n = 0; n < AROWS; ++n) {
    const int m = m0 + tid / 8 + 32 * n;
    const int p = m % HW;
    pix[n] = m < M ? m : -1;
    ph[n] = p / a.W;
    pw[n] = p % a.W;
  }

  auto load_stage = [&](int t, uint32_t slot) {
    const int gs = t0 + t;
    const int tap = gs % taps, c0 = (gs / taps) * BK;
    const int dy = taps == 9 ? tap / 3 - 1 : 0, dx = taps == 9 ? tap % 3 - 1 : 0;
    // A: the pixels shifted by the tap, zero outside the image
    const bool cfull = c0 + 8 * ac < Ca;
#pragma unroll
    for (int n = 0; n < AROWS; ++n) {
      const int hh = ph[n] + dy, ww = pw[n] + dx;
      const bool full = cfull && pix[n] >= 0 && hh >= 0 && hh < a.H && ww >= 0 && ww < a.W;
      const bf16* g =
          full ? asrc + (static_cast<int64_t>(pix[n]) + dy * a.W + dx) * Ca + c0 + 8 * ac : asrc;
      cp_async16(slot + chunk_off<BM>(tid / 8 + 32 * n, ac), g, full);
    }
    // B: weight rows (tap, c0 + k), columns [n0, n0 + BN)
    const int64_t wrow0 = static_cast<int64_t>(tap) * Ca + c0;
    if constexpr (QUANT) {
      constexpr int CH = BN / 16;  // 16-byte chunks of an int8 row segment
#pragma unroll
      for (int n = 0; n < BK * CH / NT; ++n) {
        const int i = tid + n * NT;
        const int k = i / CH, c = i % CH;
        const bool full = c0 + k < Ca && n0 + 16 * c < a.Cout;
        cp_async16(slot + A_BYTES + k * BN + 16 * c,
                   full ? wsrc + (wrow0 + k) * a.Cout + n0 + 16 * c : wsrc, full);
      }
    } else {
      constexpr int CH = BN / 8;  // 16-byte chunks of a bf16 row segment
#pragma unroll
      for (int n = 0; n < BK * CH / NT; ++n) {
        const int i = tid + n * NT;
        const int k = i / CH, c = i % CH;
        const bool full = c0 + k < Ca && n0 + 8 * c < a.Cout;
        cp_async16(slot + A_BYTES + chunk_off<BK>(k, c),
                   full ? wsrc + (wrow0 + k) * a.Cout + n0 + 8 * c : wsrc, full);
      }
    }
  };
  float acc[NP][32];
#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[pn][i] = 0.f;
  if constexpr (QUANT) {
    auto stage_b = [&](uint32_t slot) {
      __syncthreads();  // every thread's copies of the stage have landed
      dequant_tile<BN>(ring_g + (slot + A_BYTES - ring), ring_g + (bbuf - ring), tid);
      fence_proxy_async();
      __syncthreads();
      return bbuf;
    };
    mainloop<NP, true>(ring, Layout<QUANT>::STAGE, nt, load_stage, stage_b, acc);
  } else {
    mainloop<NP, true>(ring, Layout<QUANT>::STAGE, nt, load_stage, StagedB{}, acc);
  }

  // the tile transposed into the ring ([channel][pixel] fp32), then each
  // thread takes 4 pixels of one channel at a time
  constexpr int PITCH = Layout<QUANT>::PITCH;
  float* st = reinterpret_cast<float*>(ring_g);
#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = acc_row(i), c = acc_col(pn, i);
      st[c * PITCH + r] = acc[pn][i];
      st[(c + 1) * PITCH + r] = acc[pn][i + 1];
    }
  __syncthreads();
  const bool final_ = gridDim.z == 1;
  const int Mp = (M + 3) / 4 * 4;
  for (int i = tid; i < BN * (BM / 4); i += NT) {
    const int c = i / (BM / 4), q = i % (BM / 4);
    const int co = n0 + c, m = m0 + 4 * q;
    if (co >= a.Cout || m >= M) continue;
    const float4 v = *reinterpret_cast<const float4*>(st + c * PITCH + 4 * q);
    if (final_) {
      const float vv[4] = {v.x, v.y, v.z, v.w}, none[4] = {0.f, 0.f, 0.f, 0.f};
      store4<QUANT>(a, co, m, M, vv, none);
    } else {  // whole float4s: the rows are Mp long
      *reinterpret_cast<float4*>(a.part + (static_cast<int64_t>(z) * a.Cout + co) * Mp + m) = v;
    }
  }
}

// out = finish(the splits' partial sums added in split order, the skip
// conv's sum): one thread per (channel, 4 pixels), pixels fastest
template <bool QUANT>
__global__ void __launch_bounds__(256) conv_reduce_kernel(const Conv a) {
  const int M = a.B * a.H * a.W, Mp = (M + 3) / 4 * 4;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= static_cast<int64_t>(a.Cout) * (Mp / 4)) return;
  const int co = static_cast<int>(i / (Mp / 4)), m = 4 * static_cast<int>(i % (Mp / 4));
  const int64_t plane = static_cast<int64_t>(a.Cout) * Mp;
  const float* pt = a.part + static_cast<int64_t>(co) * Mp + m;
  float4 v = *reinterpret_cast<const float4*>(pt);
  for (int s = 1; s < a.splits; ++s) {
    const float4 u = *reinterpret_cast<const float4*>(pt + s * plane);
    v.x += u.x;
    v.y += u.y;
    v.z += u.z;
    v.w += u.w;
  }
  const float4 w = a.wsk != nullptr ? *reinterpret_cast<const float4*>(pt + a.splits * plane)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
  const float vv[4] = {v.x, v.y, v.z, v.w}, vs[4] = {w.x, w.y, w.z, w.w};
  store4<QUANT>(a, co, m, M, vv, vs);
}

template <bool QUANT>
cudaError_t run_conv(const Conv& a, cudaStream_t stream) {
  auto kernel = conv_tc_kernel<QUANT>;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = allow_smem(kernel, Layout<QUANT>::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const int M = a.B * a.H * a.W;
  const int z = a.splits + (a.wsk != nullptr ? 1 : 0);
  const dim3 grid((M + BM - 1) / BM, (a.Cout + BN - 1) / BN, z);
  kernel<<<grid, NT, Layout<QUANT>::SMEM, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || z == 1) return err;
  const int64_t n = static_cast<int64_t>(a.Cout) * ((M + 3) / 4);
  conv_reduce_kernel<QUANT><<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(a);
  return cudaGetLastError();
}

// the 3x3's stages split into `splits` non-empty ranges of equal length
// (the last may be shorter)
bool whole_splits(int Cs, int splits) {
  const int total = 9 * ((Cs + BK - 1) / BK);
  if (splits < 1 || splits > total) return false;
  const int per = (total + splits - 1) / splits;
  return (total + per - 1) / per == splits;
}

}  // namespace tc

}  // namespace

extern "C" {

// x: contiguous [B, Cin, H, W]; e: [B, Cout]; out, h1 (scratch): contiguous
// [B, Cout, H, W]; all in one dtype (0 fp32, 1 bf16), as are the biases b1,
// b2, b_skip [Cout]. gn*_s, gn*_b: fp32 [Cin] / [Cout]. stats: fp32 scratch
// of 2 B (Cin + Cout). Weights: quant = 0: w1 [Cout, Cin, 3, 3], w2
// [Cout, Cout, 3, 3], w_skip [Cout, Cin, 1, 1] in the dtype (OIHW); quant =
// 1: int8 w1 [3, 3, Cin, Cout], w2 [3, 3, Cout, Cout], w_skip [1, 1, Cin,
// Cout] (HWIO) with fp32 scales s1, s2, s_skip [Cout]. A null w_skip is the
// identity skip (Cin == Cout). Channels divide into `groups` of at most 256.
// Returns a cudaError_t (0 on success); the four launches are asynchronous.
int fused_resblock(const void* x, const void* e, const void* gn1_s, const void* gn1_b,
                   const void* w1, const void* s1, const void* b1, const void* gn2_s,
                   const void* gn2_b, const void* w2, const void* s2, const void* b2,
                   const void* w_skip, const void* s_skip, const void* b_skip, void* h1,
                   void* stats, void* out, int dtype, int quant, int B, int Cin, int Cout,
                   int H, int W, int groups, float eps, void* stream) {
  if (B <= 0 || Cin <= 0 || Cout <= 0 || H <= 0 || W <= 0 || groups <= 0 || Cin % groups ||
      Cout % groups || Cin / groups > kMaxGroupChannels ||
      Cout / groups > kMaxGroupChannels || (w_skip == nullptr && Cin != Cout))
    return cudaErrorInvalidValue;
  const Args a{x, e, gn1_s, gn1_b, w1, s1, b1, gn2_s, gn2_b, w2, s2, b2, w_skip, s_skip,
               b_skip, h1, stats, out, B, Cin, Cout, H, W, groups, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0 && !quant) err = launch<float, false>(a, s);
  else if (dtype == 0) err = launch<float, true>(a, s);
  else if (dtype == 1 && !quant) err = launch<__nv_bfloat16, false>(a, s);
  else if (dtype == 1) err = launch<__nv_bfloat16, true>(a, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The tensor-core entry, bf16 only: x [B, Cin, H, W], e [B, Cout], out
// and h1 (scratch) [B, Cout, H, W], biases [Cout] in bf16, all contiguous
// and 16-byte aligned; gn* fp32 as above. Weights HWIO: quant = 0 bf16 w1
// [3, 3, Cin, Cout], w2 [3, 3, Cout, Cout], w_skip [1, 1, Cin, Cout] (the
// float mode's OIHW weights repacked once, ops/fused_resblock.py); quant = 1
// the int8 ones with their fp32 scales. Scratch: stats, fp32 [2, B,
// max(Cin, Cout)]; y, bf16 [B, H, W, max(Cin, Cout)]; xt, bf16 [B, H, W,
// Cin] (with w_skip, else null); part, fp32 [max(splits1, splits2 + (w_skip
// != null)), Cout, Mp] with Mp = B H W rounded up to 4 (null when that is
// 1). splits1/2: the parts of conv 1's / conv 2's 3x3 K range (9 taps x
// 64-channel slices), each part non-empty. Cin % 8, Cout % 16 == 0; at most
// 128 channels a group. Returns a cudaError_t (0 on success); the launches
// (GN statistics, GN apply, conv 1 [+ reduce], the same for conv 2) are
// asynchronous.
int fused_resblock_tc(const void* x, const void* e, const void* gn1_s, const void* gn1_b,
                      const void* w1, const void* s1, const void* b1, const void* gn2_s,
                      const void* gn2_b, const void* w2, const void* s2, const void* b2,
                      const void* w_skip, const void* s_skip, const void* b_skip, void* h1,
                      void* stats, void* y, void* xt, void* part, void* out, int quant, int B,
                      int Cin, int Cout, int H, int W, int groups, float eps, int splits1,
                      int splits2, void* stream) {
  const bool skip = w_skip != nullptr;
  if (B <= 0 || Cin <= 0 || Cout <= 0 || H <= 0 || W <= 0 || groups <= 0 || Cin % groups ||
      Cout % groups || Cin / groups > tc::kMaxTcGroupChannels ||
      Cout / groups > tc::kMaxTcGroupChannels || (!skip && Cin != Cout) || (skip && !xt) ||
      !tc::whole_splits(Cin, splits1) || !tc::whole_splits(Cout, splits2) ||
      (std::max(splits1, splits2 + (skip ? 1 : 0)) > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  if (Cin % 8 || Cout % 16 || !aligned16(x) || !aligned16(h1) || !aligned16(y) ||
      !aligned16(out) || (skip && !aligned16(xt)) || !aligned16(w1) || !aligned16(w2) ||
      (skip && !aligned16(w_skip)) || !aligned16(part))
    return cudaErrorMisalignedAddress;
  typedef __nv_bfloat16 bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int HW = H * W;
  float* mean = static_cast<float*>(stats);
  float* var = mean + B * std::max(Cin, Cout);
  // SiLU(GN(src)) into y (and src into xt), NHWC
  auto gn = [&](const void* src, const void* gs, const void* gb, void* xt_out, int C) {
    tc::gn_stats_kernel<<<(B * C + 7) / 8, 256, 0, s>>>(static_cast<const bf16*>(src), mean, var,
                                                          B * C, HW);
    const dim3 grid((HW + tc::GN_TILE - 1) / tc::GN_TILE, (C + tc::GN_TILE - 1) / tc::GN_TILE, B);
    tc::gn_apply_kernel<<<grid, 256, 0, s>>>(
        static_cast<const bf16*>(src), mean, var, static_cast<const float*>(gs),
        static_cast<const float*>(gb), static_cast<bf16*>(y), static_cast<bf16*>(xt_out), C, HW,
        groups, eps);
    return cudaGetLastError();
  };
  cudaError_t err = gn(x, gn1_s, gn1_b, xt, Cin);
  if (err != cudaSuccess) return static_cast<int>(err);
  tc::Conv c1{static_cast<const bf16*>(y), w1, nullptr, nullptr,
              static_cast<const float*>(s1), static_cast<const bf16*>(b1),
              static_cast<const bf16*>(e), nullptr, nullptr, nullptr,
              static_cast<float*>(part), static_cast<bf16*>(h1), B, H, W, Cin, 0, Cout, splits1, 1};
  err = quant ? tc::run_conv<true>(c1, s) : tc::run_conv<false>(c1, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = gn(h1, gn2_s, gn2_b, nullptr, Cout);
  if (err != cudaSuccess) return static_cast<int>(err);
  tc::Conv c2{static_cast<const bf16*>(y), w2, static_cast<const bf16*>(xt), w_skip,
              static_cast<const float*>(s2), static_cast<const bf16*>(b2), nullptr,
              static_cast<const bf16*>(x), static_cast<const float*>(s_skip),
              static_cast<const bf16*>(b_skip), static_cast<float*>(part),
              static_cast<bf16*>(out), B, H, W, Cout, Cin, Cout, splits2, 2};
  err = quant ? tc::run_conv<true>(c2, s) : tc::run_conv<false>(c2, s);
  return static_cast<int>(err);
}

}  // extern "C"
