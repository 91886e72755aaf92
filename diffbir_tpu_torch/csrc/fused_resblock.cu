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
//   - the skip in fp32 (x itself, or a 1x1 conv with its own accumulator,
//     its own scale and its bias); one final cast of skip + h2.
//
// Design (first, simple version). The TPU kernel holds one whole image in
// VMEM (up to 100 MB); an H100 has no such memory, and GroupNorm needs the
// whole image's statistics before a conv can start (a reduction across
// blocks), so one call is four launches on the caller's stream, with no
// atomics (the result is deterministic):
//   1. gn_affine: one block per (image, group) computes the per-channel
//      moments and the group fold into fp32 a, b [B, C];
//   2. conv (stage 1): an implicit GEMM (M = H*W pixels of one image,
//      N = Cout, K = 9 taps x Cin) on the tile core of tile_gemm.cuh, whose
//      A loads apply GN1 + SiLU (the prologue) and whose epilogue adds the
//      scale, b1 and e; it writes h1;
//   3. gn_affine on h1;
//   4. conv (stage 2): the same with GN2 + SiLU, then the 1x1 skip conv as a
//      second K segment into its own accumulator, and the sum.
// The K loop runs over 16-channel slices with the 9 taps inside, so the
// shifted reads of one slice and its weights hit L1. Float weights are read
// in the module's OIHW layout and int8 weights in the JAX package's HWIO
// layout, as they are stored: nothing is repacked, at load or per call.
//
// What bounds it on an H100: 2 * H*W * Cout * (9 Cin + 9 Cout [+ Cin]) flops
// per image against reading x, the weights and e and writing the output
// (plus h1's round trip); at the serving sites it is compute-bound, and
// these tiles run at the CUDA-core fp32 rate. The prologue recomputes
// GN + SiLU for every tap and every 64-channel output tile.

#include <type_traits>

#include "tile_gemm.cuh"

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

}  // extern "C"
