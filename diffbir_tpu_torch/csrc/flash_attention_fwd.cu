// Flash-attention forward for Hopper (sm_90a), bf16 or fp32, [B,S,H,D] through strides.
//
// Replaces the Pallas TPU kernel diffbir_tpu/ops/flash_attention.py::_kernel
// (launched by _flash_attention_impl). Same math: fp32 logits q.k * d^-1/2,
// online softmax with fp32 running max m, running sum l and accumulator, the
// probabilities rounded to the input dtype before the PV product (the sum l
// keeps them unrounded), kv past Skv masked, and an l == 0 guard on the final
// divide. Optionally the per-row logsumexp lse = m + log(l) (l == 0 guarded,
// as _kernel's with_lse store) for the backward kernels, fp32 [B, H, Sq]; a
// null lse pointer skips the store and nothing else changes.
//
// The same kernels are K3, the forward of the packed layout
// (_flash_attention_impl_packed -> _kernel_packed), through the entries
// flash_attention_fwd_prescaled(_tc): q is loaded as q_scale * q rounded once
// to the input dtype (bf16(q * d^-1/2)) and the logits are scaled by `scale`
// (1 there). The CUDA-core kernel's plain entry passes q_scale = 1, which
// changes no value.
//
// Three designs in one source, each with its own entry points:
// - on the tensor cores (flash_fwd_tc_kernel; entries flash_attention_fwd_tc
//   and flash_attention_fwd_prescaled_tc): bf16 at d = 64 and 128, which is
//   every self-attention site of the port's UNet, ControlNet and vision tower;
// - on the tensor cores for one wide head (flash_fwd_wide_kernel; entry
//   flash_attention_fwd_wide_tc): bf16 at d = 512, the VAE's single-head
//   mid-block attention (K1 only: the VAE never takes the packed layout);
// - on the CUDA cores (flash_fwd_kernel; entries flash_attention_fwd and
//   flash_attention_fwd_prescaled): fp32 at any d, bf16 at d = 256, and K3
//   at d = 512. The tensor cores have no fp32 mode that keeps fp32's limit
//   (TF32 rounds). No path of the port reaches these.
//
// What bounds it on an H100: at the main path's shapes (S = 4096, d = 64) the
// kernel does 4*S^2*d flops per head against q, k and v read once per block
// from L2, so it is compute-bound, and only the tensor cores (989 TFLOP/s in
// bf16, against 67 for fp32 FMAs on the CUDA cores) come near that bound.
// The S x S logits never reach device memory, which is what the plain
// version pays for.
//
// Tensor-core design (wgmma m64n64k16 bf16 with fp32 accumulators in
// registers, the tiles of wgmma_tile.cuh, as the backward's K2a):
// - A block owns 128 query rows of one (batch, head): two warpgroups of 64
//   rows each. Q is staged once; the loop runs over 64-row kv tiles loaded
//   with cp.async in two stages (the next tile in flight while the current
//   one is multiplied; rows past Skv zero-filled by the copy).
// - S = Q.K^T reads both operands from shared memory (K-major). The online
//   softmax runs on the accumulator registers: a row of the 64x64 tile spans
//   the 4 threads of a quad, so the row max takes two xor-shuffles; the
//   logits are scaled into log2 units once (exp2 with log2(e) folded into
//   d^-1/2) and kv columns past Skv are set to NEG_INF. Each thread sums its
//   own columns of l and the quad's partial sums are added once at the end.
// - p is rounded to bf16 straight from the accumulator into the A fragments
//   of O += P.V, which reads V as an MN-major B (the descriptor's transpose
//   bit); at d = 128 that product is issued per 64-column panel.
// - K3 (PRESCALE): each thread rescales its own 16-byte chunks of Q in shared
//   memory once they land, bf16(fp32(q) * q_scale), before the first wgmma.
// - At d = 64 two blocks share an SM, so one block's softmax overlaps the
//   other's products.
//
// Wide tensor-core design (d = 512, bf16; flash_fwd_wide_kernel). At the
// VAE's shapes ([1,16384,1,512]: B*H = 1) it does 4*S^2*512 flops against
// 64 MB of q, k, v and o, so it is compute-bound, and the grid's only
// parallelism is Sq / 64 query tiles (256 at 16384 tokens, 128 at 8192,
// against 132 SMs). What d = 512 changes against the d <= 128 design:
// - o's 64 x 512 fp32 accumulator is 128 KB, more than one warpgroup's
//   registers: a block owns 64 query rows, and its two warpgroups split o's
//   columns, 256 each (4 panels of 64, 128 registers a thread).
// - Both warpgroups need the whole P of a kv tile. Each computes the same
//   64 x 64 S = Q.K^T over all 512 dims (32 wgmma k-steps from shared
//   memory) and runs the same online softmax on it, so P stays in registers
//   as the A fragment of its own O += P.V, as in the d <= 128 design; the
//   price is the S product done twice (1.5x the bound's flops). Splitting
//   S's d-reduction between the warpgroups instead, the partial sums swapped
//   through shared memory, measured slower on an H100 (the swap sits
//   between S and the softmax). Both round identically, so m and l agree.
// - Shared memory: q (64 x 512 bf16, 64 KB), one 64-row tile of k and one
//   of v (64 KB each): 192 KB of the 227 KB, so one stage each, staggered:
//   the next k tile is loaded as soon as both warpgroups are done with S
//   (under the softmax and P.V), the next v tile as soon as both are done
//   with P.V (under the next S).
// - Each block reads all of k and v (from L2 after the first block), 64 KB
//   per tile for 3 x 64 x 64 x 512 MACs: the L2 rate, not the tensor
//   cores, may bind. Thread-block clusters that share a tile would halve
//   that traffic (not done). It reaches ~25 % of the bound at 16384 tokens.
//
// CUDA-core design. One block covers ROWS query rows of one (batch, head).
// Each query row belongs to G = D/32 consecutive lanes; a lane owns 32 of the
// D dims of q and of the accumulator in registers, as 8 float4 chunks
// interleaved across the G lanes (dims 4*(g + G*c) .. +3), so a warp's float4
// reads of one shared-memory row hit consecutive 16-byte words. A loop over
// kv tiles stages BK rows of k and v into shared memory as fp32; the whole
// block reads the same k/v row at the same time (broadcast). Both products
// run on the CUDA cores in fp32 FMAs: a partial dot over the lane's 32 dims
// plus a shuffle reduction over the G lanes gives one logit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "wgmma_tile.cuh"

namespace {

constexpr float kNegInf = -0.7f * 3.402823466e38f;  // as the Pallas kernel's NEG_INF

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype(bfloat16)
}

template <typename T, int D, int NT, int BK>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int H, int Sq, int Skv,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    float q_scale, float scale) {
  constexpr int G = D / 32;     // lanes per query row
  constexpr int ROWS = NT / G;  // query rows per block
  constexpr int NC = 8;         // float4 chunks per lane (32 dims)
  static_assert(D % 32 == 0 && 32 % G == 0 && NT % G == 0, "bad tile");

  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [BK][D]
  float* vs = ks + BK * D;                       // [BK][D]

  const int tid = threadIdx.x;
  const int g = tid % G;
  const int row = blockIdx.x * ROWS + tid / G;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const bool valid = row < Sq;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  float qr[NC][4];
  float acc[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dim = 4 * (g + G * c) + e;
      qr[c][e] = valid ? to_f32<T>(from_f32<T>(to_f32<T>(qb[row * q_ss + dim]) * q_scale)) : 0.f;
      acc[c][e] = 0.f;
    }
  }
  float m = kNegInf;
  float l = 0.f;

  for (int kv0 = 0; kv0 < Skv; kv0 += BK) {
    const int nk = min(BK, Skv - kv0);
    __syncthreads();  // every lane is done with the previous tile
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D;
      const int col = i % D;
      float kx = 0.f, vx = 0.f;
      if (r < nk) {
        kx = to_f32<T>(kb[(kv0 + r) * k_ss + col]);
        vx = to_f32<T>(vb[(kv0 + r) * v_ss + col]);
      }
      ks[i] = kx;
      vs[i] = vx;
    }
    __syncthreads();

    float s[BK];
    float mt = kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * D);
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 kk = kr[g + G * c];
        part = fmaf(qr[c][0], kk.x, part);
        part = fmaf(qr[c][1], kk.y, part);
        part = fmaf(qr[c][2], kk.z, part);
        part = fmaf(qr[c][3], kk.w, part);
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      s[j] = j < nk ? part * scale : kNegInf;  // mask kv past Skv
      mt = fmaxf(mt, s[j]);
    }

    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
      const float pr = to_f32<T>(from_f32<T>(p));  // P in the input dtype for PV
      const float4* vr = reinterpret_cast<const float4*>(vs + j * D);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = vr[g + G * c];
        acc[c][0] = fmaf(pr, vv.x, acc[c][0]);
        acc[c][1] = fmaf(pr, vv.y, acc[c][1]);
        acc[c][2] = fmaf(pr, vv.z, acc[c][2]);
        acc[c][3] = fmaf(pr, vv.w, acc[c][3]);
      }
    }
    m = m_new;
  }

  if (!valid) return;
  const float l_inv = l == 0.f ? 1.f : 1.f / l;
  T* ob = o + ((static_cast<int64_t>(b) * Sq + row) * H + h) * D;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) ob[4 * (g + G * c) + e] = from_f32<T>(acc[c][e] * l_inv);
  }
  if (lse != nullptr && g == 0)
    lse[(static_cast<int64_t>(b) * H + h) * Sq + row] = m + logf(l == 0.f ? 1.f : l);
}

// ---------------------------------------------------------------------------
// The tensor-core kernel (bf16, d = 64 or 128): K1, and K3 with PRESCALE
// ---------------------------------------------------------------------------
namespace tc {

using namespace wgmma_tile;

constexpr float LN2 = 0.6931471805599453f;

// (batch, seq, head) strides in elements of q, k and v, in that order.
struct Strides {
  int64_t sb[3], ss[3], sh[3];
};

// o (and lse) for 128 query rows of one (batch, head). At d = 64 two blocks
// fit an SM (<= 128 registers, 49 KB of shared memory each).
template <int D, bool PRESCALE>
__global__ void __launch_bounds__(NT, D == 64 ? 2 : 1) flash_fwd_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int H, int Sq, int Skv, Strides st,
    float q_scale, float scale) {
  constexpr int BQ = 128, BK = 64, KS = D / 16, NP = D / 64;
  constexpr uint32_t QT = BQ * D * 2, KT = BK * D * 2;  // tile bytes
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t qs = (raw + 1023) & ~1023u;
  const uint32_t kvs = qs + QT;  // stage s: k at kvs + 2*KT*s, v KT after

  const int tid = threadIdx.x;
  const int wg = tid / 128, lane = tid % 32, wrow = (tid % 128) / 32 * 16 + lane / 4;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const bf16* qb = q + b * st.sb[0] + h * st.sh[0];
  const bf16* kb = k + b * st.sb[1] + h * st.sh[1];
  const bf16* vb = v + b * st.sb[2] + h * st.sh[2];

  load_tile<BQ, D>(qs, qb, st.ss[0], q0, Sq, tid);
  cp_async_commit();
  load_tile<BK, D>(kvs, kb, st.ss[1], 0, Skv, tid);
  load_tile<BK, D>(kvs + KT, vb, st.ss[2], 0, Skv, tid);
  cp_async_commit();
  if (PRESCALE) {
    // q = bf16(fp32(q) * q_scale), each thread on the chunks it copied (the
    // chunks load_tile gave it), once they have landed; the loop's fence and
    // barrier order these writes before the first wgmma
    cp_async_wait<1>();
    constexpr int CH = D / 8;
    uint8_t* const qg = smem_raw + (qs - raw);
#pragma unroll
    for (int n = 0; n < BQ * CH / NT; ++n) {
      const int i = tid + n * NT;
      uint4* chunk = reinterpret_cast<uint4*>(qg + chunk_off<BQ>(i / CH, i % CH));
      uint4 x = *chunk;
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(e[j]);
        e[j] = __floats2bfloat162_rn(f.x * q_scale, f.y * q_scale);
      }
      *chunk = x;
    }
  }

  // running max m2 (of the logits in log2 units) and this thread's share of
  // the running sum l, for its two rows
  float acc[NP][32], s[32];
  float m2[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[pn][i] = 0.f;
  const float scale2 = scale * LOG2E;
  const int nt = (Skv + BK - 1) / BK;

  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) {  // the next kv tile into the other stage
      const uint32_t nxt = kvs + 2 * KT * ((t + 1) & 1);
      load_tile<BK, D>(nxt, kb, st.ss[1], (t + 1) * BK, Skv, tid);
      load_tile<BK, D>(nxt + KT, vb, st.ss[2], (t + 1) * BK, Skv, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies (and q) have landed
    fence_proxy_async();
    __syncthreads();
    const uint32_t ks = kvs + 2 * KT * (t & 1), vs = ks + KT;

    // S = Q.K^T (64 x 64 per warpgroup)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss(s, desc_k<BQ>(qs, wg * 64, kk), desc_k<BK>(ks, 0, kk), kk);
    wgmma_commit();
    wgmma_wait();
    fence_acc(s);

    // logits in log2 units, NEG_INF past Skv; the row max over the quad
    float mt[2] = {kNegInf, kNegInf};
    if ((t + 1) * BK > Skv) {
      const int col0 = t * BK + 2 * (lane % 4);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = col0 + 8 * (i / 4) + (i % 2) < Skv ? s[i] * scale2 : kNegInf;
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= scale2;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) mt[(i / 2) % 2] = fmaxf(mt[(i / 2) % 2], s[i]);
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mt[hr] = fmaxf(mt[hr], __shfl_xor_sync(0xffffffffu, mt[hr], 1));
      mt[hr] = fmaxf(mt[hr], __shfl_xor_sync(0xffffffffu, mt[hr], 2));
      const float m_new = fmaxf(m2[hr], mt[hr]);
      alpha[hr] = exp2f(m2[hr] - m_new);
      m2[hr] = m_new;
      l[hr] *= alpha[hr];
    }

    // p = exp(s - m) in fp32 into l, rounded to bf16 as the A fragments of
    // O += P.V
    uint32_t a[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int hr = (i / 2) % 2;
      const float p0 = exp2f(s[i] - m2[hr]), p1 = exp2f(s[i + 1] - m2[hr]);
      l[hr] += p0 + p1;
      a[i / 8][(i % 8) / 2] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[pn][i] *= alpha[(i / 2) % 2];

    wgmma_fence();
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc[pn], a[kk], desc_mn<BK>(vs, pn, kk));
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) fence_acc(acc[pn]);
    __syncthreads();  // every warpgroup is done with this stage before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {  // the quad's shares of l
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + wg * 64 + wrow + 8 * hr;
    if (row >= Sq) continue;
    const float l_inv = l[hr] == 0.f ? 1.f : 1.f / l[hr];
    bf16* out = o + ((static_cast<int64_t>(b) * Sq + row) * H + h) * D + 2 * (lane % 4);
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(out + pn * 64 + 8 * j) =
            pack_bf16(acc[pn][4 * j + 2 * hr] * l_inv, acc[pn][4 * j + 2 * hr + 1] * l_inv);
    if (lse != nullptr && lane % 4 == 0)
      lse[(static_cast<int64_t>(b) * H + h) * Sq + row] =
          m2[hr] * LN2 + logf(l[hr] == 0.f ? 1.f : l[hr]);
  }
}

// o (and lse) of 64 query rows of one (batch, head) at d = 512: warpgroup
// wg keeps o's columns [256 wg, 256 wg + 256) (panels 4 wg .. 4 wg + 3).
__global__ void __launch_bounds__(NT, 1) flash_fwd_wide_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int H, int Sq, int Skv, Strides st,
    float scale) {
  constexpr int D = 512, BQ = 64, BK = 64, KS = D / 16, NP = D / 64 / 2;
  constexpr uint32_t T = BQ * D * 2;  // bytes of each tile: q, k, v
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t ks = qs + T, vs = ks + T;

  const int tid = threadIdx.x;
  const int wg = tid / 128, lane = tid % 32, wrow = (tid % 128) / 32 * 16 + lane / 4;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const bf16* qb = q + b * st.sb[0] + h * st.sh[0];
  const bf16* kb = k + b * st.sb[1] + h * st.sh[1];
  const bf16* vb = v + b * st.sb[2] + h * st.sh[2];

  // copy groups, in commit order: q and k tile 0, v tile 0, then per tile t
  // k tile t + 1 (after S) and v tile t + 1 (after P.V); so at each wait
  // below the group waited for is the older of the two in flight
  load_tile<BQ, D>(qs, qb, st.ss[0], q0, Sq, tid);
  load_tile<BK, D>(ks, kb, st.ss[1], 0, Skv, tid);
  cp_async_commit();
  load_tile<BK, D>(vs, vb, st.ss[2], 0, Skv, tid);
  cp_async_commit();

  float acc[NP][32], s[32];
  float m2[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[pn][i] = 0.f;
  const float scale2 = scale * LOG2E;
  const int nt = (Skv + BK - 1) / BK;

  for (int t = 0; t < nt; ++t) {
    cp_async_wait<1>();  // q and k tile t have landed
    fence_proxy_async();
    __syncthreads();

    // S = Q.K^T (64 x 64), the same in both warpgroups
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss(s, desc_k<BQ>(qs, 0, kk), desc_k<BK>(ks, 0, kk), kk);
    wgmma_commit();
    wgmma_wait();
    fence_acc(s);
    __syncthreads();  // both warpgroups are done with k tile t
    if (t + 1 < nt) load_tile<BK, D>(ks, kb, st.ss[1], (t + 1) * BK, Skv, tid);
    cp_async_commit();

    // logits in log2 units, NEG_INF past Skv; the row max over the quad
    float mt[2] = {kNegInf, kNegInf};
    if ((t + 1) * BK > Skv) {
      const int col0 = t * BK + 2 * (lane % 4);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = col0 + 8 * (i / 4) + (i % 2) < Skv ? s[i] * scale2 : kNegInf;
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= scale2;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) mt[(i / 2) % 2] = fmaxf(mt[(i / 2) % 2], s[i]);
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mt[hr] = fmaxf(mt[hr], __shfl_xor_sync(0xffffffffu, mt[hr], 1));
      mt[hr] = fmaxf(mt[hr], __shfl_xor_sync(0xffffffffu, mt[hr], 2));
      const float m_new = fmaxf(m2[hr], mt[hr]);
      alpha[hr] = exp2f(m2[hr] - m_new);
      m2[hr] = m_new;
      l[hr] *= alpha[hr];
    }
    // p = exp(s - m) in fp32 into l, rounded to bf16 as the A fragments
    uint32_t a[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int hr = (i / 2) % 2;
      const float p0 = exp2f(s[i] - m2[hr]), p1 = exp2f(s[i + 1] - m2[hr]);
      l[hr] += p0 + p1;
      a[i / 8][(i % 8) / 2] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[pn][i] *= alpha[(i / 2) % 2];

    cp_async_wait<1>();  // v tile t has landed (k tile t + 1 may be in flight)
    fence_proxy_async();
    __syncthreads();
    // O[:, this warpgroup's 256 columns] += P.V
    wgmma_fence();
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(acc[pn], a[kk], desc_mn<BK>(vs, wg * NP + pn, kk));
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) fence_acc(acc[pn]);
    __syncthreads();  // both warpgroups are done with v tile t
    if (t + 1 < nt) load_tile<BK, D>(vs, vb, st.ss[2], (t + 1) * BK, Skv, tid);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {  // the quad's shares of l
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + wrow + 8 * hr;
    if (row >= Sq) continue;
    const float l_inv = l[hr] == 0.f ? 1.f : 1.f / l[hr];
    bf16* out = o + ((static_cast<int64_t>(b) * Sq + row) * H + h) * D + wg * NP * 64 +
                2 * (lane % 4);
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(out + pn * 64 + 8 * j) =
            pack_bf16(acc[pn][4 * j + 2 * hr] * l_inv, acc[pn][4 * j + 2 * hr + 1] * l_inv);
    if (lse != nullptr && wg == 0 && lane % 4 == 0)
      lse[(static_cast<int64_t>(b) * H + h) * Sq + row] =
          m2[hr] * LN2 + logf(l[hr] == 0.f ? 1.f : l[hr]);
  }
}

}  // namespace tc

template <typename T, int D, int NT, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int H, int Sq, int Skv, const long long* st, float q_scale, float scale,
                   cudaStream_t stream) {
  constexpr int ROWS = NT / (D / 32);
  constexpr int smem = 2 * BK * D * static_cast<int>(sizeof(float));
  auto kernel = flash_fwd_kernel<T, D, NT, BK>;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err = wgmma_tile::allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + ROWS - 1) / ROWS, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, Sq, Skv, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], q_scale, scale);
  return cudaGetLastError();
}

// Tile sizes per head dim: 128 or 256 threads, 32 dims per lane, and kv tiles
// of 64 KB (32 KB at d=64) of fp32 k and v in shared memory.
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                     int H, int Sq, int Skv, int D, const long long* st, float q_scale,
                     float scale, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64, 128, 64>(q, k, v, o, lse, B, H, Sq, Skv, st, q_scale, scale, stream);
    case 128: return launch<T, 128, 128, 64>(q, k, v, o, lse, B, H, Sq, Skv, st, q_scale, scale, stream);
    case 256: return launch<T, 256, 256, 32>(q, k, v, o, lse, B, H, Sq, Skv, st, q_scale, scale, stream);
    case 512: return launch<T, 512, 256, 16>(q, k, v, o, lse, B, H, Sq, Skv, st, q_scale, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// q, k, v, o, lse, dtype and strides as flash_attention_fwd below; q is
// rounded once as q_scale * q and the logits are scaled by `scale`.
int run(const void* q, const void* k, const void* v, void* o, void* lse, int dtype, int B,
        int H, int Sq, int Skv, int D, const long long* st, float q_scale, float scale,
        void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = dispatch<float>(q, k, v, o, lse_f, B, H, Sq, Skv, D, st, q_scale, scale, s);
      break;
    case 1:
      err = dispatch<__nv_bfloat16>(q, k, v, o, lse_f, B, H, Sq, Skv, D, st, q_scale, scale, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The tensor-core kernel: 256 threads, 128 query rows a block; q, 2 stages of
// k and v as bf16 tiles, with 1 KB of slack for the 1024-byte alignment of
// the swizzle.
template <int D, bool PRESCALE>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                      int H, int Sq, int Skv, const tc::Strides& st, float q_scale,
                      float scale, cudaStream_t stream) {
  constexpr int smem = 1024 + (128 + 4 * 64) * D * 2;
  auto kernel = tc::flash_fwd_tc_kernel<D, PRESCALE>;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err = wgmma_tile::allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + 127) / 128, B * H);
  kernel<<<grid, tc::NT, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<tc::bf16*>(o), lse, H, Sq, Skv, st, q_scale,
      scale);
  return cudaGetLastError();
}

// The tensor-core entries' operands: bf16 (dtype 1), every row of q, k and
// v 16-byte aligned (cp.async moves 16 bytes); the strides as the kernels
// take them. Returns cudaSuccess or the error the entry reports.
cudaError_t tc_operands(const void* q, const void* k, const void* v, int dtype, int B, int H,
                        int Sq, int Skv, const long long* st, tc::Strides& s) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || dtype != 1) return cudaErrorInvalidValue;
  const void* ptrs[3] = {q, k, v};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorMisalignedAddress;
  for (int i = 0; i < 9; ++i)
    if (st[i] % 8 != 0) return cudaErrorMisalignedAddress;
  for (int t = 0; t < 3; ++t) {
    s.sb[t] = st[3 * t];
    s.ss[t] = st[3 * t + 1];
    s.sh[t] = st[3 * t + 2];
  }
  return cudaSuccess;
}

// As run, on the tensor cores: D = 64 or 128, operands as tc_operands.
int run_tc(bool prescale, const void* q, const void* k, const void* v, void* o, void* lse,
           int dtype, int B, int H, int Sq, int Skv, int D, const long long* st,
           float q_scale, float scale, void* stream) {
  tc::Strides s;
  cudaError_t err = tc_operands(q, k, v, dtype, B, H, Sq, Skv, st, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (D == 64)
    err = prescale
              ? launch_tc<64, true>(q, k, v, o, lse_f, B, H, Sq, Skv, s, q_scale, scale, cs)
              : launch_tc<64, false>(q, k, v, o, lse_f, B, H, Sq, Skv, s, q_scale, scale, cs);
  else if (D == 128)
    err = prescale
              ? launch_tc<128, true>(q, k, v, o, lse_f, B, H, Sq, Skv, s, q_scale, scale, cs)
              : launch_tc<128, false>(q, k, v, o, lse_f, B, H, Sq, Skv, s, q_scale, scale, cs);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The wide kernel: 256 threads, 64 query rows a block; q, one k and one v
// tile of 64 x 512 bf16, with 1 KB of slack for the swizzle's alignment.
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o, float* lse,
                        int B, int H, int Sq, int Skv, const tc::Strides& st, float scale,
                        cudaStream_t stream) {
  constexpr int smem = 1024 + 3 * 64 * 512 * 2;
  auto kernel = tc::flash_fwd_wide_kernel;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err = wgmma_tile::allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + 63) / 64, B * H);
  kernel<<<grid, tc::NT, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<tc::bf16*>(o), lse, H, Sq, Skv, st, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v: [B,S,H,D] with unit stride over D; strides (batch, seq, head) in
// elements for q, k, v in that order. o: contiguous [B,Sq,H,D]. lse: null, or
// contiguous fp32 [B,H,Sq]. dtype: 0 fp32, 1 bf16. Returns a cudaError_t (0 on
// success); the launch is asynchronous.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                        int dtype,
                        int B, int H, int Sq, int Skv, int D,
                        long long q_sb, long long q_ss, long long q_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        float scale, void* stream) {
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  return run(q, k, v, o, lse, dtype, B, H, Sq, Skv, D, st, 1.f, scale, stream);
}

// K3: as flash_attention_fwd, with q loaded as bf16(q_scale * q) (for the
// packed layout: q_scale = d^-1/2 and scale = 1 in bf16).
int flash_attention_fwd_prescaled(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int dtype,
                                  int B, int H, int Sq, int Skv, int D,
                                  long long q_sb, long long q_ss, long long q_sh,
                                  long long k_sb, long long k_ss, long long k_sh,
                                  long long v_sb, long long v_ss, long long v_sh,
                                  float q_scale, float scale, void* stream) {
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  return run(q, k, v, o, lse, dtype, B, H, Sq, Skv, D, st, q_scale, scale, stream);
}

// The tensor-core entries: the same arguments as flash_attention_fwd and
// flash_attention_fwd_prescaled; bf16 (dtype 1) at D = 64 or 128 only, with
// every row of q, k and v 16-byte aligned (else cudaErrorInvalidValue,
// cudaErrorMisalignedAddress).
int flash_attention_fwd_tc(const void* q, const void* k, const void* v, void* o, void* lse,
                           int dtype,
                           int B, int H, int Sq, int Skv, int D,
                           long long q_sb, long long q_ss, long long q_sh,
                           long long k_sb, long long k_ss, long long k_sh,
                           long long v_sb, long long v_ss, long long v_sh,
                           float scale, void* stream) {
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  return run_tc(false, q, k, v, o, lse, dtype, B, H, Sq, Skv, D, st, 1.f, scale, stream);
}

int flash_attention_fwd_prescaled_tc(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int dtype,
                                     int B, int H, int Sq, int Skv, int D,
                                     long long q_sb, long long q_ss, long long q_sh,
                                     long long k_sb, long long k_ss, long long k_sh,
                                     long long v_sb, long long v_ss, long long v_sh,
                                     float q_scale, float scale, void* stream) {
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  return run_tc(true, q, k, v, o, lse, dtype, B, H, Sq, Skv, D, st, q_scale, scale, stream);
}

// The wide tensor-core entry: the same arguments as flash_attention_fwd;
// bf16 (dtype 1) at D = 512 only, with every row of q, k and v 16-byte
// aligned (else cudaErrorInvalidValue, cudaErrorMisalignedAddress).
int flash_attention_fwd_wide_tc(const void* q, const void* k, const void* v, void* o,
                                void* lse, int dtype,
                                int B, int H, int Sq, int Skv, int D,
                                long long q_sb, long long q_ss, long long q_sh,
                                long long k_sb, long long k_ss, long long k_sh,
                                long long v_sb, long long v_ss, long long v_sh,
                                float scale, void* stream) {
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  if (D != 512) return static_cast<int>(cudaErrorInvalidValue);
  tc::Strides s;
  cudaError_t err = tc_operands(q, k, v, dtype, B, H, Sq, Skv, st, s);
  if (err == cudaSuccess)
    err = launch_wide(q, k, v, o, static_cast<float*>(lse), B, H, Sq, Skv, s, scale,
                      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
