// Flash-attention backward for Hopper (sm_90a), bf16 or fp32, [B,S,H,D] through strides.
//
// Replaces the Pallas TPU kernels diffbir_tpu/ops/flash_attention.py::_dq_kernel
// (K2a) and ::_dkv_kernel (K2b), launched by _flash_attention_bwd_impl. Same
// math and rounding points, from the saved q, k, v, o, the forward's fp32
// logsumexp lse and the output gradient dO:
//   s = q.k^T * d^-1/2 (fp32 accumulation)   p = exp(s - lse)   (fp32)
//   dp = dO.v^T (fp32)   delta = rowsum(dO * O) (fp32, recomputed here)
//   ds = p * (dp - delta) * d^-1/2
//   dq = sum_j ds->dtype * k    dv = sum_i p->dtype * dO    dk = sum_i ds->dtype * q
// with fp32 accumulators stored once in the input dtype. kv rows past Skv
// give p = 0 and q rows past Sq contribute nothing (the TPU pads them to
// q = dO = 0).
//
// Three designs in one source, each with its own entry points:
// - on the tensor cores (flash_bwd_dq_tc_kernel, flash_bwd_dkv_tc_kernel;
//   entries flash_attention_bwd_dq_tc / _dkv_tc): bf16 at d = 64 and 128,
//   which is every backward the port's training path runs;
// - on the tensor cores for one wide head (flash_bwd_dq_wide_kernel,
//   flash_bwd_dkv_wide_kernel; entries flash_attention_bwd_dq_wide_tc /
//   _dkv_wide_tc, after the pre-pass flash_attention_bwd_delta): bf16 at
//   d = 512, the VAE's single-head mid-block attention under RGB guidance's
//   gradient through the decoder;
// - on the CUDA cores (flash_bwd_dq_kernel, flash_bwd_dkv_kernel; entries
//   flash_attention_bwd_dq / _dkv): fp32 at any d, bf16 at d = 256 and 512.
//   The tensor cores have no fp32 mode that keeps fp32's limit (TF32
//   rounds), and no path of the port launches these (the VAE is frozen in
//   training; bf16 d = 512 takes the wide kernels).
// Both keep the TPU's split by accumulation axis; the TPU's sequential grid
// axis becomes a loop inside the block, so nothing carries between blocks and
// no atomics are needed: every output row is written by exactly one block, and
// gradients are bit-identical from run to run.
//
// What bounds them on an H100: at the training shapes (S = 4096, d = 64) the
// dq kernel does 3 and the dk/dv kernel 4 products of 2*Sq*Skv*d flops per
// head against a few MB of q, k, v, o and dO, so both are compute-bound, and
// only the tensor cores (989 TFLOP/s in bf16, against 67 for fp32 FMAs on
// the CUDA cores) come near that bound.
//
// Tensor-core design (wgmma m64n64k16 bf16 with fp32 accumulators in
// registers; two warpgroups a block, each owning 64 output rows):
// - dq: a block owns 128 query rows (q and dO staged once) and loops over
//   64-row kv tiles. S = Q.K^T and dP = dO.V^T read both operands from shared
//   memory (K-major); p and ds are formed on the accumulators; dQ += bf16(dS).K
//   takes dS from registers as the A operand (the accumulator's layout is the
//   A fragment's) and K as an MN-major B (the descriptor's transpose bit), so
//   p and ds never leave registers. delta = rowsum(dO*O) once per row.
// - dk/dv: a block owns 128 kv rows (k and v staged once) and loops over
//   64-row q tiles, computing the transposed tiles directly: S^T = K.Q^T and
//   dP^T = V.dO^T, then dV += bf16(P^T).dO and dK += bf16(dS^T).Q with A from
//   registers. O is staged beside dO, and delta is formed once per q tile
//   from shared memory.
// - Tiles are bf16 in shared memory, in 64-column panels of 128-byte rows
//   with the 128-byte XOR swizzle that wgmma's descriptors read, loaded with
//   cp.async in two stages: the next kv (dq) or q (dk/dv) tile is in flight
//   while the current one is multiplied. Rows past the end are zero-filled
//   by the copy (src-size 0); kv columns past Skv get p = 0, and q rows past
//   Sq contribute nothing (p = 0 in dk/dv, not stored in dq).
// - At d = 128 the products over d (dQ, dK, dV) are issued per 64-column
//   panel (n = 64), so one descriptor form serves both head dims.
// - The tiles, copies, descriptors and wgmma wrappers are those of
//   wgmma_tile.cuh, shared with the forward's tensor-core kernel.
//
// Wide tensor-core design (d = 512, bf16). At the guided decoder's shapes
// ([1,16384,1,512]: B*H = 1) dq does 3 and dk/dv 4 products of
// 2*Sq*Skv*512 flops against 80 MB of q, k, v, o, dO and the gradients, so
// both are compute-bound, and the grid's only parallelism is rows. What
// d = 512 changes against the d <= 128 design:
// - A 64 x 512 fp32 accumulator is 128 KB, a warpgroup's whole register
//   file, and the block has 227 KB of shared memory for 64 KB tiles of q
//   and dO. So kv tiles are 32 rows (wgmma m64n32k16) and no product is
//   split by columns in a way that would make a warpgroup recompute S:
//   * dq (K2a_wide): a block owns 64 query rows (q, dO staged once; one k
//     and one v tile of 32 rows; 208 KB). Warpgroup 0 computes S = Q.K^T,
//     warpgroup 1 dP = dO.V^T, each over all 512 dims; they swap the two
//     64 x 32 fp32 accumulators through shared memory (16 KB), each forms
//     p and ds of the tile in registers, and warpgroup wg adds dS.K to dq's
//     columns [256 wg, 256 wg + 256) (dS as the A fragment, as above).
//     That is the bound's 3 products, with no recompute (K1_wide does its
//     S twice); the swap sits between the products and ds.
//   * dk/dv (K2b_wide): a block owns 32 kv rows (k, v staged once; one q
//     and one dO tile of 64 rows; 220 KB) and accumulates the transposed
//     products dK^T += Q^T.dS and dV^T += dO^T.P (512 x 32 each, 8 M tiles
//     of 64: 128 registers a thread), A read MN-major from the q or dO tile,
//     B the bf16 dS^T or P^T tile in shared memory. Warpgroup 0 computes S
//     and writes P^T for warpgroup 1, warpgroup 1 computes dP and hands it
//     over (two stages of P^T and of the swap, so one barrier a q tile
//     orders them), warpgroup 0 forms dS^T. The bound's 4 products, no
//     recompute.
// - delta = rowsum(dO * O) comes from a pre-pass (flash_bwd_delta_kernel,
//   fp32 [B,H,Sq], 32 MB read at 16384 tokens), so neither kernel stages o:
//   K2b would otherwise read all of o once per 32 kv rows.
// - Each warpgroup copies the operands of its own product (warpgroup 0 q
//   and k, warpgroup 1 dO and v) and waits on its own named barrier. In dq
//   the next v tile loads under the swap and dQ, the next k tile after dQ
//   (under the next dP); in dk/dv the next q and dO tiles after their last
//   product, one stage each: their load is exposed once a q tile.
// - Each block reads all of k and v (dq: 64 KB a kv tile) or q and dO
//   (dk/dv: 128 KB a q tile) from L2: 8 GB and 16 GB at 16384 tokens, so
//   the L2 rate, and not the tensor cores, may bind, as in K1_wide.
//   Thread-block clusters that multicast a tile would cut that (not done).
// - Parallelism: Sq / 64 blocks of dq (256 at 16384 tokens, 64 at 4096,
//   against 132 SMs) and Skv / 32 of dk/dv (512, 128).
//
// CUDA-core design (the layout of the forward's CUDA-core kernel):
// - dq: a block owns ROWS query rows of one (batch, head) and loops over kv
//   tiles staged in shared memory as fp32. Each query row belongs to
//   G = D/32 consecutive lanes; a lane keeps 32 of the D dims of q, dO and the
//   dq accumulator in registers (as K1 keeps q and its accumulator).
// - dk/dv: a block owns ROWS kv rows and loops over q tiles (q, dO, lse and
//   delta staged in shared memory); a lane keeps 32 dims of k, v and the two
//   accumulators (128 fp32 registers), which is what lets d = 512 run: the
//   row is split over 16 lanes instead of held by one thread.
// Each logit and each dp is a partial dot over the lane's 32 dims plus a
// shuffle reduction over the G lanes; all products are fp32 FMAs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "wgmma_tile.cuh"

namespace {

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

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// (batch, seq, head) strides in elements of q, k, v, o and dO, in that order.
struct Strides {
  int64_t sb[5], ss[5], sh[5];
};
enum { Q = 0, K = 1, V = 2, O = 3, DO = 4 };

template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D, int NT, int BK>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const float* __restrict__ lse, const T* __restrict__ dout,
    T* __restrict__ dq, int H, int Sq, int Skv, Strides st, float scale) {
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

  const T* qr_p = q + b * st.sb[Q] + h * st.sh[Q] + static_cast<int64_t>(row) * st.ss[Q];
  const T* or_p = o + b * st.sb[O] + h * st.sh[O] + static_cast<int64_t>(row) * st.ss[O];
  const T* dr_p = dout + b * st.sb[DO] + h * st.sh[DO] + static_cast<int64_t>(row) * st.ss[DO];
  const T* kb = k + b * st.sb[K] + h * st.sh[K];
  const T* vb = v + b * st.sb[V] + h * st.sh[V];

  float qr[NC][4], dor[NC][4], acc[NC][4];
  float delta = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dim = 4 * (g + G * c) + e;
      qr[c][e] = valid ? to_f32<T>(qr_p[dim]) : 0.f;
      dor[c][e] = valid ? to_f32<T>(dr_p[dim]) : 0.f;
      const float ov = valid ? to_f32<T>(or_p[dim]) : 0.f;
      delta = fmaf(dor[c][e], ov, delta);
      acc[c][e] = 0.f;
    }
  }
  delta = group_sum<G>(delta);
  const float lse_r = valid ? lse[(static_cast<int64_t>(b) * H + h) * Sq + row] : 0.f;

  for (int kv0 = 0; kv0 < Skv; kv0 += BK) {
    const int nk = min(BK, Skv - kv0);
    __syncthreads();  // every lane is done with the previous tile
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D;
      const int col = i % D;
      float kx = 0.f, vx = 0.f;
      if (r < nk) {
        kx = to_f32<T>(kb[(kv0 + r) * st.ss[K] + col]);
        vx = to_f32<T>(vb[(kv0 + r) * st.ss[V] + col]);
      }
      ks[i] = kx;
      vs[i] = vx;
    }
    __syncthreads();

    // nk is the same for the whole block, so the shuffles stay converged;
    // kv rows past Skv are never visited, i.e. their p is 0
#pragma unroll 2
    for (int j = 0; j < nk; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * D);
      const float4* vr = reinterpret_cast<const float4*>(vs + j * D);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 kk = kr[g + G * c];
        const float4 vv = vr[g + G * c];
        s = fmaf(qr[c][0], kk.x, s);
        s = fmaf(qr[c][1], kk.y, s);
        s = fmaf(qr[c][2], kk.z, s);
        s = fmaf(qr[c][3], kk.w, s);
        dp = fmaf(dor[c][0], vv.x, dp);
        dp = fmaf(dor[c][1], vv.y, dp);
        dp = fmaf(dor[c][2], vv.z, dp);
        dp = fmaf(dor[c][3], vv.w, dp);
      }
      s = group_sum<G>(s);
      dp = group_sum<G>(dp);
      const float p = expf(s * scale - lse_r);
      const float ds = round_to<T>(p * (dp - delta) * scale);  // ds in the input dtype
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 kk = kr[g + G * c];
        acc[c][0] = fmaf(ds, kk.x, acc[c][0]);
        acc[c][1] = fmaf(ds, kk.y, acc[c][1]);
        acc[c][2] = fmaf(ds, kk.z, acc[c][2]);
        acc[c][3] = fmaf(ds, kk.w, acc[c][3]);
      }
    }
  }

  if (!valid) return;
  T* out = dq + ((static_cast<int64_t>(b) * Sq + row) * H + h) * D;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) out[4 * (g + G * c) + e] = from_f32<T>(acc[c][e]);
  }
}

template <typename T, int D, int NT, int BQ>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const float* __restrict__ lse, const T* __restrict__ dout,
    T* __restrict__ dk, T* __restrict__ dv, int H, int Sq, int Skv, Strides st,
    float scale) {
  constexpr int G = D / 32;     // lanes per kv row
  constexpr int ROWS = NT / G;  // kv rows per block
  constexpr int NC = 8;         // float4 chunks per lane (32 dims)
  constexpr int NW = NT / 32;   // warps per block
  static_assert(D % 32 == 0 && 32 % G == 0 && NT % G == 0, "bad tile");

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [BQ][D]
  float* dos = qs + BQ * D;                      // [BQ][D] dO
  float* lse_s = dos + BQ * D;                   // [BQ]
  float* delta_s = lse_s + BQ;                   // [BQ]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = tid % G;
  const int row = blockIdx.x * ROWS + tid / G;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const bool valid = row < Skv;

  const T* qb = q + b * st.sb[Q] + h * st.sh[Q];
  const T* ob = o + b * st.sb[O] + h * st.sh[O];
  const T* db = dout + b * st.sb[DO] + h * st.sh[DO];
  const T* kr_p = k + b * st.sb[K] + h * st.sh[K] + static_cast<int64_t>(row) * st.ss[K];
  const T* vr_p = v + b * st.sb[V] + h * st.sh[V] + static_cast<int64_t>(row) * st.ss[V];
  const float* lse_b = lse + (static_cast<int64_t>(b) * H + h) * Sq;

  float kr[NC][4], vr[NC][4], dk_acc[NC][4], dv_acc[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dim = 4 * (g + G * c) + e;
      kr[c][e] = valid ? to_f32<T>(kr_p[dim]) : 0.f;
      vr[c][e] = valid ? to_f32<T>(vr_p[dim]) : 0.f;
      dk_acc[c][e] = 0.f;
      dv_acc[c][e] = 0.f;
    }
  }

  for (int q0 = 0; q0 < Sq; q0 += BQ) {
    const int nq = min(BQ, Sq - q0);
    __syncthreads();  // every lane is done with the previous tile
    for (int i = tid; i < BQ * D; i += NT) {
      const int r = i / D;
      const int col = i % D;
      float qx = 0.f, dx = 0.f;
      if (r < nq) {
        qx = to_f32<T>(qb[(q0 + r) * st.ss[Q] + col]);
        dx = to_f32<T>(db[(q0 + r) * st.ss[DO] + col]);
      }
      qs[i] = qx;
      dos[i] = dx;
    }
    // delta = rowsum(dO * O) of the tile's q rows, one warp per row
    for (int r = warp; r < BQ; r += NW) {
      float part = 0.f;
      if (r < nq) {
        for (int col = lane; col < D; col += 32) {
          part = fmaf(to_f32<T>(db[(q0 + r) * st.ss[DO] + col]),
                      to_f32<T>(ob[(q0 + r) * st.ss[O] + col]), part);
        }
      }
      part = group_sum<32>(part);
      if (lane == 0) {
        delta_s[r] = part;
        lse_s[r] = r < nq ? lse_b[q0 + r] : 0.f;
      }
    }
    __syncthreads();

    // nq is the same for the whole block, so the shuffles stay converged;
    // q rows past Sq are never visited, i.e. they contribute nothing
#pragma unroll 2
    for (int i = 0; i < nq; ++i) {
      const float4* qi = reinterpret_cast<const float4*>(qs + i * D);
      const float4* di = reinterpret_cast<const float4*>(dos + i * D);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 qq = qi[g + G * c];
        const float4 dd = di[g + G * c];
        s = fmaf(kr[c][0], qq.x, s);
        s = fmaf(kr[c][1], qq.y, s);
        s = fmaf(kr[c][2], qq.z, s);
        s = fmaf(kr[c][3], qq.w, s);
        dp = fmaf(vr[c][0], dd.x, dp);
        dp = fmaf(vr[c][1], dd.y, dp);
        dp = fmaf(vr[c][2], dd.z, dp);
        dp = fmaf(vr[c][3], dd.w, dp);
      }
      s = group_sum<G>(s);
      dp = group_sum<G>(dp);
      const float p = expf(s * scale - lse_s[i]);
      const float ds = round_to<T>(p * (dp - delta_s[i]) * scale);  // ds in the input dtype
      const float pr = round_to<T>(p);                              // p in the input dtype
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 qq = qi[g + G * c];
        const float4 dd = di[g + G * c];
        dv_acc[c][0] = fmaf(pr, dd.x, dv_acc[c][0]);
        dv_acc[c][1] = fmaf(pr, dd.y, dv_acc[c][1]);
        dv_acc[c][2] = fmaf(pr, dd.z, dv_acc[c][2]);
        dv_acc[c][3] = fmaf(pr, dd.w, dv_acc[c][3]);
        dk_acc[c][0] = fmaf(ds, qq.x, dk_acc[c][0]);
        dk_acc[c][1] = fmaf(ds, qq.y, dk_acc[c][1]);
        dk_acc[c][2] = fmaf(ds, qq.z, dk_acc[c][2]);
        dk_acc[c][3] = fmaf(ds, qq.w, dk_acc[c][3]);
      }
    }
  }

  if (!valid) return;
  const int64_t off = ((static_cast<int64_t>(b) * Skv + row) * H + h) * D;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[off + 4 * (g + G * c) + e] = from_f32<T>(dk_acc[c][e]);
      dv[off + 4 * (g + G * c) + e] = from_f32<T>(dv_acc[c][e]);
    }
  }
}

// ---------------------------------------------------------------------------
// The tensor-core kernels (bf16, d = 64 or 128)
// ---------------------------------------------------------------------------
namespace tc {

using namespace wgmma_tile;

// sum of a*b over the 8 bf16 pairs of two 16-byte chunks
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 u = __bfloat1622float2(x[e]), w = __bfloat1622float2(y[e]);
    s = fmaf(u.x, w.x, s);
    s = fmaf(u.y, w.y, s);
  }
  return s;
}

// (wgmma_tile.cuh gives the accumulator's layout: p and ds feed the next
// product from registers as its A fragments.)

// K2a: dq for 128 query rows of one (batch, head). At d = 64 two blocks fit
// an SM (<= 128 registers, 66 KB of shared memory each), so one block's
// exp and stores overlap the other's products.
template <int D>
__global__ void __launch_bounds__(NT, D == 64 ? 2 : 1) flash_bwd_dq_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const float* __restrict__ lse, const bf16* __restrict__ dout,
    bf16* __restrict__ dq, int H, int Sq, int Skv, Strides st, float scale) {
  constexpr int BQ = 128, BK = 64, KS = D / 16, NP = D / 64;
  constexpr uint32_t QT = BQ * D * 2, KT = BK * D * 2;  // tile bytes
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t dos = qs + QT;
  const uint32_t kvs = dos + QT;  // stage s: k at kvs + 2*KT*s, v KT after

  const int tid = threadIdx.x;
  const int wg = tid / 128, lane = tid % 32, wrow = (tid % 128) / 32 * 16 + lane / 4;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const bf16* qb = q + b * st.sb[Q] + h * st.sh[Q];
  const bf16* kb = k + b * st.sb[K] + h * st.sh[K];
  const bf16* vb = v + b * st.sb[V] + h * st.sh[V];
  const bf16* ob = o + b * st.sb[O] + h * st.sh[O];
  const bf16* db = dout + b * st.sb[DO] + h * st.sh[DO];

  load_tile<BQ, D>(qs, qb, st.ss[Q], q0, Sq, tid);
  load_tile<BQ, D>(dos, db, st.ss[DO], q0, Sq, tid);
  load_tile<BK, D>(kvs, kb, st.ss[K], 0, Skv, tid);
  load_tile<BK, D>(kvs + KT, vb, st.ss[V], 0, Skv, tid);
  cp_async_commit();

  // lse (in log2 units) and delta = rowsum(dO * O) of this thread's two rows,
  // each summed by the 4 lanes that share them
  float lse2[2], delta[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + wg * 64 + wrow + 8 * hr;
    float part = 0.f;
    if (row < Sq) {
      const bf16* dr = db + static_cast<int64_t>(row) * st.ss[DO];
      const bf16* orow = ob + static_cast<int64_t>(row) * st.ss[O];
#pragma unroll
      for (int c = lane % 4; c < D / 8; c += 4)
        part += dot8(*reinterpret_cast<const uint4*>(dr + 8 * c),
                     *reinterpret_cast<const uint4*>(orow + 8 * c));
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    delta[hr] = part;
    lse2[hr] = row < Sq ? lse[(static_cast<int64_t>(b) * H + h) * Sq + row] * LOG2E : 0.f;
  }

  float acc[NP][32], s[32], dp[32];
#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[pn][i] = 0.f;
  const float scale2 = scale * LOG2E;
  const int nt = (Skv + BK - 1) / BK;

  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) {  // the next kv tile into the other stage
      const uint32_t nxt = kvs + 2 * KT * ((t + 1) & 1);
      load_tile<BK, D>(nxt, kb, st.ss[K], (t + 1) * BK, Skv, tid);
      load_tile<BK, D>(nxt + KT, vb, st.ss[V], (t + 1) * BK, Skv, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies (and q, dO) have landed
    fence_proxy_async();
    __syncthreads();
    const uint32_t ks = kvs + 2 * KT * (t & 1), vs = ks + KT;

    // S = Q.K^T, dP = dO.V^T (64 x 64 per warpgroup)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss(s, desc_k<BQ>(qs, wg * 64, kk), desc_k<BK>(ks, 0, kk), kk);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss(dp, desc_k<BQ>(dos, wg * 64, kk), desc_k<BK>(vs, 0, kk), kk);
    wgmma_commit();
    wgmma_wait();
    fence_acc(s);
    fence_acc(dp);

    // p = exp(s * d^-1/2 - lse) (0 past Skv), ds = p * (dp - delta) * d^-1/2
    // rounded to bf16 as the A fragments of dQ += dS.K
    uint32_t a[4][4];
    const int col0 = t * BK + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int hr = (i / 2) % 2;
      const int col = col0 + 8 * (i / 4);
      const float p0 = col < Skv ? exp2f(fmaf(s[i], scale2, -lse2[hr])) : 0.f;
      const float p1 = col + 1 < Skv ? exp2f(fmaf(s[i + 1], scale2, -lse2[hr])) : 0.f;
      a[i / 8][(i % 8) / 2] =
          pack_bf16(p0 * (dp[i] - delta[hr]) * scale, p1 * (dp[i + 1] - delta[hr]) * scale);
    }

    wgmma_fence();
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc[pn], a[kk], desc_mn<BK>(ks, pn, kk));
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) fence_acc(acc[pn]);
    __syncthreads();  // every warpgroup is done with this stage before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + wg * 64 + wrow + 8 * hr;
    if (row >= Sq) continue;
    bf16* out = dq + ((static_cast<int64_t>(b) * Sq + row) * H + h) * D + 2 * (lane % 4);
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(out + pn * 64 + 8 * j) =
            pack_bf16(acc[pn][4 * j + 2 * hr], acc[pn][4 * j + 2 * hr + 1]);
  }
}

// K2b: dk and dv for 128 kv rows of one (batch, head).
template <int D>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dkv_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const float* __restrict__ lse, const bf16* __restrict__ dout,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Sq, int Skv, Strides st,
    float scale) {
  constexpr int BKV = 128, BQ = 64, KS = D / 16, NP = D / 64;
  constexpr uint32_t KT = BKV * D * 2, QT = BQ * D * 2;  // tile bytes
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ks = (raw + 1023) & ~1023u;
  const uint32_t vs = ks + KT;
  const uint32_t qds = vs + KT;  // stage s: q at qds + 3*QT*s, dO QT after, O 2*QT after
  uint8_t* const gen = smem_raw + (ks - raw);  // generic pointer to ks
  float* const lse_s = reinterpret_cast<float*>(gen + 2 * KT + 6 * QT);  // [2][BQ], log2 units
  float* const delta_s = lse_s + 2 * BQ;                                   // [2][BQ]

  const int tid = threadIdx.x;
  const int wg = tid / 128, lane = tid % 32, wrow = (tid % 128) / 32 * 16 + lane / 4;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kv0 = blockIdx.x * BKV;
  const bf16* qb = q + b * st.sb[Q] + h * st.sh[Q];
  const bf16* kb = k + b * st.sb[K] + h * st.sh[K];
  const bf16* vb = v + b * st.sb[V] + h * st.sh[V];
  const bf16* ob = o + b * st.sb[O] + h * st.sh[O];
  const bf16* db = dout + b * st.sb[DO] + h * st.sh[DO];
  const float* lse_b = lse + (static_cast<int64_t>(b) * H + h) * Sq;

  load_tile<BKV, D>(ks, kb, st.ss[K], kv0, Skv, tid);
  load_tile<BKV, D>(vs, vb, st.ss[V], kv0, Skv, tid);
  load_tile<BQ, D>(qds, qb, st.ss[Q], 0, Sq, tid);
  load_tile<BQ, D>(qds + QT, db, st.ss[DO], 0, Sq, tid);
  load_tile<BQ, D>(qds + 2 * QT, ob, st.ss[O], 0, Sq, tid);
  cp_async_commit();

  float dka[NP][32], dva[NP][32], s[32], dp[32];
#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[pn][i] = dva[pn][i] = 0.f;
  const float scale2 = scale * LOG2E;
  const int nt = (Sq + BQ - 1) / BQ;

  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) {  // the next q tile into the other stage
      const uint32_t nxt = qds + 3 * QT * ((t + 1) & 1);
      load_tile<BQ, D>(nxt, qb, st.ss[Q], (t + 1) * BQ, Sq, tid);
      load_tile<BQ, D>(nxt + QT, db, st.ss[DO], (t + 1) * BQ, Sq, tid);
      load_tile<BQ, D>(nxt + 2 * QT, ob, st.ss[O], (t + 1) * BQ, Sq, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies (and k, v) have landed
    fence_proxy_async();
    __syncthreads();
    const int stage = t & 1;
    const uint32_t qt = qds + 3 * QT * stage, dot = qt + QT;
    float* const lse_t = lse_s + BQ * stage;
    float* const delta_t = delta_s + BQ * stage;

    {  // delta = rowsum(dO * O) of the tile's q rows from shared memory, 4 lanes a row
      const int r = tid / 4;
      const uint8_t* dr = gen + (dot - ks);
      const uint8_t* orow = dr + QT;
      float part = 0.f;
#pragma unroll
      for (int c = tid % 4; c < D / 8; c += 4)
        part += dot8(*reinterpret_cast<const uint4*>(dr + chunk_off<BQ>(r, c)),
                     *reinterpret_cast<const uint4*>(orow + chunk_off<BQ>(r, c)));
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (tid % 4 == 0) {
        const int row = t * BQ + r;
        delta_t[r] = part;
        lse_t[r] = row < Sq ? lse_b[row] * LOG2E : 0.f;
      }
    }
    __syncthreads();

    // S^T = K.Q^T, dP^T = V.dO^T (64 kv rows x 64 q columns per warpgroup)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss(s, desc_k<BKV>(ks, wg * 64, kk), desc_k<BQ>(qt, 0, kk), kk);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss(dp, desc_k<BKV>(vs, wg * 64, kk), desc_k<BQ>(dot, 0, kk), kk);
    wgmma_commit();
    wgmma_wait();
    fence_acc(s);
    fence_acc(dp);

    // p^T (0 past Sq) and ds^T, rounded to bf16 as the A fragments of
    // dV += P^T.dO and dK += dS^T.Q
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int c = 8 * (i / 4) + 2 * (lane % 4);
      const int row = t * BQ + c;
      const float p0 = row < Sq ? exp2f(fmaf(s[i], scale2, -lse_t[c])) : 0.f;
      const float p1 = row + 1 < Sq ? exp2f(fmaf(s[i + 1], scale2, -lse_t[c + 1])) : 0.f;
      pa[i / 8][(i % 8) / 2] = pack_bf16(p0, p1);
      da[i / 8][(i % 8) / 2] = pack_bf16(p0 * (dp[i] - delta_t[c]) * scale,
                                         p1 * (dp[i + 1] - delta_t[c + 1]) * scale);
    }

    wgmma_fence();
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(dva[pn], pa[kk], desc_mn<BQ>(dot, pn, kk));
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(dka[pn], da[kk], desc_mn<BQ>(qt, pn, kk));
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) {
      fence_acc(dva[pn]);
      fence_acc(dka[pn]);
    }
    __syncthreads();  // every warpgroup is done with this stage before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = kv0 + wg * 64 + wrow + 8 * hr;
    if (row >= Skv) continue;
    const int64_t off = ((static_cast<int64_t>(b) * Skv + row) * H + h) * D + 2 * (lane % 4);
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = 4 * j + 2 * hr;
        *reinterpret_cast<uint32_t*>(dk + off + pn * 64 + 8 * j) =
            pack_bf16(dka[pn][e], dka[pn][e + 1]);
        *reinterpret_cast<uint32_t*>(dv + off + pn * 64 + 8 * j) =
            pack_bf16(dva[pn][e], dva[pn][e + 1]);
      }
  }
}

// ---------------------------------------------------------------------------
// The wide tensor-core kernels (bf16, d = 512): the delta pre-pass, K2a_wide
// and K2b_wide
// ---------------------------------------------------------------------------

// delta = rowsum(dO * O) in fp32 for one warp's row of one (batch, head):
// the pre-pass of the wide kernels, which read it from [B, H, Sq].
__global__ void __launch_bounds__(NT) flash_bwd_delta_kernel(
    const bf16* __restrict__ o, const bf16* __restrict__ dout, float* __restrict__ delta,
    int H, int Sq, int D, Strides st) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (NT / 32) + warp;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  if (row >= Sq) return;
  const bf16* orow = o + b * st.sb[O] + h * st.sh[O] + static_cast<int64_t>(row) * st.ss[O];
  const bf16* drow =
      dout + b * st.sb[DO] + h * st.sh[DO] + static_cast<int64_t>(row) * st.ss[DO];
  float part = 0.f;
  for (int c = lane; c < D / 8; c += 32)
    part += dot8(*reinterpret_cast<const uint4*>(drow + 8 * c),
                 *reinterpret_cast<const uint4*>(orow + 8 * c));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  if (lane == 0) delta[(static_cast<int64_t>(b) * H + h) * Sq + row] = part;
}

constexpr int WD = 512;  // the wide kernels' head dim

// K2a_wide: dq for 64 query rows of one (batch, head) at d = 512. Warpgroup 0
// computes S = Q.K^T and warpgroup 1 dP = dO.V^T of each 32-row kv tile
// (64 x 32, all 512 dims each); the two swap their accumulators through
// shared memory, each forms p and ds of the whole tile in registers, and
// warpgroup wg adds dS.K to dq's columns [256 wg, 256 wg + 256).
__global__ void __launch_bounds__(NT, 1) flash_bwd_dq_wide_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ delta, const float* __restrict__ lse,
    const bf16* __restrict__ dout, bf16* __restrict__ dq, int H, int Sq, int Skv, Strides st,
    float scale) {
  constexpr int BQ = 64, BK = 32, KS = WD / 16, NP = WD / 64 / 2;
  constexpr uint32_t QT = BQ * WD * 2, KT = BK * WD * 2;  // tile bytes
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t qs = (raw + 1023) & ~1023u, dos = qs + QT, ks = dos + QT, vs = ks + KT;
  // the swap: element i of warpgroup g's thread t at xch[(16 g + i) * 128 + t]
  float* const xch = reinterpret_cast<float*>(smem_raw + (vs + KT - raw));

  const int tid = threadIdx.x;
  const int wg = tid / 128, wt = tid % 128, lane = tid % 32, wrow = wt / 32 * 16 + lane / 4;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  const bf16* qb = q + b * st.sb[Q] + h * st.sh[Q];
  const bf16* kb = k + b * st.sb[K] + h * st.sh[K];
  const bf16* vb = v + b * st.sb[V] + h * st.sh[V];
  const bf16* db = dout + b * st.sb[DO] + h * st.sh[DO];

  // each warpgroup copies the operands of its own product: q and the k
  // tiles (warpgroup 0), dO and the v tiles (warpgroup 1); dQ's reads of a k
  // tile follow the block barrier after the products
  if (wg == 0) {
    load_tile<BQ, WD, 128>(qs, qb, st.ss[Q], q0, Sq, wt);
    load_tile<BK, WD, 128>(ks, kb, st.ss[K], 0, Skv, wt);
  } else {
    load_tile<BQ, WD, 128>(dos, db, st.ss[DO], q0, Sq, wt);
    load_tile<BK, WD, 128>(vs, vb, st.ss[V], 0, Skv, wt);
  }
  cp_async_commit();

  float lse2[2], dl[2];  // lse in log2 units and delta of this thread's two rows
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + wrow + 8 * hr;
    lse2[hr] = row < Sq ? lse[bh * Sq + row] * LOG2E : 0.f;
    dl[hr] = row < Sq ? delta[bh * Sq + row] : 0.f;
  }

  float acc[NP][32], mine[16], other[16];
#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[pn][i] = 0.f;
  const float scale2 = scale * LOG2E;
  const uint32_t a_tile = wg == 0 ? qs : dos, b_tile = wg == 0 ? ks : vs;
  const int nt = (Skv + BK - 1) / BK;

  for (int t = 0; t < nt; ++t) {
    cp_async_wait<0>();  // this warpgroup's k (or v) tile t, and on t = 0 q (or dO)
    fence_proxy_async();
    warpgroup_sync(1 + wg);

    // S = Q.K^T (warpgroup 0) or dP = dO.V^T (warpgroup 1)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss_n32(mine, desc_k<BQ>(a_tile, 0, kk), desc_k<BK>(b_tile, 0, kk), kk);
    wgmma_commit();
    wgmma_wait();
    fence_acc(mine);
    if (wg == 1) {  // done with v tile t: the next one loads under the swap and dQ
      warpgroup_sync(2);
      if (t + 1 < nt) load_tile<BK, WD, 128>(vs, vb, st.ss[V], (t + 1) * BK, Skv, wt);
      cp_async_commit();
    }

#pragma unroll
    for (int i = 0; i < 16; ++i) xch[(16 * wg + i) * 128 + wt] = mine[i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 16; ++i) other[i] = xch[(16 * (1 - wg) + i) * 128 + wt];

    // p = exp(s * d^-1/2 - lse) (0 past Skv), ds = p * (dp - delta) * d^-1/2
    // rounded to bf16 as the A fragments of dQ += dS.K
    uint32_t a[2][4];
    const int col0 = t * BK + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const int hr = (i / 2) % 2;
      const int col = col0 + 8 * (i / 4);
      const float s0 = wg == 0 ? mine[i] : other[i], s1 = wg == 0 ? mine[i + 1] : other[i + 1];
      const float d0 = wg == 0 ? other[i] : mine[i], d1 = wg == 0 ? other[i + 1] : mine[i + 1];
      const float p0 = col < Skv ? exp2f(fmaf(s0, scale2, -lse2[hr])) : 0.f;
      const float p1 = col + 1 < Skv ? exp2f(fmaf(s1, scale2, -lse2[hr])) : 0.f;
      a[i / 8][(i % 8) / 2] = pack_bf16(p0 * (d0 - dl[hr]) * scale, p1 * (d1 - dl[hr]) * scale);
    }

    wgmma_fence();
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(acc[pn], a[kk], desc_mn<BK>(ks, wg * NP + pn, kk));
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) fence_acc(acc[pn]);
    __syncthreads();  // both warpgroups are done with k tile t and with the swap
    if (wg == 0) {
      if (t + 1 < nt) load_tile<BK, WD, 128>(ks, kb, st.ss[K], (t + 1) * BK, Skv, wt);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + wrow + 8 * hr;
    if (row >= Sq) continue;
    bf16* out = dq + ((static_cast<int64_t>(b) * Sq + row) * H + h) * WD + wg * NP * 64 +
                2 * (lane % 4);
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(out + pn * 64 + 8 * j) =
            pack_bf16(acc[pn][4 * j + 2 * hr], acc[pn][4 * j + 2 * hr + 1]);
  }
}

// K2b_wide: dk and dv for 32 kv rows of one (batch, head) at d = 512, as the
// transposed products dK^T += Q^T.dS and dV^T += dO^T.P (512 x 32 each).
// Per 64-row q tile: warpgroup 0 computes S = Q.K^T and warpgroup 1 dP =
// dO.V^T (64 x 32); warpgroup 0 forms p and writes P^T (bf16) for
// warpgroup 1, warpgroup 1 hands dP over through shared memory, warpgroup 0
// forms dS^T (bf16); then warpgroup 0 accumulates dK^T and warpgroup 1 dV^T,
// each over all 512 dims (8 M tiles of 64, 128 registers a thread).
__global__ void __launch_bounds__(NT, 1) flash_bwd_dkv_wide_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ delta, const float* __restrict__ lse,
    const bf16* __restrict__ dout, bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Sq,
    int Skv, Strides st, float scale) {
  constexpr int BKV = 32, BQ = 64, KS = WD / 16, MT = WD / 64;
  constexpr uint32_t KT = BKV * WD * 2, QT = BQ * WD * 2, PT = BKV * BQ * 2;  // tile bytes
  constexpr int SROW = WD + 8;  // the output staging's row, in bf16 (16 bytes of pad)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ks = (raw + 1023) & ~1023u, vs = ks + KT, qs = vs + KT, dos = qs + QT;
  const uint32_t pts = dos + QT;   // stage s: P^T [32 kv][64 q] at pts + PT * s
  const uint32_t dss = pts + 2 * PT;  // dS^T [32 kv][64 q]
  // the generic pointer of a shared address
  auto at = [&](uint32_t addr) { return smem_raw + (addr - raw); };
  float* const xch = reinterpret_cast<float*>(at(dss + PT));  // [2][16][128]: dP's swap

  const int tid = threadIdx.x;
  const int wg = tid / 128, wt = tid % 128, lane = tid % 32, wrow = wt / 32 * 16 + lane / 4;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kv0 = blockIdx.x * BKV;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  const bf16* qb = q + b * st.sb[Q] + h * st.sh[Q];
  const bf16* kb = k + b * st.sb[K] + h * st.sh[K];
  const bf16* vb = v + b * st.sb[V] + h * st.sh[V];
  const bf16* db = dout + b * st.sb[DO] + h * st.sh[DO];

  // warpgroup 0 copies k and the q tiles, warpgroup 1 v and the dO tiles
  if (wg == 0) {
    load_tile<BKV, WD, 128>(ks, kb, st.ss[K], kv0, Skv, wt);
    load_tile<BQ, WD, 128>(qs, qb, st.ss[Q], 0, Sq, wt);
  } else {
    load_tile<BKV, WD, 128>(vs, vb, st.ss[V], kv0, Skv, wt);
    load_tile<BQ, WD, 128>(dos, db, st.ss[DO], 0, Sq, wt);
  }
  cp_async_commit();

  float acc[MT][16], mine[16];  // dK^T (warpgroup 0) or dV^T (warpgroup 1)
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[m][i] = 0.f;
  const float scale2 = scale * LOG2E;
  const uint32_t a_tile = wg == 0 ? qs : dos, b_tile = wg == 0 ? ks : vs;
  const int nt = (Sq + BQ - 1) / BQ;
  // the byte of accumulator element i (q row wrow + 8 ((i/2) % 2), kv column
  // 8 (i/4) + 2 (lane % 4) + i % 2 of the 64 x 32 tile) in a [32 kv][64 q] tile
  auto transposed = [&](int i) {
    const int qc = wrow + 8 * ((i / 2) % 2);
    return chunk_off<BKV>(8 * (i / 4) + 2 * (lane % 4) + i % 2, qc / 8) + (qc % 8) * 2;
  };

  for (int t = 0; t < nt; ++t) {
    const int stage = t & 1;
    const uint32_t pt = pts + PT * stage;
    float* const x = xch + stage * 16 * 128;
    float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
    bool valid[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = t * BQ + wrow + 8 * hr;
      valid[hr] = row < Sq;
      if (wg == 0 && valid[hr]) {
        lse2[hr] = lse[bh * Sq + row] * LOG2E;
        dl[hr] = delta[bh * Sq + row];
      }
    }
    cp_async_wait<0>();  // this warpgroup's q (or dO) tile t, and on t = 0 k (or v)
    fence_proxy_async();
    warpgroup_sync(1 + wg);

    // S = Q.K^T (warpgroup 0) or dP = dO.V^T (warpgroup 1): 64 q x 32 kv
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss_n32(mine, desc_k<BQ>(a_tile, 0, kk), desc_k<BKV>(b_tile, 0, kk), kk);
    wgmma_commit();
    wgmma_wait();
    fence_acc(mine);

    if (wg == 0) {  // p = exp(s * d^-1/2 - lse) (0 for q rows past Sq) into P^T
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        mine[i] = valid[(i / 2) % 2] ? exp2f(fmaf(mine[i], scale2, -lse2[(i / 2) % 2])) : 0.f;
        *reinterpret_cast<bf16*>(at(pt + transposed(i))) = __float2bfloat16(mine[i]);
      }
      fence_proxy_async();
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) x[i * 128 + wt] = mine[i];
    }
    __syncthreads();

    if (wg == 0) {  // ds = p * (dp - delta) * d^-1/2 into dS^T
#pragma unroll
      for (int i = 0; i < 16; ++i)
        *reinterpret_cast<bf16*>(at(dss + transposed(i))) =
            __float2bfloat16(mine[i] * (x[i * 128 + wt] - dl[(i / 2) % 2]) * scale);
      fence_proxy_async();
      warpgroup_sync(1);
    }
    // dK^T += Q^T.dS (warpgroup 0) or dV^T += dO^T.P (warpgroup 1): A is the
    // q (dO) tile read MN-major, B the dS^T (P^T) tile
    const uint32_t bt = wg == 0 ? dss : pt;
    wgmma_fence();
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_ss_n32<1>(acc[m], desc_mn<BQ>(a_tile, m, kk), desc_k<BKV>(bt, 0, kk), 1);
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int m = 0; m < MT; ++m) fence_acc(acc[m]);
    warpgroup_sync(1 + wg);  // done with q (dO) tile t and with dS^T
    if (t + 1 < nt)
      load_tile<BQ, WD, 128>(a_tile, wg == 0 ? qb : db, st.ss[wg == 0 ? Q : DO], (t + 1) * BQ,
                             Sq, wt);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // dK^T (dV^T) staged row-major as [32 kv][SROW] bf16 over this warpgroup's
  // q (dO) tile, then copied out in 16-byte chunks
  uint8_t* const stg = at(a_tile);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int dim = 64 * m + wrow + 8 * ((i / 2) % 2);
      const int r = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
      *reinterpret_cast<bf16*>(stg + (r * SROW + dim) * 2) = __float2bfloat16(acc[m][i]);
    }
  warpgroup_sync(1 + wg);
  bf16* const out = wg == 0 ? dk : dv;
#pragma unroll
  for (int n = 0; n < BKV * (WD / 8) / 128; ++n) {
    const int idx = wt + n * 128, r = idx / (WD / 8), c = idx % (WD / 8);
    const int row = kv0 + r;
    if (row < Skv)
      *reinterpret_cast<uint4*>(out + ((static_cast<int64_t>(b) * Skv + row) * H + h) * WD +
                                8 * c) =
          *reinterpret_cast<const uint4*>(stg + (r * SROW + 8 * c) * 2);
  }
}

}  // namespace tc

using wgmma_tile::allow_smem;

struct Args {
  const void *q, *k, *v, *o, *lse, *dout;
  void *dq, *dk, *dv;
  int B, H, Sq, Skv;
  Strides st;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int NT, int BK>
cudaError_t launch_dq(const Args& a) {
  constexpr int ROWS = NT / (D / 32);
  constexpr int smem = 2 * BK * D * static_cast<int>(sizeof(float));
  auto kernel = flash_bwd_dq_kernel<T, D, NT, BK>;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + ROWS - 1) / ROWS, a.B * a.H);
  kernel<<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.o), static_cast<const float*>(a.lse),
      static_cast<const T*>(a.dout), static_cast<T*>(a.dq), a.H, a.Sq, a.Skv, a.st, a.scale);
  return cudaGetLastError();
}

template <typename T, int D, int NT, int BQ>
cudaError_t launch_dkv(const Args& a) {
  constexpr int ROWS = NT / (D / 32);
  constexpr int smem = (2 * BQ * D + 2 * BQ) * static_cast<int>(sizeof(float));
  auto kernel = flash_bwd_dkv_kernel<T, D, NT, BQ>;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Skv + ROWS - 1) / ROWS, a.B * a.H);
  kernel<<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.o), static_cast<const float*>(a.lse),
      static_cast<const T*>(a.dout), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.Sq,
      a.Skv, a.st, a.scale);
  return cudaGetLastError();
}

// Tile sizes per head dim, as K1's: 128 or 256 threads, 32 dims per lane, and
// tiles of 64 KB (32 KB at d=64) of fp32 k/v (dq) or q/dO (dk/dv) in shared
// memory.
template <typename T>
cudaError_t dispatch(bool dkv, int D, const Args& a) {
  switch (D) {
    case 64: return dkv ? launch_dkv<T, 64, 128, 64>(a) : launch_dq<T, 64, 128, 64>(a);
    case 128: return dkv ? launch_dkv<T, 128, 128, 64>(a) : launch_dq<T, 128, 128, 64>(a);
    case 256: return dkv ? launch_dkv<T, 256, 256, 32>(a) : launch_dq<T, 256, 256, 32>(a);
    case 512: return dkv ? launch_dkv<T, 512, 256, 16>(a) : launch_dq<T, 512, 256, 16>(a);
    default: return cudaErrorInvalidValue;
  }
}

// The tensor-core kernels: 256 threads; 128 rows a block (query rows for dq,
// kv rows for dk/dv); bf16 tiles with 1 KB of slack for the 1024-byte
// alignment of the swizzle.
template <int D>
cudaError_t launch_dq_tc(const Args& a) {
  constexpr int smem = 1024 + (2 * 128 + 4 * 64) * D * 2;  // q, dO; 2 stages of k, v
  auto kernel = tc::flash_bwd_dq_tc_kernel<D>;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + 127) / 128, a.B * a.H);
  kernel<<<grid, tc::NT, smem, a.stream>>>(
      static_cast<const tc::bf16*>(a.q), static_cast<const tc::bf16*>(a.k),
      static_cast<const tc::bf16*>(a.v), static_cast<const tc::bf16*>(a.o),
      static_cast<const float*>(a.lse), static_cast<const tc::bf16*>(a.dout),
      static_cast<tc::bf16*>(a.dq), a.H, a.Sq, a.Skv, a.st, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_tc(const Args& a) {
  // k, v; 2 stages of q, dO, O; lse and delta of both stages
  constexpr int smem = 1024 + (2 * 128 + 6 * 64) * D * 2 + 4 * 64 * 4;
  auto kernel = tc::flash_bwd_dkv_tc_kernel<D>;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Skv + 127) / 128, a.B * a.H);
  kernel<<<grid, tc::NT, smem, a.stream>>>(
      static_cast<const tc::bf16*>(a.q), static_cast<const tc::bf16*>(a.k),
      static_cast<const tc::bf16*>(a.v), static_cast<const tc::bf16*>(a.o),
      static_cast<const float*>(a.lse), static_cast<const tc::bf16*>(a.dout),
      static_cast<tc::bf16*>(a.dk), static_cast<tc::bf16*>(a.dv), a.H, a.Sq, a.Skv, a.st,
      a.scale);
  return cudaGetLastError();
}

// cp.async moves 16 bytes: every row of q, k, v, o and dO must start on a
// 16-byte boundary (pointers, and strides in whole 8-element chunks)
bool rows_aligned(const Args& a) {
  const void* ptrs[5] = {a.q, a.k, a.v, a.o, a.dout};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (int t = 0; t < 5; ++t)
    if (a.st.sb[t] % 8 != 0 || a.st.ss[t] % 8 != 0 || a.st.sh[t] % 8 != 0) return false;
  return true;
}

int run_tc(bool dkv, int dtype, int D, const Args& a) {
  if (a.B <= 0 || a.H <= 0 || a.Sq <= 0 || a.Skv <= 0 || dtype != 1)
    return cudaErrorInvalidValue;
  if (!rows_aligned(a)) return cudaErrorMisalignedAddress;
  cudaError_t err;
  switch (D) {
    case 64: err = dkv ? launch_dkv_tc<64>(a) : launch_dq_tc<64>(a); break;
    case 128: err = dkv ? launch_dkv_tc<128>(a) : launch_dq_tc<128>(a); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The wide kernels: 256 threads; 64 query rows a block (dq: q, dO, one k
// and one v tile of 32 rows, the swap) or 32 kv rows (dk/dv: k, v, one q
// and one dO tile of 64 rows, two stages of P^T, dS^T, two stages of the
// swap); with 1 KB of slack for the swizzle's alignment. a.o holds delta.
cudaError_t launch_dq_wide(const Args& a) {
  constexpr int smem = 1024 + (2 * 64 + 2 * 32) * tc::WD * 2 + 2 * 16 * 128 * 4;
  auto kernel = tc::flash_bwd_dq_wide_kernel;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + 63) / 64, a.B * a.H);
  kernel<<<grid, tc::NT, smem, a.stream>>>(
      static_cast<const tc::bf16*>(a.q), static_cast<const tc::bf16*>(a.k),
      static_cast<const tc::bf16*>(a.v), static_cast<const float*>(a.o),
      static_cast<const float*>(a.lse), static_cast<const tc::bf16*>(a.dout),
      static_cast<tc::bf16*>(a.dq), a.H, a.Sq, a.Skv, a.st, a.scale);
  return cudaGetLastError();
}

cudaError_t launch_dkv_wide(const Args& a) {
  constexpr int smem =
      1024 + (2 * 32 + 2 * 64) * tc::WD * 2 + 3 * 32 * 64 * 2 + 2 * 16 * 128 * 4;
  auto kernel = tc::flash_bwd_dkv_wide_kernel;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Skv + 31) / 32, a.B * a.H);
  kernel<<<grid, tc::NT, smem, a.stream>>>(
      static_cast<const tc::bf16*>(a.q), static_cast<const tc::bf16*>(a.k),
      static_cast<const tc::bf16*>(a.v), static_cast<const float*>(a.o),
      static_cast<const float*>(a.lse), static_cast<const tc::bf16*>(a.dout),
      static_cast<tc::bf16*>(a.dk), static_cast<tc::bf16*>(a.dv), a.H, a.Sq, a.Skv, a.st,
      a.scale);
  return cudaGetLastError();
}

// every row of the operands that the wide kernels copy (q, k, v, dout)
// starts on a 16-byte boundary
bool wide_rows_aligned(const Args& a) {
  const void* ptrs[4] = {a.q, a.k, a.v, a.dout};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  const int copied[4] = {Q, K, V, DO};
  for (int t : copied)
    if (a.st.sb[t] % 8 != 0 || a.st.ss[t] % 8 != 0 || a.st.sh[t] % 8 != 0) return false;
  return true;
}

int run_wide(bool dkv, int dtype, int D, const Args& a) {
  if (a.B <= 0 || a.H <= 0 || a.Sq <= 0 || a.Skv <= 0 || dtype != 1 || D != tc::WD ||
      a.o == nullptr)
    return cudaErrorInvalidValue;
  if (!wide_rows_aligned(a)) return cudaErrorMisalignedAddress;
  return static_cast<int>(dkv ? launch_dkv_wide(a) : launch_dq_wide(a));
}

int run(bool dkv, int dtype, int D, const Args& a) {
  if (a.B <= 0 || a.H <= 0 || a.Sq <= 0 || a.Skv <= 0) return cudaErrorInvalidValue;
  cudaError_t err;
  switch (dtype) {
    case 0: err = dispatch<float>(dkv, D, a); break;
    case 1: err = dispatch<__nv_bfloat16>(dkv, D, a); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

Strides unpack(const long long* st) {
  Strides s;
  for (int t = 0; t < 5; ++t) {
    s.sb[t] = st[3 * t];
    s.ss[t] = st[3 * t + 1];
    s.sh[t] = st[3 * t + 2];
  }
  return s;
}

}  // namespace

extern "C" {

// q, o, dout: [B,Sq,H,D]; k, v: [B,Skv,H,D]; each with unit stride over D.
// strides: 15 values, (batch, seq, head) in elements for q, k, v, o, dout in
// that order. lse: contiguous fp32 [B,H,Sq]. dq (K2a) and dk, dv (K2b):
// contiguous outputs in the input dtype. dtype: 0 fp32, 1 bf16. Each returns a
// cudaError_t (0 on success); the launch is asynchronous.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                           const void* lse, const void* dout, void* dq, int dtype, int B,
                           int H, int Sq, int Skv, int D, const long long* strides,
                           float scale, void* stream) {
  const Args a{q, k, v, o, lse, dout, dq, nullptr, nullptr, B, H, Sq, Skv,
               unpack(strides), scale, static_cast<cudaStream_t>(stream)};
  return run(false, dtype, D, a);
}

int flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* o,
                            const void* lse, const void* dout, void* dk, void* dv, int dtype,
                            int B, int H, int Sq, int Skv, int D, const long long* strides,
                            float scale, void* stream) {
  const Args a{q, k, v, o, lse, dout, nullptr, dk, dv, B, H, Sq, Skv,
               unpack(strides), scale, static_cast<cudaStream_t>(stream)};
  return run(true, dtype, D, a);
}

// The tensor-core entries: the same arguments; bf16 (dtype 1) at D = 64 or
// 128 only, with every row of q, k, v, o and dout 16-byte aligned (else
// cudaErrorInvalidValue, cudaErrorMisalignedAddress).
int flash_attention_bwd_dq_tc(const void* q, const void* k, const void* v, const void* o,
                              const void* lse, const void* dout, void* dq, int dtype, int B,
                              int H, int Sq, int Skv, int D, const long long* strides,
                              float scale, void* stream) {
  const Args a{q, k, v, o, lse, dout, dq, nullptr, nullptr, B, H, Sq, Skv,
               unpack(strides), scale, static_cast<cudaStream_t>(stream)};
  return run_tc(false, dtype, D, a);
}

int flash_attention_bwd_dkv_tc(const void* q, const void* k, const void* v, const void* o,
                               const void* lse, const void* dout, void* dk, void* dv,
                               int dtype, int B, int H, int Sq, int Skv, int D,
                               const long long* strides, float scale, void* stream) {
  const Args a{q, k, v, o, lse, dout, nullptr, dk, dv, B, H, Sq, Skv,
               unpack(strides), scale, static_cast<cudaStream_t>(stream)};
  return run_tc(true, dtype, D, a);
}

// The wide tensor-core entries (K2a_wide, K2b_wide): the arguments of the
// entries above with delta (contiguous fp32 [B,H,Sq], from
// flash_attention_bwd_delta) in o's place; o's strides are not read. bf16
// (dtype 1) at D = 512 only, with every row of q, k, v and dout 16-byte
// aligned (else cudaErrorInvalidValue, cudaErrorMisalignedAddress).
int flash_attention_bwd_dq_wide_tc(const void* q, const void* k, const void* v,
                                   const void* delta, const void* lse, const void* dout,
                                   void* dq, int dtype, int B, int H, int Sq, int Skv, int D,
                                   const long long* strides, float scale, void* stream) {
  const Args a{q, k, v, delta, lse, dout, dq, nullptr, nullptr, B, H, Sq, Skv,
               unpack(strides), scale, static_cast<cudaStream_t>(stream)};
  return run_wide(false, dtype, D, a);
}

int flash_attention_bwd_dkv_wide_tc(const void* q, const void* k, const void* v,
                                    const void* delta, const void* lse, const void* dout,
                                    void* dk, void* dv, int dtype, int B, int H, int Sq, int Skv,
                                    int D, const long long* strides, float scale, void* stream) {
  const Args a{q, k, v, delta, lse, dout, nullptr, dk, dv, B, H, Sq, Skv,
               unpack(strides), scale, static_cast<cudaStream_t>(stream)};
  return run_wide(true, dtype, D, a);
}

// The wide kernels' pre-pass: delta = rowsum(dout * o) in fp32 into a
// contiguous [B,H,Sq]. o, dout: bf16 (dtype 1) [B,Sq,H,D], D a multiple of
// 8, every row 16-byte aligned; strides: 6 values, (batch, seq, head) in
// elements for o, then dout.
int flash_attention_bwd_delta(const void* o, const void* dout, void* delta, int dtype, int B,
                              int H, int Sq, int D, const long long* strides, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || D <= 0 || D % 8 != 0 || dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st{};
  st.sb[O] = strides[0], st.ss[O] = strides[1], st.sh[O] = strides[2];
  st.sb[DO] = strides[3], st.ss[DO] = strides[4], st.sh[DO] = strides[5];
  if (reinterpret_cast<uintptr_t>(o) % 16 != 0 || reinterpret_cast<uintptr_t>(dout) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  for (int i = 0; i < 6; ++i)
    if (strides[i] % 8 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  const dim3 grid((Sq + tc::NT / 32 - 1) / (tc::NT / 32), B * H);
  tc::flash_bwd_delta_kernel<<<grid, tc::NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const tc::bf16*>(o), static_cast<const tc::bf16*>(dout),
      static_cast<float*>(delta), H, Sq, D, st);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
