// Fused GEGLU feed-forward for Hopper (sm_90a):
//   out = (a * gelu_erf(g)) @ W2^T + b2,  [a, g] = x @ W1^T + b1.
//
// Replaces the Pallas TPU kernel diffbir_tpu/ops/fused_ffn.py::_kernel
// (launched by _fused_ffn_impl). Same rounding points: h = x @ W1 + b1 in
// fp32 (never rounded to the input dtype), the exact-erf GELU in fp32
// (erff; the TPU kernel's rational erf was a Mosaic workaround),
// act = a * (0.5 * g * (1 + erf(g / sqrt 2))) rounded to the input dtype
// before the second product, then fp32 accumulation, + b2 in fp32, one cast.
// The biases come in the input dtype (the serving model's) and enter the
// fp32 sums exactly. Weights stay in PyTorch's Linear layout ([out, in]): no
// repacking.
//
// The TPU kernel keeps its row block's h and act in VMEM with all 39 MB of
// weights resident (d = 1280); 228 KB of shared memory cannot hold those
// weights, so here act [N, inner] makes one round trip through device
// memory (~21 MB, ~6 us at N = 8192, d = 320), in two launches:
//   1. geglu: one block owns a 128 x 64 tile of act and accumulates the
//      matching a columns (W1 rows n) and g columns (W1 rows inner + n) side
//      by side, so the GELU gate is applied in the epilogue and only act is
//      written; the (N, 2 inner) h never leaves the registers.
//   2. down: act @ W2^T + b2.
//
// Two designs, each with its own entry (ops/fused_ffn.py::ffn_entries):
// - fused_ffn_tc, bf16 (every serving site), on the tensor cores: both
//   launches run the main loop of wgmma_gemm.cuh with the weight rows as a
//   K-major B staged as they are. In the geglu launch the B tile's 128 rows
//   are W1 rows [n0, n0 + 64) and [inner + n0, inner + n0 + 64), so the a
//   and g accumulators of one output element sit in the same thread; the
//   down launch takes a 128-wide tile too (masked at d = 320, where it ran
//   faster on an H100 than a 64-wide one).
//   Epilogues stage their tile in shared memory and write it 16 bytes a
//   thread along rows.
// - fused_ffn, fp32 (and any width), on the CUDA cores: the 64 x 64 tile of
//   tile_gemm.cuh. The JAX kernel's fp32 products are fp32, which the bf16
//   tensor cores do not give.
//
// What bounds it on an H100: 16 N d inner flops against reading x, the
// weights and act; at the serving shapes (N = 8192 rows at d = 320) it is
// compute-bound (0.0204 ms at the bf16 tensor-core peak).

#include <atomic>

#include "tile_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using tile::BK;
using tile::BM;
using tile::BN;
using tile::NT;

// a[kk][r] = A[mb + r, kb + kk] for a row-major [M, K] A (zero past the edges)
template <typename T>
__device__ __forceinline__ void load_rows(float (*a)[BM], const T* __restrict__ A, int mb,
                                          int kb, int M, int K) {
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int e = threadIdx.x + p * NT;
    const int r = e / BK, kk = e % BK;
    const int m = mb + r, k = kb + kk;
    a[kk][r] = (m < M && k < K) ? tile::to_f32<T>(A[(int64_t)m * K + k]) : 0.f;
  }
}

// b[kk][c] = W[row0 + c, kb + kk] for a row-major [rows, K] W whose rows are
// the output columns (zero past row_end or K)
template <typename T>
__device__ __forceinline__ void load_cols(float (*b)[BN], const T* __restrict__ W, int row0,
                                          int row_end, int kb, int K) {
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int e = threadIdx.x + p * NT;
    const int c = e / BK, kk = e % BK;
    const int r = row0 + c, k = kb + kk;
    b[kk][c] = (r < row_end && k < K) ? tile::to_f32<T>(W[(int64_t)r * K + k]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) geglu_kernel(
    const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
    T* __restrict__ act, int N, int d, int inner) {
  __shared__ __align__(16) float as[BK][BM];
  __shared__ __align__(16) float ba[BK][BN];
  __shared__ __align__(16) float bg[BK][BN];
  const int tid = threadIdx.x;
  const int tn = tid % 16, tm = tid / 16;
  const int mb = blockIdx.y * BM, nb = blockIdx.x * BN;
  float acc_a[4][4], acc_g[4][4];
  tile::zero(acc_a);
  tile::zero(acc_g);
  for (int kb = 0; kb < d; kb += BK) {
    load_rows<T>(as, x, mb, kb, N, d);
    load_cols<T>(ba, w1, nb, inner, kb, d);
    load_cols<T>(bg, w1, inner + nb, 2 * inner, kb, d);
    __syncthreads();
    tile::fma_tile(as, ba, tm * 4, tn * 4, acc_a);
    tile::fma_tile(as, bg, tm * 4, tn * 4, acc_g);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = mb + tm * 4 + i;
    if (m >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = nb + tn * 4 + j;
      if (n >= inner) continue;
      const float a = acc_a[i][j] + tile::to_f32<T>(b1[n]);
      const float g = acc_g[i][j] + tile::to_f32<T>(b1[inner + n]);
      const float gelu = 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
      act[(int64_t)m * inner + n] = tile::from_f32<T>(a * gelu);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) down_kernel(
    const T* __restrict__ act, const T* __restrict__ w2, const T* __restrict__ b2,
    T* __restrict__ out, int N, int d, int inner) {
  __shared__ __align__(16) float as[BK][BM];
  __shared__ __align__(16) float bs[BK][BN];
  const int tid = threadIdx.x;
  const int tn = tid % 16, tm = tid / 16;
  const int mb = blockIdx.y * BM, nb = blockIdx.x * BN;
  float acc[4][4];
  tile::zero(acc);
  for (int kb = 0; kb < inner; kb += BK) {
    load_rows<T>(as, act, mb, kb, N, inner);
    load_cols<T>(bs, w2, nb, d, kb, inner);
    __syncthreads();
    tile::fma_tile(as, bs, tm * 4, tn * 4, acc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = mb + tm * 4 + i;
    if (m >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = nb + tn * 4 + j;
      if (n < d)
        out[(int64_t)m * d + n] = tile::from_f32<T>(acc[i][j] + tile::to_f32<T>(b2[n]));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, void* act, void* out, int N, int d, int inner,
                   cudaStream_t stream) {
  const dim3 g1((inner + BN - 1) / BN, (N + BM - 1) / BM);
  geglu_kernel<T><<<g1, NT, 0, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w1),
                                         static_cast<const T*>(b1), static_cast<T*>(act), N, d,
                                         inner);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 g2((d + BN - 1) / BN, (N + BM - 1) / BM);
  down_kernel<T><<<g2, NT, 0, stream>>>(static_cast<const T*>(act), static_cast<const T*>(w2),
                                        static_cast<const T*>(b2), static_cast<T*>(out), N, d,
                                        inner);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the tensor-core design (bf16)
// ---------------------------------------------------------------------------
namespace tc {

using namespace wgmma_gemm;
using wgmma_gemm::BK;  // not tile_gemm.cuh's, which the names above bring in
using wgmma_gemm::BM;
using wgmma_gemm::NT;

constexpr int NP = 2;  // 64-column panels of a tile: 128 rows of B
constexpr int BN = NP * 64;

// A ring slot: the A tile, then the [BN][BK] K-major B tile.
struct Layout {
  static constexpr uint32_t STAGE = A_BYTES + BN * BK * 2;
  static constexpr int SMEM = 1024 + STAGES * STAGE;
};

__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
}

// act[m, n0 + c] for a 128 x 64 tile: a from W1 rows n0 + c, g from rows
// inner + n0 + c (B tile rows 64 + c).
__global__ void __launch_bounds__(NT, 2) geglu_tc_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w1, const bf16* __restrict__ b1,
    bf16* __restrict__ act, int N, int d, int inner) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  uint8_t* const ring_g = smem_raw + (ring - raw);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * 64;

  auto load_stage = [&](int t, uint32_t slot) {
    const int k0 = t * BK;
    load_a(slot, ring_g + (slot - ring), x, d, m0, N, k0, d, tid);
    wgmma_gemm::load_rows<BN, BK>(
        slot + A_BYTES,
        [&](int r) -> const bf16* {
          const int n = n0 + r % 64;
          return n < inner ? w1 + static_cast<int64_t>(n + (r / 64) * inner) * d : nullptr;
        },
        k0, d, w1, tid);
  };
  float acc[NP][32];
#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[pn][i] = 0.f;
  mainloop<NP, false>(ring, Layout::STAGE, (d + BK - 1) / BK, load_stage, StagedB(), acc);

  // act = (a + b1[n]) * gelu(g + b1[inner + n]) in fp32, one rounding
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int col = acc_col(0, i), n = n0 + col;
    float2 ba = make_float2(0.f, 0.f), bg = ba;
    if (n < inner) {
      ba = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + n));
      bg = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + inner + n));
    }
    stage_pair<bf16, 64>(ring_g, acc_row(i), col,
                         (acc[0][i] + ba.x) * gelu_erf(acc[1][i] + bg.x),
                         (acc[0][i + 1] + ba.y) * gelu_erf(acc[1][i + 1] + bg.y));
  }
  __syncthreads();
  store_tile<bf16, 64>(ring_g, act, inner, m0, n0, N, inner, tid);
}

// out[m, n0 + c] = act . W2^T + b2 for a 128 x 128 tile
__global__ void __launch_bounds__(NT, 2) down_tc_kernel(
    const bf16* __restrict__ act, const bf16* __restrict__ w2, const bf16* __restrict__ b2,
    bf16* __restrict__ out, int N, int d, int inner) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  uint8_t* const ring_g = smem_raw + (ring - raw);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load_stage = [&](int t, uint32_t slot) {
    const int k0 = t * BK;
    load_a(slot, ring_g + (slot - ring), act, inner, m0, N, k0, inner, tid);
    wgmma_gemm::load_rows<BN, BK>(
        slot + A_BYTES,
        [&](int r) -> const bf16* {
          return n0 + r < d ? w2 + static_cast<int64_t>(n0 + r) * inner : nullptr;
        },
        k0, inner, w2, tid);
  };
  float acc[NP][32];
#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[pn][i] = 0.f;
  mainloop<NP, false>(ring, Layout::STAGE, (inner + BK - 1) / BK, load_stage, StagedB(), acc);

#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int col = acc_col(pn, i), n = n0 + col;
      const float2 bias =
          n < d ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b2 + n))
                : make_float2(0.f, 0.f);
      stage_pair<bf16, BN>(ring_g, acc_row(i), col, acc[pn][i] + bias.x,
                           acc[pn][i + 1] + bias.y);
    }
  __syncthreads();
  store_tile<bf16, BN>(ring_g, out, d, m0, n0, N, d, tid);
}

cudaError_t launch(const bf16* x, const bf16* w1, const bf16* b1, const bf16* w2,
                   const bf16* b2, bf16* act, bf16* out, int N, int d, int inner,
                   cudaStream_t stream) {
  static std::atomic<uint64_t> geglu_set{0}, down_set{0};
  cudaError_t err = allow_smem(geglu_tc_kernel, Layout::SMEM, geglu_set);
  if (err == cudaSuccess) err = allow_smem(down_tc_kernel, Layout::SMEM, down_set);
  if (err != cudaSuccess) return err;
  geglu_tc_kernel<<<dim3((inner + 63) / 64, (N + BM - 1) / BM), NT, Layout::SMEM, stream>>>(
      x, w1, b1, act, N, d, inner);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  down_tc_kernel<<<dim3((d + BN - 1) / BN, (N + BM - 1) / BM), NT, Layout::SMEM, stream>>>(
      act, w2, b2, out, N, d, inner);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// x: contiguous [N, d]; w1: contiguous [2 inner, d] (rows [0, inner) the
// value half a, rows [inner, 2 inner) the gate g); b1: [2 inner]; w2:
// contiguous [d, inner]; b2: [d]; act: scratch [N, inner]; out: [N, d]. All
// share one dtype (0 fp32, 1 bf16). Returns a cudaError_t (0 on success);
// both launches are asynchronous.
int fused_ffn(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
              void* act, void* out, int dtype, int N, int d, int inner, void* stream) {
  if (N <= 0 || d <= 0 || inner <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch<float>(x, w1, b1, w2, b2, act, out, N, d, inner, s); break;
    case 1: err = launch<__nv_bfloat16>(x, w1, b1, w2, b2, act, out, N, d, inner, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The tensor-core design: the arguments of fused_ffn, bf16 only (dtype 1),
// with d a multiple of 8 and every pointer 16-byte aligned (else
// cudaErrorInvalidValue, cudaErrorMisalignedAddress).
int fused_ffn_tc(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                 void* act, void* out, int dtype, int N, int d, int inner, void* stream) {
  if (N <= 0 || d <= 0 || inner <= 0 || dtype != 1) return cudaErrorInvalidValue;
  const void* ptrs[7] = {x, w1, b1, w2, b2, act, out};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorMisalignedAddress;
  if (d % 8 != 0 || inner % 8 != 0) return cudaErrorMisalignedAddress;
  typedef __nv_bfloat16 T;
  return static_cast<int>(tc::launch(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<T*>(act),
      static_cast<T*>(out), N, d, inner, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
