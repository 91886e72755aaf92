// int8 weight-only matmul for Hopper (sm_90a): out[M,N] = x[M,K] @ w_q[K,N] * scale[N].
//
// Replaces the Pallas TPU kernel diffbir_tpu/ops/quant_matmul.py::_kernel
// (launched by _pallas_quant_matmul). Same math: x is rounded to bf16 (for a
// bf16 or an fp32 x), the int8 weight enters as its exact value, the
// products accumulate in fp32 over the whole of K, the per-column fp32 scale
// multiplies the accumulator once after the K loop, and the result is cast
// to x's dtype. w_q stays in the JAX package's [K, N] layout, so both
// packages read one tensor.
//
// Three entries (ops/quant_matmul.py::quant_entries picks by M):
// - quant_matmul_tc, the tile form for M > 8 (the UNet/ControlNet sites at
//   M = 8192 ... 128 and the 154 text rows, the captioner's 624-row
//   prefill), on the tensor cores: the main loop of wgmma_gemm.cuh, a
//   128 x 128 tile per block (masked at the 320-wide sites, where it ran as
//   fast as a 64-wide tile or faster on an H100 at every site of the int8
//   path but the 154-row text sites). The int8 B tile is staged by cp.async
//   as bytes; after it lands the warps dequantise it into the swizzled bf16
//   MN-major tile that wgmma reads through the transpose bit (one extra
//   shared-memory pass per stage; the int8 -> bf16 conversion is exact and
//   bitwise: no I2F). bf16(x) x int8 is exact in fp32, so the bf16 tensor
//   cores give the kernel's products for fp32 x too (its A loader rounds x
//   on the way). The other reading, C^T = W^T . x^T with the dequantised
//   weight as register A fragments, was not taken: a thread's A fragment
//   pairs two K rows of w_q (N bytes apart), and C^T's accumulators would
//   store the output transposed, against the 16-byte row stores that the
//   output-bound sites need. The epilogue multiplies by scale[n], rounds
//   once, stages the tile in shared memory and writes it 16 bytes a thread
//   along rows.
// - quant_matmul_gemv, the GEMV form for M <= 8 (the captioner's decode at
//   M = 1, the UNet's timestep-embedding rows at M = 2): bound by reading
//   the weight once. A block owns 128 columns and a split of K; each thread
//   streams 16-byte loads of 16 consecutive columns of one row of w_q, four
//   in flight, 32 rows apart (a warp reads four 128-byte row segments); x's
//   rows sit in shared memory. The 32 row lanes of a block are summed by
//   shuffles and through shared memory in a fixed order; where K is split
//   across blocks (so the grid has ~4 blocks per SM) the partial sums go to
//   a scratch [splits, M, N] and a second kernel adds them in split order
//   and applies the scale. No atomics: reruns are bit-identical.
// - quant_matmul, the first CUDA-core version (64 x 64 tile of fp32 FMAs,
//   tile_gemm.cuh), kept as the yardstick the new entries are timed beside;
//   no path launches it.
//
// What bounds it on an H100: at M = 8192, K = 320, N = 2560 writing the 42 MB
// bf16 output (0.0143 ms at 3.35 TB/s); at (624, 4096, 4096) the tensor-core
// flops; at M <= 8 reading the int8 weight (16.8 MB at (1, 4096, 4096):
// 0.0050 ms).

#include <atomic>

#include "tile_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using tile::BK;
using tile::BM;
using tile::BN;
using tile::NT;

template <typename T>
__global__ void __launch_bounds__(NT) quant_matmul_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ wq, const float* __restrict__ scale,
    T* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) float as[BK][BM];
  __shared__ __align__(16) float bs[BK][BN];
  const int tid = threadIdx.x;
  const int tn = tid % 16, tm = tid / 16;
  const int mb = blockIdx.y * BM, nb = blockIdx.x * BN;
  float acc[4][4];
  tile::zero(acc);

  for (int kb = 0; kb < K; kb += BK) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int e = tid + p * NT;
      const int r = e / BK, kk = e % BK;  // x: 16 consecutive k of one row
      const int m = mb + r, k = kb + kk;
      as[kk][r] = (m < M && k < K)
                      ? tile::round_to<__nv_bfloat16>(tile::to_f32<T>(x[(int64_t)m * K + k]))
                      : 0.f;
      const int kr = e / BN, n = nb + e % BN;  // w_q: 64 consecutive n of one row
      const int kw = kb + kr;
      bs[kr][e % BN] = (kw < K && n < N) ? tile::to_f32<int8_t>(wq[(int64_t)kw * N + n]) : 0.f;
    }
    __syncthreads();
    tile::fma_tile(as, bs, tm * 4, tn * 4, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = mb + tm * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = nb + tn * 4 + j;
      if (n < N) out[(int64_t)m * N + n] = tile::from_f32<T>(acc[i][j] * scale[n]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const int8_t* wq, const float* scale, void* out, int M,
                   int N, int K, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  quant_matmul_kernel<T><<<grid, NT, 0, stream>>>(static_cast<const T*>(x), wq, scale,
                                                  static_cast<T*>(out), M, N, K);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tile form on the tensor cores
// ---------------------------------------------------------------------------
namespace tc {

using namespace wgmma_gemm;
using wgmma_gemm::BK;  // not tile_gemm.cuh's, which the names above bring in
using wgmma_gemm::BM;
using wgmma_gemm::NT;

constexpr int NP = 2;  // 64-column panels of the tile
constexpr int BN = NP * 64;

// The ring slot: the A tile, then BK rows of BN int8 bytes; after the ring
// the dequantised bf16 B tile [BK][BN].
struct Layout {
  static constexpr uint32_t RAW = BK * BN;
  static constexpr uint32_t STAGE = A_BYTES + RAW;
  static constexpr int SMEM = 1024 + STAGES * STAGE + BK * BN * 2;
  static_assert(STAGE % 1024 == 0, "slots must keep the swizzle's alignment");
  static_assert(OutTile<float, BN>::BYTES <= STAGES * STAGE, "the output tile must fit the ring");
};

template <typename T>
__global__ void __launch_bounds__(NT, 2) quant_matmul_tc_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ wq, const float* __restrict__ scale,
    T* __restrict__ out, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  uint8_t* const ring_g = smem_raw + (ring - raw);
  const uint32_t bbuf = ring + STAGES * Layout::STAGE;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load_stage = [&](int t, uint32_t slot) {
    const int k0 = t * BK;
    load_a(slot, ring_g + (slot - ring), x, K, m0, M, k0, K, tid);
    constexpr int CH = BN / 16;  // 16-byte chunks of a w_q row segment
#pragma unroll
    for (int n = 0; n < BK * CH / NT; ++n) {
      const int i = tid + n * NT;
      const int k = i / CH, c = i % CH;
      const bool full = k0 + k < K && n0 + 16 * c < N;
      cp_async16(slot + A_BYTES + k * BN + 16 * c,
                 full ? wq + static_cast<int64_t>(k0 + k) * N + n0 + 16 * c : wq, full);
    }
  };
  auto stage_b = [&](uint32_t slot) {
    __syncthreads();  // every thread's copies of the stage have landed
    dequant_tile<BN>(ring_g + (slot + A_BYTES - ring), ring_g + (bbuf - ring), tid);
    fence_proxy_async();
    __syncthreads();
    return bbuf;
  };
  float acc[NP][32];
#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[pn][i] = 0.f;
  mainloop<NP, true>(ring, Layout::STAGE, (K + BK - 1) / BK, load_stage, stage_b, acc);

  // out = acc * scale[n], one rounding to T, staged, then row stores
#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int col = acc_col(pn, i);
      const float2 s = n0 + col < N ? *reinterpret_cast<const float2*>(scale + n0 + col)
                                    : make_float2(0.f, 0.f);
      stage_pair<T, BN>(ring_g, acc_row(i), col, acc[pn][i] * s.x, acc[pn][i + 1] * s.y);
    }
  __syncthreads();
  store_tile<T, BN>(ring_g, out, N, m0, n0, M, N, tid);
}

template <typename T>
cudaError_t launch(const void* x, const int8_t* wq, const float* scale, void* out, int M, int N,
                   int K, cudaStream_t stream) {
  auto kernel = quant_matmul_tc_kernel<T>;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err = allow_smem(kernel, Layout::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, NT, Layout::SMEM, stream>>>(static_cast<const T*>(x), wq, scale,
                                                  static_cast<T*>(out), M, N, K);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// GEMV form (M <= 8)
// ---------------------------------------------------------------------------
namespace gemv {

constexpr int NT = 256;
constexpr int COLS = 128;          // columns per block: 8 chunks of 16
constexpr int LANES_K = NT / 8;    // rows of w_q read at once by a block
constexpr int UNROLL = 4;          // 16-byte loads in flight per thread
constexpr int MAX_ROWS = 2048;     // rows of K per split (x's shared copy)

template <typename T>
__device__ __forceinline__ float bf16_value(T v) {
  return tile::round_to<__nv_bfloat16>(tile::to_f32<T>(v));
}

// One block: columns [128 bx, 128 bx + 128) and rows [ks * by, ks * (by + 1))
// of w_q; MB >= M rows of x (the rows past M are zeros). Shared memory: x's
// rows of the split as fp32 [MB][ks], then the warps' sums [8][MB][128].
template <typename T, int MB>
__global__ void __launch_bounds__(NT) gemv_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ wq, const float* __restrict__ scale,
    float* __restrict__ part, T* __restrict__ out, int M, int N, int K, int ks) {
  extern __shared__ float gsm[];
  float* xs = gsm;
  float* red = gsm + MB * ks;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int chunk = tid % 8, krow = tid / 8;
  const int n0 = blockIdx.x * COLS + 16 * chunk;
  const int k0 = blockIdx.y * ks, k1 = min(K, k0 + ks);
  for (int i = tid; i < MB * ks; i += NT) {
    const int m = i / ks, k = k0 + i % ks;
    xs[i] = m < M && k < k1 ? bf16_value(x[static_cast<int64_t>(m) * K + k]) : 0.f;
  }
  __syncthreads();

  float acc[MB][16];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[m][e] = 0.f;
  if (n0 < N) {
    for (int k = k0 + krow; k < k1; k += LANES_K * UNROLL) {
      uint4 w[UNROLL];
#pragma unroll
      for (int j = 0; j < UNROLL; ++j)
        w[j] = k + LANES_K * j < k1
                   ? __ldg(reinterpret_cast<const uint4*>(
                         wq + static_cast<int64_t>(k + LANES_K * j) * N + n0))
                   : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        if (k + LANES_K * j >= k1) break;
        float f[16];
        wgmma_gemm::i8x4_to_f32(w[j].x, f);
        wgmma_gemm::i8x4_to_f32(w[j].y, f + 4);
        wgmma_gemm::i8x4_to_f32(w[j].z, f + 8);
        wgmma_gemm::i8x4_to_f32(w[j].w, f + 12);
        const int kx = k + LANES_K * j - k0;
#pragma unroll
        for (int m = 0; m < MB; ++m) {
          const float xv = xs[m * ks + kx];
#pragma unroll
          for (int e = 0; e < 16; ++e) acc[m][e] = fmaf(xv, f[e], acc[m][e]);
        }
      }
    }
  }
  // the four row lanes of a warp that share a chunk (lanes l, l^8, l^16,
  // l^24), then the 8 warps in order
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      acc[m][e] += __shfl_xor_sync(0xffffffffu, acc[m][e], 8);
      acc[m][e] += __shfl_xor_sync(0xffffffffu, acc[m][e], 16);
    }
  if (lane < 8) {
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int e = 0; e < 16; ++e) red[(warp * MB + m) * COLS + 16 * chunk + e] = acc[m][e];
  }
  __syncthreads();
  for (int i = tid; i < MB * COLS; i += NT) {
    const int m = i / COLS, n = blockIdx.x * COLS + i % COLS;
    if (m >= M || n >= N) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) v += red[(w * MB + m) * COLS + i % COLS];
    if (gridDim.y == 1)
      out[static_cast<int64_t>(m) * N + n] = tile::from_f32<T>(v * scale[n]);
    else
      part[(static_cast<int64_t>(blockIdx.y) * M + m) * N + n] = v;
  }
}

// out = (sum over splits of part, in split order) * scale, one rounding
template <typename T>
__global__ void __launch_bounds__(NT) reduce_kernel(const float* __restrict__ part,
                                                    const float* __restrict__ scale,
                                                    T* __restrict__ out, int M, int N,
                                                    int splits) {
  const int64_t mn = static_cast<int64_t>(M) * N;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  if (i >= mn) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += part[s * mn + i];
  out[i] = tile::from_f32<T>(v * scale[i % N]);
}

template <typename T, int MB>
cudaError_t launch(const void* x, const int8_t* wq, const float* scale, float* part, void* out,
                   int M, int N, int K, int splits, cudaStream_t stream) {
  const int ks = ((K + splits - 1) / splits + LANES_K - 1) / LANES_K * LANES_K;
  if (ks > MAX_ROWS) return cudaErrorInvalidValue;
  const int used = (K + ks - 1) / ks;  // splits that hold rows
  const int smem = static_cast<int>(sizeof(float)) * MB * (ks + (NT / 32) * COLS);
  auto kernel = gemv_kernel<T, MB>;
  // the attribute is the limit of every later launch: set it for the largest
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = wgmma_tile::allow_smem(
      kernel, static_cast<int>(sizeof(float)) * MB * (MAX_ROWS + (NT / 32) * COLS), smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + COLS - 1) / COLS, used);
  kernel<<<grid, NT, smem, stream>>>(static_cast<const T*>(x), wq, scale, part,
                                     static_cast<T*>(out), M, N, K, ks);
  err = cudaGetLastError();
  if (err != cudaSuccess || used == 1) return err;
  const int64_t mn = static_cast<int64_t>(M) * N;
  reduce_kernel<T><<<static_cast<unsigned>((mn + NT - 1) / NT), NT, 0, stream>>>(
      part, scale, static_cast<T*>(out), M, N, used);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const int8_t* wq, const float* scale, float* part,
                     void* out, int M, int N, int K, int splits, cudaStream_t stream) {
  if (M <= 1) return launch<T, 1>(x, wq, scale, part, out, M, N, K, splits, stream);
  if (M <= 2) return launch<T, 2>(x, wq, scale, part, out, M, N, K, splits, stream);
  if (M <= 4) return launch<T, 4>(x, wq, scale, part, out, M, N, K, splits, stream);
  return launch<T, 8>(x, wq, scale, part, out, M, N, K, splits, stream);
}

}  // namespace gemv

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// x: contiguous [M, K], dtype 0 fp32 or 1 bf16; w_q: contiguous int8 [K, N];
// scale: fp32 [N]; out: contiguous [M, N] in x's dtype. Returns a
// cudaError_t (0 on success); the launch is asynchronous.
int quant_matmul(const void* x, const void* w_q, const void* scale, void* out, int dtype,
                 int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  const int8_t* wq = static_cast<const int8_t*>(w_q);
  const float* sc = static_cast<const float*>(scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch<float>(x, wq, sc, out, M, N, K, s); break;
    case 1: err = launch<__nv_bfloat16>(x, wq, sc, out, M, N, K, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The tile form on the tensor cores: as quant_matmul, for any M, with K a
// multiple of 8, N a multiple of 16, x, w_q, out 16-byte aligned and scale
// 8-byte aligned (else cudaErrorMisalignedAddress).
int quant_matmul_tc(const void* x, const void* w_q, const void* scale, void* out, int dtype,
                    int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  if (K % 8 != 0 || N % 16 != 0 || !aligned16(x) || !aligned16(w_q) || !aligned16(out) ||
      reinterpret_cast<uintptr_t>(scale) % 8 != 0)
    return cudaErrorMisalignedAddress;
  const int8_t* wq = static_cast<const int8_t*>(w_q);
  const float* sc = static_cast<const float*>(scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = tc::launch<float>(x, wq, sc, out, M, N, K, s); break;
    case 1: err = tc::launch<__nv_bfloat16>(x, wq, sc, out, M, N, K, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The GEMV form: as quant_matmul, for 1 <= M <= 8, with N a multiple of 16
// and w_q 16-byte aligned; K split into `splits` parts of at most 2048 rows
// (rounded to whole 32-row steps), whose fp32 partial sums go to part
// ([splits, M, N], unused when splits is 1) before one reduce launch.
int quant_matmul_gemv(const void* x, const void* w_q, const void* scale, void* part,
                      void* out, int dtype, int M, int N, int K, int splits, void* stream) {
  if (M <= 0 || M > 8 || N <= 0 || K <= 0 || splits <= 0) return cudaErrorInvalidValue;
  if (splits > 1 && part == nullptr) return cudaErrorInvalidValue;
  if (N % 16 != 0 || !aligned16(w_q)) return cudaErrorMisalignedAddress;
  const int8_t* wq = static_cast<const int8_t*>(w_q);
  const float* sc = static_cast<const float*>(scale);
  float* pt = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = gemv::dispatch<float>(x, wq, sc, pt, out, M, N, K, splits, s); break;
    case 1: err = gemv::dispatch<__nv_bfloat16>(x, wq, sc, pt, out, M, N, K, splits, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
