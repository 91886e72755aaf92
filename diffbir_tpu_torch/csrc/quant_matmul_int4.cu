// Packed-int4 weight-only matmul for Hopper (sm_90a):
//   out[M,N] = x[M,K] @ bf16(unpack(packed)[K,N] * scale_g[K/128,N]).
//
// Replaces the Pallas TPU kernel diffbir_tpu/ops/quant_matmul.py::_kernel_int4
// (launched by _pallas_quant_matmul_int4). Same math, not the same blocks:
// each weight is its sign-extended nibble times its group's fp32 scale,
// rounded to bf16 (per-group scales do not commute with the K sum, so they
// are applied before the product); x is rounded to bf16 (for a bf16 or an
// fp32 x); products accumulate in fp32 over the whole of K; the result is
// cast to x's dtype. The products are bf16 x bf16 with fp32 sums, so the
// bf16 tensor cores give them for fp32 x too.
//
// Packing (the JAX package's, so one tensor feeds both packages): K is cut
// into 256-row windows; packed row r of window w holds logical row
// w*256 + r in its low nibble (scale group 2w) and logical row
// w*256 + 128 + r in its high nibble (scale group 2w + 1). The nibbles are
// sign-extended as the JAX shifts do: (p << 28) >> 28 and (p << 24) >> 28 on
// the int32 of the int8 byte.
//
// Three entries (ops/quant_matmul.py::int4_entries picks by M):
// - quant_matmul_int4_tc, the tile form for M > 8 (the captioner's 624-row
//   prefill), on the tensor cores: the main loop of wgmma_gemm.cuh with a
//   128 x 128 tile, as K4's tile form. A 64-deep stage lies inside one half
//   window, so it copies 64 packed rows x 128 columns of bytes and the
//   stage's scale row (cp.async, its 16-byte chunks swizzled so the warps'
//   reads of it are free of bank conflicts: 4-way before, 0.200 -> 0.137 ms
//   at (624, 4096, 4096) on an H100); after they land the warps take the
//   stage's nibble of every byte, sign-extend it bitwise (2^23 + q + 8
//   assembled by __byte_perm, one FADD: no I2F), multiply by the column's
//   fp32 scale, round to bf16 (nearest even) and write the swizzled MN-major
//   tile that wgmma reads through the transpose bit. Each byte is copied
//   once per nibble, so twice per tile: a stage that paired rows r and
//   128 + r (both nibbles of each copied byte, x as two 32-column pieces)
//   ran no faster on an H100 (0.1412 against 0.1438 ms on the same loop),
//   nor did making stage t + 1's B tile while stage t's products ran (two B
//   buffers: slower at every K5 and K6 shape timed), so neither is kept.
// - quant_matmul_int4_gemv, the GEMV form for M <= 8 (the decode, M = 1):
//   bound by reading the packed weight (0.5 byte a weight). A block owns
//   128 columns and a split of whole windows; each thread streams 16-byte
//   loads of 16 columns of 4 packed rows of a window (both nibbles of every
//   byte it loads, 32 weights), with the window's two scale groups of its
//   16 columns from L1; x's rows of the split sit in shared memory. The 32
//   row lanes are summed by shuffles and through shared memory in a fixed
//   order. K is split across blocks so the grid has ~2 blocks per SM; the
//   splits of 128 columns are one thread block cluster, whose first block
//   adds the others' sums through distributed shared memory in split order:
//   one launch and no scratch (a decode step is bound by the host's
//   launches: a second, reduce launch and a scratch allocation per call
//   cost it ~3-4 ms of enqueue per step on an H100). No atomics: reruns
//   are bit-identical.
// - quant_matmul_int4, the first CUDA-core version (a GEMV of N/32 blocks
//   for M <= 8, the 64 x 64 fp32-FMA tile of tile_gemm.cuh above), kept as
//   the yardstick the new entries are timed beside; no path launches it.
//
// What bounds it on an H100: at (624, 4096, 4096) the tensor-core flops
// (0.0212 ms); at M = 1 reading the packed weight and its scales (8.9 MB at
// (1, 4096, 4096): 0.0027 ms).

#include <cooperative_groups.h>

#include <atomic>

#include "tile_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using tile::BK;
using tile::BM;
using tile::BN;
using tile::NT;

constexpr int WINDOW = 256;  // logical K rows per pack window
constexpr int HALF = 128;    // packed rows per window = rows per scale group
constexpr int GV_COLS = 32;  // GEMV: columns per block (8 quads of 4)
constexpr int GV_LANES = 32; // GEMV: K lanes per block
constexpr int GV_NT = 256;   // GEMV: threads per block
constexpr int GV_MAXM = 8;   // GEMV: the largest M it takes

__device__ __forceinline__ int lo_nibble(int p) {
  return static_cast<int>(static_cast<unsigned>(p) << 28) >> 28;
}
__device__ __forceinline__ int hi_nibble(int p) {
  return static_cast<int>(static_cast<unsigned>(p) << 24) >> 28;
}
__device__ __forceinline__ float dequant(int q, float s) {
  return tile::round_to<__nv_bfloat16>(static_cast<float>(q) * s);
}

template <typename T>
__global__ void __launch_bounds__(NT) int4_tile_kernel(
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
    // logical rows [kb, kb + 16): one half of one window, one scale group
    const int r0 = kb % WINDOW;
    const bool high = r0 >= HALF;
    const int64_t prow0 = (int64_t)(kb / WINDOW) * HALF + r0 % HALF;
    const float* srow = scale + (int64_t)(kb / HALF) * N;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int e = tid + p * NT;
      const int r = e / BK, kk = e % BK;  // x: 16 consecutive k of one row
      const int m = mb + r;
      as[kk][r] = m < M
                      ? tile::round_to<__nv_bfloat16>(tile::to_f32<T>(x[(int64_t)m * K + kb + kk]))
                      : 0.f;
      const int kr = e / BN, c = e % BN, n = nb + c;  // weights: 64 consecutive n of one row
      float wv = 0.f;
      if (n < N) {
        const int b = wq[(prow0 + kr) * N + n];
        wv = dequant(high ? hi_nibble(b) : lo_nibble(b), srow[n]);
      }
      bs[kr][c] = wv;
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
      if (n < N) out[(int64_t)m * N + n] = tile::from_f32<T>(acc[i][j]);
    }
  }
}

// VEC: N % 4 == 0 and aligned pointers, so a quad's 4 bytes and 4 scales
// are one 4-byte and one 16-byte load.
template <typename T, bool VEC>
__global__ void __launch_bounds__(GV_NT) int4_gemv_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ wq, const float* __restrict__ scale,
    T* __restrict__ out, int M, int N, int K) {
  __shared__ float red[GV_LANES][GV_MAXM][GV_COLS];
  const int quad = threadIdx.x % (GV_COLS / 4);
  const int lane = threadIdx.x / (GV_COLS / 4);
  const int n0 = blockIdx.x * GV_COLS + quad * 4;
  float acc[GV_MAXM][4];
#pragma unroll
  for (int m = 0; m < GV_MAXM; ++m) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;
  }

  if (n0 < N) {
    for (int w = 0; w < K / WINDOW; ++w) {
      float s_lo[4], s_hi[4];
      const float* g_lo = scale + (int64_t)(2 * w) * N + n0;
      const float* g_hi = g_lo + N;
      if (VEC) {
        const float4 a = *reinterpret_cast<const float4*>(g_lo);
        const float4 b = *reinterpret_cast<const float4*>(g_hi);
        s_lo[0] = a.x; s_lo[1] = a.y; s_lo[2] = a.z; s_lo[3] = a.w;
        s_hi[0] = b.x; s_hi[1] = b.y; s_hi[2] = b.z; s_hi[3] = b.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s_lo[c] = n0 + c < N ? g_lo[c] : 0.f;
          s_hi[c] = n0 + c < N ? g_hi[c] : 0.f;
        }
      }
      int bytes[HALF / GV_LANES][4];  // this lane's packed rows of the window
#pragma unroll
      for (int j = 0; j < HALF / GV_LANES; ++j) {
        const int8_t* row = wq + ((int64_t)w * HALF + lane + j * GV_LANES) * N + n0;
        if (VEC) {
          const char4 v = *reinterpret_cast<const char4*>(row);
          bytes[j][0] = v.x; bytes[j][1] = v.y; bytes[j][2] = v.z; bytes[j][3] = v.w;
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) bytes[j][c] = n0 + c < N ? row[c] : 0;
        }
      }
#pragma unroll
      for (int j = 0; j < HALF / GV_LANES; ++j) {
        const int k_lo = w * WINDOW + lane + j * GV_LANES;
        float w_lo[4], w_hi[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          w_lo[c] = dequant(lo_nibble(bytes[j][c]), s_lo[c]);
          w_hi[c] = dequant(hi_nibble(bytes[j][c]), s_hi[c]);
        }
#pragma unroll
        for (int m = 0; m < GV_MAXM; ++m) {
          if (m < M) {
            const T* xm = x + (int64_t)m * K;
            const float x_lo = tile::round_to<__nv_bfloat16>(tile::to_f32<T>(xm[k_lo]));
            const float x_hi = tile::round_to<__nv_bfloat16>(tile::to_f32<T>(xm[k_lo + HALF]));
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              acc[m][c] = fmaf(x_lo, w_lo[c], acc[m][c]);
              acc[m][c] = fmaf(x_hi, w_hi[c], acc[m][c]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < GV_MAXM; ++m) {
    if (m < M) {
#pragma unroll
      for (int c = 0; c < 4; ++c) red[lane][m][quad * 4 + c] = acc[m][c];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < M * GV_COLS; i += GV_NT) {
    const int m = i / GV_COLS, col = i % GV_COLS;
    const int n = blockIdx.x * GV_COLS + col;
    float s = 0.f;
    for (int l = 0; l < GV_LANES; ++l) s += red[l][m][col];  // fixed order
    if (n < N) out[(int64_t)m * N + n] = tile::from_f32<T>(s);
  }
}

template <typename T>
cudaError_t launch(const void* x, const int8_t* wq, const float* scale, void* out, int M,
                   int N, int K, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (M <= GV_MAXM) {
    const dim3 grid((N + GV_COLS - 1) / GV_COLS);
    const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(wq) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(scale) % 16 == 0;
    if (vec) {
      int4_gemv_kernel<T, true><<<grid, GV_NT, 0, stream>>>(xt, wq, scale, ot, M, N, K);
    } else {
      int4_gemv_kernel<T, false><<<grid, GV_NT, 0, stream>>>(xt, wq, scale, ot, M, N, K);
    }
  } else {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    int4_tile_kernel<T><<<grid, NT, 0, stream>>>(xt, wq, scale, ot, M, N, K);
  }
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

// The ring slot: the A tile, BK packed rows of BN bytes, the stage's scale
// row (BN fp32, padded to keep the slots 1024-byte aligned); after the ring
// the dequantised bf16 B tile [BK][BN].
struct Layout {
  static constexpr uint32_t RAW = BK * BN;
  static constexpr uint32_t SCALES = A_BYTES + RAW;
  static constexpr uint32_t STAGE = SCALES + 1024;
  static constexpr int SMEM = 1024 + STAGES * STAGE + BK * BN * 2;
  static_assert(STAGE % 1024 == 0, "slots must keep the swizzle's alignment");
  static_assert(BN * 4 <= 1024, "the scale row must fit its pad");
  static_assert(OutTile<float, BN>::BYTES <= STAGES * STAGE, "the output tile must fit the ring");
};

// 4 nibbles (the low ones of w's bytes, after any shift) sign-extended, as
// fp32 (exact): 2^23 + (q + 8) assembled bitwise, minus 2^23 + 8
__device__ __forceinline__ void nib4_to_f32(uint32_t w, float* f) {
  const uint32_t u = (w & 0x0F0F0F0Fu) ^ 0x08080808u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388616.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388616.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388616.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388616.f;
}

// Slot of 16-byte chunk q (columns 4q .. 4q + 3) of a stage's staged scale
// row: the 8 chunks that the 8 threads of a quarter warp read at once
// (q = 4c + j for c = 0..7) land in 8 distinct bank groups.
__device__ __forceinline__ int scale_slot(int q) { return q ^ ((q >> 3) & 7); }

// The [BK][BN] packed bytes at raw into the swizzled MN-major bf16 tile at
// dst: the low (or, with high, the high) nibble of each byte times the
// column's scale (sc: the stage's staged fp32 scale row, chunks at
// scale_slot), rounded to bf16; one 16-byte chunk of 16 columns a thread per
// pass. A thread's columns are the same in every pass, so it reads its 16
// scales once.
__device__ __forceinline__ void dequant_int4_tile(const uint8_t* raw, const float* sc, bool high,
                                                  uint8_t* dst, int tid) {
  constexpr int CH = BN / 16;
  static_assert((BK * CH) % NT == 0 && NT % CH == 0, "bad tile");
  const int shift = high ? 4 : 0;
  const int c = tid % CH;
  float4 s[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    s[j] = *reinterpret_cast<const float4*>(sc + 4 * scale_slot(4 * c + j));
#pragma unroll 1
  for (int n = 0; n < BK * CH / NT; ++n) {
    const int k = (tid + n * NT) / CH;
    const uint4 w = *reinterpret_cast<const uint4*>(raw + k * BN + 16 * c);
    const uint32_t words[4] = {w.x >> shift, w.y >> shift, w.z >> shift, w.w >> shift};
    uint32_t o[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float f[4];
      nib4_to_f32(words[j], f);
      o[2 * j] = pack_bf16(f[0] * s[j].x, f[1] * s[j].y);
      o[2 * j + 1] = pack_bf16(f[2] * s[j].z, f[3] * s[j].w);
    }
    *reinterpret_cast<uint4*>(dst + chunk_off<BK>(k, 2 * c)) = make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(dst + chunk_off<BK>(k, 2 * c + 1)) =
        make_uint4(o[4], o[5], o[6], o[7]);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 2) int4_tc_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ wq, const float* __restrict__ scale,
    T* __restrict__ out, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  uint8_t* const ring_g = smem_raw + (ring - raw);
  const uint32_t bbuf = ring + STAGES * Layout::STAGE;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // stage t: logical rows [64t, 64t + 64), one half of window 64t / 256,
  // one scale group; packed rows (64t / 256) * 128 + 64t % 128 onwards
  auto load_stage = [&](int t, uint32_t slot) {
    const int k0 = t * BK;
    load_a(slot, ring_g + (slot - ring), x, K, m0, M, k0, K, tid);
    const int64_t prow0 = static_cast<int64_t>(k0 / WINDOW) * HALF + k0 % HALF;
    constexpr int CH = BN / 16;  // 16-byte chunks of a packed row segment
#pragma unroll
    for (int n = 0; n < BK * CH / NT; ++n) {
      const int i = tid + n * NT;
      const int k = i / CH, c = i % CH;
      const bool full = n0 + 16 * c < N;
      cp_async16(slot + A_BYTES + k * BN + 16 * c, full ? wq + (prow0 + k) * N + n0 + 16 * c : wq,
                 full);
    }
    if (tid < BN / 4) {
      const bool full = n0 + 4 * tid < N;
      cp_async16(slot + Layout::SCALES + 16 * scale_slot(tid),
                 full ? scale + static_cast<int64_t>(k0 / HALF) * N + n0 + 4 * tid : scale, full);
    }
  };
  int t_b = 0;  // the mainloop asks for the stages' B tiles in order
  auto stage_b = [&](uint32_t slot) {
    const bool high = (t_b++ * BK) % WINDOW >= HALF;
    __syncthreads();  // every thread's copies of the stage have landed
    dequant_int4_tile(ring_g + (slot + A_BYTES - ring),
                      reinterpret_cast<const float*>(ring_g + (slot + Layout::SCALES - ring)), high,
                      ring_g + (bbuf - ring), tid);
    fence_proxy_async();
    __syncthreads();
    return bbuf;
  };
  float acc[NP][32];
#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[pn][i] = 0.f;
  mainloop<NP, true>(ring, Layout::STAGE, K / BK, load_stage, stage_b, acc);

  // one rounding to T, staged, then row stores
#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      stage_pair<T, BN>(ring_g, acc_row(i), acc_col(pn, i), acc[pn][i], acc[pn][i + 1]);
  __syncthreads();
  store_tile<T, BN>(ring_g, out, N, m0, n0, M, N, tid);
}

template <typename T>
cudaError_t launch(const void* x, const int8_t* wq, const float* scale, void* out, int M, int N,
                   int K, cudaStream_t stream) {
  auto kernel = int4_tc_kernel<T>;
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
namespace decode {

namespace cg = cooperative_groups;

constexpr int NT = 256;
constexpr int COLS = 128;          // columns per block: 8 chunks of 16
constexpr int LANES_K = NT / 8;    // packed rows of a window read at once by a block
constexpr int ROWS = HALF / LANES_K;  // packed rows of a window per thread (4 loads in flight)
constexpr int MAX_WINDOWS = 16;    // windows per split (x's shared copy: 4096 rows)
constexpr int MAX_SPLITS = 8;      // blocks of a cluster (the portable limit)

template <typename T>
__device__ __forceinline__ float bf16_value(T v) {
  return tile::round_to<__nv_bfloat16>(tile::to_f32<T>(v));
}

// 16 fp32 of 4 scale float4s
__device__ __forceinline__ void load16(const float* p, float* s) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p) + j);
    s[4 * j] = v.x;
    s[4 * j + 1] = v.y;
    s[4 * j + 2] = v.z;
    s[4 * j + 3] = v.w;
  }
}

// One block: columns [128 bx, 128 bx + 128) and windows [wps * by,
// wps * (by + 1)) of K; MB >= M rows of x (the rows past M are zeros). The
// splits of a column block are one cluster (1, gridDim.y, 1): each block
// sums its 8 warps into fin, and the cluster's first block adds the
// others' fin through distributed shared memory in split order and writes
// out. Shared memory: x's rows of the split as fp32 [MB][wps * 256], the
// warps' sums [8][MB][128], fin [MB][128].
template <typename T, int MB>
__global__ void __launch_bounds__(NT) int4_gemv_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ wq, const float* __restrict__ scale,
    T* __restrict__ out, int M, int N, int K, int wps) {
  extern __shared__ float gsm[];
  const int ks = wps * WINDOW;  // logical rows of a split
  float* xs = gsm;
  float* red = gsm + MB * ks;
  float* fin = red + (NT / 32) * MB * COLS;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int chunk = tid % 8, krow = tid / 8;
  const int n0 = blockIdx.x * COLS + 16 * chunk;
  const int w0 = blockIdx.y * wps, w1 = min(K / WINDOW, w0 + wps);
  const int k0 = w0 * WINDOW, k1 = w1 * WINDOW;
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
    for (int w = w0; w < w1; ++w) {
      uint4 v[ROWS];
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
        v[j] = __ldg(reinterpret_cast<const uint4*>(
            wq + (static_cast<int64_t>(w) * HALF + krow + LANES_K * j) * N + n0));
      float s_lo[16], s_hi[16];
      load16(scale + static_cast<int64_t>(2 * w) * N + n0, s_lo);
      load16(scale + static_cast<int64_t>(2 * w + 1) * N + n0, s_hi);
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        const uint32_t words[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
        float lo[16], hi[16];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          tc::nib4_to_f32(words[q], lo + 4 * q);
          tc::nib4_to_f32(words[q] >> 4, hi + 4 * q);
        }
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          lo[e] = tile::round_to<__nv_bfloat16>(lo[e] * s_lo[e]);
          hi[e] = tile::round_to<__nv_bfloat16>(hi[e] * s_hi[e]);
        }
        const int kx = (w - w0) * WINDOW + krow + LANES_K * j;  // the low nibbles' row
#pragma unroll
        for (int m = 0; m < MB; ++m) {
          const float x_lo = xs[m * ks + kx], x_hi = xs[m * ks + kx + HALF];
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            acc[m][e] = fmaf(x_lo, lo[e], acc[m][e]);
            acc[m][e] = fmaf(x_hi, hi[e], acc[m][e]);
          }
        }
      }
    }
  }
  // the four row lanes of a warp that share a chunk (lanes l, l^8, l^16,
  // l^24), then the 8 warps in order, then the cluster's blocks in order
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
    const int m = i / COLS;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) v += red[(w * MB + m) * COLS + i % COLS];
    fin[i] = v;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's fin is written
  if (cluster.block_rank() == 0) {
    const int splits = static_cast<int>(cluster.num_blocks());
    for (int i = tid; i < MB * COLS; i += NT) {
      const int m = i / COLS, n = blockIdx.x * COLS + i % COLS;
      if (m >= M || n >= N) continue;
      float v = 0.f;
      for (int r = 0; r < splits; ++r) v += cluster.map_shared_rank(fin, r)[i];
      out[static_cast<int64_t>(m) * N + n] = tile::from_f32<T>(v);
    }
  }
  cluster.sync();  // the other blocks' fin stays until it is read
}

template <typename T, int MB>
cudaError_t launch(const void* x, const int8_t* wq, const float* scale, void* out, int M, int N,
                   int K, int splits, cudaStream_t stream) {
  const int windows = K / WINDOW;
  const int wps = (windows + splits - 1) / splits;
  const int used = (windows + wps - 1) / wps;  // splits that hold windows
  if (wps > MAX_WINDOWS || used > MAX_SPLITS) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(sizeof(float)) * MB * (wps * WINDOW + (NT / 32 + 1) * COLS);
  auto kernel = int4_gemv_kernel<T, MB>;
  // the attribute is the limit of every later launch: set it for the largest
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = wgmma_tile::allow_smem(
      kernel,
      static_cast<int>(sizeof(float)) * MB * (MAX_WINDOWS * WINDOW + (NT / 32 + 1) * COLS),
      smem_set);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + COLS - 1) / COLS, used);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = used;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), wq, scale,
                            static_cast<T*>(out), M, N, K, wps);
}

template <typename T>
cudaError_t dispatch(const void* x, const int8_t* wq, const float* scale, void* out, int M,
                     int N, int K, int splits, cudaStream_t stream) {
  if (M <= 1) return launch<T, 1>(x, wq, scale, out, M, N, K, splits, stream);
  if (M <= 2) return launch<T, 2>(x, wq, scale, out, M, N, K, splits, stream);
  if (M <= 4) return launch<T, 4>(x, wq, scale, out, M, N, K, splits, stream);
  return launch<T, 8>(x, wq, scale, out, M, N, K, splits, stream);
}

}  // namespace decode

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// x: contiguous [M, K], dtype 0 fp32 or 1 bf16; packed: contiguous int8
// [K/2, N] (window-halved); scale_g: contiguous fp32 [K/128, N]; out:
// contiguous [M, N] in x's dtype. K must be a whole number of 256-row
// windows. Returns a cudaError_t (0 on success); the launch is asynchronous.
int quant_matmul_int4(const void* x, const void* packed, const void* scale_g, void* out,
                      int dtype, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % WINDOW) return cudaErrorInvalidValue;
  const int8_t* wq = static_cast<const int8_t*>(packed);
  const float* sc = static_cast<const float*>(scale_g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch<float>(x, wq, sc, out, M, N, K, s); break;
    case 1: err = launch<__nv_bfloat16>(x, wq, sc, out, M, N, K, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The tile form on the tensor cores: as quant_matmul_int4, for any M, with
// N a multiple of 16 and x, packed, scale_g, out 16-byte aligned (else
// cudaErrorMisalignedAddress).
int quant_matmul_int4_tc(const void* x, const void* packed, const void* scale_g, void* out,
                         int dtype, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % WINDOW) return cudaErrorInvalidValue;
  if (N % 16 != 0 || !aligned16(x) || !aligned16(packed) || !aligned16(scale_g) ||
      !aligned16(out))
    return cudaErrorMisalignedAddress;
  const int8_t* wq = static_cast<const int8_t*>(packed);
  const float* sc = static_cast<const float*>(scale_g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = tc::launch<float>(x, wq, sc, out, M, N, K, s); break;
    case 1: err = tc::launch<__nv_bfloat16>(x, wq, sc, out, M, N, K, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The GEMV form: as quant_matmul_int4, for 1 <= M <= 8, with N a multiple of
// 16 and packed, scale_g 16-byte aligned; K's windows split into `splits`
// parts (at most 8) of at most 16 windows, one cluster of blocks per 128
// columns. One launch.
int quant_matmul_int4_gemv(const void* x, const void* packed, const void* scale_g, void* out,
                           int dtype, int M, int N, int K, int splits, void* stream) {
  if (M <= 0 || M > 8 || N <= 0 || K <= 0 || K % WINDOW || splits <= 0)
    return cudaErrorInvalidValue;
  if (N % 16 != 0 || !aligned16(packed) || !aligned16(scale_g)) return cudaErrorMisalignedAddress;
  const int8_t* wq = static_cast<const int8_t*>(packed);
  const float* sc = static_cast<const float*>(scale_g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = decode::dispatch<float>(x, wq, sc, out, M, N, K, splits, s); break;
    case 1: err = decode::dispatch<__nv_bfloat16>(x, wq, sc, out, M, N, K, splits, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
