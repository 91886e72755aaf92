// Packed-int4 weight-only matmul for Hopper (sm_90a):
//   out[M,N] = x[M,K] @ bf16(unpack(packed)[K,N] * scale_g[K/128,N]).
//
// Replaces the Pallas TPU kernel diffbir_tpu/ops/quant_matmul.py::_kernel_int4
// (launched by _pallas_quant_matmul_int4). Same math, not the same blocks:
// each weight is its sign-extended nibble times its group's fp32 scale,
// rounded to bf16 (per-group scales do not commute with the K sum, so they
// are applied before the product); x is rounded to bf16 (for a bf16 or an
// fp32 x); products accumulate in fp32 over the whole of K; the result is
// cast to x's dtype.
//
// Packing (the JAX package's, so one tensor feeds both packages): K is cut
// into 256-row windows; packed row r of window w holds logical row
// w*256 + r in its low nibble (scale group 2w) and logical row
// w*256 + 128 + r in its high nibble (scale group 2w + 1). The nibbles are
// sign-extended as the JAX shifts do: (p << 28) >> 28 and (p << 24) >> 28 on
// the int32 of the int8 byte.
//
// Two forms, chosen by M:
// - M <= 8 (the captioner's decode, M = 1): a GEMV form. A block owns a
//   strip of 32 columns; its 256 threads are 8 column quads (4 columns each,
//   one 4-byte load per packed row) by 32 K lanes. Each lane walks 4 packed
//   rows of every window, so it loads the window's two scale rows once; the
//   32 lanes' partial sums are added in shared memory in a fixed order (no
//   atomics, so a result is the same from run to run). What bounds it on an
//   H100 is reading the packed weight (0.5 byte a weight): N/32 blocks (128
//   at N = 4096) is fewer than two per SM, so it cannot keep enough bytes in
//   flight to reach the memory rate.
// - M > 8 (the prompt's prefill, M = 624): the shared 64 x 64 CUDA-core tile
//   of tile_gemm.cuh with an int4 B-loader (unpack, scale, round to bf16,
//   store fp32 in shared memory); a 16-deep slice never straddles a half
//   window, so it reads one nibble of 16 packed rows and one scale row.
//   Compute-bound there, at the CUDA cores' fp32 rate, not the tensor
//   cores'.

#include "tile_gemm.cuh"

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

}  // extern "C"
