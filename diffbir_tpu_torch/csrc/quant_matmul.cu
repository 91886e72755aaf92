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
// Design (first, simple version): the shared 64 x 64 tile core of
// tile_gemm.cuh; each block stages 16-deep slices of x (rounded to bf16)
// and of the int8 weight as fp32 in shared memory and runs fp32 FMAs on the
// CUDA cores. Ragged M, N and K are masked, so the UNet's 320-wide sites
// need no 128 alignment.
//
// What bounds it on an H100: at the serving shapes (M = 8192 rows of x at
// N, K >= 320) the product is compute-bound; the kernel reads int8 weights
// (half the bytes of bf16) but runs at the CUDA-core fp32 rate, not the
// tensor cores'. At M = 2 (the timestep-embedding rows) and M = 154 (the
// text context) it is bound by reading the weight.

#include "tile_gemm.cuh"

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

}  // extern "C"
