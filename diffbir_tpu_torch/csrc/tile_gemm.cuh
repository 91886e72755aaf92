// The tiled CUDA-core matrix-product core of the first (CUDA-core) versions
// of the kernels, kept as the yardsticks the tensor-core entries are timed
// beside and for the fp32 entries: the fused ResBlock's fused_resblock (K6:
// fp32, and K6_cc for bf16), the packed-int4 matmul's quant_matmul_int4
// (K5_cc), the int8 matmul's quant_matmul (K4_cc) and the fused GEGLU FFN's
// fused_ffn (K7: fp32, and K7_cc). No serving path runs it: every bf16 path
// of K4-K7 runs on the tensor cores (wgmma_gemm.cuh).
//
// One block of NT = 256 threads computes a BM x BN = 64 x 64 tile of
// C = A @ B with fp32 accumulators in registers, 4 x 4 per thread. The
// kernels stage BK = 16 deep slices of A (as a[k][m]) and B (as b[k][n]) in
// shared memory as fp32, each with its own loads and conversions (a bf16 or
// int8 operand is exact in fp32, so the products are the tensor cores'
// bf16 x bf16 -> fp32 products), and call fma_tile() on them; every product
// is an fp32 FMA on the CUDA cores.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace tile {

constexpr int BM = 64;   // rows of C per block
constexpr int BN = 64;   // columns of C per block
constexpr int BK = 16;   // depth of one shared-memory slice
constexpr int NT = 256;  // threads per block: 16 x 16, each 4 x 4 of C

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype(bfloat16)
}

// x rounded to T and back (identity for fp32)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// acc[i][j] += sum_k a[k][m0 + i] * b[k][n0 + j] over one BK slice; the rows
// of a and b are 16-byte aligned (BM and BN are multiples of 4 floats).
__device__ __forceinline__ void fma_tile(const float (*a)[BM], const float (*b)[BN],
                                         int m0, int n0, float acc[4][4]) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(&a[k][m0]);
    const float4 bv = *reinterpret_cast<const float4*>(&b[k][n0]);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ void zero(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
}

}  // namespace tile

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
