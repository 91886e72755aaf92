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
// Design (first, simple version). One block covers ROWS query rows of one
// (batch, head). Each query row belongs to G = D/32 consecutive lanes; a lane
// owns 32 of the D dims of q and of the accumulator in registers, as 8 float4
// chunks interleaved across the G lanes (dims 4*(g + G*c) .. +3), so a warp's
// float4 reads of one shared-memory row hit consecutive 16-byte words. A loop
// over kv tiles stages BK rows of k and v into shared memory as fp32; the
// whole block reads the same k/v row at the same time (broadcast). Both
// products run on the CUDA cores in fp32 FMAs: a partial dot over the lane's
// 32 dims plus a shuffle reduction over the G lanes gives one logit.
//
// What bounds it on an H100: at the main path's shapes (S = 4096, d = 64) the
// kernel does 4*S^2*d flops per head and reads q, k and v once per block from
// L2, so it is compute-bound; without tensor cores it runs at the CUDA-core
// fp32 rate (67 TFLOP/s peak) rather than the bf16 tensor-core rate. The
// S x S logits never reach device memory, which is what the plain version
// pays for. Moving QK^T and PV onto wgmma is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

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
    float scale) {
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
      qr[c][e] = valid ? to_f32<T>(qb[row * q_ss + dim]) : 0.f;
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

template <typename T, int D, int NT, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int H, int Sq, int Skv, const long long* st, float scale, cudaStream_t stream) {
  constexpr int ROWS = NT / (D / 32);
  constexpr int smem = 2 * BK * D * static_cast<int>(sizeof(float));
  auto kernel = flash_fwd_kernel<T, D, NT, BK>;
  // The shared-memory limit past 48 KB is a per-device attribute of the
  // function: set it once per device, not on every launch.
  static std::atomic<uint64_t> smem_set{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = 1ull << (dev & 63);
  if (!(smem_set.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set.fetch_or(bit, std::memory_order_release);
  }
  const dim3 grid((Sq + ROWS - 1) / ROWS, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, Sq, Skv, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], scale);
  return cudaGetLastError();
}

// Tile sizes per head dim: 128 or 256 threads, 32 dims per lane, and kv tiles
// of 64 KB (32 KB at d=64) of fp32 k and v in shared memory.
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                     int H, int Sq, int Skv, int D, const long long* st, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64, 128, 64>(q, k, v, o, lse, B, H, Sq, Skv, st, scale, stream);
    case 128: return launch<T, 128, 128, 64>(q, k, v, o, lse, B, H, Sq, Skv, st, scale, stream);
    case 256: return launch<T, 256, 256, 32>(q, k, v, o, lse, B, H, Sq, Skv, st, scale, stream);
    case 512: return launch<T, 512, 256, 16>(q, k, v, o, lse, B, H, Sq, Skv, st, scale, stream);
    default: return cudaErrorInvalidValue;
  }
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
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  cudaError_t err;
  switch (dtype) {
    case 0: err = dispatch<float>(q, k, v, o, lse_f, B, H, Sq, Skv, D, st, scale, s); break;
    case 1: err = dispatch<__nv_bfloat16>(q, k, v, o, lse_f, B, H, Sq, Skv, D, st, scale, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
