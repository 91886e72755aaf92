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
// Design (first, simple version, the layout of the forward kernel K1). The two
// kernels keep the TPU's split by accumulation axis; the TPU's sequential grid
// axis becomes a loop inside the block, so nothing carries between blocks and
// no atomics are needed: every output row is written by exactly one block, and
// gradients are bit-identical from run to run.
// - dq: a block owns ROWS query rows of one (batch, head) and loops over kv
//   tiles staged in shared memory as fp32. Each query row belongs to
//   G = D/32 consecutive lanes; a lane keeps 32 of the D dims of q, dO and the
//   dq accumulator in registers (as K1 keeps q and its accumulator).
// - dk/dv: a block owns ROWS kv rows and loops over q tiles (q, dO, lse and
//   delta staged in shared memory); a lane keeps 32 dims of k, v and the two
//   accumulators (128 fp32 registers), which is what lets d = 512 run: the
//   row is split over 16 lanes instead of held by one thread.
// Each logit and each dp is a partial dot over the lane's 32 dims plus a
// shuffle reduction over the G lanes; all products are fp32 FMAs on the CUDA
// cores.
//
// What bounds it on an H100: at the training shapes (S = 4096, d = 64) the
// dq kernel does 3 and the dk/dv kernel 4 products of 2*Sq*Skv*d flops per
// head against a few MB of q, k, v, o and dO, so both are compute-bound; on
// the CUDA cores they run at the fp32 FMA rate (67 TFLOP/s peak), not the
// bf16 tensor-core rate. Moving the products onto wgmma is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

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

// The shared-memory limit past 48 KB is a per-device attribute of each
// function: set it once per device and template instance, not per launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  done.fetch_or(bit, std::memory_order_release);
  return cudaSuccess;
}

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

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
