// The tensor-core GEMM main loop shared by the int8 matmul's tile form (K4,
// csrc/quant_matmul.cu), the fused GEGLU FFN (K7, csrc/fused_ffn.cu), the
// packed-int4 matmul's tile form (K5, csrc/quant_matmul_int4.cu) and the
// fused ResBlock's convolutions (K6, csrc/fused_resblock.cu), on the
// building blocks of wgmma_tile.cuh.
//
// One block of NT = 256 threads (two warpgroups of 64 rows) computes a
// BM x (NP * 64) tile of C = A . B with fp32 accumulators in registers
// (acc[NP][32] per thread, the 64x64 wgmma accumulator layout of
// wgmma_tile.cuh per 64-column panel). A is bf16 [M, K], K-major, staged
// as a swizzled [BM][BK] tile. Per BK = 64-deep stage every warpgroup
// issues 4 x NP wgmma m64n64k16 on its 64 rows, reading both operands from
// shared memory. The stages come through a ring of STAGES slots filled by
// cp.async: the copies of stage t + STAGES - 1 are issued while the
// products of stage t run, and the zero-fill of the copies masks ragged M,
// N and K (rows past the end, 8-column chunks past the end).
//
// Two hooks, written by each kernel:
// - load_stage(t, slot): issue the copies of stage t into a ring slot (A at
//   the slot, then the kernel's raw B bytes); load_a below serves bf16 A
//   (cp.async) and fp32 A (rounded to bf16 on the way: x is rounded anyway);
// - stage_b(slot) -> the shared address of the stage's bf16 B tile, called
//   once the thread's copies of the stage have landed; it ends with the
//   proxy fence and barrier that order its (and the copies') shared-memory
//   writes before the wgmma reads. B is K-major ([NP*64 rows = N][BK], a
//   Linear weight, staged as it is: K7) or MN-major ([BK rows = K][NP*64],
//   read through the descriptor's transpose bit: K4's int8 [K, N] weight
//   and K6's int8 conv weight per tap, dequantised by the warps from their
//   staged bytes; K5's packed int4 weight, unpacked and scaled the same way;
//   K6's float conv weight per tap, staged as it is).
// The epilogue is the kernel's: stage_pair and store_tile stage the output
// tile in shared memory (the ring, once the loop is done) and write it with
// 16-byte coalesced stores.

#pragma once

#include <type_traits>

#include "wgmma_tile.cuh"

namespace wgmma_gemm {

using namespace wgmma_tile;

constexpr int BM = 128;      // rows of C per block: two warpgroups of 64
constexpr int BK = 64;       // depth of one stage: one 128-byte row of bf16
constexpr int STAGES = 3;    // ring slots
constexpr uint32_t A_BYTES = BM * BK * 2;

// Rows r = 0..R-1 of an [R][D] swizzled bf16 tile at dst from row_ptr(r)
// (the row's first element, or nullptr for a zero row), columns [col0,
// col0 + D), by the block's NT threads with cp.async; 8-column chunks at or
// past ncols are zero-filled (ncols % 8 == 0). `base` is any valid address,
// given to the copies that read nothing.
template <int R, int D, typename RowPtr>
__device__ __forceinline__ void load_rows(uint32_t dst, RowPtr row_ptr, int col0, int ncols,
                                          const bf16* base, int tid) {
  constexpr int CH = D / 8;
  static_assert((R * CH) % NT == 0, "bad tile");
#pragma unroll
  for (int n = 0; n < R * CH / NT; ++n) {
    const int i = tid + n * NT;
    const int r = i / CH, c = i % CH;
    const bf16* g = row_ptr(r);
    const bool full = g != nullptr && col0 + 8 * c < ncols;
    cp_async16(dst + chunk_off<R>(r, c), full ? g + col0 + 8 * c : base, full);
  }
}

// A: rows [m0, m0 + BM) and columns [k0, k0 + BK) of a row-major [M, K] x
// into the tile at dst (shared address; dst_g the same as a generic
// pointer). bf16 through cp.async.
__device__ __forceinline__ void load_a(uint32_t dst, uint8_t*, const bf16* x, int64_t ldx,
                                       int m0, int M, int k0, int K, int tid) {
  load_rows<BM, BK>(
      dst, [&](int r) -> const bf16* { return m0 + r < M ? x + (m0 + r) * ldx : nullptr; }, k0,
      K, x, tid);
}
// fp32: loaded, rounded to bf16 (nearest even) and stored by the threads
// (synchronous; no serving path has fp32 activations)
__device__ __forceinline__ void load_a(uint32_t, uint8_t* dst_g, const float* x, int64_t ldx,
                                       int m0, int M, int k0, int K, int tid) {
  constexpr int CH = BK / 8;
#pragma unroll
  for (int n = 0; n < BM * CH / NT; ++n) {
    const int i = tid + n * NT;
    const int r = i / CH, c = i % CH;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < M && k0 + 8 * c < K) {
      const float4* g = reinterpret_cast<const float4*>(x + (m0 + r) * ldx + k0 + 8 * c);
      const float4 lo = g[0], hi = g[1];
      v = make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w), pack_bf16(hi.x, hi.y),
                     pack_bf16(hi.z, hi.w));
    }
    *reinterpret_cast<uint4*>(dst_g + chunk_off<BM>(r, c)) = v;
  }
}

// C tile [BM][NP * 64] of this block (acc, zeroed by the caller) += A . B
// over ktiles stages; ring is the 1024-byte aligned shared address of slot
// 0, slots stage_bytes apart (a multiple of 1024, A first). Returns with
// every copy landed and the ring free for the epilogue.
template <int NP, bool B_MN, typename LoadStage, typename StageB>
__device__ __forceinline__ void mainloop(uint32_t ring, uint32_t stage_bytes, int ktiles,
                                         LoadStage load_stage, StageB stage_b,
                                         float (&acc)[NP][32]) {
  const int wg = threadIdx.x / 128;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage(s, ring + s * stage_bytes);
    cp_async_commit();
  }
  for (int t = 0; t < ktiles; ++t) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of stage t have landed
    const uint32_t slot = ring + (t % STAGES) * stage_bytes;
    const uint32_t b = stage_b(slot);  // ends with fence + barrier
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t a = desc_k<BM>(slot, wg * 64, kk);
#pragma unroll
      for (int pn = 0; pn < NP; ++pn) {
        wgmma_ss<B_MN>(acc[pn], a,
                       B_MN ? desc_mn<BK>(b, pn, kk) : desc_k<NP * 64>(b, pn * 64, kk), 1);
      }
    }
    wgmma_commit();
    // the slot of stage t - 1: every thread passed this stage's barrier, so
    // every warpgroup is done with it
    const int next = t + STAGES - 1;
    if (next < ktiles) load_stage(next, ring + (next % STAGES) * stage_bytes);
    cp_async_commit();
    wgmma_wait();
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) fence_acc(acc[pn]);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// stage_b of a K-major B copied as it is: the stage's B tile follows A.
struct StagedB {
  __device__ __forceinline__ uint32_t operator()(uint32_t slot) const {
    fence_proxy_async();
    __syncthreads();
    return slot + A_BYTES;
  }
};

// The int8 value of each byte of w, exactly, as 4 fp32: 2^23 + (b + 128)
// assembled bitwise, minus 2^23 + 128.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}
// ... and as 4 bf16 (two pairs): an integer of at most 8 bits is the upper
// half of its fp32 bits
__device__ __forceinline__ uint2 i8x4_to_bf16(uint32_t w) {
  float f[4];
  i8x4_to_f32(w, f);
  return make_uint2(__byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
                    __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

// The [BK][BN] int8 tile at raw (row-major, BN bytes a row) into the
// swizzled MN-major bf16 tile at dst (rows = K, 64-column panels), one
// 16-byte chunk of 16 values a thread per pass.
template <int BN>
__device__ __forceinline__ void dequant_tile(const uint8_t* raw, uint8_t* dst, int tid) {
  constexpr int CH = BN / 16;
  static_assert((BK * CH) % NT == 0, "bad tile");
#pragma unroll
  for (int n = 0; n < BK * CH / NT; ++n) {
    const int i = tid + n * NT;
    const int k = i / CH, c = i % CH;
    const uint4 w = *reinterpret_cast<const uint4*>(raw + k * BN + 16 * c);
    const uint2 b0 = i8x4_to_bf16(w.x), b1 = i8x4_to_bf16(w.y);
    const uint2 b2 = i8x4_to_bf16(w.z), b3 = i8x4_to_bf16(w.w);
    *reinterpret_cast<uint4*>(dst + chunk_off<BK>(k, 2 * c)) = make_uint4(b0.x, b0.y, b1.x, b1.y);
    *reinterpret_cast<uint4*>(dst + chunk_off<BK>(k, 2 * c + 1)) =
        make_uint4(b2.x, b2.y, b3.x, b3.y);
  }
}

// ---------------------------------------------------------------------------
// epilogue: the output tile staged in shared memory, then 16-byte stores
// ---------------------------------------------------------------------------
// Row and column (in the block's tile) of accumulator element i of panel pn
// of this thread, and of element i + 1 (the next column).
__device__ __forceinline__ int acc_row(int i) {
  const int tid = threadIdx.x, lane = tid % 32;
  return (tid / 128) * 64 + (tid % 128) / 32 * 16 + lane / 4 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int acc_col(int pn, int i) {
  return pn * 64 + 8 * (i / 4) + 2 * (threadIdx.x % 4);
}

// A [BM][COLS] tile of T with rows 16 bytes longer than their data, so the
// accumulators' eight rows per warp land on distinct banks.
template <typename T, int COLS>
struct OutTile {
  static constexpr int PITCH = COLS * static_cast<int>(sizeof(T)) + 16;
  static constexpr int BYTES = BM * PITCH;
};

// values (v0, v1) at (row, col), (row, col + 1) of a staged tile of T
template <typename T, int COLS>
__device__ __forceinline__ void stage_pair(uint8_t* tile, int row, int col, float v0, float v1) {
  uint8_t* p = tile + row * OutTile<T, COLS>::PITCH + col * static_cast<int>(sizeof(T));
  if constexpr (std::is_same<T, float>::value)
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  else
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(v0, v1);
}

// The staged tile to out rows [m0, m0 + BM), columns [n0, n0 + COLS) of a
// row-major [M, N] out with row stride ldo, 16 bytes a thread, rows past M
// and chunks past N left out (N a whole number of 16-byte chunks). A
// barrier must separate the staging writes from this.
template <typename T, int COLS>
__device__ __forceinline__ void store_tile(const uint8_t* tile, T* out, int64_t ldo, int m0,
                                           int n0, int M, int N, int tid) {
  constexpr int PER = 16 / static_cast<int>(sizeof(T));  // values per chunk
  constexpr int CH = COLS / PER;
  for (int i = tid; i < BM * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const int m = m0 + r, n = n0 + c * PER;
    if (m < M && n < N)
      *reinterpret_cast<uint4*>(out + m * ldo + n) =
          *reinterpret_cast<const uint4*>(tile + r * OutTile<T, COLS>::PITCH + c * 16);
  }
}

}  // namespace wgmma_gemm
