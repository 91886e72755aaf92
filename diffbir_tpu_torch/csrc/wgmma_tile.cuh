// Tensor-core building blocks for Hopper (sm_90a) shared by the flash kernels
// (csrc/flash_attention_fwd.cu: K1/K3; csrc/flash_attention_bwd.cu: K2a/K2b).
//
// wgmma m64n64k16 (and m64n32k16, for the wide backward) bf16 with fp32
// accumulators in registers. Operands live in shared memory as bf16 tiles in
// 64-column panels of 128-byte rows with the 128-byte XOR swizzle, loaded
// with cp.async (rows past the end zero-filled); a tile is read K-major (rows
// = M or N, columns = K) or MN-major (rows = K, columns = M or N) through the
// descriptor's transpose bit, so one layout serves both readings. The
// accumulator of one product is the A fragment of the next once rounded to
// bf16 (pack_bf16), so p and ds never leave registers.
//
// The accumulator of a 64x64 wgmma tile: thread (warp w of its warpgroup,
// lane l) holds element i at row 16w + l/4 + 8*((i/2)%2), column
// 8*(i/4) + 2*(l%4) + i%2. The A fragment of K columns 16kk..16kk+15 is
// then the pairs (8kk, 8kk+1), (8kk+2, 8kk+3), (8kk+4, 8kk+5), (8kk+6, 8kk+7)
// of such an accumulator rounded to bf16.
//
// Host side: allow_smem sets a kernel's dynamic shared-memory limit once per
// device.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace wgmma_tile {

typedef __nv_bfloat16 bf16;
constexpr int NT = 256;  // two warpgroups of 128 threads, 64 rows each
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of the 16-byte chunk c (columns 8c..8c+7) of row r in an
// [R][D] bf16 tile: 64-column panels of R rows x 128 bytes, each chunk at
// chunk (c % 8) ^ (r % 8) of its row. With the tile 1024-byte aligned this
// is the layout of wgmma's 128-byte swizzle, read K-major (rows = M or N,
// columns = K) or MN-major (rows = K, columns = N) alike.
template <int R>
__device__ __forceinline__ uint32_t chunk_off(int r, int c) {
  return (c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  // src-size 0 writes 16 zero bytes: the ragged edge is zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// orders this thread's generic-proxy writes to shared memory (cp.async)
// before the async proxy's reads (wgmma); a barrier follows
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [row0, row0 + R) of a [rows][D] operand with row stride ss (elements)
// into an [R][D] tile at shared address dst, asynchronously, by the block's
// THREADS threads; rows at or past nrows are zero-filled.
template <int R, int D, int THREADS = NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, int64_t ss, int row0,
                                          int nrows, int tid) {
  constexpr int CH = D / 8;
  static_assert((R * CH) % THREADS == 0, "bad tile");
#pragma unroll
  for (int n = 0; n < R * CH / THREADS; ++n) {
    const int i = tid + n * THREADS;
    const int r = i / CH, c = i % CH;
    const bool full = row0 + r < nrows;
    const bf16* g = full ? src + static_cast<int64_t>(row0 + r) * ss + c * 8 : src;
    cp_async16(dst + chunk_off<R>(r, c), g, full);
  }
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading offset 16 bytes (unused by these layouts), stride offset
// 1024 bytes (from one group of 8 rows to the next), layout B128.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}
// K-major operand: rows r0..r0+63 of an [R][D] tile, K columns 16kk..16kk+15
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int r0, int kk) {
  return desc(tile + (kk >> 2) * (R * 128) + r0 * 128 + (kk & 3) * 32);
}
// MN-major B (or A): K rows 16kk..16kk+15 of an [R][D] tile, the N (or M)
// columns of panel pn
template <int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int pn, int kk) {
  return desc(tile + pn * (R * 128) + kk * 16 * 128);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// ties the accumulators to the wait above, so that nothing reads them before
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// the named barrier `id` (1..15) of one warpgroup's 128 threads
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

#define WGMMA_TILE_ACC32(d)                                                                \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])
#define WGMMA_TILE_D32                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64x64 fp32) = A.B (+ d if acc): A K-major and B K-major (or MN-major,
// read through the transpose bit, if B_MN) in shared memory
template <int B_MN = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_TILE_D32
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : WGMMA_TILE_ACC32(d)
      : "l"(a), "l"(b), "r"(acc), "n"(B_MN));
}
// d (64x64 fp32) += A.B: A (64x16 bf16) from registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_TILE_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WGMMA_TILE_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64x32 fp32) = A.B (+ d if acc): A K-major (or MN-major, read through
// the transpose bit, if A_MN) and B K-major (32 rows), both in shared memory.
// The accumulator's layout is that of the 64x64 tile above, columns 0..31.
template <int A_MN = 0>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", %16, %17, p, 1, 1, %19, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc), "n"(A_MN));
}

#undef WGMMA_TILE_ACC32
#undef WGMMA_TILE_D32

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The shared-memory limit past 48 KB is a per-device attribute of each
// function: set it once per device and template instance, not per launch.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int smem, std::atomic<uint64_t>& done) {
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

}  // namespace wgmma_tile
