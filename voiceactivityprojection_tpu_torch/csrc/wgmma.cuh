// Hopper tensor-core pieces shared by the attention kernels
// (csrc/flash_alibi.cu, csrc/flash_alibi_train.cu) and the conv stack
// (csrc/conv_stack.cu): bf16 64 x 64 tiles in
// shared memory under the 128-byte swizzle, filled by cp.async, read by
// `wgmma.mma_async` m64n64k16 (f32 accumulators) through matrix descriptors.
// Needs sm_90a.
//
// Tile layout. A 64 x 64 bf16 tile is 64 rows of 128 bytes (8 KB), based at
// a 1024-byte-aligned shared address. The 16-byte chunk c (elements 8c ..
// 8c + 7) of row r sits at byte r * 128 + 16 * (c ^ (r % 8)): the layout TMA
// writes under CU_TENSOR_MAP_SWIZZLE_128B, and the one the descriptor's
// swizzle mode 1 reads. One stored tile serves two operand roles:
// - K-major (the contraction runs along the 64 elements of a row: Q and K in
//   Q K^T): 8-row groups 1024 bytes apart (SBO), the k-step of 16 elements
//   one 32-byte move of the start address inside the swizzle atom;
// - MN-major (the contraction runs down the rows: V in P V, K in dS K):
//   the descriptor's transpose bit set, 8-row groups 1024 bytes apart, the
//   k-step of 16 rows a 2048-byte move. The 64-element row is exactly one
//   swizzle atom wide, so the stride between atoms along MN is never used;
//   both byte offsets are set to 1024.
//
// Accumulators. Element i (0..31) of thread t of the warpgroup, in an
// m64n64 f32 accumulator, is row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2)
// and column 8 (i / 4) + 2 (t % 4) + i % 2 (`acc_row`, `acc_col`). Rounded
// pairwise to bf16, accumulator elements 8kk .. 8kk + 7 are the A fragment
// of k-step kk (columns 16kk .. 16kk + 15) of a product whose A comes from
// registers (`acc_to_a`), so a score tile feeds the next product without a
// trip through shared memory.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace vap {
namespace wg {

constexpr int NT = 128;           // one warpgroup
constexpr int TILE = 64;          // rows and columns of a tile
constexpr int TILE_BYTES = 8192;  // 64 rows of 128 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of chunk c (elements 8c .. 8c + 7) of row r in a swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// shared-memory matrix descriptor, 128-byte swizzle (layout type 1)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (static_cast<uint64_t>(1) << 62);
}
// descriptors of k-step kk of a tile read K-major and MN-major
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc_sw128(tile + 32 * kk, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc_sw128(tile + 2048 * kk, 1024, 1024);
}

// ---- wgmma ordering -------------------------------------------------------
__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins registers at this point of the program: the compiler may not move
// their reads or writes across it (wgmma writes them behind its back)
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

#define VAP_WG_ACC32(d)                                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),   \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),   \
      "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define VAP_WG_D32                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (+)= A B, m64n64k16, bf16 in, f32 accumulate; A and B from shared memory,
// B K-major (TRANS_B 0) or MN-major (TRANS_B 1: a (K rows x N columns)
// row-major tile), A K-major (TRANS_A 0) or MN-major (TRANS_A 1: a (K rows
// x M columns) row-major tile, the GRU backward's h^T). `accumulate` 0
// ignores d. (TRANS_A 0 emits the same instruction text as before it
// existed.)
template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VAP_WG_D32
      ", %32, %33, p, 1, 1, %36, %35;\n}\n"
      : VAP_WG_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B), "n"(TRANS_A));
}

// d += A B with A from registers (the four bf16x2 A fragments of one k-step)
// and B from shared memory, MN-major (transpose bit 1)
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VAP_WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : VAP_WG_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// An attention operand of head width DH (32, 64 or 128) in shared memory:
// DH / 64 swizzled tiles side by side (panel p holds columns 64 p ..
// 64 p + 63) or, for DH = 32, one tile whose columns 32 .. 63 are zeros. A
// contraction over DH runs DH / 16 k-steps (the zero columns are never
// read); an output DH wide is one m64n64 accumulator a panel, of which the
// first OUT_ELEMS elements of each thread lie in columns < DH.
template <int DH>
struct Head {
  static_assert(DH == 32 || DH == 64 || DH == 128, "the attention kernels take head widths 32, 64, 128");
  static constexpr int PANELS = DH < TILE ? 1 : DH / TILE;
  static constexpr uint32_t BYTES = PANELS * TILE_BYTES;
  static constexpr int KSTEPS = DH / 16;
  static constexpr int OUT_ELEMS = DH < TILE ? 16 : 32;
};

// d = A B^T over the DH-deep contraction of two K-major operands
template <int DH>
__device__ __forceinline__ void tile_abt(float (&d)[32], uint32_t a_tile, uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < Head<DH>::KSTEPS; ++kk)
    mma_ss<0>(d, desc_k(a_tile + (kk >> 2) * TILE_BYTES, kk & 3),
              desc_k(b_tile + (kk >> 2) * TILE_BYTES, kk & 3), kk);
}
// d += A B with A the register fragments of four k-steps and B an MN-major tile
__device__ __forceinline__ void tile_rs(float (&d)[32], const uint32_t (&a)[4][4], uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_rs(d, a[kk], desc_mn(b_tile, kk));
}

// ---- accumulator layout ---------------------------------------------------
__device__ __forceinline__ int acc_row(int t, int i) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int t, int i) { return 8 * (i >> 2) + 2 * (t & 3) + (i & 1); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// the accumulator rounded to bf16 as the A fragments of its four k-steps
__device__ __forceinline__ void acc_to_a(const float (&d)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) a[kk][f] = pack_bf16(d[8 * kk + 2 * f], d[8 * kk + 2 * f + 1]);
}

// max / sum over the 4 lanes of a quad (the lanes that hold one row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- the cp.async ring ----------------------------------------------------
// 16 bytes from global to shared, or 16 zero bytes when !valid (src-size 0:
// nothing is read, and `src` must still be a mapped address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// orders this thread's completed shared-memory writes before later reads by
// the async proxy (wgmma); a barrier then extends that to the warpgroup
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows [r0, r0 + 64) of a (rows x DH) bf16 slice into a Head<DH> operand,
// zeros past `rows` (and in columns DH .. 63 for DH = 32): 512 chunks a
// panel, four per thread, eight threads per row. (The attention kernels'
// loader, written out rather than as a call of load_tile_rows: that call's
// extra bounds tests cost the dK/dV kernel 14 registers and one block an
// SM, and the backward pair 15 % of its time on the H100.)
template <int DH>
__device__ __forceinline__ void load_head(uint32_t tile, const __nv_bfloat16* __restrict__ src, int r0,
                                          int rows, int tid) {
#pragma unroll
  for (int p = 0; p < Head<DH>::PANELS; ++p)
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int idx = tid + NT * it;
      const int r = idx >> 3, c = idx & 7;
      const int g = r0 + r;
      const bool ok = g < rows && (DH >= TILE || c < DH / 8);
      // a skipped copy still names an address inside the slice
      const size_t off = DH >= TILE ? static_cast<size_t>(ok ? g : 0) * DH + p * TILE + c * 8
                                    : (ok ? static_cast<size_t>(g) * DH + c * 8 : 0);
      cp_async16(tile + p * TILE_BYTES + swz(r, c), src + off, ok);
    }
}
// a strided window into a swizzled tile: tile row r <- the 64 elements at
// src + g * ld with g = g0 + r * gstep, or zeros where r >= nrows or g lies
// outside [0, glim) (the conv kernel's im2col rows, s input positions
// apart; a 64-column slice of a weight matrix whose rows are ld apart)
__device__ __forceinline__ void load_tile_rows(uint32_t tile, const __nv_bfloat16* __restrict__ src,
                                               int g0, int gstep, int glim, int nrows, int ld,
                                               int tid) {
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int idx = tid + NT * it;
    const int r = idx >> 3, c = idx & 7;
    const int g = g0 + r * gstep;
    const bool ok = r < nrows && g >= 0 && g < glim;
    cp_async16(tile + swz(r, c), src + static_cast<size_t>(ok ? g : 0) * ld + c * 8, ok);
  }
}
// rows [r0, r0 + 64) of a per-row f32 vector, zeros past `rows`: element t
// by the thread that passes t in [0, 64); others pass t outside that range
__device__ __forceinline__ void load_rows(uint32_t dst, const float* __restrict__ src, int r0,
                                          int rows, int t) {
  if (static_cast<unsigned>(t) < TILE) {
    const int g = r0 + t;
    const bool ok = g < rows;
    cp_async4(dst + 4 * t, src + (ok ? g : 0), ok);
  }
}

// the first 1024-byte-aligned shared address at or after `raw`
__device__ __forceinline__ uint32_t align1024(const void* raw) {
  return (smem_u32(raw) + 1023u) & ~1023u;
}

}  // namespace wg
}  // namespace vap
