// Hopper tensor-core pieces shared by the attention kernels
// (csrc/flash_alibi.cu, csrc/flash_alibi_train.cu) and the conv stack
// (csrc/conv_stack.cu): bf16 64 x 64 tiles in
// shared memory under the 128-byte swizzle, filled by cp.async, read by
// `wgmma.mma_async` m64n64k16 (f32 accumulators) through matrix descriptors;
// and the float32 operands of the 3xTF32 kernels (m64n64k8 tf32, the
// section at the end). Needs sm_90a.
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

// ---- float32 on the tensor cores: 3xTF32 ------------------------------------
// A float32 value v is split into hi = rna(v) and lo = rna(v - hi), both
// tf32 (10 mantissa bits); A B is then A_lo B_hi + A_hi B_lo + A_hi B_hi,
// three m64n64k8 tf32 products into one f32 accumulator, in that order (the
// dropped A_lo B_lo and the halves' own rounding leave about 2^-22 of each
// product). tf32 `wgmma` reads its shared-memory operands K-major only: a
// tile is rows of 32 floats (128 bytes, one swizzle atom wide) under the
// 128-byte swizzle, the 16-byte chunk c (floats 4c .. 4c + 3) of row r at
// swz(r, c); a k-step of 8 floats is a 32-byte move inside the atom
// (desc_k), and a contraction longer than 32 runs over panels of R rows x
// 128 bytes side by side. An operand whose contraction runs down the rows
// of the stored tensor (V in P V, dO and Q in dV and dK, K in dQ) is
// written transposed into shared memory on its way from global memory.
//
// The A fragment of a k-step held in registers: register f is row
// acc_row(t, 0) + 8 (f % 2), k-column t % 4 + 4 (f / 2). An accumulator
// holds columns 2 (t % 4) and 2 (t % 4) + 1 of each 8-column group instead,
// so a score tile feeds the next product straight from its registers when
// the contraction order inside each group of 8 is permuted: k-position p
// holds column 2 (p % 4) + p / 4, that is column c sits at k-position
// kpos(c) (`acc_to_tf32x3`), and the transposed B operand is written in the
// same order (`kpos` on its column). The sum over the group is unchanged.

// v rounded to tf32, nearest with ties away from zero (the low 13 bits zero)
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
// the position of column c of an 8-column group in the permuted contraction
__host__ __device__ __forceinline__ constexpr int kpos(int c) {
  return (c & ~7) | ((c & 7) >> 1) | ((c & 1) << 2);
}

// d (+)= A B, m64n64k8, tf32 in, f32 accumulate; A from registers (the four
// tf32 of the thread's fragment), B K-major from shared memory; `accumulate`
// 0 ignores d
__device__ __forceinline__ void mma_tf32_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " VAP_WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : VAP_WG_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
// d (+)= A B, m64n64k8 tf32, A and B K-major from shared memory
__device__ __forceinline__ void mma_tf32_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " VAP_WG_D32
      ", %32, %33, p, 1, 1;\n}\n"
      : VAP_WG_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B^T in 3xTF32 over a W-float contraction (W a multiple of 32) of
// two K-major 64-row operands, each given as its hi and lo halves (W / 32
// panels of 8 KB); `accumulate` 0 starts d from the first product
// (The base addresses pass through an empty asm at every k-step, so that
// each step's descriptors are formed only after the step before it was
// issued: formed all at once, or hoisted out of a key loop, they hold up
// to 128 registers at Dh = 128, and the kernels spill.)
template <int W>
__device__ __forceinline__ void tile_abt_tf32x3(float (&d)[32], uint32_t a_hi, uint32_t a_lo, uint32_t b_hi,
                                                uint32_t b_lo, int accumulate) {
#pragma unroll
  for (int kk = 0; kk < W / 8; ++kk) {
    asm volatile("" : "+r"(a_hi), "+r"(a_lo), "+r"(b_hi), "+r"(b_lo));
    const uint32_t p = (kk >> 2) * TILE_BYTES;
    const int ks = kk & 3;
    mma_tf32_ss(d, desc_k(a_lo + p, ks), desc_k(b_hi + p, ks), accumulate || kk);
    mma_tf32_ss(d, desc_k(a_hi + p, ks), desc_k(b_lo + p, ks), 1);
    mma_tf32_ss(d, desc_k(a_hi + p, ks), desc_k(b_hi + p, ks), 1);
  }
}
// d += A B^T as tile_abt_tf32x3, but each k-step's three products summed in
// a fresh accumulator (f[0], f[1] in turns) and added to d with FADD: the
// tensor cores' accumulation rounds toward zero, so a sum fed straight by
// `wgmma` shrinks its magnitude coherently, and the backward's dP shrunk so
// makes dS = W (dP - delta) lose its zero row sums, which the gradients of
// the q and k projections, small by cancellation, feel first (5.8e-5 of a
// leaf's largest in the CPU emulation of a train step, against 5.6e-6 so;
// tests/test_torch_flash_tf32x3.py). The next k-step's products run while
// the last one's are added. Issues its own fence, commits and waits:
// whatever was committed before has retired when it returns.
template <int W>
__device__ __forceinline__ void tile_abt_tf32x3_nearest(float (&d)[32], float (&f)[2][32], uint32_t a_hi,
                                                        uint32_t a_lo, uint32_t b_hi, uint32_t b_lo) {
#pragma unroll
  for (int kk = 0; kk < W / 8; ++kk) {
    fence();  // f[kk & 1] was last read two steps ago
    asm volatile("" : "+r"(a_hi), "+r"(a_lo), "+r"(b_hi), "+r"(b_lo));
    const uint32_t p = (kk >> 2) * TILE_BYTES;
    const int ks = kk & 3;
    mma_tf32_ss(f[kk & 1], desc_k(a_lo + p, ks), desc_k(b_hi + p, ks), 0);
    mma_tf32_ss(f[kk & 1], desc_k(a_hi + p, ks), desc_k(b_lo + p, ks), 1);
    mma_tf32_ss(f[kk & 1], desc_k(a_hi + p, ks), desc_k(b_hi + p, ks), 1);
    commit();
    if (kk > 0) {
      wait<1>();
      pin(f[(kk - 1) & 1]);
#pragma unroll
      for (int i = 0; i < 32; ++i) d[i] += f[(kk - 1) & 1][i];
    }
  }
  wait<0>();
  pin(f[(W / 8 - 1) & 1]);
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] += f[(W / 8 - 1) & 1][i];
}
// d (+)= A B in 3xTF32 over a 64-deep contraction: A the split fragments of
// its eight k-steps (acc_to_tf32x3), B a transposed operand of 64 rows
// (N) in two 32-column panels `panel` bytes apart, hi and lo
__device__ __forceinline__ void tile_rs_tf32x3(float (&d)[32], const uint32_t (&a_hi)[8][4],
                                               const uint32_t (&a_lo)[8][4], uint32_t b_hi, uint32_t b_lo,
                                               uint32_t panel, int accumulate) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    asm volatile("" : "+r"(b_hi), "+r"(b_lo));
    const uint32_t p = (kk >> 2) * panel;
    const int ks = kk & 3;
    mma_tf32_rs(d, a_lo[kk], desc_k(b_hi + p, ks), accumulate || kk);
    mma_tf32_rs(d, a_hi[kk], desc_k(b_lo + p, ks));
    mma_tf32_rs(d, a_hi[kk], desc_k(b_hi + p, ks));
  }
}

// an m64n64 accumulator split into tf32 hi and lo as the A fragments of the
// eight k-steps of a product contracting over its columns, in the permuted
// order (column 2 (t % 4) at k-position t % 4, column 2 (t % 4) + 1 at
// t % 4 + 4)
__device__ __forceinline__ void acc_to_tf32x3(const float (&d)[32], uint32_t (&hi)[8][4], uint32_t (&lo)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const float v = d[4 * kk + ((f & 1) << 1) + (f >> 1)];
      hi[kk][f] = tf32_rna(v);
      lo[kk][f] = tf32_rna(v - __uint_as_float(hi[kk][f]));
    }
}
__device__ __forceinline__ void pin(uint32_t (&a)[8][4]) {
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}
__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t a) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(a) : "memory");
}

// Rows [r0, r0 + 64) of a (rows x ld) f32 slice, columns [c0, c0 + W), read
// from global memory in 16-byte pieces (zeros past `rows`): f(r, c, v) gets
// tile row r, column c (a multiple of 4, 0 <= c < W) and the four floats
// v. Lane l of a warp takes tile row 32 h + l, so that a warp's stores to a
// K-major tile (a row each) and to a transposed one (a column each) hit 32
// different banks; each warp takes W / 8 consecutive pieces of its rows.
// `src + ld * g + c0` must be 16-byte aligned (ld and c0 multiples of 4).
// `fetch_f32` reads a thread's N pieces from piece `first` of its W / 8
// into registers, `place_f32` hands them to f; `load_f32_tile` does both,
// at most eight pieces (32 registers) in flight at once. The reads are
// volatile asm, so that they stay where the kernel issues them (a
// read-only `__ldg` may move across barriers and loop iterations); the
// thread index and the tiles' bases pass through an empty asm at each call,
// so that the addresses, which depend on nothing else, are formed there
// and not hoisted out of the key loop for every piece at once.
__device__ __forceinline__ float4 ld_nc_f4(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p)
               : "memory");
  return v;
}
template <int W, int N>
__device__ __forceinline__ void fetch_f32(float4 (&v)[N], const float* __restrict__ src, int r0, int rows, int ld,
                                          int c0, int tid, int first = 0) {
  constexpr int PIECES = W / 4;  // 16-byte pieces a row
  asm volatile("" : "+r"(tid));
  const int lane = tid & 31, w = tid >> 5;
#pragma unroll
  for (int it = 0; it < N; ++it) {
    const int item = w * (W / 8) + first + it;
    const int g = r0 + 32 * (item / PIECES) + lane;
    v[it] = g < rows ? ld_nc_f4(src + static_cast<size_t>(g) * ld + c0 + 4 * (item % PIECES))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}
template <int W, int N, typename F>
__device__ __forceinline__ void place_f32(const float4 (&v)[N], int tid, F&& f, int first = 0) {
  constexpr int PIECES = W / 4;
  asm volatile("" : "+r"(tid));
  const int lane = tid & 31, w = tid >> 5;
#pragma unroll
  for (int it = 0; it < N; ++it) {
    const int item = w * (W / 8) + first + it;
    f(32 * (item / PIECES) + lane, 4 * (item % PIECES), v[it]);
  }
}
template <int W, typename F>
__device__ __forceinline__ void load_f32_tile(const float* __restrict__ src, int r0, int rows, int ld, int c0,
                                              int tid, F&& f) {
  constexpr int EACH = W / 8, BATCH = EACH < 8 ? EACH : 8;
#pragma unroll
  for (int b0 = 0; b0 < EACH; b0 += BATCH) {
    float4 v[BATCH];
    fetch_f32<W>(v, src, r0, rows, ld, c0, tid, b0);
    place_f32<W>(v, tid, f, b0);
  }
}
// the four floats of row r, columns c .. c + 3 of a K-major tile (hi, lo):
// panel c / 32 of `panel` bytes
__device__ __forceinline__ void store_kmajor(uint32_t hi, uint32_t lo, uint32_t panel, int r, int c, float4 v) {
  asm volatile("" : "+r"(hi), "+r"(lo));
  const uint32_t off = (c >> 5) * panel + swz(r, (c & 31) >> 2);
  const uint32_t h0 = tf32_rna(v.x), h1 = tf32_rna(v.y), h2 = tf32_rna(v.z), h3 = tf32_rna(v.w);
  st_shared_v4(hi + off, h0, h1, h2, h3);
  st_shared_v4(lo + off, tf32_rna(v.x - __uint_as_float(h0)), tf32_rna(v.y - __uint_as_float(h1)),
               tf32_rna(v.z - __uint_as_float(h2)), tf32_rna(v.w - __uint_as_float(h3)));
}
// the same four floats into a transposed tile: rows c .. c + 3, column
// kpos(r) (panel kpos(r) / 32 of `panel` bytes)
__device__ __forceinline__ void store_trans(uint32_t hi, uint32_t lo, uint32_t panel, int r, int c, float4 v) {
  asm volatile("" : "+r"(hi), "+r"(lo));
  const int p = kpos(r);
  const uint32_t base = (p >> 5) * panel + 4 * (p & 3);
  const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t off = base + swz(c + j, (p & 31) >> 2);
    const uint32_t h = tf32_rna(x[j]);
    st_shared_b32(hi + off, h);
    st_shared_b32(lo + off, tf32_rna(x[j] - __uint_as_float(h)));
  }
}
// The float32 attention forwards (csrc/flash_alibi.cu K4/K5/K10,
// csrc/flash_alibi_train.cu K6) at head width DH: shared memory holds Q hi,
// Q lo, K hi, K lo, each (64 x DH) K-major in DH / 32 panels of 8 KB, then
// V^T hi and lo, each VROWS rows (DH, or 64 with zeros past DH = 32) x 64
// keys in two 32-key panels, plus the slack to align to 1024: 64, 96 and
// 192 KB at DH = 32, 64, 128 (three, two and one block an SM).
template <int DH>
struct F32Tiles {
  static constexpr uint32_t OP = DH * 256;          // one half of a 64 x DH K-major operand
  static constexpr int VROWS = DH < TILE ? TILE : DH;
  static constexpr uint32_t VPANEL = VROWS * 128;   // a 32-key panel of V^T
  static constexpr int OPANELS = DH < TILE ? 1 : DH / TILE;
  static constexpr int OUT_ELEMS = DH < TILE ? 16 : 32;
  static constexpr size_t SMEM = 4 * OP + 4 * VPANEL + 1024;
  // at DH <= 64 the next key tile's K and V are read into registers (DH / 4
  // pieces of a thread, 64 registers at DH = 64) while the current tile
  // multiplies; at 128 they would not fit beside O
  static constexpr bool PREFETCH = DH <= TILE;
};

// zeros over [addr, addr + bytes), bytes a multiple of 16
__device__ __forceinline__ void zero_shared(uint32_t addr, uint32_t bytes, int tid) {
  for (uint32_t o = 16 * tid; o < bytes; o += 16 * NT) st_shared_v4(addr + o, 0, 0, 0, 0);
}

// ---- mbarriers and TMA (K11's W1 ring, K13's ring) ---------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// waits for the phase of `parity` to complete; traps after about 2 s
// instead of hanging the card on a lost arrival
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (clock64() - start < (1ll << 32)) {
    asm volatile(
        "{\n.reg .pred P1;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
  }
  __trap();
}
// a 2-D box of the tensor map into this CTA's shared memory, counted on its
// mbarrier `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda);
// null where the driver has none
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

}  // namespace wg
}  // namespace vap
