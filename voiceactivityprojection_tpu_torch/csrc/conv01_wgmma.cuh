// conv0 + conv1 of the CPC encoder in bfloat16 on Hopper's tensor cores:
// the bf16 route of csrc/conv_fused.cu (K11, the TPU kernel `_fused_kernel`
// of voiceactivityprojection_tpu/ops/conv_fused.py:82). The function is the
// one in conv_fused.cu's header; this file is its sm_90a design.
//
// Bound: operations. conv1 is 98 % of the FLOPs (M = conv1 outputs, N = 256
// channels, K = 8 taps x 256 = 2048); at R = 128 x 320000 the call is 2.2
// TFLOP against 0.17 GB of samples and features. Next in line is W1 (1 MB),
// which every CTA streams through shared memory once: at M outputs a CTA
// that is 1 MB / M a conv1 output, 16.8 GB of L2 reads a call at M = 128
// (twice that at M = 64). So a CTA takes as many outputs as its registers
// allow, keeps in shared memory only one 64-channel slice of conv0 at a
// time, and gives the rest to W1's ring.
//
// One CTA per (row, 128 conv1 outputs), two warpgroups (256 threads, so up
// to 255 registers a thread): warpgroup w owns outputs 64 w .. 64 w + 63,
// all 256 output channels (an m64n256 f32 accumulator, 128 registers).
//
// 1. conv0 on the tensor cores. The tile reads 516 conv0 positions, nine
//    tiles of 64. Their im2col operands (64 positions x 16 taps, bf16, no
//    swizzle) are cut once from the CTA's 2,585 samples in shared memory,
//    zero outside [0, n) and past position 515, and multiplied by w0 with
//    its 10 taps padded to 16 by zero rows (one k-step; the padded taps meet
//    zeros, never stale values: 0 x NaN is NaN). The CUDA-core route spends
//    10 FMAs an output element where the tensor cores spend a fraction of
//    one (and, tried here in conv1's shadow, cost more than it hid).
//    a. Statistics and group 0: one m64n256k16 product per tile (two n128
//       halves into the accumulators conv1 uses later); a position's 256
//       channels lie in one quad of lanes, so its mean and unbiased
//       variance are quad sums (two passes over the registers), kept in
//       shared memory; channels 0-63 are normalised and stored at once.
//    b. Groups 1-3 of conv1's contraction (64 input channels each): conv0
//       is recomputed for the group, a warpgroup's five tiles issued
//       together as m64n32k16 products (two halves, 5 x 16 registers beside
//       conv1's 128: one wait a half instead of one a tile), normalised
//       with the kept statistics, passed through ReLU and stored.
//    Stored means: rounded to bf16, polyphase: position p to plane p % 4,
//    row p / 4 (129 rows of 128 bytes a plane; chunk c of the row at shared
//    address a sits at a + 16 (c ^ ((a >> 7) & 7)), so the 8 rows an
//    ldmatrix reads meet 8 bank groups), literal zeros for positions outside
//    [0, n0) (conv1's padding).
// 2. conv1 over a group's 8 taps x 64 channels: tap t of output j reads
//    position 4 j + t, plane t % 4, row j + t / 4. Rows t / 4 = 1 start
//    inside a 128-byte swizzle atom, which a wgmma shared-memory descriptor
//    did not read right on the H100 even with its base-offset field (bits
//    49-51) set to the row phase, so A comes from registers: each warp
//    loads its 16 rows of a k-step with one ldmatrix.x4 (any row address
//    works) and issues `wgmma` m64n128k16 twice (the halves of N = 256)
//    with A in registers and B read from W1 in place as the MN-major operand
//    (as K1's conv_cn_relu_wgmma_kernel); one stage's products stay in
//    flight while the next stage's A is loaded.
// 3. W1 streams in the order it is used (group-major: rows t * 256 + 64 g
//    + 32 h) by TMA (128-byte swizzle) into a 7-stage mbarrier ring of 32
//    rows x 256 columns. Thread 0 arms each stage's full barrier with its
//    bytes and issues the first 7 loads; a later load is issued by the
//    thread whose release of the stage's previous load is the last one a
//    CTA counts (an atomic count a stage), so no thread waits to refill a
//    stage and no third warpgroup takes registers (a producer warpgroup
//    left the consumers too few registers, and they spilled). Each CTA
//    loads all of W1: multicasting each load to a thread-block cluster of
//    2 or 4 CTAs (neighbouring position tiles) was slower on the H100 at
//    every size tried (PERF.md), and was removed.
// 4. The epilogue adds the bias, applies ChannelNorm (quad sums again) and
//    ReLU to the f32 accumulators, stages the bf16 tile in shared memory
//    (the planes' region, free by then) and writes it out in whole rows,
//    one 16-byte store a lane.
//
// Nothing here changes a helper of wgmma.cuh:
// the m64n128 and m64n32 products, the no-swizzle descriptor and the
// ldmatrix load are new functions beside the old ones.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace vap {
namespace c01 {
namespace wg = vap::wg;
using bf16 = __nv_bfloat16;

constexpr int C = 256;                      // channels
constexpr int K0 = 10, S0 = 5, P0 = 3;      // conv0
constexpr int K1 = 8, S1 = 4, P1 = 2;       // conv1
constexpr int TU = 128;                     // conv1 outputs a CTA
constexpr int NPOS = S1 * (TU - 1) + K1;    // conv0 positions a tile reads: 516
constexpr int PLANES = S1;                  // polyphase planes
constexpr int PLANE_ROWS = NPOS / PLANES;   // 129
constexpr int PLANE_BYTES = PLANE_ROWS * 128;          // 64 channels of a plane: 16,512
constexpr int Z0_BYTES = PLANES * PLANE_BYTES;         // one channel group: 66,048
constexpr int GROUPS = C / 64;              // input-channel groups of conv1
constexpr int TAPS0 = 16;                   // conv0's taps, padded to one k-step
constexpr int NSAMP = S0 * (NPOS - 1) + K0;            // samples a tile reads: 2,585
constexpr int NSAMP_BUF = 2592;             // >= S0 * (NPOS - 1) + TAPS0, zero past NSAMP
constexpr int CONV0_TILES = (NPOS + 63) / 64;          // 9
constexpr int KTOT = K1 * C;                // 2048
constexpr int STAGE_ROWS = 32;              // W1 rows a stage
constexpr int STAGES = 7;
constexpr int LOADS = KTOT / STAGE_ROWS;    // 64 stage loads a CTA
constexpr int LOADS_PER_GROUP = LOADS / GROUPS;        // 16
constexpr int BOX_BYTES = STAGE_ROWS * 128;            // one 64-channel box of a stage
constexpr int STAGE_BYTES = STAGE_ROWS * C * 2;        // 16,384
constexpr int NT = 256;                     // two warpgroups (8 warps: up to 255 registers a thread)

// shared memory, offsets from the first 1024-aligned address
constexpr int OFF_RING = 0;
constexpr int OFF_W0 = OFF_RING + STAGES * STAGE_BYTES;            // 114,688: 4 tiles of 16 x 64
constexpr int OFF_A0 = OFF_W0 + GROUPS * TAPS0 * 128;              // 122,880: 9 im2col tiles of 64 x 16
constexpr int A0_TILE_BYTES = 64 * TAPS0 * 2;                      // 2,048, no swizzle
constexpr int OFF_Z0 = OFF_A0 + CONV0_TILES * A0_TILE_BYTES;       // 141,312
constexpr int OFF_SAMP = OFF_Z0 + Z0_BYTES;                        // 205,312
constexpr int OFF_PARAM = OFF_SAMP + NSAMP_BUF * 2;                // 210,496: 6 x 256 f32
constexpr int OFF_STATS = OFF_PARAM + 6 * C * 4;                   // 216,640: (mean, inv) a position
constexpr int OFF_BARS = OFF_STATS + CONV0_TILES * 64 * 8;         // 223,296
constexpr int SMEM_USED = OFF_BARS + STAGES * 8 + STAGES * 4;      // 223,380: full barriers, release counts
constexpr int SMEM_BYTES = SMEM_USED + 1024;                       // with the alignment slack
static_assert(OFF_W0 % 1024 == 0 && OFF_A0 % 1024 == 0, "swizzled regions read by wgmma");
static_assert(TU * C * 2 <= Z0_BYTES, "the output tile is staged in the planes' region");
static_assert(SMEM_BYTES <= 232448, "one CTA an SM");
static_assert(NSAMP_BUF >= S0 * (NPOS - 1) + TAPS0, "the padded taps stay in the buffer");

// ---- helpers new to this kernel ---------------------------------------------
// a no-swizzle K-major descriptor (layout type 0): 8-row x 16-byte core
// matrices of 128 contiguous bytes, `lbo` apart along K and `sbo` apart
// along M (the im2col tiles: K = 16, two core matrices a row group)
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}
// byte offset of element k (< 16) of row r in such a tile
__device__ __forceinline__ uint32_t plain_off(int r, int k) {
  return (r >> 3) * 256 + (k >> 3) * 128 + (r & 7) * 16 + (k & 7) * 2;
}
// four 8 x 8 bf16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8: the A fragment of one wgmma k-step for a warp
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// byte address of chunk c (elements 8c .. 8c + 7) of the 128-byte row at
// `row`, under the address-based 128-byte swizzle
__device__ __forceinline__ uint32_t swz_abs(uint32_t row, int c) {
  return row + ((static_cast<uint32_t>(c) ^ ((row >> 7) & 7)) << 4);
}

#define VAP_C01_ACC64(d)                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),   \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),   \
      "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),   \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),   \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),   \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),   \
      "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (+)= A B, m64n128k16, bf16 in, f32 accumulate; A K-major and B MN-major
// (a K rows x N columns row-major operand), both from shared memory.
// `accumulate` 0 ignores d.
__device__ __forceinline__ void mma_n128(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : VAP_C01_ACC64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}
// d (+)= A B, m64n128k16, A from registers (the four bf16x2 fragments of
// one k-step) and B MN-major from shared memory
__device__ __forceinline__ void mma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : VAP_C01_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
// d = A B, m64n32k16, A K-major and B MN-major from shared memory
__device__ __forceinline__ void mma_n32(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, 0, 1, 1, 0, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b));
}
__device__ __forceinline__ void pin_a(uint32_t (&a)[2][4]) {
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}
__device__ __forceinline__ void pin64(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---- mbarrier and TMA: csrc/wgmma.cuh ------------------------------------------
// adds one to the u32 at a shared address of this CTA, with release and
// acquire at CTA scope; returns the value before
__device__ __forceinline__ uint32_t atom_add_cta(uint32_t addr) {
  uint32_t old;
  asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], 1;\n" : "=r"(old) : "r"(addr) : "memory");
  return old;
}

// byte offset (from the aligned base) of channel chunk c8 (channels 8 c8 ..
// 8 c8 + 7 of the current 64-channel group) of conv0 position p of the
// tile: plane p % 4, row p / 4
__device__ __forceinline__ uint32_t z0_chunk(int p, int c8) {
  return swz_abs(OFF_Z0 + (p & 3) * PLANE_BYTES + (p >> 2) * 128, c8);
}

// ---- the kernel -------------------------------------------------------------
// Accumulator element i of thread t (m64n128 half h2 of a warpgroup's
// m64n256): row acc_row(t, i), channel 128 h2 + 8 (i / 4) + 2 (t % 4) + i % 2.
struct Params {
  const bf16* x;        // (R, n)
  const bf16* w0;       // (10, 1, 256)
  const bf16* b0;
  const bf16* g0;
  const bf16* e0;
  const bf16* b1;
  const bf16* g1;
  const bf16* e1;
  bf16* out;            // (R, n1, 256)
  int n, n0, n1;
};

// adds the bias to a warpgroup's m64n256 accumulator (two halves) and
// returns each of the thread's two rows' mean and 1 / sqrt(var + eps),
// unbiased, two passes, all 256 channels of a row in one quad of lanes
__device__ __forceinline__ void row_stats(float (&d0)[64], float (&d1)[64], const float* bias, int t,
                                          float (&mean)[2], float (&inv)[2]) {
  const int cq = 2 * (t & 3);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int c8 = 0; c8 < 16; ++c8) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * c8 + cq);
    const float2 b2 = *reinterpret_cast<const float2*>(bias + 128 + 8 * c8 + cq);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      d0[4 * c8 + 2 * h] += b.x;
      d0[4 * c8 + 2 * h + 1] += b.y;
      d1[4 * c8 + 2 * h] += b2.x;
      d1[4 * c8 + 2 * h + 1] += b2.y;
      sum[h] += (d0[4 * c8 + 2 * h] + d0[4 * c8 + 2 * h + 1]) + (d1[4 * c8 + 2 * h] + d1[4 * c8 + 2 * h + 1]);
    }
  }
  float d2[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) mean[h] = wg::quad_sum(sum[h]) * (1.f / C);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float u = d0[i] - mean[(i >> 1) & 1], v = d1[i] - mean[(i >> 1) & 1];
    d2[(i >> 1) & 1] += u * u + v * v;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) inv[h] = rsqrtf(wg::quad_sum(d2[h]) * (1.f / (C - 1)) + 1e-5f);
}

// the im2col tiles of conv0 (positions 64 ti + r, taps k < 16: sample
// 5 (64 ti + r) + k of the CTA's buffer, zero past position NPOS - 1), one
// 16-byte chunk (8 taps of a position) a step of the threads
__device__ __forceinline__ void im2col_all(uint8_t* sm, int tid) {
  const bf16* samp = reinterpret_cast<const bf16*>(sm + OFF_SAMP);
  for (int q = tid; q < CONV0_TILES * 64 * 2; q += NT) {
    const int pos = q >> 1, c = q & 1;
    uint32_t v[4] = {0, 0, 0, 0};
    if (pos < NPOS) {
      const bf16* s = samp + S0 * pos + 8 * c;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        __nv_bfloat162 pr;
        pr.x = s[2 * k];
        pr.y = s[2 * k + 1];
        v[k] = *reinterpret_cast<uint32_t*>(&pr);
      }
    }
    *reinterpret_cast<uint4*>(sm + OFF_A0 + (pos >> 6) * A0_TILE_BYTES + plain_off(pos & 63, 8 * c)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// the W1 row of stage load i: group-major, rows t * 256 + 64 g + 32 h
__device__ __forceinline__ int load_row(int i) {
  const int g = i / LOADS_PER_GROUP, k = i % LOADS_PER_GROUP;
  return (k >> 1) * C + 64 * g + STAGE_ROWS * (k & 1);
}

__global__ void __launch_bounds__(NT, 1) conv01_wgmma_kernel(const __grid_constant__ CUtensorMap w1map,
                                                             const Params p) {
  extern __shared__ uint8_t raw[];
  const uint32_t S = wg::align1024(raw);           // shared address of the aligned base
  uint8_t* sm = raw + (S - wg::smem_u32(raw));     // the same, generic
  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int row = blockIdx.y;
  const int u0 = blockIdx.x * TU;                  // first conv1 output of the tile
  const int p_first = S1 * u0 - P1;                // conv0 position of tile position 0
  const uint32_t full = S + OFF_BARS, released = full + STAGES * 8;

  // ---- set-up: barriers, samples, padded w0, the norms' parameters ----------
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(full + 8 * s, 1);
      *reinterpret_cast<uint32_t*>(sm + OFF_BARS + STAGES * 8 + 4 * s) = 0;
    }
    wg::fence_mbar_init();
  }
  {
    const bf16* xr = p.x + static_cast<size_t>(row) * p.n;
    const long long s_first = static_cast<long long>(S0) * p_first - P0;
    bf16* samp = reinterpret_cast<bf16*>(sm + OFF_SAMP);
    for (int i = tid; i < NSAMP_BUF; i += NT) {
      const long long g = s_first + i;
      samp[i] = (i < NSAMP && g >= 0 && g < p.n) ? xr[g] : __float2bfloat16_rn(0.f);
    }
    for (int q = tid; q < (C / 8) * TAPS0; q += NT) {  // 16-byte chunks of w0, taps 10..15 zero
      const int tap = q >> 5, cc = q & 31;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (tap < K0) v = *reinterpret_cast<const uint4*>(p.w0 + tap * C + 8 * cc);
      *reinterpret_cast<uint4*>(sm + OFF_W0 + (cc >> 3) * (TAPS0 * 128) + wg::swz(tap, cc & 7)) = v;
    }
    float* prm = reinterpret_cast<float*>(sm + OFF_PARAM);
#pragma unroll
    for (int v = 0; v < 6; ++v) {
      const bf16* src = v == 0 ? p.b0 : v == 1 ? p.g0 : v == 2 ? p.e0 : v == 3 ? p.b1 : v == 4 ? p.g1 : p.e1;
      for (int i = tid; i < C; i += NT) prm[v * C + i] = __bfloat162float(src[i]);
    }
    __syncthreads();  // the samples are in
    im2col_all(sm, tid);
    wg::fence_proxy_async();
  }
  __syncthreads();

  // W1's stage loads. Load L goes to stage L % STAGES, as four 64-channel
  // boxes. Thread 0 arms the stage's full barrier for a load (the bytes to
  // expect) and issues the first STAGES; a later load is issued by the
  // thread whose release of the stage's previous load is the second (both
  // warpgroups) on the stage's count. So no thread waits to refill a stage.
  auto issue = [&](int load) {
    const int s = load % STAGES;
#pragma unroll
    for (int g = 0; g < 4; ++g)
      wg::tma_load(S + OFF_RING + s * STAGE_BYTES + g * BOX_BYTES, &w1map, 64 * g, load_row(load), full + 8 * s);
  };
  if (tid == 0)
    for (int load = 0; load < STAGES; ++load) {
      wg::mbar_expect_tx(full + 8 * load, STAGE_BYTES);
      issue(load);
    }
  {
    const int w = __shfl_sync(0xffffffffu, tid / 128, 0);  // warpgroup (uniform): outputs 64 w ..
    const int t = tid & 127;
    const int row0 = wg::acc_row(t, 0), cq = 2 * (t & 3);
    const float* prm = reinterpret_cast<const float*>(sm + OFF_PARAM);
    float2* stats = reinterpret_cast<float2*>(sm + OFF_STATS);
    float d0[64], d1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d0[i] = d1[i] = 0.f;

    // stores conv0's normalised channels 64 g + 8 c8 + cq, +1 of the thread's
    // two rows of tile ti (value(c8, h, e) the pre-norm sum with the bias)
    auto store_group = [&](int g, int ti, int c8_first, int c8_count, auto value) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pos = 64 * ti + row0 + 8 * h;
        if (pos >= NPOS) continue;
        const float2 st = stats[pos];
        const int gp = p_first + pos;
        const bool valid = gp >= 0 && gp < p.n0;  // conv1's padding: literal zeros
#pragma unroll
        for (int c8 = c8_first; c8 < c8_first + c8_count; ++c8) {
          const int ch = 64 * g + 8 * c8 + cq;
          const float2 gm = *reinterpret_cast<const float2*>(prm + C + ch);
          const float2 be = *reinterpret_cast<const float2*>(prm + 2 * C + ch);
          const float y0 = fmaxf((value(c8, h, 0) - st.x) * st.y * gm.x + be.x, 0.f);
          const float y1 = fmaxf((value(c8, h, 1) - st.x) * st.y * gm.y + be.y, 0.f);
          *reinterpret_cast<__nv_bfloat162*>(sm + z0_chunk(pos, c8) + cq * 2) =
              valid ? __floats2bfloat162_rn(y0, y1) : __floats2bfloat162_rn(0.f, 0.f);
        }
      }
    };

    // ---- 1a. conv0's statistics (all 256 channels) and group 0 ------------
    for (int ti = w; ti < CONV0_TILES; ti += 2) {
      const uint64_t a = desc_plain(S + OFF_A0 + ti * A0_TILE_BYTES, 128, 256);
      wg::fence();
      mma_n128(d0, a, wg::desc_sw128(S + OFF_W0, TAPS0 * 128, 1024), 0);
      mma_n128(d1, a, wg::desc_sw128(S + OFF_W0 + 2 * TAPS0 * 128, TAPS0 * 128, 1024), 0);
      wg::commit();
      wg::wait<0>();
      pin64(d0);
      pin64(d1);
      float mean[2], inv[2];
      row_stats(d0, d1, prm, t, mean, inv);  // (adds the bias)
      if ((t & 3) == 0)
#pragma unroll
        for (int h = 0; h < 2; ++h) stats[64 * ti + row0 + 8 * h] = make_float2(mean[h], inv[h]);
      __syncwarp();  // the quad's statistics before its lanes read them
      store_group(0, ti, 0, 8, [&](int c8, int h, int e) { return d0[4 * c8 + 2 * h + e]; });
    }

    // ---- 1b + 2, for each input-channel group g ---------------------------
    // lane l reads output row j = 64 w + 16 (warp % 4) + l % 16, channel
    // chunk l / 16 of a k-step: tile position 4 j + tap
    const int lane = tid & 31, j = 64 * w + 16 * (warp & 3) + (lane & 15), kh = lane >> 4;
    auto stage = [&](int i, uint32_t (&a)[2][4], uint32_t (&prev)[2][4]) {
      const int s = i % STAGES;
      const int k = i % LOADS_PER_GROUP, tap = k >> 1;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) ldsm_x4(S + z0_chunk(4 * j + tap, 4 * (k & 1) + 2 * kk + kh), a[kk]);
      wg::mbar_wait(full + 8 * s, (i / STAGES) & 1);
      // the stage's next phase is load i + STAGES: arm it (no load of it can
      // start before both warpgroups release load i)
      if (tid == 0 && i + STAGES < LOADS) wg::mbar_expect_tx(full + 8 * s, STAGE_BYTES);
      const uint32_t b = S + OFF_RING + s * STAGE_BYTES;
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        mma_rs_n128(d0, a[kk], wg::desc_sw128(b + 2048 * kk, BOX_BYTES, 1024), i > 0 || kk > 0);
        mma_rs_n128(d1, a[kk], wg::desc_sw128(b + 2 * BOX_BYTES + 2048 * kk, BOX_BYTES, 1024), i > 0 || kk > 0);
      }
      wg::commit();
      wg::wait<1>();  // load i - 1's products are done: its stage and A registers are free
      pin_a(prev);    // (their registers stay untouched until here)
      // release load i - 1's stage; the second release on the stage's count
      // issues load i - 1 + STAGES
      if (i > 0 && t == 0 && i - 1 + STAGES < LOADS)
        if (atom_add_cta(released + 4 * ((i - 1) % STAGES)) % 2 == 1) issue(i - 1 + STAGES);
    };
    for (int g = 0; g < GROUPS; ++g) {
      // 1b. conv0's channels 64 g .. 64 g + 63 into the polyphase planes, in
      // two n32 halves: a warpgroup's (up to) five tiles are issued together
      // into 5 x 16 accumulator registers beside conv1's 128, then stored
      constexpr int MY_TILES = (CONV0_TILES + 1) / 2;  // 5
#pragma unroll
      for (int half = 0; g > 0 && half < 2; ++half) {
        float c[MY_TILES][16];
        wg::fence();
#pragma unroll
        for (int k = 0; k < MY_TILES; ++k)
          if (w + 2 * k < CONV0_TILES)
            mma_n32(c[k], desc_plain(S + OFF_A0 + (w + 2 * k) * A0_TILE_BYTES, 128, 256),
                    wg::desc_mn(S + OFF_W0 + g * (TAPS0 * 128) + 64 * half, 0));
        wg::commit();
        wg::wait<0>();  // (also conv1's products still in flight)
#pragma unroll
        for (int k = 0; k < MY_TILES; ++k) {
          if (w + 2 * k >= CONV0_TILES) continue;
#pragma unroll
          for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(c[k][i])::"memory");
          store_group(g, w + 2 * k, 4 * half, 4, [&](int c8, int h, int e) {
            return c[k][4 * (c8 - 4 * half) + 2 * h + e] + prm[64 * g + 8 * c8 + cq + e];
          });
        }
      }
      __syncthreads();  // group g's planes are complete
      // 2. conv1 over group g: 16 stage loads of 32 W1 rows, two k-steps each
      // (no product is in flight here: conv0's last products waited for all)
      uint32_t a_even[2][4], a_odd[2][4];
      for (int i = g * LOADS_PER_GROUP; i < (g + 1) * LOADS_PER_GROUP; i += 2) {
        stage(i, a_even, a_odd);
        stage(i + 1, a_odd, a_even);
      }
      __syncthreads();  // every warp's reads of group g's planes are done
    }
    wg::wait<0>();
    pin64(d0);
    pin64(d1);

    // ---- 3. epilogue: bias, ChannelNorm, ReLU, one bf16 write -------------
    // The normalised tile goes to shared memory (the planes' region, free
    // now: row r at 512 r, its 16-byte chunk c at c ^ (r % 8), so a warp's
    // eight rows meet eight bank groups), then out in whole rows: a warp
    // stores a row's 512 bytes with one 16-byte store a lane.
    float mean[2], inv[2];
    row_stats(d0, d1, prm + 3 * C, t, mean, inv);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * w + row0 + 8 * h;
#pragma unroll
      for (int c8 = 0; c8 < 32; ++c8) {
        const int ch = 8 * c8 + cq;
        const float2 gm = *reinterpret_cast<const float2*>(prm + 4 * C + ch);
        const float2 be = *reinterpret_cast<const float2*>(prm + 5 * C + ch);
        const float v0 = c8 < 16 ? d0[4 * c8 + 2 * h] : d1[4 * (c8 - 16) + 2 * h];
        const float v1 = c8 < 16 ? d0[4 * c8 + 2 * h + 1] : d1[4 * (c8 - 16) + 2 * h + 1];
        *reinterpret_cast<__nv_bfloat162*>(sm + OFF_Z0 + r * 512 + ((c8 ^ (r & 7)) << 4) + cq * 2) =
            __floats2bfloat162_rn(fmaxf((v0 - mean[h]) * inv[h] * gm.x + be.x, 0.f),
                                  fmaxf((v1 - mean[h]) * inv[h] * gm.y + be.y, 0.f));
      }
    }
    __syncthreads();
    for (int q = tid; q < TU * 32; q += NT) {
      const int r = q >> 5, c = q & 31;
      if (u0 + r >= p.n1) continue;
      *reinterpret_cast<uint4*>(p.out + (static_cast<size_t>(row) * p.n1 + u0 + r) * C + 8 * c) =
          *reinterpret_cast<const uint4*>(sm + OFF_Z0 + r * 512 + ((c ^ (r & 7)) << 4));
    }
  }
}

}  // namespace c01
}  // namespace vap
