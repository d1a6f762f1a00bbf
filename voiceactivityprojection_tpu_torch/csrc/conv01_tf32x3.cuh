// conv0 + conv1 of the CPC encoder in float32: the float32 route of
// csrc/conv_fused.cu (K11, the TPU kernel `_fused_kernel` of
// voiceactivityprojection_tpu/ops/conv_fused.py:82), conv1 on Hopper's
// tensor cores in 3xTF32. The function is the one in conv_fused.cu's
// header; this file is its float32 design.
//
// Bound: operations. conv1 is 98 % of the FLOPs (M = conv1 outputs, N = 256
// channels, K = 8 taps x 256 = 2048): 2.15 TFLOP at R = 128 x 320000, three
// TF32 products each (x_lo w_hi + x_hi w_lo + x_hi w_hi, the 3xTF32 of
// csrc/wgmma.cuh and K1's conv_cn_relu_tf32x3_kernel), 13 ms at 495 TFLOP/s
// against 65 ms for the same products in f32 FFMA.
//
// One CTA per (row, 128 conv1 outputs), two warpgroups (256 threads):
// warpgroup q owns outputs 64 q .. 64 q + 63, all 256 output channels (an
// m64n256 f32 accumulator, 128 registers).
//
// 1. conv0 in exact f32 FFMA. The tile reads 516 conv0 positions, 2,585
//    samples (kept in shared memory, zero outside [0, n)). In f32 the 516 x
//    256 conv0 outputs are 528 KB, so shared memory holds one group of 32
//    input channels at a time (66 KB):
//    a. statistics: a warp a position, a lane 8 channels (their 80 taps of
//       w0 in registers); the mean and unbiased variance over the 256
//       channels (eps 1e-5) by warp sums, two passes, kept as (mean, 1 /
//       std) a position;
//    b. for each group g of conv1's contraction (channels 32 g .. 32 g + 31,
//       a lane one channel): conv0 recomputed for the group in the same
//       order (so the same value the statistics saw), normalised, passed
//       through ReLU and stored polyphase: position p to plane p % 4, row
//       p / 4, one 128-byte row of 32 floats, its 16-byte chunk c at
//       c ^ (row % 8); literal zeros for positions outside [0, n0) (conv1's
//       padding).
// 2. conv1 over a group's 8 taps x 32 channels, a chunk a tap: tap t of
//    output j reads position 4 j + t, plane t % 4, row j + t / 4, so a
//    warp's 8 rows of a k-step are consecutive rows of one plane (8 bank
//    groups under the swizzle). tf32 `wgmma` reads shared memory K-major
//    only and the rows t / 4 = 1 start mid-atom, so A comes from registers:
//    each thread reads its fragment from the plane and splits it into tf32
//    hi and lo in registers (K1's 3xTF32 kernel does the same from its
//    im2col tile). B is the chunk's 256 output channels x 32 input channels
//    of W1's hi and lo halves, K-major (`split_tf32_kmajor_kernel` of
//    csrc/conv_stack.cu writes them, K1's pre-split layout), by cp.async
//    into a two-stage ring (64 KB a stage). A k-step is 3 products of
//    m64n256k8 (one instruction for all 256 channels). The products of a chunk stay in flight
//    while the threads issue the next chunk's W1 load, read and split its
//    A fragments (two register sets, used in turn) and, at a group's end,
//    compute the next group of conv0 (the planes are free once every
//    fragment of the group is in registers). The contraction runs
//    group-major (g, then tap, then the group's 32 channels), straight into
//    the accumulators: 768 truncating
//    additions an output, as K1's conv1, whose stack lands 4.4-4.9e-5 from
//    its plain version against the 1e-4 bar.
// 3. The epilogue adds the bias, applies ChannelNorm (quad sums, two
//    passes) and ReLU to the f32 accumulators and stores them in f32.
//
// Nothing here changes a helper of wgmma.cuh: the m64n256k8 tf32 product is
// a new function beside them.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace vap {
namespace c01f {

constexpr int C = 256;                      // channels
constexpr int K0 = 10, S0 = 5, P0 = 3;      // conv0
constexpr int K1 = 8, S1 = 4, P1 = 2;       // conv1
constexpr int TU = 128;                     // conv1 outputs a CTA
constexpr int NPOS = S1 * (TU - 1) + K1;    // conv0 positions a tile reads: 516
constexpr int PLANES = S1;                  // polyphase planes
constexpr int PLANE_ROWS = NPOS / PLANES;   // 129
constexpr int GC = 32;                      // input channels a group: one 128-byte f32 row
constexpr int GROUPS = C / GC;              // 8
constexpr int PLANE_BYTES = PLANE_ROWS * 128;        // 16,512
constexpr int Z0_BYTES = PLANES * PLANE_BYTES;       // one group of conv0: 66,048
constexpr int NSAMP = S0 * (NPOS - 1) + K0;          // samples a tile reads: 2,585
constexpr int NSAMP_BUF = 2588;             // NSAMP rounded up to 16 bytes
constexpr int B_BYTES = C * 128;            // a chunk's hi (or lo): 256 out channels x 32 in, K-major
constexpr int STAGE_BYTES = 2 * B_BYTES;    // hi, then lo: 65,536
constexpr int STAGES = 2;
constexpr int CHUNKS = GROUPS * K1;         // 64: chunk 8 g + tap
constexpr int NT = 256;                     // two warpgroups
constexpr int NWARP = NT / 32;

// shared memory, offsets from the first 1024-aligned address
constexpr int OFF_RING = 0;
constexpr int OFF_Z0 = OFF_RING + STAGES * STAGE_BYTES;   // 131,072
constexpr int OFF_SAMP = OFF_Z0 + Z0_BYTES;                // 197,120
constexpr int OFF_STATS = OFF_SAMP + NSAMP_BUF * 4;        // 207,472: (mean, 1 / std) a position
constexpr int SMEM_USED = OFF_STATS + NPOS * 8;            // 211,600
constexpr int SMEM_BYTES = SMEM_USED + 1024;               // with the alignment slack
static_assert(OFF_Z0 % 1024 == 0 && STAGE_BYTES % 1024 == 0, "swizzled tiles read by wgmma");
static_assert(SMEM_BYTES <= 232448, "one CTA an SM");

struct Params {
  const float* x;       // (R, n)
  const float* w0;      // (10, 1, 256)
  const float* b0;
  const float* g0;
  const float* e0;
  const float* w1_hi;   // (8, 256 out, 256 in): W1's tf32 hi, K-major
  const float* w1_lo;   // the same, lo
  const float* b1;
  const float* g1;
  const float* e1;
  float* out;           // (R, n1, 256)
  int n, n0, n1;
};

// byte offset (from the aligned base) of float c (< 32) of conv0 position p
// of the current group: plane p % 4, row p / 4, chunk c / 4 swizzled
__device__ __forceinline__ uint32_t z0_off(int p, int c) {
  const int r = p >> 2;
  return OFF_Z0 + (p & 3) * PLANE_BYTES + r * 128 + (((c >> 2) ^ (r & 7)) << 4) + 4 * (c & 3);
}

// d (+)= A B, m64n256k8, tf32 in, f32 accumulate: A from registers (the
// four tf32 of the thread's fragment), B K-major from shared memory, 256
// rows of 128 bytes (four 64-row tiles side by side). Element i of d is row
// wg::acc_row(t, i), column 8 (i / 4) + 2 (t % 4) + i % 2: the four m64n64
// accumulators of columns 64 g .. 64 g + 63 laid end to end.
__device__ __forceinline__ void mma_tf32_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
      "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
        "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}
__device__ __forceinline__ void pin128(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__global__ void __launch_bounds__(NT, 1) conv01_tf32x3_kernel(const Params p) {
  extern __shared__ uint8_t raw_f[];
  const uint32_t S = wg::align1024(raw_f);       // shared address of the aligned base
  uint8_t* sm = raw_f + (S - wg::smem_u32(raw_f));  // the same, generic
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int q = __shfl_sync(0xffffffffu, tid >> 7, 0);  // warpgroup (uniform): outputs 64 q ..
  const int wt = tid & 127;
  const int row = blockIdx.y;
  const int u0 = blockIdx.x * TU;                // first conv1 output of the tile
  const int p_first = S1 * u0 - P1;              // conv0 position of tile position 0
  float* samp = reinterpret_cast<float*>(sm + OFF_SAMP);
  float2* stats = reinterpret_cast<float2*>(sm + OFF_STATS);

  // chunk i (group i / 8, tap i % 8): W1's hi and lo rows (tap, out) of the
  // group's 32 input channels into stage st, four 64-row tiles each
  auto load_chunk = [&](int i, int st) {
    const int g = i >> 3, tap = i & 7;
    const uint32_t base = S + OFF_RING + st * STAGE_BYTES;
    for (int idx = tid; idx < 2 * C * 8; idx += NT) {
      const int half = idx / (C * 8), r = (idx >> 3) & (C - 1), c = idx & 7;
      const float* src = (half ? p.w1_lo : p.w1_hi) + (static_cast<size_t>(tap) * C + r) * C + GC * g + 4 * c;
      wg::cp_async16(base + half * B_BYTES + (r >> 6) * wg::TILE_BYTES + wg::swz(r & 63, c), src, true);
    }
  };
  load_chunk(0, 0);
  wg::cp_async_commit();

  // ---- set-up: the tile's samples, zero outside [0, n) ---------------------
  {
    const float* xr = p.x + static_cast<size_t>(row) * p.n;
    const long long s_first = static_cast<long long>(S0) * p_first - P0;
    for (int i = tid; i < NSAMP_BUF; i += NT) {
      const long long gi = s_first + i;
      samp[i] = (i < NSAMP && gi >= 0 && gi < p.n) ? xr[gi] : 0.f;
    }
  }
  __syncthreads();

  // ---- 1a. conv0's statistics: warp a position, lane channels lane + 32 e --
  {
    float w0r[K0][8], bb[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
#pragma unroll
      for (int tap = 0; tap < K0; ++tap) w0r[tap][e] = p.w0[tap * C + lane + 32 * e];
      bb[e] = p.b0[lane + 32 * e];
    }
    for (int pos = warp; pos < NPOS; pos += NWARP) {
      float a[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) a[e] = 0.f;
#pragma unroll
      for (int tap = 0; tap < K0; ++tap) {
        const float xv = samp[S0 * pos + tap];
#pragma unroll
        for (int e = 0; e < 8; ++e) a[e] = fmaf(xv, w0r[tap][e], a[e]);
      }
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        a[e] += bb[e];
        s += a[e];
      }
      const float mean = warp_sum(s) * (1.f / C);
      float d2 = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = a[e] - mean;
        d2 += d * d;
      }
      const float inv = rsqrtf(warp_sum(d2) * (1.f / (C - 1)) + 1e-5f);
      if (lane == 0) stats[pos] = make_float2(mean, inv);
    }
  }

  float acc[128];  // m64n256: element 32 g + i is the m64n64 element i of columns 64 g ..
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  // the thread's A fragment rows (tile outputs) and its column in a k-step
  const int fr = wg::acc_row(wt, 0) + 64 * q, fc = wt & 3;

  // ---- 1b. conv0's channels 32 g + lane, normalised, into the planes -------
  auto conv0_group = [&](int g) {
    const int ch = GC * g + lane;
    float wv[K0];
#pragma unroll
    for (int tap = 0; tap < K0; ++tap) wv[tap] = p.w0[tap * C + ch];
    const float bv = p.b0[ch], gm = p.g0[ch], be = p.e0[ch];
    for (int pos = warp; pos < NPOS; pos += NWARP) {
      float a = 0.f;
#pragma unroll
      for (int tap = 0; tap < K0; ++tap) a = fmaf(samp[S0 * pos + tap], wv[tap], a);
      a += bv;
      const float2 st = stats[pos];
      const int gp = p_first + pos;
      const float y = gp >= 0 && gp < p.n0 ? fmaxf((a - st.x) * st.y * gm + be, 0.f) : 0.f;
      *reinterpret_cast<float*>(sm + z0_off(pos, lane)) = y;
    }
  };
  // the A fragments of chunk i's 4 k-steps (tap i % 8 of the group in the
  // planes), split: register f holds output row fr + 8 (f % 2), channel
  // 8 kk + fc + 4 (f / 2)
  auto fragments = [&](int i, uint32_t(&ahi)[4][4], uint32_t(&alo)[4][4]) {
    const int tap = i & 7;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int j = fr + 8 * (f & 1), c = 8 * kk + fc + 4 * (f >> 1);
        const float v = *reinterpret_cast<const float*>(sm + z0_off(S1 * j + tap, c));
        ahi[kk][f] = wg::tf32_rna(v);
        alo[kk][f] = wg::tf32_rna(v - __uint_as_float(ahi[kk][f]));
      }
  };
  // ---- 2. conv1, chunk i: its products with the fragments (ahi, alo) made
  // while chunk i - 1's ran; then, while chunk i's run, chunk i + 1's W1
  // load, conv0's next group where chunk i + 1 starts one, and chunk i + 1's
  // fragments into (nhi, nlo), whose registers chunk i - 1's products read
  auto chunk = [&](int i, uint32_t(&ahi)[4][4], uint32_t(&alo)[4][4], uint32_t(&nhi)[4][4],
                   uint32_t(&nlo)[4][4]) {
    const int st = i & 1;
    wg::wait<0>();  // chunk i - 1's products are done
    pin128(acc);
    wg::pin(nhi);  // (their registers stay untouched until here)
    wg::pin(nlo);
    wg::cp_async_wait<0>();
    wg::fence_proxy_async();
    __syncthreads();  // chunk i's W1 is in; every warpgroup is done with the other stage
    const uint32_t Bh = S + OFF_RING + st * STAGE_BYTES, Bl = Bh + B_BYTES;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_tf32_rs_n256(acc, alo[kk], wg::desc_k(Bh, kk));
      mma_tf32_rs_n256(acc, ahi[kk], wg::desc_k(Bl, kk));
      mma_tf32_rs_n256(acc, ahi[kk], wg::desc_k(Bh, kk));
    }
    wg::commit();
    if (i + 1 < CHUNKS) {
      load_chunk(i + 1, st ^ 1);
      wg::cp_async_commit();
      if (((i + 1) & 7) == 0) {
        __syncthreads();  // every warp's fragment reads of the group are done
        conv0_group((i + 1) >> 3);
        __syncthreads();  // the next group's planes are complete
      }
      fragments(i + 1, nhi, nlo);
    }
  };

  __syncthreads();  // the statistics are in
  conv0_group(0);
  __syncthreads();  // group 0's planes are complete
  uint32_t ahi0[4][4], alo0[4][4], ahi1[4][4], alo1[4][4];
  fragments(0, ahi0, alo0);
#pragma unroll 1
  for (int i = 0; i < CHUNKS; i += 2) {
    chunk(i, ahi0, alo0, ahi1, alo1);
    chunk(i + 1, ahi1, alo1, ahi0, alo0);
  }
  wg::wait<0>();
  pin128(acc);
  wg::pin(ahi0);
  wg::pin(alo0);

  // ---- 3. epilogue: bias, ChannelNorm (unbiased), ReLU, f32 stores --------
  const int r0 = wg::acc_row(wt, 0) + 64 * q, cq = 2 * (wt & 3);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int gq = 0; gq < 4; ++gq)
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float b = p.b1[64 * gq + 8 * c8 + cq + e];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[32 * gq + 4 * c8 + 2 * h + e] += b;
          sum[h] += acc[32 * gq + 4 * c8 + 2 * h + e];
        }
      }
  float mean[2], d2[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) mean[h] = wg::quad_sum(sum[h]) * (1.f / C);
#pragma unroll
  for (int gq = 0; gq < 4; ++gq)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float d = acc[32 * gq + i] - mean[(i >> 1) & 1];
      d2[(i >> 1) & 1] += d * d;
    }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) inv[h] = rsqrtf(wg::quad_sum(d2[h]) * (1.f / (C - 1)) + 1e-5f);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int u = u0 + r0 + 8 * h;
    if (u >= p.n1) continue;
    float* o = p.out + (static_cast<size_t>(row) * p.n1 + u) * C + cq;
#pragma unroll
    for (int gq = 0; gq < 4; ++gq)
#pragma unroll
      for (int c8 = 0; c8 < 8; ++c8) {
        const int ch = 64 * gq + 8 * c8 + cq;
        float2 y;
        y.x = fmaxf((acc[32 * gq + 4 * c8 + 2 * h] - mean[h]) * inv[h] * p.g1[ch] + p.e1[ch], 0.f);
        y.y = fmaxf((acc[32 * gq + 4 * c8 + 2 * h + 1] - mean[h]) * inv[h] * p.g1[ch + 1] + p.e1[ch + 1], 0.f);
        *reinterpret_cast<float2*>(o + 64 * gq + 8 * c8) = y;
      }
  }
}

}  // namespace c01f
}  // namespace vap
