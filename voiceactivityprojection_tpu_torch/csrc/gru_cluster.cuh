// The GRU forward step on a thread-block cluster, bf16 I/O at H = 256: the
// tensor-core design of the recurrence (csrc/gru_recurrence.cu, K3) and of
// the recurrence fused with the downsample (csrc/gru_downsample.cu, K2).
// Replaces, for bf16, the TPU kernels `_gru_kernel` (:49) and
// `_gru_ds_kernel` (:94) of voiceactivityprojection_tpu/ops/gru_pallas.py,
// which keep W_hh resident in VMEM and run each step as one (B, H) x (H, 3H)
// MXU product (:64-71). Needs sm_90a.
//
// Per step t, with x_proj precomputed and gate order r, z, n:
//   hp = h @ W_hh + b_hh
//   r = sigmoid(x_r + hp_r); z = sigmoid(x_z + hp_z); n = tanh(x_n + r * hp_n)
//   h = (1 - z) * n + z * h
// The carry and the gate math are f32; outputs are bf16.
//
// Design. A cluster of 8 CTAs (one an SM) runs N rows (N = 8, 16 or 32;
// rows past R are zeros that are never stored). CTA k owns the 32 hidden
// units [32k, 32k + 32) and keeps their W_hh columns of all three gates in
// registers for the whole launch, so no step reads W_hh from L2 or shared
// memory. It computes
//   hp^T[gate columns, rows] = W_slice^T . h^T
// on `wgmma` (M = gate columns, K = H, N = rows) with A from registers and
// B, the K-major bf16 tile of h for all H units, from shared memory. Two
// warpgroups each take half of the K = H contraction (8 k-steps); each
// runs the gate math of half the rows and gets the other half's sums for
// those rows through shared memory. The two m64 A
// tiles are laid out so that the r, z and n columns of one (unit, row)
// land in one thread: rows 16w + g and 16w + g + 8 of tile 0 are gates r
// and z of unit 8w + g, row 16w + g of tile 1 is gate n and row 16w + g + 8
// zeros; thread t of warp w then holds r, z, n of unit 8w + (t % 32) / 4
// for the rows 8i + 2 (t % 4) + {0, 1}, and the gate math runs on the
// accumulator registers.
//
// The f32 carry stays in the product: h is split into h_hi = bf16(h) and
// h_lo = bf16(h - h_hi), stored side by side as the 2N columns of B, so one
// m64n(2N)k16 product a k-step gives W h_hi and W h_lo in separate
// accumulator columns, which the thread adds: an f32 x bf16 dot to about
// 2^-16 of |h|. Each thread keeps the f32 carry of its (unit, row) pairs in
// registers.
//
// After the gate math each CTA writes its units' h_hi / h_lo into its own
// next-step buffer, then sends that slice to every peer's buffer with
// st.async (16 bytes a store into distributed shared memory), each store
// counted on the peer's mbarrier of that buffer; a CTA starts step t + 1
// when its mbarrier has seen the bytes of every peer's slice (the one local
// arrival announces how many). The buffers are double, and no cluster
// barrier runs in the loop: a peer can send the buffer of step t + 2 only
// after it has the slices of step t + 1, which this CTA sends after its
// products of step t are done. x_proj slices of the CTA's units arrive by
// cp.async two steps ahead (three runs of 32 bf16 per row per step,
// zero-filled past R and T).
//
// K3's epilogue: the hi slice is bf16(h), so each CTA stores ys[:, t, its
// units] from it with 16-byte stores.
//
// K2's epilogue, fused (the GRU output never reaches device memory):
// downsample output j (k = 5, stride 2, 4 zero frames on the left) is
//   y_j = b_d + sum_tap h_{2j - 4 + tap} @ W_d[tap]
// and frame f feeds the outputs j = (f + 4 - tap) / 2 of the taps of f's
// parity. CTA k owns output channels [32 k, 32 k + 32) and keeps their W_d
// columns of all five taps resident in shared memory, packed two taps to
// an m64 tile ([tap4 | tap2], [tap0 | tap1], [tap3 | zeros]); in step t,
// after the GRU products (a second wgmma group, waited for after the gate
// math), each K half multiplies two of those tiles by the B tile of frame
// t - 1 (already in its buffer); the halves swap their sums, and each adds
// the elements of its rows to the f32 sum of their output (four in flight,
// in shared memory). When output j is complete (step 2j + 1) its LayerNorm
// statistics are reduced over the cluster in two exchanges that ride on
// the steps' mbarriers: the row sums (step 2j + 1), then the squared
// deviations from the mean (2j + 2); in step 2j + 3 each CTA normalises
// its channels, rounds to bf16, applies the exact-erf GELU and stores
// them. The loop runs until the last output is stored (steps past T carry
// zero x_proj and store nothing).
//
// Bound: the dependent steps. A step is the latency of 8 chained `wgmma`
// (per accumulator and K half), the halves' exchange, the gate math and
// the DSMEM broadcast.

#pragma once

#include "common.cuh"
#include "wgmma.cuh"

namespace vap {
namespace gc {

constexpr int H = 256;
constexpr int C = 8;                   // CTAs a cluster
constexpr int U = H / C;               // hidden units of one CTA
constexpr int KS = 2;                  // GRU warpgroups, each half of the K = H contraction
constexpr int STAGES = 3;              // x_proj ring: two steps in flight
constexpr int TILE_BYTES = 256 * 128;  // an MN-major m64 A operand with K = H (K2's W_d)
constexpr int NOUT_SLOTS = 4;          // downsample outputs in flight

// dynamic shared memory of one CTA (ops/gru_cluster.py smem_bytes reckons
// the same): alignment slack, K2's W_d tiles, the two h buffers (hi and lo
// rows), the x_proj ring, the exchange of the K halves' sums (K2: of the
// GRU's and of the conv's), K2's output sums and
// statistics, and the two buffers' mbarriers
__host__ __device__ constexpr int smem_bytes(int N, bool ds) {
  return 1024 + (ds ? 3 * TILE_BYTES : 0) + 2 * 2 * 512 * N + STAGES * N * 3 * U * 2 +
         (ds ? 2 : 1) * KS * 128 * 2 * N * 4 + (ds ? (NOUT_SLOTS * N * 32 + 2 * C * N + N) * 4 : 0) + 16;
}
constexpr int NT = 128 * KS;  // threads of one CTA: a warpgroup for each K half

struct Params {
  const __nv_bfloat16* xp;    // (R, T, 3H)
  const __nv_bfloat16* w_hh;  // (H, 3H)
  const __nv_bfloat16* b_hh;  // (3H,)
  const __nv_bfloat16* h0;    // (R, H)
  __nv_bfloat16* ys;          // K3: (R, T, H)
  const __nv_bfloat16* w_d;   // K2: (5, H, H) as (tap, in, out)
  const __nv_bfloat16* b_d;   // K2: (H,)
  const __nv_bfloat16* ln_w;  // K2: (H,)
  const __nv_bfloat16* ln_b;  // K2: (H,)
  __nv_bfloat16* out;         // K2: (R, ceil(T / 2), H)
  int R, T;
};

// ---- cluster primitives ---------------------------------------------------
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// the address of the same shared-memory offset in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the gates' f32 sigmoid and tanh through the hardware exp2 (a few ulp of
// f32 from expf; tanh x = 2 sigmoid(2x) - 1, exact to 1e-7 absolute)
__device__ __forceinline__ float sigmoid(float x) { return __frcp_rn(1.f + __expf(-x)); }
__device__ __forceinline__ float tanh_(float x) { return 2.f * sigmoid(2.f * x) - 1.f; }

// ---- wgmma m64nNk16, A MN-major and B K-major, both from shared memory -----
// (K2's conv, A a W_d tile)
template <int N> struct Mma;
template <> struct Mma<16> {
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(acc));
  }
};
template <> struct Mma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc));
  }
};
// mbarriers: a buffer is complete when its phase has seen the one local
// arrival (with the bytes to expect) and that many bytes of st.async
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// 16 bytes (or one word) into a peer's shared memory, counted on the peer's
// mbarrier `bar` when they land (both cluster addresses, from mapa)
__device__ __forceinline__ void st_async_v4(uint32_t addr, uint4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async_f32(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(addr),
               "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}
// orders this thread's generic-proxy writes to (and reads of) its CTA's
// shared memory against the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async_cta() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <> struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VAP_WG_D32 ", %32, %33, p, 1, 1, 1, 0;\n}\n"
        : VAP_WG_ACC32(d)
        : "l"(a), "l"(b), "r"(acc));
  }
};

// the same products with A from registers (the four bf16x2 A fragments of
// one k-step) and B K-major from shared memory
template <int N> struct MmaRS;
template <> struct MmaRS<16> {
  static __device__ __forceinline__ void run(float (&d)[8], uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(acc));
  }
};
template <> struct MmaRS<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(acc));
  }
};
template <> struct MmaRS<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VAP_WG_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : VAP_WG_ACC32(d)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(acc));
  }
};
// two bf16 of a column of W, rows k and k + 1, as one A-fragment register
__device__ __forceinline__ uint32_t w_pair(const __nv_bfloat16* __restrict__ w, int k, int col) {
  __nv_bfloat162 v = __halves2bfloat162(w[static_cast<size_t>(k) * 3 * H + col],
                                        w[static_cast<size_t>(k + 1) * 3 * H + col]);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int M>
__device__ __forceinline__ void pin(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// k-step ks (16 k rows) of an A tile (256 k rows of 128 bytes, swizzled)
__device__ __forceinline__ uint64_t desc_a(uint32_t tile, int ks) {
  return wg::desc_sw128(tile + 2048 * ks, 1024, 1024);
}
// k-step ks of an h buffer: 4 panels of 64 units, each 2N rows of 128
// bytes (rows 0 .. N-1 h_hi, rows N .. 2N-1 h_lo)
template <int N>
__device__ __forceinline__ uint64_t desc_b(uint32_t buf, int ks) {
  return wg::desc_sw128(buf + (ks >> 2) * (256 * N) + 32 * (ks & 3), 16, 1024);
}
// byte offset of unit k in row `row` (< 2N) of an h buffer
template <int N>
__device__ __forceinline__ uint32_t b_offset(int row, int k) {
  return (k >> 6) * (256 * N) + wg::swz(row, (k & 63) >> 3) + (k & 7) * 2;
}

template <int N, bool DS>
__global__ void __launch_bounds__(NT, 1) gru_cluster_kernel(const Params p) {
  constexpr int KL = 16 / KS;           // k-steps of one GRU warpgroup
  constexpr int PANEL = 256 * N;        // 64 units x 2N rows (hi, lo)
  constexpr int BUF = 4 * PANEL;        // one h buffer
  constexpr int XSTAGE = N * 3 * U;     // bf16 elements of one x_proj stage
  constexpr int CH = U / 8;             // 16-byte chunks of the CTA's units in a row
  constexpr int G = 3 * H;
  constexpr uint32_t SLICE_BYTES = (C - 1) * 2 * N * U * 2;  // the peers' h slices a step
  constexpr uint32_t STAT_BYTES = (C - 1) * N * 4;           // the peers' partials of a statistic
  static_assert(N == 8 || N == 16 || N == 32, "8, 16 or 32 rows a cluster");
  static_assert(KS == 2, "the K-half exchange is written for two GRU warpgroups");

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = wg::align1024(smem_raw);
  unsigned char* const gb = smem_raw + (base - wg::smem_u32(smem_raw));  // generic view of base
  const uint32_t wd = base;
  const uint32_t hb = wd + (DS ? 3 * TILE_BYTES : 0);  // buffer b at hb + b BUF
  const uint32_t xs_addr = hb + 2 * BUF;
  const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(gb + (xs_addr - base));
  float* red = reinterpret_cast<float*>(gb + (xs_addr - base) + STAGES * XSTAGE * 2);  // [KS][2N][128]
  float* cred = red + KS * 128 * 2 * N;                 // K2: [KS][2N][128]
  float* ysum = cred + (DS ? KS * 128 * 2 * N : 0);     // [slot][n][32]
  float* sums = ysum + (DS ? NOUT_SLOTS * N * 32 : 0);  // [rank][n]
  float* vars = sums + (DS ? C * N : 0);                // [rank][n]
  float* mean = vars + (DS ? C * N : 0);                // [n]
  const uint32_t mbar = wg::smem_u32(mean + (DS ? N : 0));  // two mbarriers, one a buffer

  const int tid = threadIdx.x;
  // warpgroup q takes the k-steps [q KL, q KL + KL); its index read from
  // lane 0 so the compiler knows it is uniform across the warp (a wgmma
  // on a path it takes for divergent is serialised)
  const int q = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int wt = tid & 127, w = (tid >> 5) & 3, lane = tid & 31;
  const uint32_t rank = cluster_rank();
  const int row0 = static_cast<int>(blockIdx.x / C) * N;
  const int ul = 8 * w + (lane >> 2);  // the thread's unit in the CTA
  const int k_own = static_cast<int>(rank) * U + ul;
  const int n_out = (p.T + 1) / 2;
  const int steps = DS ? 2 * (n_out - 1) + 4 : p.T;

  if constexpr (DS) {
    // W_d columns [32 rank, 32 rank + 32) of each tap, two taps a tile
    for (int idx = tid; idx < 3 * 256 * 8; idx += NT) {
      const int c = idx & 7, kr = (idx >> 3) & 255, tile = idx >> 11;
      const int tap = c < 4 ? (tile == 0 ? 4 : tile == 1 ? 0 : 3) : (tile == 0 ? 2 : tile == 1 ? 1 : -1);
      const bool ok = tap >= 0;
      const __nv_bfloat16* src =
          p.w_d + (static_cast<size_t>(ok ? tap : 0) * H + kr) * H + 32 * rank + 8 * (c & 3);
      wg::cp_async16(wd + tile * TILE_BYTES + wg::swz(kr, c), ok ? src : p.w_d, ok);
    }
    for (int i = tid; i < NOUT_SLOTS * N * 32; i += NT) ysum[i] = 0.f;
  }
  auto load_x = [&](int t, int stage) {
    const bool tv = t < p.T;
    for (int idx = tid; idx < N * 3 * CH; idx += NT) {
      const int c = idx % CH, g = (idx / CH) % 3, n = idx / (3 * CH);
      const int row = row0 + n;
      const bool ok = tv && row < p.R;
      const __nv_bfloat16* src =
          ok ? p.xp + (static_cast<size_t>(row) * p.T + t) * G + g * H + rank * U + 8 * c : p.xp;
      wg::cp_async16(xs_addr + 2 * (stage * XSTAGE + (n * 3 + g) * U + 8 * c), src, ok);
    }
    wg::cp_async_commit();
  };
  load_x(0, 0);  // with W_d
  load_x(1, 1);

  // The A fragments of this warpgroup's k-steps, resident in registers for
  // the launch: rows 16w + lane/4 and + 8 of the two m64 tiles are gates r
  // and z (tile 0) and n and zero (tile 1) of unit k_own; columns 2 (lane
  // % 4) + {0, 1} and + 8 are the k rows of W_hh.
  uint32_t af[KL][6];
#pragma unroll
  for (int kl = 0; kl < KL; ++kl) {
    const int k = 16 * (q * KL + kl) + 2 * (lane & 3);
    af[kl][0] = w_pair(p.w_hh, k, k_own);
    af[kl][1] = w_pair(p.w_hh, k, H + k_own);
    af[kl][2] = w_pair(p.w_hh, k + 8, k_own);
    af[kl][3] = w_pair(p.w_hh, k + 8, H + k_own);
    af[kl][4] = w_pair(p.w_hh, k, 2 * H + k_own);
    af[kl][5] = w_pair(p.w_hh, k + 8, 2 * H + k_own);
  }

  // h0 into buffer 0 (hi = h0, lo = 0: h0 is bf16), and the thread's carry
  for (int idx = tid; idx < N * H; idx += NT) {
    const int n = idx / H, k = idx % H;
    const int g = row0 + n;
    const __nv_bfloat16 v = g < p.R ? p.h0[static_cast<size_t>(g) * H + k] : __float2bfloat16_rn(0.f);
    *reinterpret_cast<__nv_bfloat16*>(gb + (hb - base) + b_offset<N>(n, k)) = v;
    *reinterpret_cast<__nv_bfloat16*>(gb + (hb - base) + b_offset<N>(N + n, k)) = __float2bfloat16_rn(0.f);
  }
  // GRU warpgroup q carries the rows 8 i + 2 (lane % 4) + q of unit k_own
  float hc[N / 8];
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int g = row0 + 8 * i + 2 * (lane & 3) + (q & 1);
    hc[i] = g < p.R ? to_f32(p.h0[static_cast<size_t>(g) * H + k_own]) : 0.f;
  }
  const float bhr = to_f32(p.b_hh[k_own]), bhz = to_f32(p.b_hh[H + k_own]),
              bhn = to_f32(p.b_hh[2 * H + k_own]);
  // K2: the downsample bias and LayerNorm weights of the lane's channel
  const int chan = 32 * static_cast<int>(rank) + lane;
  const float bd = DS ? to_f32(p.b_d[chan]) : 0.f, lnw = DS ? to_f32(p.ln_w[chan]) : 0.f,
              lnb = DS ? to_f32(p.ln_b[chan]) : 0.f;
  if (tid == 0) {
    mbar_init(mbar, 1);
    mbar_init(mbar + 8, 1);
    fence_mbar_init();
  }

  wg::cp_async_wait<1>();  // W_d and stage 0
  fence_proxy_async_cta();
  __syncthreads();
  cluster_arrive();  // every CTA runs, its mbarriers set, before any remote write
  cluster_wait();

  // the bytes the peers send for step s (s >= 1): their h slices, and in K2
  // the row sums of output (s - 2) / 2 (s even) or the squared deviations
  // of output (s - 3) / 2 (s odd, s >= 3)
  auto expected = [&](int s) -> uint32_t {
    uint32_t b = SLICE_BYTES;
    if constexpr (DS) {
      if (!(s & 1) && (s - 2) / 2 < n_out) b += STAT_BYTES;
      if ((s & 1) && s >= 3 && (s - 3) / 2 < n_out) b += STAT_BYTES;
    }
    return b;
  };

  for (int t = 0; t < steps; ++t) {
    const int cur = t & 1;
    const uint32_t buf = hb + cur * BUF;
    const uint32_t next = (hb - base) + (cur ^ 1) * BUF;  // offset of the next buffer
    const uint32_t next_bar = mbar + 8 * (cur ^ 1);
    if (t >= 1) {
      // every peer's slice of h_{t-1} (and K2's partials) has landed
      mbar_wait(mbar + 8 * cur, ((t - 1) >> 1) & 1);
      fence_proxy_async_cta();
    }

    float g0[N], g1[N], c0[N], c1[N];
    const int f = t - 1;  // the frame in buffer cur (K2)
    wg::fence();
#pragma unroll
    for (int kl = 0; kl < KL; ++kl) {
      const uint64_t b = desc_b<N>(buf, q * KL + kl);
      MmaRS<2 * N>::run(g0, af[kl][0], af[kl][1], af[kl][2], af[kl][3], b, kl > 0);
      MmaRS<2 * N>::run(g1, af[kl][4], 0u, af[kl][5], 0u, b, kl > 0);
    }
    wg::commit();
    if constexpr (DS) {
      // the conv taps of frame f, this warpgroup's K half, in a second group
      if (t >= 1) {
        const uint32_t ta = wd + ((f & 1) ? 2 : 0) * TILE_BYTES, tb = wd + TILE_BYTES;
#pragma unroll
        for (int kl = 0; kl < KL; ++kl) {
          const int ks = q * KL + kl;
          const uint64_t b = desc_b<N>(buf, ks);
          Mma<2 * N>::run(c0, desc_a(ta, ks), b, kl > 0);
          Mma<2 * N>::run(c1, desc_a(tb, ks), b, kl > 0);
        }
      }
      wg::commit();
    }

    // beside the products: the next buffer's expected bytes, the x_proj of
    // step t + 2, and K2's statistics
    if (tid == 0 && t + 1 < steps) mbar_expect_tx(next_bar, expected(t + 1));
    load_x(t + 2, (t + 2) % STAGES);
    if (DS && q == 1) {
      if (t >= 2 && !(t & 1)) {
        // output j complete, row sums exchanged: the mean, and the squared
        // deviations over this CTA's channels to every peer
        const int j = (t - 2) >> 1;
        if (j < n_out) {
          for (int n = w; n < N; n += 4) {
            float s = 0.f;
#pragma unroll
            for (int r = 0; r < C; ++r) s += sums[r * N + n];
            const float mu = s / H;
            const float d = ysum[((j & 3) * N + n) * 32 + lane] + bd - mu;
            const float v = warp_sum(d * d);
            if (lane == 0) mean[n] = mu;
            const uint32_t dst = wg::smem_u32(&vars[rank * N + n]);
            if (lane == static_cast<int>(rank)) vars[rank * N + n] = v;
            else if (lane < C) st_async_f32(mapa(dst, lane), v, mapa(next_bar, lane));
          }
        }
      } else if (t >= 3 && (t & 1)) {
        // LayerNorm, rounding to bf16, exact GELU and the store of output j
        const int j = (t - 3) >> 1;
        if (j < n_out) {
          for (int n = w; n < N; n += 4) {
            float v = 0.f;
#pragma unroll
            for (int r = 0; r < C; ++r) v += vars[r * N + n];
            const float inv = rsqrtf(v / H + 1e-5f);
            float& acc = ysum[((j & 3) * N + n) * 32 + lane];
            const float y = round_to<__nv_bfloat16>((acc + bd - mean[n]) * inv * lnw + lnb);
            if (row0 + n < p.R)
              p.out[(static_cast<size_t>(row0 + n) * n_out + j) * H + chan] =
                  __float2bfloat16_rn(0.5f * y * (1.f + erff(y * 0.70710678118654752f)));
            acc = 0.f;  // the slot's next output starts from zero
          }
        }
      }
    }
    // the GRU's products (the conv's may still run)
    if constexpr (DS) wg::wait<1>();
    else wg::wait<0>();
    pin(g0);
    pin(g1);
    // each K half's sums of the other warpgroup's rows to it: accumulator
    // element i lies in a row of parity i % 2 (hi and lo columns alike),
    // and warpgroup q runs the gate math of the rows of parity q
    {
      float* mine = red + q * 2 * N * 128;
      const float* other = red + (q ^ 1) * 2 * N * 128;
      if (q == 0) {
#pragma unroll
        for (int i = 1; i < N; i += 2) {
          mine[i * 128 + wt] = g0[i];
          mine[(N + i) * 128 + wt] = g1[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < N; i += 2) {
          mine[i * 128 + wt] = g0[i];
          mine[(N + i) * 128 + wt] = g1[i];
        }
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");
      if (q == 0) {
#pragma unroll
        for (int i = 0; i < N; i += 2) {
          g0[i] += other[i * 128 + wt];
          g1[i] += other[(N + i) * 128 + wt];
        }
      } else {
#pragma unroll
        for (int i = 1; i < N; i += 2) {
          g0[i] += other[i * 128 + wt];
          g1[i] += other[(N + i) * 128 + wt];
        }
      }
    }

    // gate math on the accumulators (column n: W h_hi, column N + n: W
    // h_lo), warpgroup q on its rows; the new h into the next buffer
    const __nv_bfloat16* xst = xs + (t % STAGES) * XSTAGE;
    {
#pragma unroll
      for (int i = 0; i < N / 8; ++i) {
        const int n = 8 * i + 2 * (lane & 3) + q;
        // accumulator columns of row n: 4i + q (gates r, n) and 4i + 2 + q (z)
        const float hr = q ? g0[4 * i + 1] + g0[4 * i + 1 + N / 2] : g0[4 * i] + g0[4 * i + N / 2];
        const float hz = q ? g0[4 * i + 3] + g0[4 * i + 3 + N / 2] : g0[4 * i + 2] + g0[4 * i + 2 + N / 2];
        const float hn = q ? g1[4 * i + 1] + g1[4 * i + 1 + N / 2] : g1[4 * i] + g1[4 * i + N / 2];
        const __nv_bfloat16* x = xst + n * 3 * U + ul;
        const float r = sigmoid(to_f32(x[0]) + hr + bhr);
        const float z = sigmoid(to_f32(x[U]) + hz + bhz);
        const float nn = tanh_(to_f32(x[2 * U]) + r * (hn + bhn));
        hc[i] = (1.f - z) * nn + z * hc[i];
        const __nv_bfloat16 h_hi = __float2bfloat16_rn(hc[i]);
        const __nv_bfloat16 h_lo = __float2bfloat16_rn(hc[i] - __bfloat162float(h_hi));
        *reinterpret_cast<__nv_bfloat16*>(gb + next + b_offset<N>(n, k_own)) = h_hi;
        *reinterpret_cast<__nv_bfloat16*>(gb + next + b_offset<N>(N + n, k_own)) = h_lo;
      }
    }
    if constexpr (DS) {
      wg::wait<0>();  // the conv's products
      if (t >= 1) {
        pin(c0);
        pin(c1);
        // each K half's conv sums of the other warpgroup's rows to it
        float* mine = cred + q * 2 * N * 128;
        const float* other = cred + (q ^ 1) * 2 * N * 128;
        if (q == 0) {
#pragma unroll
          for (int i = 1; i < N; i += 2) {
            mine[i * 128 + wt] = c0[i];
            mine[(N + i) * 128 + wt] = c1[i];
          }
        } else {
#pragma unroll
          for (int i = 0; i < N; i += 2) {
            mine[i * 128 + wt] = c0[i];
            mine[(N + i) * 128 + wt] = c1[i];
          }
        }
        asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");
        // frame f's products into the sums of the outputs it feeds (rows
        // 0-31 of a tile are warps 0-1, rows 32-63 warps 2-3), warpgroup q
        // adding the elements of its rows n
        const int m = f >> 1;
        int j0, j1;
        if (w < 2) {
          j0 = (f & 1) ? m + 1 : m;       // tap 3 / tap 4
          j1 = (f & 1) ? -1 : m + 2;      // -     / tap 0
        } else {
          j0 = (f & 1) ? -1 : m + 1;      // -     / tap 2
          j1 = (f & 1) ? m + 2 : -1;      // tap 1 / -
        }
        const bool k0 = j0 >= 0 && j0 < n_out, k1 = j1 >= 0 && j1 < n_out;
        auto add = [&](int i) {
          const int n = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          const int co = 16 * (w & 1) + (lane >> 2) + 8 * ((i >> 1) & 1);
          const int h = i + N / 2;  // the h_lo column of row n
          if (k0)
            ysum[((j0 & 3) * N + n) * 32 + co] +=
                (c0[i] + other[i * 128 + wt]) + (c0[h] + other[h * 128 + wt]);
          if (k1)
            ysum[((j1 & 3) * N + n) * 32 + co] +=
                (c1[i] + other[(N + i) * 128 + wt]) + (c1[h] + other[(N + h) * 128 + wt]);
        };
        if (q == 0) {
#pragma unroll
          for (int i = 0; i < N / 2; i += 2) add(i);
        } else {
#pragma unroll
          for (int i = 1; i < N / 2; i += 2) add(i);
        }
      }
    }
    fence_proxy_async_cta();  // the new h, before the next step's products read it
    wg::cp_async_wait<1>();   // stage t + 1 has landed
    __syncthreads();

    // this CTA's slice of the new h to every peer (and K3's ys from the hi
    // rows); nothing is sent after the last step
    const bool send = t + 1 < steps;
    constexpr int ITEMS = 2 * N * CH;  // 16-byte chunks of the slice (hi and lo rows)
    for (int idx = tid; idx < ITEMS * (C - 1); idx += NT) {
      const int item = idx % ITEMS, peer = idx / ITEMS;
      const int r = peer + (peer >= static_cast<int>(rank));  // the peers other than this CTA
      const int row = item / CH, cc = static_cast<int>(rank) * CH + item % CH;
      const uint32_t off = next + (cc >> 3) * PANEL + wg::swz(row, cc & 7);
      const uint4 v = *reinterpret_cast<const uint4*>(gb + off);
      if (send) st_async_v4(mapa(base + off, r), v, mapa(next_bar, r));
      if constexpr (!DS) {
        if (peer == 0 && row < N && row0 + row < p.R)
          *reinterpret_cast<uint4*>(p.ys + (static_cast<size_t>(row0 + row) * p.T + t) * H + 8 * cc) = v;
      }
    }
    if (DS && q == 1) {
      // output j complete: its row sums over this CTA's channels to every peer
      if ((t & 1) && send) {
        const int j = (t - 1) >> 1;
        if (j < n_out) {
          for (int n = w; n < N; n += 4) {
            const float s = warp_sum(ysum[((j & 3) * N + n) * 32 + lane] + bd);
            const uint32_t dst = wg::smem_u32(&sums[rank * N + n]);
            if (lane == static_cast<int>(rank)) sums[rank * N + n] = s;
            else if (lane < C) st_async_f32(mapa(dst, lane), s, mapa(next_bar, lane));
          }
        }
      }
      __syncwarp();  // this warp's own partials before its reads next step
    }
  }
  cluster_arrive();  // no CTA leaves while a peer may still write to it
  cluster_wait();
  wg::cp_async_wait<0>();
}

// ---- host side ------------------------------------------------------------
template <int N, bool DS>
cudaLaunchConfig_t config(int clusters, cudaStream_t st, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem_bytes(N, DS);
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int N, bool DS>
int launch_or_query(const Params* p, cudaStream_t st, int* smem, int* max_clusters) {
  auto kern = gru_cluster_kernel<N, DS>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(N, DS));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  if (p == nullptr) {  // the query: shared bytes and co-resident clusters
    cudaLaunchConfig_t cfg = config<N, DS>(1, st, attr);
    *smem = smem_bytes(N, DS);
    return static_cast<int>(cudaOccupancyMaxActiveClusters(max_clusters, kern, &cfg));
  }
  cudaLaunchConfig_t cfg = config<N, DS>((p->R + N - 1) / N, st, attr);
  e = cudaLaunchKernelEx(&cfg, kern, *p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// the instantiations: clusters of C = 8 CTAs; K3 at N in {8, 16, 32} rows,
// K2 at N in {8, 16}; any other tiling is cudaErrorInvalidValue
template <bool DS>
int dispatch(int N, int cluster, const Params* p, cudaStream_t st, int* smem, int* max_clusters) {
  if (cluster != C) return static_cast<int>(cudaErrorInvalidValue);
#define VAP_GC_CASE(NN) \
  if (N == NN) return launch_or_query<NN, DS>(p, st, smem, max_clusters)
  VAP_GC_CASE(8);
  VAP_GC_CASE(16);
  if constexpr (!DS) VAP_GC_CASE(32);
#undef VAP_GC_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace gc
}  // namespace vap
