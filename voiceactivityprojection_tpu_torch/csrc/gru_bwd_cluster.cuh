// The GRU backward (K9) in bf16 at H = 256: the gate recompute and the
// weight gradients as tensor-core products over all rows and steps, and
// the reverse recurrence on a thread-block cluster. Replaces, for bf16, the
// TPU kernel `_gru_bwd_kernel` of voiceactivityprojection_tpu/ops/
// gru_pallas.py (:300), which recomputes h_{t-1} @ W_hh inside its reverse
// loop and carries dh, dW and db through its sequential grid in VMEM.
// Needs sm_90a.
//
// The recompute depends only on x_proj and h_{t-1} = ys[:, t-1] (h0 at
// t = 0), inputs of the backward and not values of its reverse chain. With
// G = dh_t + dys_t, the gate gradients are
//   dxp = G [a_r, a_z, a_n],  dgates = G [a_r, a_z, a_n r]
//   dh_{t-1} = G z + dgates W_hh^T
// with a_n = (1 - z)(1 - n^2), a_z = (h_{t-1} - n) z (1 - z) and
// a_r = a_n hn r (1 - r), hn = (h_{t-1} W_hh + b_hh)_n. So the work is
// three kernels and the fixed-order sum of csrc/gru_backward.cu:
//
// 1. gru_bwd_gates_wgmma_kernel: hp = h_{t-1} @ W_hh + b_hh for all R T
//    rows at once, M = 64 rows x 64 units a warpgroup, K = H in four
//    chunks on a two-stage cp.async ring. A is the K-major h_{t-1} rows
//    (ys or h0, row by row); B the three 64-column blocks of W_hh (gates
//    r, z, n of the same units) read in place as MN-major tiles, so one
//    thread holds hp_r, hp_z, hp_n of each of its (row, unit). The
//    epilogue forms r, z, n in f32 with x_proj and b_hh, as the JAX kernel
//    does, and stores the five coefficients (a_r, a_z, a_n, r, z) in f32 as
//    (R, T, H / 32, 5, 32): one CTA's slice of one (row, step) below is
//    640 contiguous bytes.
// 2. gru_bwd_cluster_kernel<N>: the reverse recurrence. A cluster of 8
//    CTAs takes N rows (8, 16 or 32; rows past R carry zeros and store
//    nothing). CTA k owns the units [32k, 32k + 32), so the 96 gate columns
//    {g H + u}. It keeps W_hh[:, its 96 columns] in registers as the A
//    operand of dh_partial^T = W_own dg_own^T (M = 256 units, K = 96,
//    N = rows): two warpgroups, each two m64 tiles, 6 k-steps, 48
//    registers. B is dg of the CTA's own columns, written by its own gate
//    math into its own shared memory (double-buffered), split as
//    dg_hi = bf16(dg) and dg_lo = bf16(dg - dg_hi) side by side along N,
//    as the forward keeps its f32 carry: no exchange precedes the product.
//    After it, each thread adds the hi and lo columns; each warp stages its
//    16 units x N rows and sends them (16-byte st.async) to the CTA that
//    owns those units, this CTA included, counted on that CTA's mbarrier
//    of the step's buffer. A step t (T - 1 down to 0): wait for the 8
//    slices of step t + 1; dh_t = G_{t+1} z_{t+1} (kept in registers) + the
//    8 slices added in rank order (the result does not depend on which
//    bytes arrive first); G = dh_t + dys_t; store dxp (bf16) and
//    dg_hi / dg_lo ((2, R, T, 3H) bf16 scratch for 3.); write the B tile,
//    run the 6 k-steps, send. The coefficients and dys arrive by cp.async
//    three steps ahead. dh0 is the slice sum after t = 0, in f32.
// 3. gru_bwd_dw_wgmma_kernel: dW_hh = h_{t-1}^T (dg_hi + dg_lo) as one
//    product with K = 2 R T (the hi rows, then the lo rows, both against
//    the same h_{t-1}): A is h_{t-1} read MN-major (the transpose bit of
//    A), B the dg scratch MN-major; a fifth row tile with A all ones gives
//    db_hh as the product's row 0. The K range is cut into `splits` slices
//    (about two blocks an SM), each block writes its slice's partial, and
//    gru_bwd_sum_kernel adds them in slice order: no atomics anywhere, the
//    result repeats bit for bit.
//
// Bound: the T dependent steps of 2.; a step is the latency of 6 chained
// `wgmma` k-steps, the reduce-scatter through distributed shared memory
// and a few multiplies. 1. moves about 330 MB of f32 coefficients at
// R = 32 x 2000 (bytes); 3. is 2 x 2 R T H 3H FLOPs on the tensor cores.

#pragma once

#include "gru_cluster.cuh"
#include "gru_step.cuh"

namespace vap {
namespace gb {

using bf16 = __nv_bfloat16;
constexpr int H = gc::H;        // 256
constexpr int C = gc::C;        // CTAs a cluster
constexpr int U = H / C;        // hidden units of one CTA
constexpr int G = 3 * H;
constexpr int NCOEF = 5;        // a_r, a_z, a_n, r, z
constexpr int STAGES = 4;       // coefficient / dys ring of the recurrence: three steps in flight
constexpr int NT = 256;         // recurrence threads: two warpgroups
constexpr int KSTEPS = 3 * U / 16;  // the product's K = 96 gate columns
constexpr int GATES_SMEM = 2 * 4 * wg::TILE_BYTES + 1024;  // 1.: two stages of A + 3 B tiles
constexpr int DW_SMEM = 2 * 5 * wg::TILE_BYTES + 1024;     // 3.: two stages of A + 4 B tiles
constexpr int DW_ROW_TILES = H / 64 + 1;                   // 3.: four unit tiles and the ones tile
constexpr int DW_COL_TILES = G / 256;                      // 3.: 256 gate columns a block

// dynamic shared memory of one recurrence CTA (ops/gru_cluster.py
// backward_smem_bytes reckons the same): alignment slack, two B tiles (two
// 128-byte-swizzled panels of 2N rows each), two receive buffers
// [rank][row][unit] f32, the send staging [rank][row][unit], the ring
// (a stage: [row][5][32] f32 coefficients, then [row][32] bf16 dys), and
// the two buffers' mbarriers
__host__ __device__ constexpr int smem_bytes(int N) {
  return 1024 + 2 * 512 * N + 2 * C * N * U * 4 + C * N * U * 4 + STAGES * N * (NCOEF * U * 4 + U * 2) + 16;
}

struct Params {
  const bf16* xp;    // (R, T, 3H)
  const bf16* w_hh;  // (H, 3H)
  const bf16* b_hh;  // (3H,)
  const bf16* h0;    // (R, H)
  const bf16* ys;    // (R, T, H)
  const bf16* dys;   // (R, T, H), dh_last folded in
  bf16* dxp;         // (R, T, 3H)
  float* coef;       // (R, T, H / 32, 5, 32)
  bf16* dg;          // (2, R, T, 3H): dg_hi, then dg_lo
  float* dh0;        // (R, H)
  float* partial;    // (splits, H + 1, 3H)
  int R, T, splits;
};

// the mbarrier wait of the recurrence, bounded: a slice that has not
// landed after about 2^32 cycles (2 s; a step takes microseconds) ends the
// launch with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait_bounded(uint32_t bar, uint32_t parity) {
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

// tile row r <- 64 elements [c0, c0 + 64) of h_{t-1} for flattened row
// k = k0 + r (k past R T names the same row as k - R T: the lo pass of 3.),
// that is ys[k - 1] or, at t = 0, h0 of its sequence; zeros past k_end
__device__ __forceinline__ void load_hprev_rows(uint32_t tile, const Params& p, long long k0,
                                                long long k_end, int c0, int tid) {
  const long long M = static_cast<long long>(p.R) * p.T;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int idx = tid + wg::NT * it;
    const int r = idx >> 3, c = idx & 7;
    const long long k = k0 + r;
    const bool ok = k < k_end;
    const bf16* src = p.h0;  // a skipped copy still names a mapped address
    if (ok) {
      const long long n = k >= M ? k - M : k;
      const long long seq = n / p.T;
      src = n - seq * p.T > 0 ? p.ys + (n - 1) * H : p.h0 + seq * H;
    }
    wg::cp_async16(tile + wg::swz(r, c), src + c0 + 8 * c, ok);
  }
}

// ---- 1. the coefficients -------------------------------------------------
__global__ void __launch_bounds__(wg::NT, 3) gru_bwd_gates_wgmma_kernel(const Params p) {
  constexpr int STAGE = 4 * wg::TILE_BYTES;  // A, then the r, z, n tiles of W_hh
  extern __shared__ unsigned char smem_raw[];
  const uint32_t S0 = wg::align1024(smem_raw);
  const int tid = threadIdx.x;
  const long long M = static_cast<long long>(p.R) * p.T;
  const long long m0 = static_cast<long long>(blockIdx.x) * wg::TILE;
  const int u0 = wg::TILE * blockIdx.y;

  auto load = [&](int kc, int st) {
    const uint32_t A = S0 + st * STAGE;
    load_hprev_rows(A, p, m0, M, wg::TILE * kc, tid);
#pragma unroll
    for (int g = 0; g < 3; ++g)
      wg::load_tile_rows(A + (1 + g) * wg::TILE_BYTES, p.w_hh + g * H + u0, wg::TILE * kc, 1, H, wg::TILE,
                         G, tid);
  };
  load(0, 0);
  wg::cp_async_commit();

  float acc[3][32];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[g][i] = 0.f;

  constexpr int NCHUNK = H / wg::TILE;
#pragma unroll 1
  for (int kc = 0; kc < NCHUNK; ++kc) {
    const int st = kc & 1;
    wg::cp_async_wait<0>();
    wg::fence_proxy_async();
    __syncthreads();  // chunk kc is in; every warp is done with the other stage
    if (kc + 1 < NCHUNK) load(kc + 1, st ^ 1);
    wg::cp_async_commit();
    const uint32_t A = S0 + st * STAGE;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int g = 0; g < 3; ++g)
        wg::mma_ss<1>(acc[g], wg::desc_k(A, kk), wg::desc_mn(A + (1 + g) * wg::TILE_BYTES, kk), 1);
    wg::commit();
    wg::wait<0>();
#pragma unroll
    for (int g = 0; g < 3; ++g) wg::pin(acc[g]);
  }

  // epilogue: elements e, e + 1 are units u, u + 1 of one row
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const long long n = m0 + wg::acc_row(tid, e);
    if (n >= M) continue;
    const int u = u0 + wg::acc_col(tid, e);
    const long long seq = n / p.T;
    const bf16* hsrc = n - seq * p.T > 0 ? p.ys + (n - 1) * H : p.h0 + seq * H;
    const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(hsrc + u));
    const bf16* x = p.xp + n * G + u;
    const float2 xr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x));
    const float2 xz = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + H));
    const float2 xn = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + 2 * H));
    const float2 br = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.b_hh + u));
    const float2 bz = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.b_hh + H + u));
    const float2 bn = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.b_hh + 2 * H + u));
    float out[NCOEF][2];
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      const float r = sigmoidf_((l ? xr.y : xr.x) + (acc[0][e + l] + (l ? br.y : br.x)));
      const float z = sigmoidf_((l ? xz.y : xz.x) + (acc[1][e + l] + (l ? bz.y : bz.x)));
      const float hn = acc[2][e + l] + (l ? bn.y : bn.x);
      const float nn = tanhf((l ? xn.y : xn.x) + r * hn);
      const float an = (1.f - z) * (1.f - nn * nn);
      out[0][l] = an * hn * r * (1.f - r);
      out[1][l] = ((l ? h.y : h.x) - nn) * z * (1.f - z);
      out[2][l] = an;
      out[3][l] = r;
      out[4][l] = z;
    }
    float* dst = p.coef + (n * C + (u >> 5)) * (NCOEF * U) + (u & 31);
#pragma unroll
    for (int c = 0; c < NCOEF; ++c) *reinterpret_cast<float2*>(dst + c * U) = make_float2(out[c][0], out[c][1]);
  }
}

// ---- 2. the reverse recurrence --------------------------------------------
template <int N>
__global__ void __launch_bounds__(NT, 1) gru_bwd_cluster_kernel(const Params p) {
  constexpr int PANEL = 256 * N;                      // 64 gate columns x 2N rows (hi, lo)
  constexpr int BBUF = 2 * PANEL;                     // one B tile: K = 96 in two panels
  constexpr int RECV = C * N * U;                     // floats of one receive buffer
  constexpr int CROW = NCOEF * U * 4;                 // bytes of a row's coefficients in a stage
  constexpr int CSTAGE = N * (CROW + U * 2);          // bytes of one ring stage
  constexpr int PER = N / 8;                          // (row, unit) elements of a thread
  constexpr int NE = N / 2;                           // summed accumulator elements of a tile
  constexpr uint32_t STEP_BYTES = C * N * U * 4;      // the 8 slices that land in a buffer a step
  static_assert(N == 8 || N == 16 || N == 32, "8, 16 or 32 rows a cluster");

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = wg::align1024(smem_raw);
  unsigned char* const gbase = smem_raw + (base - wg::smem_u32(smem_raw));  // generic view of base
  const uint32_t btile = base;  // B tile b at btile + b BBUF
  const uint32_t recv_addr = base + 2 * BBUF;
  float* const recv = reinterpret_cast<float*>(gbase + 2 * BBUF);  // [buffer][rank][row][unit]
  float* const stg = recv + 2 * RECV;                               // [rank][row][unit]
  const uint32_t ring_addr = recv_addr + 3 * RECV * 4;
  const unsigned char* const ring = gbase + (ring_addr - base);
  const uint32_t mbar = ring_addr + STAGES * CSTAGE;  // two mbarriers, one a buffer

  const int tid = threadIdx.x;
  // the warpgroup index read from lane 0, so the compiler knows it is
  // uniform across the warp (a wgmma on a path it takes for divergent is
  // serialised)
  const int q = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int w = (tid >> 5) & 3, lane = tid & 31;
  const uint32_t rank = gc::cluster_rank();
  const int row0 = static_cast<int>(blockIdx.x / C) * N;
  const int T = p.T;

  // A fragments, resident for the launch: tile mt of warpgroup q holds the
  // units i = 128 q + 64 mt + (0 .. 63); k-step ks the 16 gate columns
  // 16 ks .. of the CTA, column c being W_hh column (c / 32) H + 32 rank + c % 32
  uint32_t af[2][KSTEPS][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int i = 128 * q + 64 * mt + 16 * w + (lane >> 2);
      const int c = 16 * ks + 2 * (lane & 3);
      const int col = (c >> 5) * H + static_cast<int>(rank) * U + (c & 31);
      const bf16* w0 = p.w_hh + static_cast<size_t>(i) * G + col;
      af[mt][ks][0] = *reinterpret_cast<const uint32_t*>(w0);
      af[mt][ks][1] = *reinterpret_cast<const uint32_t*>(w0 + 8 * G);
      af[mt][ks][2] = *reinterpret_cast<const uint32_t*>(w0 + 8);
      af[mt][ks][3] = *reinterpret_cast<const uint32_t*>(w0 + 8 * G + 8);
    }

  // step j (t = T - 1 - j): the rows' coefficients and dys of this CTA's
  // units into stage j % STAGES, zeros past R and past the last step
  auto load_stage = [&](int j) {
    constexpr int CCH = CROW / 16, DCH = U * 2 / 16;
    const int t = T - 1 - j;
    const uint32_t dst = ring_addr + (j % STAGES) * CSTAGE;
    for (int idx = tid; idx < N * (CCH + DCH); idx += NT) {
      const int n = idx / (CCH + DCH), c = idx % (CCH + DCH);
      const int row = row0 + n;
      const bool ok = j < T && row < p.R;
      const size_t rt = ok ? static_cast<size_t>(row) * T + t : 0;
      if (c < CCH)
        wg::cp_async16(dst + n * CROW + 16 * c, p.coef + (rt * C + rank) * (NCOEF * U) + 4 * c, ok);
      else
        wg::cp_async16(dst + N * CROW + n * U * 2 + 16 * (c - CCH), p.dys + rt * H + rank * U + 8 * (c - CCH), ok);
    }
    wg::cp_async_commit();
  };
#pragma unroll 1
  for (int s = 0; s < STAGES - 1; ++s) load_stage(s);
  if (tid == 0) {
    gc::mbar_init(mbar, 1);
    gc::mbar_init(mbar + 8, 1);
    gc::fence_mbar_init();
  }
  wg::cp_async_wait<STAGES - 2>();  // stage 0
  __syncthreads();
  gc::cluster_arrive();  // every CTA runs, its mbarriers set, before any remote write
  gc::cluster_wait();

  // thread element s: unit uu = lane of this CTA, row n = tid / 32 + 8 s
  float gz[PER];
#pragma unroll
  for (int s = 0; s < PER; ++s) gz[s] = 0.f;
  const size_t lo_plane = static_cast<size_t>(p.R) * T * G;

#pragma unroll 1
  for (int j = 0; j < T; ++j) {
    const int t = T - 1 - j;
    const int cur = j & 1;  // this step's B tile and the buffer its slices go to
    load_stage(j + STAGES - 1);  // into the stage read in step j - 1
    if (tid == 0) gc::mbar_expect_tx(mbar + 8 * cur, STEP_BYTES);
    if (j >= 1) mbar_wait_bounded(mbar + 8 * (cur ^ 1), ((j - 1) >> 1) & 1);

    // gate math: G, dxp, dg (hi and lo) into the B tile and the scratch
    const float* rb = recv + (cur ^ 1) * RECV;
    const unsigned char* stage = ring + (j % STAGES) * CSTAGE;
    const uint32_t bt = btile - base + cur * BBUF;
#pragma unroll
    for (int s = 0; s < PER; ++s) {
      const int n = (tid >> 5) + 8 * s;
      float dh = gz[s];
      if (j >= 1) {
        float sum = 0.f;
#pragma unroll
        for (int r = 0; r < C; ++r) sum += rb[(r * N + n) * U + lane];
        dh += sum;
      }
      const float* cf = reinterpret_cast<const float*>(stage + n * CROW) + lane;
      const float g =
          dh + __bfloat162float(reinterpret_cast<const bf16*>(stage + N * CROW)[n * U + lane]);
      const float d[3] = {g * cf[0], g * cf[U], g * cf[2 * U] * cf[3 * U]};
      const float dn = g * cf[2 * U];
      gz[s] = g * cf[4 * U];
      const int row = row0 + n;
      const size_t o = (static_cast<size_t>(row) * T + t) * G + rank * U + lane;
      if (row < p.R) {
        p.dxp[o] = __float2bfloat16_rn(d[0]);
        p.dxp[o + H] = __float2bfloat16_rn(d[1]);
        p.dxp[o + 2 * H] = __float2bfloat16_rn(dn);
      }
#pragma unroll
      for (int g3 = 0; g3 < 3; ++g3) {
        const bf16 hi = __float2bfloat16_rn(d[g3]);
        const bf16 lo = __float2bfloat16_rn(d[g3] - __bfloat162float(hi));
        *reinterpret_cast<bf16*>(gbase + bt + gc::b_offset<N>(n, 32 * g3 + lane)) = hi;
        *reinterpret_cast<bf16*>(gbase + bt + gc::b_offset<N>(N + n, 32 * g3 + lane)) = lo;
        if (row < p.R) {
          p.dg[o + g3 * H] = hi;
          p.dg[lo_plane + o + g3 * H] = lo;
        }
      }
    }
    gc::fence_proxy_async_cta();      // the B tile, before the products read it
    wg::cp_async_wait<STAGES - 2>();  // step j + 1's stage has landed
    __syncthreads();

    // dh_partial^T = W_own dg_own^T: columns n of the hi rows, N + n of the lo
    float acc[2][N];
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const uint64_t b = gc::desc_b<N>(btile + cur * BBUF, ks);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        gc::MmaRS<2 * N>::run(acc[mt], af[mt][ks][0], af[mt][ks][1], af[mt][ks][2], af[mt][ks][3], b, ks > 0);
    }
    wg::commit();
    wg::wait<0>();
    gc::pin(acc[0]);
    gc::pin(acc[1]);

    // reduce-scatter: each warp's 16 units x N rows of a tile, hi + lo, to
    // the CTA that owns the units (this one included), into its buffer cur
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int ib = 128 * q + 64 * mt + 16 * w;  // the warp's first unit
      const int m = ib >> 5;                      // their owner
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const int i = ib + (lane >> 2) + 8 * ((e >> 1) & 1);
        const int n = 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
        stg[(m * N + n) * U + (i & 31)] = acc[mt][e] + acc[mt][e + NE];
      }
      __syncwarp();
#pragma unroll
      for (int c = lane; c < 4 * N; c += 32) {
        const int n = c >> 2, uu = (ib & 31) + 4 * (c & 3);
        const uint4 v = *reinterpret_cast<const uint4*>(stg + (m * N + n) * U + uu);
        const uint32_t dst = recv_addr + 4 * (cur * RECV + (rank * N + n) * U + uu);
        gc::st_async_v4(gc::mapa(dst, m), v, gc::mapa(mbar + 8 * cur, m));
      }
    }
  }

  // dh0: the carry after t = 0, from the last step's slices
  const int last = (T - 1) & 1;
  mbar_wait_bounded(mbar + 8 * last, ((T - 1) >> 1) & 1);
#pragma unroll
  for (int s = 0; s < PER; ++s) {
    const int n = (tid >> 5) + 8 * s;
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < C; ++r) sum += recv[last * RECV + (r * N + n) * U + lane];
    if (row0 + n < p.R) p.dh0[static_cast<size_t>(row0 + n) * H + rank * U + lane] = gz[s] + sum;
  }
  gc::cluster_arrive();  // no CTA leaves while a peer may still write to it
  gc::cluster_wait();
  wg::cp_async_wait<0>();
}

// ---- 3. dW_hh and db_hh ---------------------------------------------------
// block (x, y, z): gate columns [256 x, 256 x + 256), row tile y (units
// [64 y, 64 y + 64), or y = 4 the ones tile: db), K slice z of the 2 R T
__global__ void __launch_bounds__(wg::NT, 2) gru_bwd_dw_wgmma_kernel(const Params p) {
  constexpr int STAGE = 5 * wg::TILE_BYTES;  // A, then four B tiles
  extern __shared__ unsigned char smem_raw[];
  const uint32_t S0 = wg::align1024(smem_raw);
  const int tid = threadIdx.x;
  const int it = blockIdx.y;
  const bool ones = it == H / wg::TILE;
  const int j0 = 256 * blockIdx.x;
  const long long K = 2ll * p.R * p.T;
  const long long per = ((K + p.splits - 1) / p.splits + wg::TILE - 1) / wg::TILE * wg::TILE;
  const long long k_begin = blockIdx.z * per;
  const long long k_end = k_begin + per < K ? k_begin + per : K;
  const int nchunks = k_begin < k_end ? static_cast<int>((k_end - k_begin + wg::TILE - 1) / wg::TILE) : 0;

  if (ones) {
    // A of both stages all ones: row 0 of the product is the column sums
    // of B (zero-filled past the slice)
    unsigned char* gb = smem_raw + (S0 - wg::smem_u32(smem_raw));
    for (int i = tid; i < wg::TILE_BYTES / 4; i += wg::NT) {
      reinterpret_cast<uint32_t*>(gb)[i] = 0x3F803F80u;
      reinterpret_cast<uint32_t*>(gb + STAGE)[i] = 0x3F803F80u;
    }
    wg::fence_proxy_async();
  }
  auto load = [&](int kc, int st) {
    const uint32_t A = S0 + st * STAGE;
    const long long k0 = k_begin + static_cast<long long>(wg::TILE) * kc;
    if (!ones) load_hprev_rows(A, p, k0, k_end, wg::TILE * it, tid);
#pragma unroll
    for (int g = 0; g < 4; ++g)
      wg::load_tile_rows(A + (1 + g) * wg::TILE_BYTES, p.dg + j0 + wg::TILE * g, static_cast<int>(k0), 1,
                         static_cast<int>(k_end), wg::TILE, G, tid);
  };
  if (nchunks > 0) load(0, 0);
  wg::cp_async_commit();

  float acc[4][32];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[g][i] = 0.f;

#pragma unroll 1
  for (int kc = 0; kc < nchunks; ++kc) {
    const int st = kc & 1;
    wg::cp_async_wait<0>();
    wg::fence_proxy_async();
    __syncthreads();  // chunk kc is in; every warp is done with the other stage
    if (kc + 1 < nchunks) load(kc + 1, st ^ 1);
    wg::cp_async_commit();
    const uint32_t A = S0 + st * STAGE;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        wg::mma_ss<1, 1>(acc[g], wg::desc_mn(A, kk), wg::desc_mn(A + (1 + g) * wg::TILE_BYTES, kk), 1);
    wg::commit();
    wg::wait<0>();
#pragma unroll
    for (int g = 0; g < 4; ++g) wg::pin(acc[g]);
  }
  wg::cp_async_wait<0>();

  float* out = p.partial + static_cast<size_t>(blockIdx.z) * (H + 1) * G;
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int m = wg::acc_row(tid, e);
      const int j = j0 + wg::TILE * g + wg::acc_col(tid, e);
      if (ones && m != 0) continue;
      const int row = ones ? H : wg::TILE * it + m;
      *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * G + j) = make_float2(acc[g][e], acc[g][e + 1]);
    }
}

// ---- host side --------------------------------------------------------------
template <int N>
cudaLaunchConfig_t config(int clusters, cudaStream_t st, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem_bytes(N);
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int N>
int launch_or_query(const Params* p, cudaStream_t st, int* smem, int* max_clusters) {
  auto kern = gru_bwd_cluster_kernel<N>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(N));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  if (p == nullptr) {  // the query: shared bytes and co-resident clusters
    cudaLaunchConfig_t cfg = config<N>(1, st, attr);
    *smem = smem_bytes(N);
    return static_cast<int>(cudaOccupancyMaxActiveClusters(max_clusters, kern, &cfg));
  }
  cudaLaunchConfig_t cfg = config<N>((p->R + N - 1) / N, st, attr);
  e = cudaLaunchKernelEx(&cfg, kern, *p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// the instantiations: clusters of C = 8 CTAs at N in {8, 16, 32} rows; any
// other tiling is cudaErrorInvalidValue
inline int dispatch(int N, int cluster, const Params* p, cudaStream_t st, int* smem, int* max_clusters) {
  if (cluster != C) return static_cast<int>(cudaErrorInvalidValue);
#define VAP_GB_CASE(NN) \
  if (N == NN) return launch_or_query<NN>(p, st, smem, max_clusters)
  VAP_GB_CASE(8);
  VAP_GB_CASE(16);
  VAP_GB_CASE(32);
#undef VAP_GB_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace gb
}  // namespace vap
