// The GRU backward (K9) in float32 at H = 256: the three-phase design of
// csrc/gru_bwd_cluster.cuh (bf16) in exact f32 FFMA on the CUDA cores, as
// csrc/gru_cluster_f32.cuh carries the forward. Replaces, for float32, the
// TPU kernel `_gru_bwd_kernel` of voiceactivityprojection_tpu/ops/
// gru_pallas.py (:300), which recomputes h_{t-1} @ W_hh inside its reverse
// loop and carries dh, dW and db through its sequential grid in VMEM.
//
// With G = dh_t + dys_t and the coefficients a_n = (1 - z)(1 - n^2),
// a_z = (h_{t-1} - n) z (1 - z), a_r = a_n hn r (1 - r), hn = (h_{t-1} W_hh
// + b_hh)_n, the step is
//   dxp = G [a_r, a_z, a_n],  dgates = G [a_r, a_z, a_n r]
//   dh_{t-1} = G z + dgates W_hh^T
// and the work is four launches (no atomics: the result repeats bit for bit):
//
// 1. gru_bwd_coef_f32_kernel: hp = h_{t-1} @ W_hh + b_hh for all R T rows at
//    once (h_{t-1} = ys[:, t-1], h0 at t = 0: inputs of the backward, not
//    values of its reverse chain). A block takes 64 rows x the r, z, n
//    columns of 64 units (a 64 x 192 tile, K = 256 in chunks of 16 on a
//    two-stage ring: h_{t-1} through registers, transposed into shared
//    memory, W_hh by cp.async); a thread holds 4 rows x 4 units x 3 gates,
//    so the epilogue forms r, z, n and the five coefficients (a_r, a_z, a_n,
//    r, z) of its own elements and stores them as (R, T, H / 32, 5, 32),
//    bf16's layout: one CTA's slice of one (row, step) is 640 contiguous
//    bytes.
// 2. gru_bwd_f32_cluster_kernel<N>: the reverse recurrence on a cluster of 8
//    CTAs (one an SM) with N rows (2 to 32; rows past R carry zeros and store
//    nothing). CTA k owns the units [32k, 32k + 32), so the 96 gate columns
//    {g H + u}. Thread i (256 a CTA) keeps W_hh[i, the CTA's 96 columns] in
//    registers for the launch and forms dh_partial[n, i] = dg_own[n, :] .
//    W_hh[i, own]: the full K = 96 in one thread, so no k-slice reduction
//    inside the CTA; dg_own is read from the CTA's own shared memory (the
//    same float4 across the warp). Warp w holds units [32w, 32w + 32), CTA
//    w's: it stages its N x 32 partials and sends them (16-byte st.async)
//    into CTA w's receive buffer of the step, counted on CTA w's mbarrier.
//    A step t (T - 1 down to 0): wait for the 8 slices of step t + 1;
//    dh_t = G_{t+1} z_{t+1} (kept in registers) + the 8 slices added in rank
//    order (whatever order they land in); G = dh_t + dys_t; store dxp and the
//    f32 dgates scratch (for 3.); write dg_own (double-buffered, so no
//    barrier separates a step's product from the next step's gate math);
//    the product; send. No cluster barrier runs in the loop. The coefficients
//    and dys arrive by cp.async three steps ahead. dh0 is the carry after
//    t = 0.
// 3. gru_bwd_dw_f32_kernel: [dW_hh; db_hh] = [h_{t-1}, 1]^T dgates over the
//    R T rows, the same 64 x 192 FFMA tile (64 units x 192 gate columns, both
//    operands by cp.async as stored), the rows cut into `splits` slices
//    (about two blocks an SM); row tile 0 also sums its slice's dgates
//    columns (db). Each block writes its slice's partial, and
//    csrc/gru_backward.cu's gru_bwd_sum_kernel adds them in slice order.
//
// Bound: the T dependent steps of 2.; a step is the product (N x 96 FFMA a
// thread, N x 24 shared float4 reads), the exchange through distributed
// shared memory and the gate math. 1. and 3. are each 2 R T H 3H FLOPs
// (25.2 GFLOP at R = 32 x 2000: 0.38 ms at the f32 FFMA rate). The block
// kernel this replaces streamed all of W_hh (768 KB) from L2 twice a step.

#pragma once

#include "gru_bwd_cluster.cuh"
#include "gru_cluster_f32.cuh"

namespace vap {
namespace gbf {

constexpr int H = 256;
constexpr int C = 8;           // CTAs a cluster
constexpr int U = H / C;       // hidden units of one CTA
constexpr int G = 3 * H;
constexpr int KOWN = 3 * U;    // the CTA's gate columns: the product's K
constexpr int NCOEF = 5;       // a_r, a_z, a_n, r, z
constexpr int STAGES = 4;      // coefficient / dys ring of the recurrence: three steps in flight
constexpr int NT = 256;        // threads of every kernel here
constexpr int TM = 64;         // 1. and 3.: the tile's rows (1.: (row, step) rows; 3.: units)
constexpr int TN = 192;        // 1. and 3.: the tile's columns (1.: r, z, n of 64 units; 3.: gate columns)
constexpr int KC = 16;         // 1. and 3.: the contraction a chunk
constexpr int DW_COL_TILES = G / TN;  // 3.: 4
constexpr int DW_ROW_TILES = H / TM;  // 3.: 4 (row tile 0 also sums db)

// dynamic shared memory of one recurrence CTA (ops/gru_cluster.py
// f32_backward_smem_bytes reckons the same): two receive buffers
// [rank][row][unit] f32, each warp's send staging [row][unit], two dg
// buffers [row][96], the ring (a stage: [row][5][32] coefficients, then
// [row][32] dys, f32) and the two buffers' mbarriers
__host__ __device__ constexpr int smem_bytes(int N) {
  return 2 * C * N * U * 4 + (NT / 32) * N * U * 4 + 2 * N * KOWN * 4 + STAGES * N * (NCOEF + 1) * U * 4 + 2 * 8;
}

struct Params {
  const float* xp;    // (R, T, 3H)
  const float* w_hh;  // (H, 3H)
  const float* b_hh;  // (3H,)
  const float* h0;    // (R, H)
  const float* ys;    // (R, T, H)
  const float* dys;   // (R, T, H), dh_last folded in
  float* dxp;         // (R, T, 3H)
  float* coef;        // (R, T, H / 32, 5, 32)
  float* dgates;      // (R, T, 3H)
  float* dh0;         // (R, H)
  float* partial;     // (splits, H + 1, 3H)
  int R, T, splits;
};

// h_{t-1} of flattened row m = (row, t): ys[m - 1], or h0 of the row at t = 0
__device__ __forceinline__ const float* hprev_row(const Params& p, int m) {
  const int seq = m / p.T;
  return m - seq * p.T > 0 ? p.ys + static_cast<size_t>(m - 1) * H : p.h0 + static_cast<size_t>(seq) * H;
}

// one chunk of the 64 x 192 tile: acc[i][4 g + e] += sum_k a[k][4 ty + i]
// b[k][64 g + 4 tx + e] (a and b K rows of the chunk, row-major)
__device__ __forceinline__ void chunk_fma(const float (*a)[TM], const float (*b)[TN], float (&acc)[4][12], int ty,
                                          int tx) {
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(&a[k][4 * ty]);
    float bv[12];
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(&b[k][64 * g + 4 * tx]);
      bv[4 * g] = v.x;
      bv[4 * g + 1] = v.y;
      bv[4 * g + 2] = v.z;
      bv[4 * g + 3] = v.w;
    }
    const float as[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 12; ++j) acc[i][j] = fmaf(as[i], bv[j], acc[i][j]);
  }
}

// ---- 1. the coefficients -------------------------------------------------
// block (x, y): rows [64 x, 64 x + 64) of the R T, units [64 y, 64 y + 64)
__global__ void __launch_bounds__(NT) gru_bwd_coef_f32_kernel(const Params p) {
  __shared__ __align__(16) float as[2][KC][TM];  // h_{t-1}, transposed: [k][row]
  __shared__ __align__(16) float bs[2][KC][TN];  // W_hh rows: [k][gate][unit]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int M = p.R * p.T;
  const int m0 = blockIdx.x * TM;
  const int u0 = 64 * blockIdx.y;

  // A: row m0 + lm, floats 4 lq .. 4 lq + 3 of the chunk (zeros past M)
  const int lm = tid & 63, lq = tid >> 6;
  const float* arow = m0 + lm < M ? hprev_row(p, m0 + lm) : nullptr;
  auto load_a = [&](int k0) {
    return arow != nullptr ? *reinterpret_cast<const float4*>(arow + k0 + 4 * lq) : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto store_a = [&](int st, float4 v) {
    as[st][4 * lq][lm] = v.x;
    as[st][4 * lq + 1][lm] = v.y;
    as[st][4 * lq + 2][lm] = v.z;
    as[st][4 * lq + 3][lm] = v.w;
  };
  // B: rows k0 .. k0 + 15 of W_hh, columns g H + u0 .. + 63 of each gate
  auto load_b = [&](int k0, int st) {
#pragma unroll
    for (int it = 0; it < 3; ++it) {
      const int idx = tid + NT * it;
      const int k = idx / 48, c = idx % 48, g = c >> 4, cc = c & 15;
      wg::cp_async16(wg::smem_u32(&bs[st][k][64 * g + 4 * cc]),
                     p.w_hh + static_cast<size_t>(k0 + k) * G + g * H + u0 + 4 * cc, true);
    }
  };

  float4 areg = load_a(0);
  load_b(0, 0);
  wg::cp_async_commit();
  store_a(0, areg);
  float acc[4][12];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 12; ++j) acc[i][j] = 0.f;

  constexpr int NCH = H / KC;
#pragma unroll 1
  for (int kc = 0; kc < NCH; ++kc) {
    const int st = kc & 1;
    wg::cp_async_wait<0>();
    __syncthreads();  // chunk kc is in; every warp is done with the other stage
    if (kc + 1 < NCH) {
      areg = load_a((kc + 1) * KC);
      load_b((kc + 1) * KC, st ^ 1);
    }
    wg::cp_async_commit();
    chunk_fma(as[st], bs[st], acc, ty, tx);
    if (kc + 1 < NCH) store_a(st ^ 1, areg);
  }

  // epilogue: rows 4 ty + i, units u0 + 4 tx + e, gates r, z, n
  const int u = u0 + 4 * tx;
  const float4 br = *reinterpret_cast<const float4*>(p.b_hh + u);
  const float4 bz = *reinterpret_cast<const float4*>(p.b_hh + H + u);
  const float4 bn = *reinterpret_cast<const float4*>(p.b_hh + 2 * H + u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= M) continue;
    const float4 h = *reinterpret_cast<const float4*>(hprev_row(p, m) + u);
    const float* x = p.xp + static_cast<size_t>(m) * G + u;
    const float4 xr = *reinterpret_cast<const float4*>(x);
    const float4 xz = *reinterpret_cast<const float4*>(x + H);
    const float4 xn = *reinterpret_cast<const float4*>(x + 2 * H);
    const float hv[4] = {h.x, h.y, h.z, h.w};
    const float xrv[4] = {xr.x, xr.y, xr.z, xr.w}, xzv[4] = {xz.x, xz.y, xz.z, xz.w};
    const float xnv[4] = {xn.x, xn.y, xn.z, xn.w};
    const float brv[4] = {br.x, br.y, br.z, br.w}, bzv[4] = {bz.x, bz.y, bz.z, bz.w};
    const float bnv[4] = {bn.x, bn.y, bn.z, bn.w};
    float out[NCOEF][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float r = sigmoidf_(xrv[e] + (acc[i][e] + brv[e]));
      const float z = sigmoidf_(xzv[e] + (acc[i][4 + e] + bzv[e]));
      const float hn = acc[i][8 + e] + bnv[e];
      const float nn = tanhf(xnv[e] + r * hn);
      const float an = (1.f - z) * (1.f - nn * nn);
      out[0][e] = an * hn * r * (1.f - r);
      out[1][e] = (hv[e] - nn) * z * (1.f - z);
      out[2][e] = an;
      out[3][e] = r;
      out[4][e] = z;
    }
    float* dst = p.coef + (static_cast<size_t>(m) * C + (u >> 5)) * (NCOEF * U) + (u & 31);
#pragma unroll
    for (int c = 0; c < NCOEF; ++c)
      *reinterpret_cast<float4*>(dst + c * U) = make_float4(out[c][0], out[c][1], out[c][2], out[c][3]);
  }
}

// ---- 2. the reverse recurrence --------------------------------------------
template <int N>
__global__ void __launch_bounds__(NT, 1) gru_bwd_f32_cluster_kernel(const Params p) {
  constexpr int RECV = C * N * U;              // floats of one receive buffer, [rank][row][unit]
  constexpr int STG = N * U;                   // floats of a warp's staging, [row][unit]
  constexpr int DGB = N * KOWN;                // floats of one dg buffer, [row][gate column]
  constexpr int CROW = (NCOEF + 1) * U;        // floats of a row in a stage: [5][32] coefficients, [32] dys
  constexpr int CSTAGE = N * CROW;             // floats of one ring stage
  constexpr int PER = (N + 7) / 8;             // rows of a thread's gate math
  constexpr uint32_t STEP_BYTES = C * N * U * 4;  // the 8 slices that land in a buffer a step
  static_assert(N == 2 || N == 4 || N == 8 || N == 16 || N == 32, "2 to 32 rows a cluster");
  static_assert(smem_bytes(N) <= 232448, "a CTA's shared memory");

  extern __shared__ __align__(16) unsigned char smem_gbf[];
  float* recv = reinterpret_cast<float*>(smem_gbf);  // [buffer][rank][row][unit]
  float* stg = recv + 2 * RECV;                      // [warp][row][unit]
  float* dgs = stg + (NT / 32) * STG;                // [buffer][row][gate column]
  float* ring = dgs + 2 * DGB;                       // [stage][row][...]
  const uint32_t mbar = wg::smem_u32(ring + STAGES * CSTAGE);  // two mbarriers, one a buffer

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const uint32_t rank = gc::cluster_rank();
  const int row0 = static_cast<int>(blockIdx.x / C) * N;
  const int T = p.T;

  // the product: unit tid of the layer; column c of the CTA's 96 is W_hh
  // column (c / 32) H + 32 rank + c % 32
  float wr[KOWN];
#pragma unroll
  for (int c = 0; c < KOWN; c += 4) {
    const float4 v =
        *reinterpret_cast<const float4*>(p.w_hh + static_cast<size_t>(tid) * G + (c >> 5) * H + rank * U + (c & 31));
    wr[c] = v.x;
    wr[c + 1] = v.y;
    wr[c + 2] = v.z;
    wr[c + 3] = v.w;
  }

  // step j (t = T - 1 - j): the rows' coefficients and dys of this CTA's
  // units into stage j % STAGES, zeros past R and past the last step
  auto load_stage = [&](int j) {
    constexpr int CCH = NCOEF * U / 4, DCH = U / 4;
    const int t = T - 1 - j;
    float* dst = ring + (j % STAGES) * CSTAGE;
    for (int idx = tid; idx < N * (CCH + DCH); idx += NT) {
      const int n = idx / (CCH + DCH), c = idx % (CCH + DCH);
      const int row = row0 + n;
      const bool ok = j < T && row < p.R;
      const size_t rt = ok ? static_cast<size_t>(row) * T + t : 0;
      if (c < CCH)
        wg::cp_async16(wg::smem_u32(dst + n * CROW + 4 * c), p.coef + (rt * C + rank) * (NCOEF * U) + 4 * c, ok);
      else
        wg::cp_async16(wg::smem_u32(dst + n * CROW + NCOEF * U + 4 * (c - CCH)), p.dys + rt * H + rank * U + 4 * (c - CCH),
                       ok);
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

  // gate math: unit `lane` of this CTA, rows w + 8 s
  float gz[PER];
#pragma unroll
  for (int s = 0; s < PER; ++s) gz[s] = 0.f;
  float* const sg = stg + w * STG;

#pragma unroll 1
  for (int j = 0; j < T; ++j) {
    const int t = T - 1 - j;
    const int cur = j & 1;  // this step's dg buffer and the receive buffer its slices go to
    load_stage(j + STAGES - 1);  // into the stage read in step j - 1
    if (tid == 0) gc::mbar_expect_tx(mbar + 8 * cur, STEP_BYTES);
    if (j >= 1) gb::mbar_wait_bounded(mbar + 8 * (cur ^ 1), ((j - 1) >> 1) & 1);

    // G, dxp, dgates and this step's dg
    const float* rb = recv + (cur ^ 1) * RECV;
    const float* stage = ring + (j % STAGES) * CSTAGE;
    float* dg = dgs + cur * DGB;
#pragma unroll
    for (int s = 0; s < PER; ++s) {
      const int n = w + 8 * s;
      if (n < N) {
        float dh = gz[s];
        if (j >= 1) {
          float sum = 0.f;
#pragma unroll
          for (int r = 0; r < C; ++r) sum += rb[(r * N + n) * U + lane];
          dh += sum;
        }
        const float* cf = stage + n * CROW + lane;
        const float g = dh + cf[NCOEF * U];
        const float dr = g * cf[0], dz = g * cf[U], dn = g * cf[2 * U];
        const float dnr = dn * cf[3 * U];
        gz[s] = g * cf[4 * U];
        dg[n * KOWN + lane] = dr;
        dg[n * KOWN + U + lane] = dz;
        dg[n * KOWN + 2 * U + lane] = dnr;
        const int row = row0 + n;
        if (row < p.R) {
          const size_t o = (static_cast<size_t>(row) * T + t) * G + rank * U + lane;
          p.dxp[o] = dr;
          p.dxp[o + H] = dz;
          p.dxp[o + 2 * H] = dn;
          p.dgates[o] = dr;
          p.dgates[o + H] = dz;
          p.dgates[o + 2 * H] = dnr;
        }
      }
    }
    wg::cp_async_wait<STAGES - 2>();  // step j + 1's stage has landed
    __syncthreads();                  // dg is complete

    // dh_partial[n, tid] = dg[n, :] . W_hh[tid, the CTA's 96 columns]
    float acc[N];
#pragma unroll
    for (int n = 0; n < N; ++n) acc[n] = 0.f;
#pragma unroll
    for (int c = 0; c < KOWN; c += 4)
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float4 d = *reinterpret_cast<const float4*>(dg + n * KOWN + c);
        acc[n] = fmaf(d.x, wr[c], acc[n]);
        acc[n] = fmaf(d.y, wr[c + 1], acc[n]);
        acc[n] = fmaf(d.z, wr[c + 2], acc[n]);
        acc[n] = fmaf(d.w, wr[c + 3], acc[n]);
      }

    // reduce-scatter: the warp's units 32 w .. 32 w + 31 are CTA w's; its
    // N x 32 partials into CTA w's receive buffer cur, slot `rank`
    __syncwarp();  // the warp's reads of its staging in the last step are done
#pragma unroll
    for (int n = 0; n < N; ++n) sg[n * U + lane] = acc[n];
    __syncwarp();
#pragma unroll
    for (int c = lane; c < N * U / 4; c += 32) {
      const int n = c >> 3, q = c & 7;
      const uint4 v = *reinterpret_cast<const uint4*>(sg + n * U + 4 * q);
      const uint32_t dst = wg::smem_u32(recv + cur * RECV + (rank * N + n) * U + 4 * q);
      gc::st_async_v4(gc::mapa(dst, w), v, gc::mapa(mbar + 8 * cur, w));
    }
  }

  // dh0: the carry after t = 0, from the last step's slices
  const int last = (T - 1) & 1;
  gb::mbar_wait_bounded(mbar + 8 * last, ((T - 1) >> 1) & 1);
#pragma unroll
  for (int s = 0; s < PER; ++s) {
    const int n = w + 8 * s;
    if (n >= N) continue;
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
// block (x, y, z): gate columns [192 x, 192 x + 192), units [64 y, 64 y +
// 64), slice z of the R T rows; y = 0 also sums the slice's dgates columns
__global__ void __launch_bounds__(NT) gru_bwd_dw_f32_kernel(const Params p) {
  __shared__ __align__(16) float as[2][KC][TM];  // h_{t-1}: [row][unit]
  __shared__ __align__(16) float bs[2][KC][TN];  // dgates: [row][gate column]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int M = p.R * p.T;
  const int per = ((M + p.splits - 1) / p.splits + KC - 1) / KC * KC;
  const int k_begin = blockIdx.z * per;
  const int k_end = k_begin + per < M ? k_begin + per : M;
  const int nch = k_begin < k_end ? (k_end - k_begin + KC - 1) / KC : 0;
  const int j0 = TN * blockIdx.x, i0 = TM * blockIdx.y;
  const bool with_db = blockIdx.y == 0;

  // chunk kc: rows k_begin + 16 kc .. (zeros past the slice)
  auto load = [&](int kc, int st) {
    const int k0 = k_begin + kc * KC;
    {
      const int r = tid >> 4, c = tid & 15, m = k0 + r;
      const bool ok = m < k_end;
      wg::cp_async16(wg::smem_u32(&as[st][r][4 * c]), ok ? hprev_row(p, m) + i0 + 4 * c : p.h0, ok);
    }
#pragma unroll
    for (int it = 0; it < 3; ++it) {
      const int idx = tid + NT * it;
      const int r = idx / 48, c = idx % 48, m = k0 + r;
      const bool ok = m < k_end;
      wg::cp_async16(wg::smem_u32(&bs[st][r][4 * c]), ok ? p.dgates + static_cast<size_t>(m) * G + j0 + 4 * c : p.dgates,
                     ok);
    }
  };
  if (nch > 0) load(0, 0);
  wg::cp_async_commit();

  float acc[4][12];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 12; ++j) acc[i][j] = 0.f;
  float db = 0.f;
#pragma unroll 1
  for (int kc = 0; kc < nch; ++kc) {
    const int st = kc & 1;
    wg::cp_async_wait<0>();
    __syncthreads();  // chunk kc is in; every warp is done with the other stage
    if (kc + 1 < nch) load(kc + 1, st ^ 1);
    wg::cp_async_commit();
    chunk_fma(as[st], bs[st], acc, ty, tx);
    if (with_db && tid < TN)
#pragma unroll
      for (int k = 0; k < KC; ++k) db += bs[st][k][tid];
  }
  wg::cp_async_wait<0>();

  float* out = p.partial + static_cast<size_t>(blockIdx.z) * (H + 1) * G;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < 3; ++g)
      *reinterpret_cast<float4*>(out + static_cast<size_t>(i0 + 4 * ty + i) * G + j0 + 64 * g + 4 * tx) =
          make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]);
  if (with_db && tid < TN) out[static_cast<size_t>(H) * G + j0 + tid] = db;
}

// ---- host side --------------------------------------------------------------
// the instantiations (launched, or queried, by csrc/gru_cluster_f32.cuh's
// launch_or_query): clusters of C = 8 CTAs at N in {2, 4, 8, 16, 32} rows;
// any other tiling is cudaErrorInvalidValue
inline int dispatch(int N, int cluster, const Params* p, cudaStream_t st, int* smem, int* max_clusters) {
  if (cluster != C) return static_cast<int>(cudaErrorInvalidValue);
#define VAP_GBF_CASE(NN)                                                                                     \
  if (N == NN)                                                                                               \
  return gcf::launch_or_query(gru_bwd_f32_cluster_kernel<NN>, smem_bytes(NN), NN, p, st, smem, max_clusters)
  VAP_GBF_CASE(2);
  VAP_GBF_CASE(4);
  VAP_GBF_CASE(8);
  VAP_GBF_CASE(16);
  VAP_GBF_CASE(32);
#undef VAP_GBF_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace gbf
}  // namespace vap
