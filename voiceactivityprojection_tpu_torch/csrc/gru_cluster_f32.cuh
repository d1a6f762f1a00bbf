// The GRU forward step on a thread-block cluster in float32 at H = 256, with
// K2's fused downsample (csrc/gru_downsample.cu). Replaces, for float32, the
// TPU kernel `_gru_ds_kernel` (:94) of voiceactivityprojection_tpu/ops/
// gru_pallas.py, which keeps W_hh resident in VMEM and runs each step as one
// (B, H) x (H, 3H) MXU product (:64-71). The cluster, the slices, the
// exchange and the epilogue are the bfloat16 design of csrc/gru_cluster.cuh;
// the arithmetic is exact f32 on the CUDA cores.
//
// Per step t, with x_proj precomputed and gate order r, z, n:
//   hp = h @ W_hh + b_hh
//   r = sigmoid(x_r + hp_r); z = sigmoid(x_z + hp_z); n = tanh(x_n + r * hp_n)
//   h = (1 - z) * n + z * h
// then y_j = LN(b_d + sum_tap h_{2j - 4 + tap} @ W_d[tap]), out_j = GELU(y_j).
//
// Design. A cluster of 8 CTAs (one an SM) runs N rows (N = 2, 4, 8 or 9; rows
// past R are zeros that are never stored). CTA k owns the hidden units and the
// output channels [32k, 32k + 32).
// - W_hh: the CTA's 96 columns (r, z, n of its units) stay in registers for
//   the whole launch, 96 a thread: thread (unit u, k-slice s) holds the 32 rows
//   of slice s of the three columns of u, so no step reads W_hh from L2.
//   Each step is N x 256 x 96 FFMA a CTA; h is read from shared memory as
//   float4 runs of a row, the same address for a quarter-warp. The slices'
//   partial sums meet in two levels: a shuffle across the two slices of a
//   warp, then the four slice pairs through shared memory.
// - The carry is f32 and so is what the CTAs exchange: after the gate math
//   each CTA writes its units of h_t into its own buffer, then sends that
//   slice to every peer with st.async (16 bytes a store into distributed
//   shared memory), counted on the peer's mbarrier of that buffer, as in
//   bf16 (the same bytes a step as bf16's hi/lo pair). Three buffers, so that
//   the conv can read h_{t-1} after h_t has been sent: a peer writes buffer
//   (t + 3) % 3 only once it has h_{t+2}, which this CTA sends after step t + 1.
//   No cluster barrier runs in the loop.
// - x_proj slices of the CTA's units arrive by cp.async two steps ahead.
// - The downsample: W_d's columns of the CTA's channels for all five taps
//   (5 x 256 x 32 f32, 160 KB) stay in shared memory. Thread (channel c,
//   k-slice s) adds frame f's products over its slice to the open outputs of
//   its channel, held in registers: frame 2m feeds outputs m, m + 1, m + 2
//   (taps 4, 2, 0), frame 2m + 1 outputs m + 1, m + 2 (taps 3, 1). This runs
//   in step f + 1 after h_{f+1} has been sent, so the products of the conv
//   fill the time the exchange takes and stay off the recurrence's dependent
//   chain. When output m is complete (frame 2m) the eight slices' partials
//   are summed through shared memory, and its LayerNorm statistics are
//   reduced over the cluster in two exchanges that ride on the steps'
//   mbarriers, sent before the conv of their step: the row sums (step
//   2m + 2), then the squared deviations from the mean (2m + 3); in step
//   2m + 4 each CTA normalises its channels, applies the exact-erf GELU and
//   stores them. The loop runs until the last output is stored (steps past T
//   carry zero x_proj and store nothing).
//
// Bound: the dependent steps, each the FFMA of the product (about 0.8 us at
// N = 8), the exchange and the gate math; the conv's FFMA (N x 5 x 256 x 32
// every other step) shares the SM's FMA pipes.
//
// Shared memory at N rows: 163,864 + 6,152 N bytes (N = 9: 219,232), within
// the 232,448 a CTA may take; N = 16 would need 262,296. K3's float32 route
// can take the same step (the product over the slices, the gate math and the
// slice exchange) without the downsample.

#pragma once

#include "gru_cluster.cuh"

namespace vap {
namespace gcf {

constexpr int H = 256;
constexpr int C = 8;       // CTAs a cluster
constexpr int U = H / C;   // hidden units and output channels of one CTA
constexpr int KSL = 8;     // k-slices of the contraction over H, 32 units of h each
constexpr int STAGES = 3;  // x_proj ring: two steps in flight
constexpr int HBUFS = 3;   // h buffers
constexpr int TAPS = 5;    // downsample taps
constexpr int NT = 256;    // threads: (unit, k-slice) in the product, (channel, k-slice) in the conv

// dynamic shared memory of one CTA (ops/gru_cluster.py f32_smem_bytes
// reckons the same): W_d, the h buffers, the x_proj ring, the slice pairs'
// partial sums (the conv's eight slices share it), the outputs' sums, the
// statistics and means of two outputs, and the buffers' mbarriers
__host__ __device__ constexpr int smem_bytes(int N) {
  return TAPS * H * U * 4 + HBUFS * N * H * 4 + STAGES * N * 3 * U * 4 + (KSL / 2) * 3 * N * U * 4 +
         2 * N * U * 4 + 2 * 2 * C * N * 4 + 2 * N * 4 + HBUFS * 8;
}

struct Params {
  const float* xp;    // (R, T, 3H)
  const float* w_hh;  // (H, 3H)
  const float* b_hh;  // (3H,)
  const float* h0;    // (R, H)
  const float* w_d;   // (5, H, H) as (tap, in, out)
  const float* b_d;   // (H,)
  const float* ln_w;  // (H,)
  const float* ln_b;  // (H,)
  float* out;         // (R, ceil(T / 2), H)
  int R, T;
};

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// the wait on a buffer's mbarrier, bounded: 2^32 cycles (about 2 s) end the
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

__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// frame h (rows [n][k]) over k-slice s into the open outputs of channel c:
// an odd frame adds taps 3, 1 to a0, a1; an even one taps 4, 2, 0 to a0, a1,
// a2 (W_d rows [tap][k][c]: the warp reads 32 neighbouring floats, h the
// same float4 across the warp)
template <int N, bool ODD>
__device__ __forceinline__ void conv_frame(const float* h, const float* wd, int s, int c, float (&a0)[N],
                                           float (&a1)[N], float (&a2)[N]) {
  const float* wk = wd + (U * s) * U + c;
#pragma unroll
  for (int kq = 0; kq < U / 4; ++kq) {
    float4 hv[N];
#pragma unroll
    for (int n = 0; n < N; ++n) hv[n] = *reinterpret_cast<const float4*>(h + n * H + U * s + 4 * kq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* wt = wk + (4 * kq + kk) * U;
      if constexpr (ODD) {
        const float w3 = wt[3 * H * U], w1 = wt[1 * H * U];
#pragma unroll
        for (int n = 0; n < N; ++n) {
          a0[n] = fmaf(lane_of(hv[n], kk), w3, a0[n]);
          a1[n] = fmaf(lane_of(hv[n], kk), w1, a1[n]);
        }
      } else {
        const float w4 = wt[4 * H * U], w2 = wt[2 * H * U], w0 = wt[0];
#pragma unroll
        for (int n = 0; n < N; ++n) {
          a0[n] = fmaf(lane_of(hv[n], kk), w4, a0[n]);
          a1[n] = fmaf(lane_of(hv[n], kk), w2, a1[n]);
          a2[n] = fmaf(lane_of(hv[n], kk), w0, a2[n]);
        }
      }
    }
  }
}

template <int N>
__global__ void __launch_bounds__(NT, 1) gru_ds_f32_cluster_kernel(const Params p) {
  constexpr int BUF = N * H;                    // floats of one h buffer, [n][k]
  constexpr int XSTAGE = N * 3 * U;             // floats of one x_proj stage, [n][gate][u]
  constexpr int RED = 3 * N * U;                // floats of one slice pair's partials, [gate][n][u]
  constexpr int PAIRS = (N * U + NT - 1) / NT;  // (unit, row) pairs of a thread's gate math
  constexpr int CH = U / 4;                     // 16-byte chunks of a CTA's slice of a row
  constexpr uint32_t SLICE_BYTES = (C - 1) * N * U * 4;  // the peers' h slices a step
  constexpr uint32_t STAT_BYTES = (C - 1) * N * 4;       // the peers' partials of a statistic
  static_assert(N >= 1 && N <= 11, "at most 11 rows fit a CTA's shared memory");

  extern __shared__ __align__(16) unsigned char smem_f32[];
  float* wd = reinterpret_cast<float*>(smem_f32);  // [tap][k][c]
  float* hb = wd + TAPS * H * U;                   // buffer b at hb + b BUF
  float* xs = hb + HBUFS * BUF;                    // [stage][n][gate][u]
  float* red = xs + STAGES * XSTAGE;               // [pair][gate][n][u]; the conv's [slice][n][c]
  float* ysum = red + (KSL / 2) * RED;             // [slot][n][c]: b_d + the conv, two outputs
  float* sums = ysum + 2 * N * U;                  // [slot][rank][n]
  float* vars = sums + 2 * C * N;                  // [slot][rank][n]
  float* mean = vars + 2 * C * N;                  // [slot][n]
  const uint32_t mbar = wg::smem_u32(mean + 2 * N);  // HBUFS mbarriers, one a buffer

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const uint32_t rank = gc::cluster_rank();
  const int row0 = static_cast<int>(blockIdx.x / C) * N;
  const int n_out = (p.T + 1) / 2;
  const int steps = 2 * n_out + 3;
  // the product: unit gu of this CTA over k-slice gs (warp w holds 16 units
  // of two slices; a shuffle over lane bit 4 adds the slices of a pair)
  const int gu = 16 * (w & 1) + (lane & 15);
  const int gs = 2 * (w >> 1) + (lane >> 4);
  // the gate math and the epilogue: unit / channel `lane`, rows w + 8 i
  const int chan = static_cast<int>(rank) * U + lane;

  // W_d columns [32 rank, 32 rank + 32) of every tap and input unit
  for (int idx = tid; idx < TAPS * H * CH; idx += NT) {
    const int c4 = idx % CH, tk = idx / CH;  // tk = tap * H + k
    wg::cp_async16(wg::smem_u32(wd + tk * U + 4 * c4), p.w_d + static_cast<size_t>(tk) * H + rank * U + 4 * c4,
                   true);
  }
  auto load_x = [&](int t, int stage) {
    const bool tv = t < p.T;
    for (int idx = tid; idx < N * 3 * CH; idx += NT) {
      const int c4 = idx % CH, g = (idx / CH) % 3, n = idx / (3 * CH);
      const int row = row0 + n;
      const bool ok = tv && row < p.R;
      const float* src = ok ? p.xp + (static_cast<size_t>(row) * p.T + t) * 3 * H + g * H + rank * U + 4 * c4 : p.xp;
      wg::cp_async16(wg::smem_u32(xs + stage * XSTAGE + (n * 3 + g) * U + 4 * c4), src, ok);
    }
    wg::cp_async_commit();
  };
  load_x(0, 0);  // with W_d
  load_x(1, 1);

  // this thread's W_hh: rows [32 gs, 32 gs + 32) of the r, z, n columns of unit gu
  float wr[3][U];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int i = 0; i < U; ++i)
      wr[g][i] = p.w_hh[static_cast<size_t>(U * gs + i) * 3 * H + g * H + rank * U + gu];

  // h0 into buffer 0, and the carry of the thread's (unit lane, row w + 8 i)
  for (int idx = tid; idx < N * H; idx += NT) {
    const int n = idx / H, k = idx % H;
    hb[idx] = row0 + n < p.R ? p.h0[static_cast<size_t>(row0 + n) * H + k] : 0.f;
  }
  float hc[PAIRS];
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int n = w + 8 * i;
    hc[i] = n < N && row0 + n < p.R ? p.h0[static_cast<size_t>(row0 + n) * H + chan] : 0.f;
  }
  const float bhr = p.b_hh[chan], bhz = p.b_hh[H + chan], bhn = p.b_hh[2 * H + chan];
  const float bd = p.b_d[chan], lnw = p.ln_w[chan], lnb = p.ln_b[chan];
  if (tid == 0) {
#pragma unroll
    for (int b = 0; b < HBUFS; ++b) gc::mbar_init(mbar + 8 * b, 1);
    gc::fence_mbar_init();
  }
  // the conv's open outputs of channel `lane` over slice w: a0 the oldest
  float a0[N], a1[N], a2[N];
#pragma unroll
  for (int n = 0; n < N; ++n) a0[n] = a1[n] = a2[n] = 0.f;

  wg::cp_async_wait<1>();  // W_d and stage 0
  __syncthreads();
  gc::cluster_arrive();  // every CTA runs, its mbarriers set, before any remote write
  gc::cluster_wait();

  // the bytes the peers send for step s (s >= 1): their h slices, and the
  // row sums of output (s - 3) / 2 (s odd) or the squared deviations of
  // output (s - 4) / 2 (s even)
  auto expected = [&](int s) -> uint32_t {
    uint32_t b = SLICE_BYTES;
    if ((s & 1) && s >= 3 && (s - 3) / 2 < n_out) b += STAT_BYTES;
    if (!(s & 1) && s >= 4 && (s - 4) / 2 < n_out) b += STAT_BYTES;
    return b;
  };

  for (int t = 0; t < steps; ++t) {
    const float* cur = hb + (t % HBUFS) * BUF;  // h_{t-1}
    float* nxt = hb + ((t + 1) % HBUFS) * BUF;  // h_t
    const uint32_t next_bar = mbar + 8 * ((t + 1) % HBUFS);
    const bool send = t + 1 < steps;
    if (t >= 1) mbar_wait_bounded(mbar + 8 * (t % HBUFS), ((t - 1) / HBUFS) & 1);
    if (tid == 0 && send) gc::mbar_expect_tx(next_bar, expected(t + 1));
    load_x(t + 2, (t + 2) % STAGES);

    // the product over this thread's slice, then the slice pair's sum
    float acc[3][N];
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int n = 0; n < N; ++n) acc[g][n] = 0.f;
#pragma unroll
    for (int kq = 0; kq < U / 4; ++kq)
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float4 hv = *reinterpret_cast<const float4*>(cur + n * H + U * gs + 4 * kq);
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          acc[g][n] = fmaf(hv.x, wr[g][4 * kq], acc[g][n]);
          acc[g][n] = fmaf(hv.y, wr[g][4 * kq + 1], acc[g][n]);
          acc[g][n] = fmaf(hv.z, wr[g][4 * kq + 2], acc[g][n]);
          acc[g][n] = fmaf(hv.w, wr[g][4 * kq + 3], acc[g][n]);
        }
      }
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int n = 0; n < N; ++n) acc[g][n] += __shfl_xor_sync(0xffffffffu, acc[g][n], 16);
    if (lane < 16) {
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int n = 0; n < N; ++n) red[(w >> 1) * RED + (g * N + n) * U + gu] = acc[g][n];
    }
    __syncthreads();

    // gate math of (unit lane, row w + 8 i); the new h into the next buffer
    const float* xst = xs + (t % STAGES) * XSTAGE;
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int n = w + 8 * i;
      if (n < N) {
        float hr = 0.f, hz = 0.f, hn = 0.f;
#pragma unroll
        for (int sp = 0; sp < KSL / 2; ++sp) {
          hr += red[sp * RED + (0 * N + n) * U + lane];
          hz += red[sp * RED + (1 * N + n) * U + lane];
          hn += red[sp * RED + (2 * N + n) * U + lane];
        }
        const float* x = xst + n * 3 * U + lane;
        const float r = sigmoid(x[0] + (hr + bhr));
        const float z = sigmoid(x[U] + (hz + bhz));
        const float nn = tanhf(x[2 * U] + r * (hn + bhn));
        hc[i] = (1.f - z) * nn + z * hc[i];
        nxt[n * H + chan] = hc[i];
      }
    }
    wg::cp_async_wait<1>();  // stage t + 1 has landed
    __syncthreads();

    // this CTA's slice of h_t to every peer (nothing after the last step)
    if (send) {
      for (int idx = tid; idx < N * CH * (C - 1); idx += NT) {
        const int item = idx % (N * CH), peer = idx / (N * CH);
        const int r = peer + (peer >= static_cast<int>(rank));  // the peers other than this CTA
        const float* src = nxt + (item / CH) * H + rank * U + 4 * (item % CH);
        const uint4 v = *reinterpret_cast<const uint4*>(src);
        gc::st_async_v4(gc::mapa(wg::smem_u32(src), r), v, gc::mapa(next_bar, r));
      }
    }

    // the statistics, before the conv so that the peers' next step does not
    // wait on it: warp w takes the rows w + 8 i, lane the channel
    if (!(t & 1) && t >= 2) {
      const int m = (t - 2) >> 1;  // this CTA's row sums of output m to every peer
      if (m < n_out && send) {
        for (int n = w; n < N; n += 8) {
          if (lane < C && lane != static_cast<int>(rank)) {
            const float* src = sums + ((m & 1) * C + rank) * N + n;
            gc::st_async_f32(gc::mapa(wg::smem_u32(src), lane), *src, gc::mapa(next_bar, lane));
          }
        }
      }
      const int j = (t - 4) >> 1;  // variances in: LayerNorm, GELU and the store of output j
      if (t >= 4 && j < n_out) {
        for (int n = w; n < N; n += 8) {
          float v = 0.f;
#pragma unroll
          for (int r = 0; r < C; ++r) v += vars[((j & 1) * C + r) * N + n];
          const float inv = rsqrtf(v / H + 1e-5f);
          const float y = (ysum[((j & 1) * N + n) * U + lane] - mean[(j & 1) * N + n]) * inv * lnw + lnb;
          if (row0 + n < p.R)
            p.out[(static_cast<size_t>(row0 + n) * n_out + j) * H + chan] =
                0.5f * y * (1.f + erff(y * 0.70710678118654752f));
        }
      }
    } else if ((t & 1) && t >= 3) {
      const int m = (t - 3) >> 1;  // row sums in: the mean, and the squared deviations to every peer
      if (m < n_out) {
        for (int n = w; n < N; n += 8) {
          float s = 0.f;
#pragma unroll
          for (int r = 0; r < C; ++r) s += sums[((m & 1) * C + r) * N + n];
          const float mu = s / H;
          const float d = ysum[((m & 1) * N + n) * U + lane] - mu;
          const float v = warp_sum(d * d);
          if (lane == 0) mean[(m & 1) * N + n] = mu;
          float* dst = vars + ((m & 1) * C + rank) * N + n;
          if (lane == static_cast<int>(rank)) *dst = v;
          else if (lane < C && send) gc::st_async_f32(gc::mapa(wg::smem_u32(dst), lane), v, gc::mapa(next_bar, lane));
        }
      }
    }

    // the conv: frame f = t - 1 (buffer cur) into the open outputs of channel
    // lane over slice w
    if (t >= 1) {
      const int f = t - 1;
      if (f & 1) conv_frame<N, true>(cur, wd, w, lane, a0, a1, a2);
      else conv_frame<N, false>(cur, wd, w, lane, a0, a1, a2);
      if (!(f & 1)) {
        // output m = f / 2 is complete: its slices' partials summed in order,
        // b_d added, and this CTA's row sums kept for the next step's send
        const int m = f >> 1;
#pragma unroll
        for (int n = 0; n < N; ++n) red[(w * N + n) * U + lane] = a0[n];
        __syncthreads();
        if (m < n_out) {
          for (int n = w; n < N; n += 8) {
            float y = bd;
#pragma unroll
            for (int s = 0; s < KSL; ++s) y += red[(s * N + n) * U + lane];
            ysum[((m & 1) * N + n) * U + lane] = y;
            const float rs = warp_sum(y);
            if (lane == 0) sums[((m & 1) * C + rank) * N + n] = rs;
          }
        }
#pragma unroll
        for (int n = 0; n < N; ++n) {
          a0[n] = a1[n];
          a1[n] = a2[n];
          a2[n] = 0.f;
        }
        __syncthreads();  // the partials read before the next step's product sums overwrite them
      }
    }
  }
  gc::cluster_arrive();  // no CTA leaves while a peer may still write to it
  gc::cluster_wait();
  wg::cp_async_wait<0>();
}

// ---- host side ------------------------------------------------------------
template <int N>
int launch_or_query(const Params* p, cudaStream_t st, int* smem, int* max_clusters) {
  auto kern = gru_ds_f32_cluster_kernel<N>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(N));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem_bytes(N);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (p == nullptr) {  // the query: shared bytes and co-resident clusters
    cfg.gridDim = dim3(C);
    *smem = smem_bytes(N);
    return static_cast<int>(cudaOccupancyMaxActiveClusters(max_clusters, kern, &cfg));
  }
  cfg.gridDim = dim3((p->R + N - 1) / N * C);
  e = cudaLaunchKernelEx(&cfg, kern, *p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// the instantiations: clusters of C = 8 CTAs at N in {2, 4, 8, 9} rows; any
// other tiling is cudaErrorInvalidValue
inline int dispatch(int N, int cluster, const Params* p, cudaStream_t st, int* smem, int* max_clusters) {
  if (cluster != C) return static_cast<int>(cudaErrorInvalidValue);
#define VAP_GCF_CASE(NN) \
  if (N == NN) return launch_or_query<NN>(p, st, smem, max_clusters)
  VAP_GCF_CASE(2);
  VAP_GCF_CASE(4);
  VAP_GCF_CASE(8);
  VAP_GCF_CASE(9);
#undef VAP_GCF_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace gcf
}  // namespace vap
