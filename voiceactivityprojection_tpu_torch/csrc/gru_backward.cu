// GRU backward (reverse-time BPTT) over precomputed input projections.
// Replaces the TPU kernel `_gru_bwd_kernel` of
// voiceactivityprojection_tpu/ops/gru_pallas.py (:300; entry point
// `_backward_pallas`, :380).
//
// Given x_proj, W_hh, b_hh, h0, the forward's outputs ys and their
// cotangents dys (the h_last cotangent already folded into dys[:, T-1]),
// for t from T-1 down to 0, with h_{t-1} = ys[:, t-1] (h0 at t = 0) read in
// the I/O type and the gates recomputed in f32:
//   hp = h_{t-1} @ W_hh + b_hh;  r, z, n as in the forward;  G = dh + dys[:, t]
//   dn = G (1 - z)(1 - n^2);  dz = G (h_{t-1} - n) z (1 - z);  dr = dn hp_n r (1 - r)
//   dxp[:, t] = [dr, dz, dn] (I/O type);  dgates[:, t] = [dr, dz, dn r] (f32)
//   dh = G z + dgates @ W_hh^T
// dh0 is the carry after t = 0 (f32), and over all rows and steps
//   dW_hh = sum h_{t-1}^T dgates,  db_hh = sum dgates  (f32).
//
// The TPU kernel carries dh, dW and db across its sequential grid in VMEM.
// Blocks on the card carry nothing between them, so the work is three
// kernels without atomics (the result does not depend on the schedule):
// (a) gru_bwd_recurrence_kernel, K3's shape: one block of 3H threads per
//     row. Thread j recomputes column j of h_{t-1} @ W_hh from W_hh[:, j] in
//     L2 (csrc/gru_step.cuh); threads i < H form the gate gradients, store
//     dxp and the f32 dgates scratch, and keep the f32 dh carry in a
//     register. For dgates @ W_hh^T the three groups of H threads each sum
//     one third of the 3H range for every i, reading the wrapper's
//     transposed copy W_hh^T (3H, H) row by row (coalesced), and the three
//     partials are added in shared memory. Four barriers per step.
// (b) gru_bwd_weights_kernel: dW_hh and db_hh as one (H+1) x 3H product
//     [h_{t-1}, 1]^T dgates over the R*T rows, in 64 x 64 tiles (4 x 4
//     outputs a thread) on the CUDA cores in f32; the rows are cut into
//     `splits` slices so that enough blocks are in flight, and each block
//     writes its tile's partial sum for its slice.
// (c) gru_bwd_sum_kernel adds the slices' partials in slice order.
//
// Bound: (a) the T dependent steps, each streaming W_hh twice from L2
// (768 KB f32 / 384 KB bf16 at H=256, which no SM's shared memory holds);
// (b) operations, 2 R T H 3H multiply-adds on the CUDA cores.
//
// That block design is the route of any H but 256. At H = 256 both dtypes
// run the three-phase cluster design (the gate recompute as one product
// ahead of the loop, W_hh resident in the registers of an 8-CTA cluster, dh
// as a reduce-scatter through distributed shared memory, dW_hh as a second
// product over all rows and steps, (c) as the last launch): bfloat16 on
// `wgmma` (csrc/gru_bwd_cluster.cuh, vap_gru_backward_cluster), float32 in
// exact f32 FFMA (csrc/gru_bwd_cluster_f32.cuh,
// vap_gru_backward_cluster_f32); the wrapper picks the route and the tiling
// (ops/gru_cluster.py).

#include "gru_bwd_cluster.cuh"
#include "gru_bwd_cluster_f32.cuh"
#include "gru_step.cuh"

namespace {

constexpr int MAX_THREADS = 768;
constexpr int TILE = 64;      // (b): output tile edge
constexpr int BN = 32;        // (b): rows of the contraction per shared-memory stage
constexpr int WTHREADS = 256; // (b): 16 x 16 threads, 4 x 4 outputs each
constexpr int SUM_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) gru_bwd_recurrence_kernel(
    const T* __restrict__ xp, const T* __restrict__ w_hh, const T* __restrict__ w_hh_t,
    const T* __restrict__ b_hh, const T* __restrict__ h0, const T* __restrict__ ys,
    const T* __restrict__ dys, T* __restrict__ dxp, float* __restrict__ dgates,
    float* __restrict__ dh0, int steps, int H) {
  extern __shared__ float smem[];
  float* hprev = smem;        // H: h_{t-1}
  float* hp = hprev + H;      // 3H: h_{t-1} @ W_hh + b_hh
  float* dg = hp + 3 * H;     // 3H: dgates of the step
  float* part = dg + 3 * H;   // 3H: the three groups' partials of dgates @ W_hh^T

  const int tid = threadIdx.x;
  const int G3 = 3 * H;
  const int row = blockIdx.x;
  const size_t xrow = static_cast<size_t>(row) * steps * G3;
  const size_t hrow = static_cast<size_t>(row) * steps * H;

  const float bh = vap::to_f32(b_hh[tid]);
  const T* wcol = w_hh + tid;
  // group grp sums k in [grp H, (grp + 1) H) of dgates[k] W_hh^T[k, col]
  const int grp = tid / H;
  const int col = tid - grp * H;
  const T* wt_col = w_hh_t + static_cast<size_t>(grp) * H * H + col;
  const float* dg_grp = dg + grp * H;

  float dh = 0.f;  // threads i < H: dL/dh_t[i], carried from step to step
  for (int t = steps - 1; t >= 0; --t) {
    float h = 0.f, g = 0.f, xr = 0.f, xz = 0.f, xn = 0.f;
    if (tid < H) {
      h = vap::to_f32(t > 0 ? ys[hrow + static_cast<size_t>(t - 1) * H + tid]
                            : h0[static_cast<size_t>(row) * H + tid]);
      hprev[tid] = h;
      g = dh + vap::to_f32(dys[hrow + static_cast<size_t>(t) * H + tid]);
      const T* xt = xp + xrow + static_cast<size_t>(t) * G3;
      xr = vap::to_f32(xt[tid]);
      xz = vap::to_f32(xt[H + tid]);
      xn = vap::to_f32(xt[2 * H + tid]);
    }
    __syncthreads();  // hprev is complete
    hp[tid] = vap::column_dot(hprev, wcol, H, G3) + bh;
    __syncthreads();  // hp is complete
    float gz = 0.f;
    if (tid < H) {
      const float r = vap::sigmoidf_(xr + hp[tid]);
      const float z = vap::sigmoidf_(xz + hp[H + tid]);
      const float hn = hp[2 * H + tid];
      const float n = tanhf(xn + r * hn);
      const float dn = g * (1.f - z) * (1.f - n * n);
      const float dz = g * (h - n) * z * (1.f - z);
      const float dr = dn * hn * r * (1.f - r);
      const float dnr = dn * r;
      T* dx = dxp + xrow + static_cast<size_t>(t) * G3;
      dx[tid] = vap::from_f32<T>(dr);
      dx[H + tid] = vap::from_f32<T>(dz);
      dx[2 * H + tid] = vap::from_f32<T>(dn);
      float* dgo = dgates + xrow + static_cast<size_t>(t) * G3;
      dgo[tid] = dr;
      dgo[H + tid] = dz;
      dgo[2 * H + tid] = dnr;
      dg[tid] = dr;
      dg[H + tid] = dz;
      dg[2 * H + tid] = dnr;
      gz = g * z;
    }
    __syncthreads();  // dg is complete
    part[tid] = vap::column_dot(dg_grp, wt_col, H, H);
    __syncthreads();  // part is complete
    if (tid < H) dh = gz + ((part[tid] + part[H + tid]) + part[2 * H + tid]);
  }
  if (tid < H) dh0[static_cast<size_t>(row) * H + tid] = dh;
}

// partial[z] (H+1, 3H) = [h_{t-1}, 1]^T dgates over rows [z chunk, (z+1) chunk)
// of the R*T; tile (blockIdx.y, blockIdx.x) of 64 x 64, row H (db) by the
// blocks with blockIdx.y == 0.
template <typename T>
__global__ void __launch_bounds__(WTHREADS) gru_bwd_weights_kernel(
    const T* __restrict__ ys, const T* __restrict__ h0, const float* __restrict__ dgates,
    float* __restrict__ partial, long long n_rows, int steps, int H, long long chunk) {
  __shared__ __align__(16) float hs[BN][TILE];
  __shared__ __align__(16) float ds[BN][TILE];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int G3 = 3 * H;
  const int k0 = blockIdx.x * TILE;
  const int i0 = blockIdx.y * TILE;
  const bool with_db = blockIdx.y == 0;
  const long long n_begin = static_cast<long long>(blockIdx.z) * chunk;
  const long long n_end = n_begin + chunk < n_rows ? n_begin + chunk : n_rows;

  float acc[4][4] = {};
  float db = 0.f;
  for (long long n0 = n_begin; n0 < n_end; n0 += BN) {
    for (int e = tid; e < BN * TILE; e += WTHREADS) {
      const int nn = e / TILE, c = e % TILE;
      const long long n = n0 + nn;
      float hv = 0.f, dv = 0.f;
      if (n < n_end) {
        const int i = i0 + c, k = k0 + c;
        if (i < H) {
          const long long r = n / steps;
          const int t = static_cast<int>(n - r * steps);
          hv = vap::to_f32(t > 0 ? ys[(n - 1) * H + i] : h0[r * H + i]);
        }
        if (k < G3) dv = dgates[n * G3 + k];
      }
      hs[nn][c] = hv;
      ds[nn][c] = dv;
    }
    __syncthreads();
#pragma unroll 4
    for (int nn = 0; nn < BN; ++nn) {
      const float4 a = *reinterpret_cast<const float4*>(&hs[nn][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ds[nn][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
    }
    if (with_db && tid < TILE) {
      for (int nn = 0; nn < BN; ++nn) db += ds[nn][tid];
    }
    __syncthreads();
  }
  float* out = partial + static_cast<size_t>(blockIdx.z) * (H + 1) * G3;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int i = i0 + ty * 4 + p;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + tx * 4 + q;
      if (i < H && k < G3) out[static_cast<size_t>(i) * G3 + k] = acc[p][q];
    }
  }
  if (with_db && tid < TILE && k0 + tid < G3) out[static_cast<size_t>(H) * G3 + k0 + tid] = db;
}

__global__ void __launch_bounds__(SUM_THREADS) gru_bwd_sum_kernel(
    const float* __restrict__ partial, float* __restrict__ out, int n, int splits) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int j = 0; j < splits; ++j) s += partial[static_cast<size_t>(j) * n + e];
  out[e] = s;
}

}  // namespace

// xp, dxp: (rows, T, 3H); w_hh: (H, 3H); w_hh_t: (3H, H), its transpose;
// b_hh: (3H,); h0: (rows, H); ys, dys: (rows, T, H), all in the I/O type.
// f32 outputs and scratch: dgates (rows, T, 3H); dh0 (rows, H); partial
// (splits, H+1, 3H); dwb (H+1, 3H) = [dW_hh; db_hh]. Needs H % 32 == 0 and
// 3H <= 768. Launches (a), (b), (c) in order on `stream`; returns the first
// cudaGetLastError() that is not cudaSuccess.
extern "C" int vap_gru_backward(const void* xp, const void* w_hh, const void* w_hh_t,
                                const void* b_hh, const void* h0, const void* ys, const void* dys,
                                void* dxp, float* dgates, float* dh0, float* partial, float* dwb,
                                int rows, int steps, int H, int splits, int dtype, void* stream) {
  if (H % 32 != 0 || 3 * H > MAX_THREADS || rows < 1 || steps < 1 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G3 = 3 * H;
  const long long n_rows = static_cast<long long>(rows) * steps;
  const long long per = (n_rows + splits - 1) / splits;
  const long long chunk = (per + BN - 1) / BN * BN;
  const size_t smem = static_cast<size_t>(10 * H) * sizeof(float);
  const dim3 wgrid((G3 + TILE - 1) / TILE, (H + TILE - 1) / TILE, splits);
  const int n_out = (H + 1) * G3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = 0;
  VAP_DISPATCH_DTYPE(dtype, T, {
    gru_bwd_recurrence_kernel<T><<<rows, G3, smem, st>>>(
        static_cast<const T*>(xp), static_cast<const T*>(w_hh), static_cast<const T*>(w_hh_t),
        static_cast<const T*>(b_hh), static_cast<const T*>(h0), static_cast<const T*>(ys),
        static_cast<const T*>(dys), static_cast<T*>(dxp), dgates, dh0, steps, H);
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    gru_bwd_weights_kernel<T><<<wgrid, WTHREADS, 0, st>>>(
        static_cast<const T*>(ys), static_cast<const T*>(h0), dgates, partial, n_rows, steps, H,
        chunk);
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  });
  gru_bwd_sum_kernel<<<(n_out + SUM_THREADS - 1) / SUM_THREADS, SUM_THREADS, 0, st>>>(
      partial, dwb, n_out, splits);
  return static_cast<int>(cudaGetLastError());
}

// The cluster design (bf16, H = 256): xp, dxp (rows, T, 768); w_hh (256,
// 768); b_hh (768,); h0 (rows, 256); ys, dys (rows, T, 256), all bf16 and
// 16-byte aligned. Scratch: coef (rows, T, 8, 5, 32) f32; dg (2, rows, T,
// 768) bf16; partial (splits, 257, 768) f32. Outputs dh0 (rows, 256) and
// dwb (257, 768) = [dW_hh; db_hh], f32. `phases` selects the launches, in
// order: 1 the coefficients, 2 the recurrence (clusters of `cluster` CTAs,
// `rows_per_cluster` rows each), 4 the weight product, 8 the slice sum;
// the wrapper passes 15 (the others time one phase alone). Returns the
// first cudaGetLastError() that is not cudaSuccess (cudaErrorInvalidValue
// for a tiling it does not take).
extern "C" int vap_gru_backward_cluster(const void* xp, const void* w_hh, const void* b_hh, const void* h0,
                                        const void* ys, const void* dys, void* dxp, float* coef, void* dg,
                                        float* dh0, float* partial, float* dwb, int rows, int steps,
                                        int cluster, int rows_per_cluster, int splits, int phases,
                                        void* stream) {
  namespace gb = vap::gb;
  using bf16 = __nv_bfloat16;
  if (rows < 1 || steps < 1 || splits < 1 || 2ll * rows * steps > 0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidValue);
  gb::Params p = {};
  p.xp = static_cast<const bf16*>(xp);
  p.w_hh = static_cast<const bf16*>(w_hh);
  p.b_hh = static_cast<const bf16*>(b_hh);
  p.h0 = static_cast<const bf16*>(h0);
  p.ys = static_cast<const bf16*>(ys);
  p.dys = static_cast<const bf16*>(dys);
  p.dxp = static_cast<bf16*>(dxp);
  p.coef = coef;
  p.dg = static_cast<bf16*>(dg);
  p.dh0 = dh0;
  p.partial = partial;
  p.R = rows;
  p.T = steps;
  p.splits = splits;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = 0;
  if (phases & 1) {
    rc = static_cast<int>(cudaFuncSetAttribute(gb::gru_bwd_gates_wgmma_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, gb::GATES_SMEM));
    if (rc != 0) return rc;
    const long long m = static_cast<long long>(rows) * steps;
    gb::gru_bwd_gates_wgmma_kernel<<<dim3(static_cast<unsigned>((m + 63) / 64), gb::H / 64), 128,
                                     gb::GATES_SMEM, st>>>(p);
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  if (phases & 2) {
    rc = gb::dispatch(rows_per_cluster, cluster, &p, st, nullptr, nullptr);
    if (rc != 0) return rc;
  }
  if (phases & 4) {
    rc = static_cast<int>(cudaFuncSetAttribute(gb::gru_bwd_dw_wgmma_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, gb::DW_SMEM));
    if (rc != 0) return rc;
    gb::gru_bwd_dw_wgmma_kernel<<<dim3(gb::DW_COL_TILES, gb::DW_ROW_TILES, splits), 128, gb::DW_SMEM, st>>>(p);
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  if (phases & 8) {
    const int n_out = (gb::H + 1) * gb::G;
    gru_bwd_sum_kernel<<<(n_out + SUM_THREADS - 1) / SUM_THREADS, SUM_THREADS, 0, st>>>(partial, dwb, n_out,
                                                                                      splits);
    rc = static_cast<int>(cudaGetLastError());
  }
  return rc;
}

// The recurrence kernel's dynamic shared bytes a CTA and the clusters that
// can be resident at once (cudaOccupancyMaxActiveClusters) for one tiling.
extern "C" int vap_gru_backward_cluster_info(int cluster, int rows_per_cluster, int* smem, int* max_clusters) {
  return vap::gb::dispatch(rows_per_cluster, cluster, nullptr, nullptr, smem, max_clusters);
}

// The cluster design in float32 (H = 256): xp, dxp (rows, T, 768); w_hh
// (256, 768); b_hh (768,); h0 (rows, 256); ys, dys (rows, T, 256), all f32
// and 16-byte aligned. Scratch: coef (rows, T, 8, 5, 32); dgates (rows, T,
// 768); partial (splits, 257, 768). Outputs dh0 (rows, 256) and dwb (257,
// 768) = [dW_hh; db_hh]. `phases` as vap_gru_backward_cluster's: 1 the
// coefficients, 2 the recurrence, 4 the weight product, 8 the slice sum.
// Returns the first cudaGetLastError() that is not cudaSuccess
// (cudaErrorInvalidValue for a tiling it does not take).
extern "C" int vap_gru_backward_cluster_f32(const void* xp, const void* w_hh, const void* b_hh, const void* h0,
                                            const void* ys, const void* dys, void* dxp, float* coef, float* dgates,
                                            float* dh0, float* partial, float* dwb, int rows, int steps,
                                            int cluster, int rows_per_cluster, int splits, int phases,
                                            void* stream) {
  namespace gf = vap::gbf;
  if (rows < 1 || steps < 1 || splits < 1 || static_cast<long long>(rows) * steps > 0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidValue);
  gf::Params p = {};
  p.xp = static_cast<const float*>(xp);
  p.w_hh = static_cast<const float*>(w_hh);
  p.b_hh = static_cast<const float*>(b_hh);
  p.h0 = static_cast<const float*>(h0);
  p.ys = static_cast<const float*>(ys);
  p.dys = static_cast<const float*>(dys);
  p.dxp = static_cast<float*>(dxp);
  p.coef = coef;
  p.dgates = dgates;
  p.dh0 = dh0;
  p.partial = partial;
  p.R = rows;
  p.T = steps;
  p.splits = splits;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = 0;
  if (phases & 1) {
    const int m = rows * steps;
    gf::gru_bwd_coef_f32_kernel<<<dim3((m + gf::TM - 1) / gf::TM, gf::H / 64), gf::NT, 0, st>>>(p);
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  if (phases & 2) {
    rc = gf::dispatch(rows_per_cluster, cluster, &p, st, nullptr, nullptr);
    if (rc != 0) return rc;
  }
  if (phases & 4) {
    gf::gru_bwd_dw_f32_kernel<<<dim3(gf::DW_COL_TILES, gf::DW_ROW_TILES, splits), gf::NT, 0, st>>>(p);
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  if (phases & 8) {
    const int n_out = (gf::H + 1) * gf::G;
    gru_bwd_sum_kernel<<<(n_out + SUM_THREADS - 1) / SUM_THREADS, SUM_THREADS, 0, st>>>(partial, dwb, n_out,
                                                                                      splits);
    rc = static_cast<int>(cudaGetLastError());
  }
  return rc;
}

// The float32 recurrence kernel's dynamic shared bytes a CTA and the
// clusters that can be resident at once for one tiling.
extern "C" int vap_gru_backward_cluster_f32_info(int cluster, int rows_per_cluster, int* smem, int* max_clusters) {
  return vap::gbf::dispatch(rows_per_cluster, cluster, nullptr, nullptr, smem, max_clusters);
}
