// GRU recurrence + causal downsample conv (k=5, s=2) + LayerNorm + exact
// GELU. Replaces the TPU kernel `_gru_ds_kernel` of
// voiceactivityprojection_tpu/ops/gru_pallas.py (:94).
//
// Per step t, with x_proj precomputed (x @ W_ih + b_ih) and gate order r, z, n:
//   hp = h @ W_hh + b_hh
//   r = sigmoid(x_r + hp_r); z = sigmoid(x_z + hp_z); n = tanh(x_n + r * hp_n)
//   h = (1 - z) * n + z * h
// Downsample output j (causal, 4 zero frames on the left) reads h_{2j-4..2j}:
//   y_j = LN(b_d + sum_tap h_{2j-4+tap} @ W_d[tap]); out_j = GELU(round_T(y_j))
// so ceil(T/2) outputs. Gate math, the carry, the conv sums and the norm
// statistics are f32 whatever the I/O type; outputs are in the I/O type.
//
// One block of 3H threads per sequence. Thread j owns column j of h @ W_hh
// and reads W_hh[:, j] from L2 every step (coalesced across the warp); the
// hidden state is in shared memory (the step: csrc/gru_step.cuh). Every TB steps the block runs the
// downsample for the TB/2 outputs those steps complete, from a ring that
// holds the last 4 + TB hidden states, then LayerNorm and GELU with one
// warp per output row. The GRU output never reaches device memory.
//
// Bound: the sequential steps. W_hh does not fit in shared memory (768 KB
// f32 / 384 KB bf16 at H=256), so each step's time is what one SM needs
// to stream it from L2.
//
// That block kernel is the route of any H but 256. At H = 256 both dtypes
// run an 8-CTA cluster with W_hh resident in registers and W_d in shared
// memory (route and tiling: ops/gru_cluster.py): bfloat16 the kernel of
// csrc/gru_cluster.cuh (the step and the conv on `wgmma`, the carry split
// into two bf16 halves), through vap_gru_downsample_cluster; float32 the
// kernel of csrc/gru_cluster_f32.cuh (the step and the conv as f32 FFMA, h
// exchanged in f32, the conv run after each step's send), through
// vap_gru_downsample_cluster_f32.

#include "gru_cluster.cuh"
#include "gru_cluster_f32.cuh"
#include "gru_step.cuh"

namespace {

constexpr int TB = 24;          // GRU steps per downsample chunk
constexpr int NOUT = TB / 2;    // downsample outputs per chunk
constexpr int KD = 5;           // downsample taps
constexpr int PADL = KD - 1;    // causal left padding in frames
constexpr int OUT_PER_GROUP = NOUT / 3;  // the 3 thread groups of H split the outputs
constexpr int MAX_THREADS = 768;

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) gru_ds_kernel(
    const T* __restrict__ xp, const T* __restrict__ w_hh, const T* __restrict__ b_hh,
    const T* __restrict__ h0, const T* __restrict__ w_d, const T* __restrict__ b_d,
    const T* __restrict__ ln_w, const T* __restrict__ ln_b, T* __restrict__ out, int steps_total,
    int H) {
  extern __shared__ float smem[];
  float* h = smem;                       // H
  float* hp = h + H;                     // 3H
  float* ring = hp + 3 * H;              // (PADL + TB) x H, frame f <-> t = t0 - PADL + f
  float* ys = ring + (PADL + TB) * H;    // NOUT x H pre-norm downsample outputs

  const int tid = threadIdx.x;
  const int G = 3 * H;
  const int row = blockIdx.x;
  const int n_out = (steps_total + 1) / 2;
  const T* xrow = xp + static_cast<size_t>(row) * steps_total * G;
  T* orow = out + static_cast<size_t>(row) * n_out * H;

  if (tid < H) h[tid] = vap::to_f32(h0[static_cast<size_t>(row) * H + tid]);
  for (int i = tid; i < PADL * H; i += blockDim.x) ring[i] = 0.f;
  const float bh = vap::to_f32(b_hh[tid]);
  const T* wcol = w_hh + tid;
  __syncthreads();

  for (int t0 = 0; t0 < steps_total; t0 += TB) {
    const int steps = min(TB, steps_total - t0);
    for (int s = 0; s < steps; ++s) {
      const float hn =
          vap::gru_step<T>(h, hp, xrow + static_cast<size_t>(t0 + s) * G, wcol, bh, H);
      if (tid < H) ring[(PADL + s) * H + tid] = hn;
      __syncthreads();
    }

    // downsample conv for the outputs this chunk completes
    const int j0 = t0 / 2;
    const int nj = min(NOUT, n_out - j0);
    {
      const int grp = tid / H;
      const int c = tid - grp * H;
      const int jb = grp * OUT_PER_GROUP;
      if (jb < nj) {
        const float bd = vap::to_f32(b_d[c]);
        float acc[OUT_PER_GROUP];
#pragma unroll
        for (int q = 0; q < OUT_PER_GROUP; ++q) acc[q] = bd;
        for (int tap = 0; tap < KD; ++tap) {
          const T* wt = w_d + static_cast<size_t>(tap) * H * H + c;
          const float* fr = ring + (2 * jb + tap) * H;
#pragma unroll 4
          for (int ci = 0; ci < H; ++ci) {
            const float wv = vap::to_f32(wt[static_cast<size_t>(ci) * H]);
#pragma unroll
            for (int q = 0; q < OUT_PER_GROUP; ++q) acc[q] = fmaf(fr[2 * q * H + ci], wv, acc[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < OUT_PER_GROUP; ++q) ys[(jb + q) * H + c] = acc[q];
      }
    }
    __syncthreads();

    // LayerNorm (biased variance) + exact GELU, one warp per output row
    const int warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
    for (int jl = warp; jl < nj; jl += nwarps) {
      const float* yr = ys + jl * H;
      float s = 0.f;
      for (int c = lane; c < H; c += 32) s += yr[c];
      const float mean = vap::warp_sum(s) / H;
      float d2 = 0.f;
      for (int c = lane; c < H; c += 32) {
        const float d = yr[c] - mean;
        d2 += d * d;
      }
      const float inv = rsqrtf(vap::warp_sum(d2) / H + 1e-5f);
      T* o = orow + static_cast<size_t>(j0 + jl) * H;
      for (int c = lane; c < H; c += 32) {
        const float y = vap::round_to<T>((yr[c] - mean) * inv * vap::to_f32(ln_w[c]) +
                                         vap::to_f32(ln_b[c]));
        o[c] = vap::from_f32<T>(0.5f * y * (1.f + erff(y * 0.70710678118654752f)));
      }
    }

    // the last PADL hidden states open the next chunk's window
    if (steps == TB) {
      for (int i = tid; i < PADL * H; i += blockDim.x) ring[i] = ring[TB * H + i];
    }
    __syncthreads();
  }
}

}  // namespace

// xp: (rows, T, 3H); w_hh: (H, 3H); b_hh: (3H,); h0: (rows, H); w_d: (5, H, H);
// b_d, ln_w, ln_b: (H,); out: (rows, ceil(T/2), H). Needs H % 32 == 0 and
// 3H <= 768. Returns cudaGetLastError().
extern "C" int vap_gru_downsample(const void* xp, const void* w_hh, const void* b_hh,
                                  const void* h0, const void* w_d, const void* b_d,
                                  const void* ln_w, const void* ln_b, void* out, int rows,
                                  int steps, int H, int dtype, void* stream) {
  if (H % 32 != 0 || 3 * H > MAX_THREADS || rows < 1 || steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(4 + PADL + TB + NOUT) * H * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  VAP_DISPATCH_DTYPE(dtype, T, {
    auto kern = gru_ds_kernel<T>;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kern<<<rows, 3 * H, smem, st>>>(
        static_cast<const T*>(xp), static_cast<const T*>(w_hh), static_cast<const T*>(b_hh),
        static_cast<const T*>(h0), static_cast<const T*>(w_d), static_cast<const T*>(b_d),
        static_cast<const T*>(ln_w), static_cast<const T*>(ln_b), static_cast<T*>(out), steps,
        H);
  });
  return static_cast<int>(cudaGetLastError());
}

// The cluster kernel (bf16, H = 256): xp (rows, T, 768), w_hh (256, 768),
// b_hh (768,), h0 (rows, 256), w_d (5, 256, 256), b_d, ln_w, ln_b (256,),
// out (rows, ceil(T/2), 256), all bf16, 16-byte aligned; clusters of
// `cluster` CTAs, `rows_per_cluster` rows each. Returns cudaGetLastError()
// (cudaErrorInvalidValue for a tiling it does not take).
extern "C" int vap_gru_downsample_cluster(const void* xp, const void* w_hh, const void* b_hh,
                                          const void* h0, const void* w_d, const void* b_d,
                                          const void* ln_w, const void* ln_b, void* out, int rows,
                                          int steps, int cluster, int rows_per_cluster, void* stream) {
  if (rows < 1 || steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  vap::gc::Params p = {};
  p.xp = static_cast<const __nv_bfloat16*>(xp);
  p.w_hh = static_cast<const __nv_bfloat16*>(w_hh);
  p.b_hh = static_cast<const __nv_bfloat16*>(b_hh);
  p.h0 = static_cast<const __nv_bfloat16*>(h0);
  p.w_d = static_cast<const __nv_bfloat16*>(w_d);
  p.b_d = static_cast<const __nv_bfloat16*>(b_d);
  p.ln_w = static_cast<const __nv_bfloat16*>(ln_w);
  p.ln_b = static_cast<const __nv_bfloat16*>(ln_b);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.R = rows;
  p.T = steps;
  return vap::gc::dispatch<true>(rows_per_cluster, cluster, &p, static_cast<cudaStream_t>(stream),
                                 nullptr, nullptr);
}

// The fused kernel's dynamic shared bytes a CTA and the clusters that can be
// resident at once (cudaOccupancyMaxActiveClusters) for one tiling.
extern "C" int vap_gru_downsample_cluster_info(int cluster, int rows_per_cluster, int* smem,
                                               int* max_clusters) {
  return vap::gc::dispatch<true>(rows_per_cluster, cluster, nullptr, nullptr, smem, max_clusters);
}

// The float32 cluster kernel (H = 256): the same arguments as
// vap_gru_downsample_cluster, all float32, 16-byte aligned; clusters of
// `cluster` CTAs, `rows_per_cluster` rows each. Returns cudaGetLastError()
// (cudaErrorInvalidValue for a tiling it does not take).
extern "C" int vap_gru_downsample_cluster_f32(const void* xp, const void* w_hh, const void* b_hh,
                                              const void* h0, const void* w_d, const void* b_d,
                                              const void* ln_w, const void* ln_b, void* out, int rows,
                                              int steps, int cluster, int rows_per_cluster, void* stream) {
  if (rows < 1 || steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  vap::gcf::Params p = {};
  p.xp = static_cast<const float*>(xp);
  p.w_hh = static_cast<const float*>(w_hh);
  p.b_hh = static_cast<const float*>(b_hh);
  p.h0 = static_cast<const float*>(h0);
  p.w_d = static_cast<const float*>(w_d);
  p.b_d = static_cast<const float*>(b_d);
  p.ln_w = static_cast<const float*>(ln_w);
  p.ln_b = static_cast<const float*>(ln_b);
  p.out = static_cast<float*>(out);
  p.R = rows;
  p.T = steps;
  return vap::gcf::dispatch(rows_per_cluster, cluster, &p, static_cast<cudaStream_t>(stream), nullptr, nullptr);
}

// The float32 cluster kernel's dynamic shared bytes a CTA and the clusters
// that can be resident at once for one tiling.
extern "C" int vap_gru_downsample_cluster_f32_info(int cluster, int rows_per_cluster, int* smem,
                                                   int* max_clusters) {
  return vap::gcf::dispatch(rows_per_cluster, cluster, nullptr, nullptr, smem, max_clusters);
}
