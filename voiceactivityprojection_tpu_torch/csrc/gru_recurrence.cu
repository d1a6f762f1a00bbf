// GRU recurrence over precomputed input projections. Replaces the TPU kernel
// `_gru_kernel` of voiceactivityprojection_tpu/ops/gru_pallas.py (:49; entry
// point `gru_recurrence_pallas`, :255).
//
// Per step t, with x_proj precomputed (x @ W_ih + b_ih) and gate order r, z, n:
//   hp = h @ W_hh + b_hh
//   r = sigmoid(x_r + hp_r); z = sigmoid(x_z + hp_z); n = tanh(x_n + r * hp_n)
//   h = (1 - z) * n + z * h;   ys[:, t] = h
// Gate math and the carry are f32 whatever the I/O type (as the TPU kernel's
// f32 scratch carry); ys is written in the I/O type.
//
// One block of 3H threads per sequence, the design of the GRU + downsample
// kernel (csrc/gru_downsample.cu) without its epilogue, with the same step
// (csrc/gru_step.cuh): thread j owns column j of h @ W_hh and reads
// W_hh[:, j] from L2 every step (coalesced across the warp), the hidden state
// lives in shared memory, two barriers per step, and threads j < H write
// ys[:, t, j] (one coalesced row per step).
//
// Bound: the sequential steps. W_hh (768 KB f32 / 384 KB bf16 at H=256) does
// not fit one SM's shared memory, so each step's time is what one SM needs to
// stream it from L2; the rows of a batch run side by side on separate SMs.
//
// That block kernel is the route of any H but 256, in either dtype. At
// H = 256 both dtypes run on an 8-SM thread-block cluster whose CTAs keep
// their units' W_hh columns in registers: bfloat16 the step on `wgmma`
// (csrc/gru_cluster.cuh, vap_gru_recurrence_cluster below), float32 the step
// as f32 FFMA over eight k-slices (csrc/gru_cluster_f32.cuh,
// vap_gru_recurrence_cluster_f32); the wrapper picks the route and the
// tiling (ops/gru_cluster.py).

#include "gru_cluster_f32.cuh"
#include "gru_step.cuh"

namespace {

constexpr int MAX_THREADS = 768;

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) gru_kernel(
    const T* __restrict__ xp, const T* __restrict__ w_hh, const T* __restrict__ b_hh,
    const T* __restrict__ h0, T* __restrict__ ys, int steps, int H) {
  extern __shared__ float smem[];
  float* h = smem;   // H
  float* hp = h + H;  // 3H

  const int tid = threadIdx.x;
  const int G = 3 * H;
  const int row = blockIdx.x;
  const T* xrow = xp + static_cast<size_t>(row) * steps * G;
  T* yrow = ys + static_cast<size_t>(row) * steps * H;

  if (tid < H) h[tid] = vap::to_f32(h0[static_cast<size_t>(row) * H + tid]);
  const float bh = vap::to_f32(b_hh[tid]);
  const T* wcol = w_hh + tid;
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const float hn = vap::gru_step<T>(h, hp, xrow + static_cast<size_t>(t) * G, wcol, bh, H);
    if (tid < H) yrow[static_cast<size_t>(t) * H + tid] = vap::from_f32<T>(hn);
    __syncthreads();
  }
}

}  // namespace

// xp: (rows, T, 3H); w_hh: (H, 3H); b_hh: (3H,); h0: (rows, H); ys: (rows, T, H).
// Needs H % 32 == 0 and 3H <= 768. Returns cudaGetLastError().
extern "C" int vap_gru_recurrence(const void* xp, const void* w_hh, const void* b_hh,
                                  const void* h0, void* ys, int rows, int steps, int H, int dtype,
                                  void* stream) {
  if (H % 32 != 0 || 3 * H > MAX_THREADS || rows < 1 || steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(4 * H) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  VAP_DISPATCH_DTYPE(dtype, T, {
    gru_kernel<T><<<rows, 3 * H, smem, st>>>(
        static_cast<const T*>(xp), static_cast<const T*>(w_hh), static_cast<const T*>(b_hh),
        static_cast<const T*>(h0), static_cast<T*>(ys), steps, H);
  });
  return static_cast<int>(cudaGetLastError());
}

// The cluster kernel (bf16, H = 256): xp (rows, T, 768), w_hh (256, 768),
// b_hh (768,), h0 (rows, 256), ys (rows, T, 256), all bf16, 16-byte aligned;
// clusters of `cluster` CTAs, `rows_per_cluster` rows each. Returns
// cudaGetLastError() (cudaErrorInvalidValue for a tiling it does not take).
extern "C" int vap_gru_recurrence_cluster(const void* xp, const void* w_hh, const void* b_hh,
                                          const void* h0, void* ys, int rows, int steps, int cluster,
                                          int rows_per_cluster, void* stream) {
  if (rows < 1 || steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  vap::gc::Params p = {};
  p.xp = static_cast<const __nv_bfloat16*>(xp);
  p.w_hh = static_cast<const __nv_bfloat16*>(w_hh);
  p.b_hh = static_cast<const __nv_bfloat16*>(b_hh);
  p.h0 = static_cast<const __nv_bfloat16*>(h0);
  p.ys = static_cast<__nv_bfloat16*>(ys);
  p.R = rows;
  p.T = steps;
  return vap::gc::dispatch<false>(rows_per_cluster, cluster, &p, static_cast<cudaStream_t>(stream),
                                  nullptr, nullptr);
}

// The cluster kernel's dynamic shared bytes a CTA and the clusters that can
// be resident at once (cudaOccupancyMaxActiveClusters) for one tiling.
extern "C" int vap_gru_recurrence_cluster_info(int cluster, int rows_per_cluster, int* smem,
                                               int* max_clusters) {
  return vap::gc::dispatch<false>(rows_per_cluster, cluster, nullptr, nullptr, smem, max_clusters);
}

// The float32 cluster kernel (H = 256): xp (rows, T, 768), w_hh (256, 768),
// b_hh (768,), h0 (rows, 256), ys (rows, T, 256), all float32, 16-byte
// aligned; clusters of `cluster` CTAs, `rows_per_cluster` rows each. Returns
// cudaGetLastError() (cudaErrorInvalidValue for a tiling it does not take).
extern "C" int vap_gru_recurrence_cluster_f32(const void* xp, const void* w_hh, const void* b_hh,
                                              const void* h0, void* ys, int rows, int steps, int cluster,
                                              int rows_per_cluster, void* stream) {
  if (rows < 1 || steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  vap::gcf::RecParams p = {};
  p.xp = static_cast<const float*>(xp);
  p.w_hh = static_cast<const float*>(w_hh);
  p.b_hh = static_cast<const float*>(b_hh);
  p.h0 = static_cast<const float*>(h0);
  p.ys = static_cast<float*>(ys);
  p.R = rows;
  p.T = steps;
  return vap::gcf::dispatch_recurrence(rows_per_cluster, cluster, &p, static_cast<cudaStream_t>(stream), nullptr,
                                       nullptr);
}

// The float32 cluster kernel's dynamic shared bytes a CTA and the clusters
// that can be resident at once for one tiling.
extern "C" int vap_gru_recurrence_cluster_f32_info(int cluster, int rows_per_cluster, int* smem,
                                                   int* max_clusters) {
  return vap::gcf::dispatch_recurrence(rows_per_cluster, cluster, nullptr, nullptr, smem, max_clusters);
}
