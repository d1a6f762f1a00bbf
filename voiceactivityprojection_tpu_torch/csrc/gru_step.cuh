// One GRU step for a block of 3H threads, shared by the GRU kernels
// (csrc/gru_recurrence.cu, csrc/gru_downsample.cu, and the backward's
// recompute in csrc/gru_backward.cu). With x_proj precomputed
// (x @ W_ih + b_ih) and gate order r, z, n:
//   hp = h @ W_hh + b_hh
//   r = sigmoid(x_r + hp_r); z = sigmoid(x_z + hp_z); n = tanh(x_n + r * hp_n)
//   h = (1 - z) * n + z * h
// Thread j owns column j of h @ W_hh and reads W_hh[:, j] from L2 (coalesced
// across the warp); the f32 carry h (H) and hp (3H) live in shared memory.
#pragma once

#include "common.cuh"

namespace vap {

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

// sum_i v[i] * col[i * stride] over i < n (n % 4 == 0): v in shared memory,
// col a column of a row-major matrix read from L2 (coalesced across the warp
// when neighbouring threads own neighbouring columns).
template <typename T>
__device__ __forceinline__ float column_dot(const float* v, const T* __restrict__ col, int n,
                                            int stride) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
  for (int i = 0; i < n; i += 4) {
    a0 = fmaf(v[i], to_f32(col[static_cast<size_t>(i) * stride]), a0);
    a1 = fmaf(v[i + 1], to_f32(col[static_cast<size_t>(i + 1) * stride]), a1);
    a2 = fmaf(v[i + 2], to_f32(col[static_cast<size_t>(i + 2) * stride]), a2);
    a3 = fmaf(v[i + 3], to_f32(col[static_cast<size_t>(i + 3) * stride]), a3);
  }
  return (a0 + a1) + (a2 + a3);
}

// One step on x_proj row `xt` (3H elements); `wcol` is W_hh + threadIdx.x and
// `bh` is b_hh[threadIdx.x]. Updates h in place; threads j < H return the new
// h[j], the others 0. It ends without a barrier: the caller stores the new
// state where it needs it, then calls __syncthreads() before the next step.
template <typename T>
__device__ __forceinline__ float gru_step(float* h, float* hp, const T* __restrict__ xt,
                                          const T* __restrict__ wcol, float bh, int H) {
  const int tid = threadIdx.x;
  float xr = 0.f, xz = 0.f, xn = 0.f;
  if (tid < H) {
    xr = to_f32(xt[tid]);
    xz = to_f32(xt[H + tid]);
    xn = to_f32(xt[2 * H + tid]);
  }
  hp[tid] = column_dot(h, wcol, H, 3 * H) + bh;
  __syncthreads();  // every read of h for this step is done; hp is complete
  float hn = 0.f;
  if (tid < H) {
    const float r = sigmoidf_(xr + hp[tid]);
    const float z = sigmoidf_(xz + hp[H + tid]);
    const float n = tanhf(xn + r * hp[2 * H + tid]);
    hn = (1.f - z) * n + z * h[tid];
    h[tid] = hn;
  }
  return hn;
}

}  // namespace vap
