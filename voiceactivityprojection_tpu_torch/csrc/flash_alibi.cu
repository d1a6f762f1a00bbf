// Causal ALiBi attention with the online softmax. Replaces the TPU kernels
// `_single_block_kernel` (:122, and its schedule variants) and
// `_flash_kernel` (:54) of voiceactivityprojection_tpu/ops/flash_alibi.py,
// which compute the same function:
//
//   s_ij = (q_i . k_j) * scale + slope_h * (j - i)   for j <= i (else masked)
//   out_i = sum_j softmax_j(s_i)_j v_j
//
// with f32 scores and softmax, the probabilities rounded to v's type before
// the value product (as the TPU kernels do), f32 sums, output in q's type.
//
// One block of 256 threads (16 x 16) per (batch*head, 64-query tile). It
// walks the 64-key tiles 0..qt (the causal diagonal) keeping, per query
// row, the running max m, sum l and a 64 x Dh accumulator in registers:
// thread (ty, tx) owns score rows ty + 16a and columns tx + 16b, and output
// columns tx + 16e. Row max and row sum reduce over the 16 lanes of a
// half-warp. Tiles are widened to f32 in shared memory (rows padded by one
// float against bank conflicts). Query tiles are scheduled last-first, so
// the blocks with the longest key loops start first.
//
// Bound: the roofline is about balanced at T=1000 (250 FLOP per byte of I/O
// in bf16), but this version is bound by its arithmetic: it uses the CUDA
// cores, not the tensor cores.

#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BKV = 64;  // keys per tile
constexpr int NT = 256;
constexpr int PS = BKV + 1;  // row stride of the probability tile

template <int DH>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(BQ * (DH + 1) + BKV * (DH + 1) + BKV * DH + BQ * PS) * sizeof(float);
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT) flash_alibi_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ slopes, T* __restrict__ out, int H, int steps, float scale) {
  constexpr int QS = DH + 1;
  constexpr int CPT = DH / 16;  // output columns per thread
  extern __shared__ float sm[];
  float* Qs = sm;               // BQ x QS
  float* Ks = Qs + BQ * QS;     // BKV x QS
  float* Vs = Ks + BKV * QS;    // BKV x DH
  float* Ps = Vs + BKV * DH;    // BQ x PS

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const float slope = slopes[bh % H];
  const size_t base = static_cast<size_t>(bh) * steps * DH;
  const int q0 = qt * BQ;

  for (int idx = tid; idx < BQ * DH; idx += NT) {
    const int r = idx / DH, d = idx - r * DH;
    const int gq = q0 + r;
    Qs[r * QS + d] = gq < steps ? vap::to_f32(q[base + static_cast<size_t>(gq) * DH + d]) : 0.f;
  }

  float m_i[4], l_i[4], acc[4][CPT];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m_i[a] = -CUDART_INF_F;
    l_i[a] = 0.f;
#pragma unroll
    for (int e = 0; e < CPT; ++e) acc[a][e] = 0.f;
  }

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();  // the previous tile's Ks/Vs/Ps are no longer read
    for (int idx = tid; idx < BKV * DH; idx += NT) {
      const int r = idx / DH, d = idx - r * DH;
      const int gk = k0 + r;
      const bool in = gk < steps;
      const size_t off = base + static_cast<size_t>(gk) * DH + d;
      Ks[r * QS + d] = in ? vap::to_f32(k[off]) : 0.f;
      Vs[r * DH + d] = in ? vap::to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = Qs[(ty + 16 * a) * QS + d];
#pragma unroll
      for (int b = 0; b < 4; ++b) kb[b] = Ks[(tx + 16 * b) * QS + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = q0 + ty + 16 * a;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = k0 + tx + 16 * b;
        const float val = s[a][b] * scale + slope * static_cast<float>(j - i);
        s[a][b] = j <= i ? val : -CUDART_INF_F;
        mx = fmaxf(mx, s[a][b]);
      }
      const float m_new = fmaxf(m_i[a], vap::half_warp_max(mx));
      const float corr = expf(m_i[a] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float p = expf(s[a][b] - m_new);
        rs += p;
        Ps[(ty + 16 * a) * PS + tx + 16 * b] = vap::round_to<T>(p);
      }
      l_i[a] = l_i[a] * corr + vap::half_warp_sum(rs);
      m_i[a] = m_new;
#pragma unroll
      for (int e = 0; e < CPT; ++e) acc[a][e] *= corr;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BKV; ++c) {
      float pa[4], vv[CPT];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = Ps[(ty + 16 * a) * PS + c];
#pragma unroll
      for (int e = 0; e < CPT; ++e) vv[e] = Vs[c * DH + tx + 16 * e];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < CPT; ++e) acc[a][e] = fmaf(pa[a], vv[e], acc[a][e]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i < steps) {
      T* o = out + base + static_cast<size_t>(i) * DH;
#pragma unroll
      for (int e = 0; e < CPT; ++e) o[tx + 16 * e] = vap::from_f32<T>(acc[a][e] / l_i[a]);
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* slopes, void* out, int bh,
           int H, int steps, float scale, cudaStream_t st) {
  auto kern = flash_alibi_kernel<T, DH>;
  constexpr size_t smem = smem_bytes<DH>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((steps + BQ - 1) / BQ, bh);
  kern<<<grid, NT, smem, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                               static_cast<const T*>(v), static_cast<const float*>(slopes),
                               static_cast<T*>(out), H, steps, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: (bh, T, dh) with bh = B*H; slopes: (H,) f32; dh must be 64.
// Returns cudaGetLastError().
extern "C" int vap_flash_alibi(const void* q, const void* k, const void* v, const void* slopes,
                               void* out, int bh, int H, int steps, int dh, float scale,
                               int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  VAP_DISPATCH_DTYPE(dtype, T, {
    if (dh == 64) return launch<T, 64>(q, k, v, slopes, out, bh, H, steps, scale, st);
    return static_cast<int>(cudaErrorInvalidValue);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}
