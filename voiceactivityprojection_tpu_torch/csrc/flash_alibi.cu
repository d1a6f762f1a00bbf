// Causal ALiBi attention with the online softmax. Replaces the TPU kernels
// `_single_block_kernel` (:122, and its schedule variants), `_flash_kernel`
// (:54) and `_flash_offset_kernel` (:590) of
// voiceactivityprojection_tpu/ops/flash_alibi.py, which compute the same
// function for Tq query rows at global offset `off` of a Tk-key timeline
// (off = 0 and Tq = Tk for the first two):
//
//   s_ij = (q_i . k_j) * scale + slope_h * (j - (off + i))   for j <= off + i (else masked)
//   out_i = sum_j softmax_j(s_i)_j v_j
//
// with f32 scores and softmax, the probabilities rounded to v's type before
// the value product (as the TPU kernels do), f32 sums, output in q's type.
//
// One block of 256 threads (16 x 16) per (batch*head, 64-query tile). It
// walks the 64-key tiles from 0 up to the tile that holds the key of the
// tile's last real query row (global row off + q0 + 63, or off + Tq - 1 in
// a ragged last tile): the bound compares global row indices, not tile
// indices, so an offset that is not a multiple of 64 ends the walk on the
// right tile. Per query row the running max m, sum l and a 64 x Dh
// accumulator live in registers: thread (ty, tx) owns score rows ty + 16a
// and columns tx + 16b, and output columns tx + 16e. Row max and row sum
// reduce over the 16 lanes of a half-warp. Tiles are widened to f32 in
// shared memory (rows padded by one float against bank conflicts). Query
// tiles are scheduled last-first, so the blocks with the longest key loops
// start first. Offsets into q/out use Tq and into k/v use Tk, in size_t
// (bh * Tk * Dh passes 2^31 at an hour of audio). `vap_flash_alibi` (K4/K5)
// runs the instantiation whose offset is 0 and Tk = Tq at compile time;
// `vap_flash_alibi_offset` (K10) the one that reads them.
//
// Bound: the roofline is about balanced at T=1000 (250 FLOP per byte of I/O
// in bf16), and on the operations side for context-parallel shards of long
// audio (Tq = 7500 rows over Tk = 30000 keys); this version is bound by its
// arithmetic on the CUDA cores, not the tensor cores.

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

// OFFSET false is K4/K5's instantiation: one timeline (Tk = Tq) and offset 0
// as compile-time facts, so its code is that of the kernel before offsets.
template <typename T, int DH, bool OFFSET>
__global__ void __launch_bounds__(NT) flash_alibi_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ slopes, T* __restrict__ out, int H, int Tq, int Tk_arg,
    int offset_arg, float scale) {
  const int Tk = OFFSET ? Tk_arg : Tq;
  const int q_offset = OFFSET ? offset_arg : 0;
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
  const size_t q_base = static_cast<size_t>(bh) * Tq * DH;
  const size_t kv_base = OFFSET ? static_cast<size_t>(bh) * Tk * DH : q_base;
  const int q0 = qt * BQ;
  // the last key tile: the one that holds the tile's last real query row,
  // in global rows (without an offset, the diagonal tile qt)
  const int kt_last = OFFSET ? min(Tk - 1, q_offset + min(q0 + BQ, Tq) - 1) / BKV : qt;

  for (int idx = tid; idx < BQ * DH; idx += NT) {
    const int r = idx / DH, d = idx - r * DH;
    const int lq = q0 + r;
    Qs[r * QS + d] = lq < Tq ? vap::to_f32(q[q_base + static_cast<size_t>(lq) * DH + d]) : 0.f;
  }

  float m_i[4], l_i[4], acc[4][CPT];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m_i[a] = -CUDART_INF_F;
    l_i[a] = 0.f;
#pragma unroll
    for (int e = 0; e < CPT; ++e) acc[a][e] = 0.f;
  }

  for (int kt = 0; kt <= kt_last; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();  // the previous tile's Ks/Vs/Ps are no longer read
    for (int idx = tid; idx < BKV * DH; idx += NT) {
      const int r = idx / DH, d = idx - r * DH;
      const int gk = k0 + r;
      const bool in = gk < Tk;
      const size_t off = kv_base + static_cast<size_t>(gk) * DH + d;
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
      const int i = q_offset + q0 + ty + 16 * a;  // global query row
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
    const int lq = q0 + ty + 16 * a;
    if (lq < Tq) {
      T* o = out + q_base + static_cast<size_t>(lq) * DH;
#pragma unroll
      for (int e = 0; e < CPT; ++e) o[tx + 16 * e] = vap::from_f32<T>(acc[a][e] / l_i[a]);
    }
  }
}

template <typename T, int DH, bool OFFSET>
int launch(const void* q, const void* k, const void* v, const void* slopes, void* out, int bh,
           int H, int Tq, int Tk, int q_offset, float scale, cudaStream_t st) {
  auto kern = flash_alibi_kernel<T, DH, OFFSET>;
  constexpr size_t smem = smem_bytes<DH>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Tq + BQ - 1) / BQ, bh);
  kern<<<grid, NT, smem, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                               static_cast<const T*>(v), static_cast<const float*>(slopes),
                               static_cast<T*>(out), H, Tq, Tk, q_offset, scale);
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
    if (dh == 64) return launch<T, 64, false>(q, k, v, slopes, out, bh, H, steps, steps, 0, scale, st);
    return static_cast<int>(cudaErrorInvalidValue);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}

// q, out: (bh, Tq, dh); k, v: (bh, Tk, dh): query row i sits at global row
// q_offset + i of the key timeline; 0 <= q_offset and q_offset + Tq <= Tk
// (the wrapper checks). Returns cudaGetLastError().
extern "C" int vap_flash_alibi_offset(const void* q, const void* k, const void* v,
                                      const void* slopes, void* out, int bh, int H, int Tq,
                                      int Tk, int q_offset, int dh, float scale, int dtype,
                                      void* stream) {
  if (q_offset < 0 || Tq < 1 || q_offset + Tq > Tk) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  VAP_DISPATCH_DTYPE(dtype, T, {
    if (dh == 64) return launch<T, 64, true>(q, k, v, slopes, out, bh, H, Tq, Tk, q_offset, scale, st);
    return static_cast<int>(cudaErrorInvalidValue);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}
