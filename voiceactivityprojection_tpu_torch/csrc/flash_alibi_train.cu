// Causal ALiBi attention with in-kernel attention dropout, forward and
// backward. Replaces the TPU kernels of
// voiceactivityprojection_tpu/ops/flash_alibi_train.py: `_fwd_kernel` (:122),
// and `_bwd_fused_kernel` (:366) with `_bwd_dq_kernel` (:242) +
// `_bwd_dkv_kernel` (:297), two TPU schedules of one backward.
//
// Forward, per (batch*head bh, query i), keys j <= i:
//   s_ij = (q_i . k_j) * scale + slope_h * (j - i);  m_i = max_j s_ij
//   l_i = sum_j exp(s_ij - m_i)                 (every visible key, before the mask)
//   out_i = sum_j keep_ij round_T(exp(s_ij - m_i)) v_j / (1 - rate) / l_i
//   lse_i = m_i + log l_i                        (f32)
// keep_ij = lowbias32(bh, i, j, seed) >= rate * 2^32, in uint32 arithmetic
// (the JAX package's `_hash_keep`, bit for bit).
//
// Backward, with W = exp(s - lse), delta = rowsum(dO . out) (computed by the
// caller) and Y = keep . W / (1 - rate):
//   dV_j = sum_i round_T(Y_ij) dO_i
//   dP_ij = dO_i . v_j;  dS_ij = W_ij (keep_ij dP_ij / (1 - rate) - delta_i)
//   dQ_i = scale sum_j round_T(dS_ij) k_j;  dK_j = scale sum_i round_T(dS_ij) q_i
// f32 sums, outputs in the I/O type T (the JAX kernels' rounding points).
//
// The forward, and the float32 backward, run blocks of 256 threads (16 x 16)
// on 64 x 64 tiles: thread (ty, tx) owns rows ty + 16a and columns tx + 16b
// of a score tile and columns tx + 16e of a 64-wide output row, all tiles
// widened to f32 in shared memory (rows padded by one float against bank
// conflicts), products on the CUDA cores.
// - fwd (K6, both dtypes): one block per (bh, 64-query tile), the inference
//   kernel's online softmax (csrc/flash_alibi.cu) plus the mask and lse;
//   query tiles are scheduled last-first (longest key loops first).
// - dkv: one block per (bh, 64-key tile) holding K, V and the dK, dV
//   accumulators; it walks the query tiles from the diagonal down.
// - dq: one block per (bh, 64-query tile) holding Q, dO and dQ; it walks the
//   key tiles up to the diagonal.
// The bfloat16 backward (K7/K8) keeps that split and runs it on the tensor
// cores, in the FlashAttention-3 arrangement (csrc/wgmma.cuh), one
// warpgroup (128 threads) per block:
// - `flash_train_dkv_wgmma_kernel`: K and V resident; per query tile it
//   forms the transposed products S^T = K Q^T and dP^T = V dO^T directly
//   (m64n64k16, keys as the M rows, Q and dO K-major B operands), Y^T and
//   dS^T in the accumulator registers (element (row j, column i): the hash
//   of the global (bh, i, j), lse_i and delta_i of the column from shared
//   memory), then dV += Y^T dO and dK += dS^T Q with Y^T and dS^T rounded
//   to bf16 straight into register A fragments and dO, Q read MN-major.
// - `flash_train_dq_wgmma_kernel`: Q and dO resident; per key tile S = Q K^T,
//   dP = dO V^T, dS in registers (lse and delta of its two rows in
//   registers), dQ += dS K with K read MN-major from the same swizzled tile
//   that served as the K-major operand of S.
// The streamed tiles (Q/dO and the rows' lse/delta in dkv, K/V in dq) go
// through a two-stage cp.async ring, the next tile landing while the
// current one multiplies; rows past `steps` are zero-filled by the copies'
// src-size, and `valid = j <= i && i < steps` keeps a padded query row out
// of dK and dV. Masks are evaluated only on the diagonal tile and a ragged
// last query tile.
// No atomics: the backward is deterministic.
//
// Bound on the card: the forward sits near the ridge at T=1000 and is bound
// by its bytes; the backward's five products over the causal pairs bound it
// by operations. The float32 kernels multiply on the CUDA cores in f32 and
// are bound by their own arithmetic (the f32 path is the port's
// correctness path: TF32 would break its bars); the bfloat16 backward moves
// the five products onto the tensor cores, which leaves the per-score work
// (exponential, mask hash, about ten integer operations) as its floor.

#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

namespace wg = vap::wg;

constexpr int DH = 64;        // head width (model dim 256 / 4 heads)
constexpr int BT = 64;        // rows and keys per tile
constexpr int NT = 256;
constexpr int RS = DH + 1;    // row stride of a 64 x DH tile
constexpr int PS = BT + 1;    // row stride of a 64 x 64 tile
constexpr int TILE = BT * RS;

struct Dropout {
  uint32_t thresh;
  uint32_t seed;
  float inv;  // 1 / (1 - rate), or 1
  int on;
};

__device__ __forceinline__ bool keep(const Dropout& d, uint32_t bh, uint32_t i, uint32_t j) {
  uint32_t x = bh * 0x9E3779B1u + i * 0x85EBCA6Bu + j * 0xC2B2AE35u + d.seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= d.thresh;
}

// rows [r0, r0 + 64) of one (steps x DH) slice into a 64 x RS f32 tile,
// zeros past `steps`
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int r0, int steps) {
  for (int idx = threadIdx.x; idx < BT * DH; idx += NT) {
    const int r = idx / DH, d = idx - r * DH;
    const int g = r0 + r;
    dst[r * RS + d] = g < steps ? vap::to_f32(src[static_cast<size_t>(g) * DH + d]) : 0.f;
  }
}

// per-row f32 statistics of rows [r0, r0 + 64), zeros past `steps`
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int r0, int steps) {
  if (threadIdx.x < BT) {
    const int g = r0 + threadIdx.x;
    dst[threadIdx.x] = g < steps ? src[g] : 0.f;
  }
}

// acc[a][b] = sum_d A[ty + 16a][d] * B[tx + 16b][d]  (A B^T of two 64 x DH tiles)
__device__ __forceinline__ void tile_abt(float acc[4][4], const float* A, const float* B, int ty,
                                         int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = A[(ty + 16 * a) * RS + d];
#pragma unroll
    for (int b = 0; b < 4; ++b) bv[b] = B[(tx + 16 * b) * RS + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) flash_train_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ slopes, T* __restrict__ out, float* __restrict__ lse, int H,
    int steps, float scale, Dropout dr) {
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Ks = Qs + TILE;
  float* Vs = Ks + TILE;
  float* Ps = Vs + TILE;  // BT x PS

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const float slope = slopes[bh % H];
  const size_t base = static_cast<size_t>(bh) * steps * DH;
  const int q0 = qt * BT;

  load_tile(Qs, q + base, q0, steps);
  float m_i[4], l_i[4], acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m_i[a] = -CUDART_INF_F;
    l_i[a] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[a][e] = 0.f;
  }

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the previous tile's Ks/Vs/Ps are no longer read
    load_tile(Ks, k + base, k0, steps);
    load_tile(Vs, v + base, k0, steps);
    __syncthreads();

    float s[4][4];
    tile_abt(s, Qs, Ks, ty, tx);
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
        float p = expf(s[a][b] - m_new);
        rs += p;  // the denominator sums every visible key, dropped or not
        if (dr.on && !keep(dr, bh, i, k0 + tx + 16 * b)) p = 0.f;
        Ps[(ty + 16 * a) * PS + tx + 16 * b] = vap::round_to<T>(p);
      }
      l_i[a] = l_i[a] * corr + vap::half_warp_sum(rs);
      m_i[a] = m_new;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][e] *= corr;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BT; ++c) {
      float pa[4], vv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = Ps[(ty + 16 * a) * PS + c];
#pragma unroll
      for (int e = 0; e < 4; ++e) vv[e] = Vs[c * RS + tx + 16 * e];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][e] = fmaf(pa[a], vv[e], acc[a][e]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i < steps) {
      T* o = out + base + static_cast<size_t>(i) * DH;
#pragma unroll
      for (int e = 0; e < 4; ++e) o[tx + 16 * e] = vap::from_f32<T>(acc[a][e] * dr.inv / l_i[a]);
      if (tx == 0) lse[static_cast<size_t>(bh) * steps + i] = m_i[a] + logf(l_i[a]);
    }
  }
}

// W, and dS = W (keep dP / (1 - rate) - delta), of one 64 x 64 tile (rows q0 +
// ty + 16a, keys k0 + tx + 16b) from the raw products s = Q K^T and dp = dO V^T;
// w and dp are overwritten with Y (the dropped, rescaled W) and dS.
__device__ __forceinline__ void tile_grads(float w[4][4], float dp[4][4], const float* lse_s,
                                           const float* delta_s, int q0, int k0, int steps,
                                           int bh, float slope, float scale, const Dropout& dr,
                                           int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a, i = q0 + r;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = k0 + tx + 16 * b;
      const bool valid = j <= i && i < steps;
      const float wv =
          valid ? expf(w[a][b] * scale + slope * static_cast<float>(j - i) - lse_s[r]) : 0.f;
      float y = wv, dpv = dp[a][b];
      if (dr.on) {
        const bool kp = valid && keep(dr, bh, i, j);
        y = kp ? wv * dr.inv : 0.f;
        dpv = kp ? dpv * dr.inv : 0.f;
      }
      w[a][b] = y;
      dp[a][b] = wv * (dpv - delta_s[r]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) flash_train_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ slopes, T* __restrict__ dk, T* __restrict__ dv, int H, int steps,
    float scale, Dropout dr) {
  extern __shared__ float sm[];
  float* Ks = sm;
  float* Vs = Ks + TILE;
  float* Qs = Vs + TILE;
  float* dOs = Qs + TILE;
  float* Ys = dOs + TILE;    // BT x PS, Y rounded to T
  float* dSs = Ys + BT * PS;  // BT x PS, dS rounded to T
  float* lse_s = dSs + BT * PS;
  float* delta_s = lse_s + BT;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const float slope = slopes[bh % H];
  const size_t base = static_cast<size_t>(bh) * steps * DH;
  const size_t rbase = static_cast<size_t>(bh) * steps;
  const int k0 = kt * BT;
  const int nq = (steps + BT - 1) / BT;

  load_tile(Ks, k + base, k0, steps);
  load_tile(Vs, v + base, k0, steps);
  float dk_acc[4][4], dv_acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[a][e] = dv_acc[a][e] = 0.f;

  for (int qt = kt; qt < nq; ++qt) {
    const int q0 = qt * BT;
    __syncthreads();  // the previous tile's Qs/dOs/Ys/dSs are no longer read
    load_tile(Qs, q + base, q0, steps);
    load_tile(dOs, dout + base, q0, steps);
    load_rows(lse_s, lse + rbase, q0, steps);
    load_rows(delta_s, delta + rbase, q0, steps);
    __syncthreads();

    float w[4][4], dp[4][4];
    tile_abt(w, Qs, Ks, ty, tx);
    tile_abt(dp, dOs, Vs, ty, tx);
    tile_grads(w, dp, lse_s, delta_s, q0, k0, steps, bh, slope, scale, dr, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        Ys[(ty + 16 * a) * PS + tx + 16 * b] = vap::round_to<T>(w[a][b]);
        dSs[(ty + 16 * a) * PS + tx + 16 * b] = vap::round_to<T>(dp[a][b]);
      }
    __syncthreads();

    // dV[j] += sum_i Y[i][j] dO[i];  dK[j] += sum_i dS[i][j] Q[i]  (j = ty + 16a)
#pragma unroll 4
    for (int i = 0; i < BT; ++i) {
      float ya[4], sa[4], dov[4], qv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        ya[a] = Ys[i * PS + ty + 16 * a];
        sa[a] = dSs[i * PS + ty + 16 * a];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dov[e] = dOs[i * RS + tx + 16 * e];
        qv[e] = Qs[i * RS + tx + 16 * e];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dv_acc[a][e] = fmaf(ya[a], dov[e], dv_acc[a][e]);
          dk_acc[a][e] = fmaf(sa[a], qv[e], dk_acc[a][e]);
        }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = k0 + ty + 16 * a;
    if (j < steps) {
      const size_t off = base + static_cast<size_t>(j) * DH;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk[off + tx + 16 * e] = vap::from_f32<T>(scale * dk_acc[a][e]);
        dv[off + tx + 16 * e] = vap::from_f32<T>(dv_acc[a][e]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) flash_train_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ slopes, T* __restrict__ dq, int H, int steps, float scale,
    Dropout dr) {
  extern __shared__ float sm[];
  float* Qs = sm;
  float* dOs = Qs + TILE;
  float* Ks = dOs + TILE;
  float* Vs = Ks + TILE;
  float* dSs = Vs + TILE;  // BT x PS
  float* lse_s = dSs + BT * PS;
  float* delta_s = lse_s + BT;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const float slope = slopes[bh % H];
  const size_t base = static_cast<size_t>(bh) * steps * DH;
  const size_t rbase = static_cast<size_t>(bh) * steps;
  const int q0 = qt * BT;

  load_tile(Qs, q + base, q0, steps);
  load_tile(dOs, dout + base, q0, steps);
  load_rows(lse_s, lse + rbase, q0, steps);
  load_rows(delta_s, delta + rbase, q0, steps);
  float dq_acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[a][e] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the previous tile's Ks/Vs/dSs are no longer read
    load_tile(Ks, k + base, k0, steps);
    load_tile(Vs, v + base, k0, steps);
    __syncthreads();

    float w[4][4], dp[4][4];
    tile_abt(w, Qs, Ks, ty, tx);
    tile_abt(dp, dOs, Vs, ty, tx);
    tile_grads(w, dp, lse_s, delta_s, q0, k0, steps, bh, slope, scale, dr, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) dSs[(ty + 16 * a) * PS + tx + 16 * b] = vap::round_to<T>(dp[a][b]);
    __syncthreads();

    // dQ[i] += sum_j dS[i][j] K[j]  (i = ty + 16a)
#pragma unroll 8
    for (int c = 0; c < BT; ++c) {
      float sa[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) sa[a] = dSs[(ty + 16 * a) * PS + c];
#pragma unroll
      for (int e = 0; e < 4; ++e) kv[e] = Ks[c * RS + tx + 16 * e];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq_acc[a][e] = fmaf(sa[a], kv[e], dq_acc[a][e]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i < steps) {
      T* o = dq + base + static_cast<size_t>(i) * DH;
#pragma unroll
      for (int e = 0; e < 4; ++e) o[tx + 16 * e] = vap::from_f32<T>(scale * dq_acc[a][e]);
    }
  }
}

// ---- bfloat16 backward: the tensor-core kernels ----------------------------
using bf16 = __nv_bfloat16;
// K, V, then two stages of (Q, dO) tiles and of the rows' (lse, delta), plus
// the slack to align to 1024
constexpr int DKV_WG_ROWS = 6 * wg::TILE_BYTES;
constexpr size_t DKV_WG_SMEM = DKV_WG_ROWS + 2 * 2 * BT * sizeof(float) + 1024;
// Q, dO, then two stages of (K, V), plus the slack
constexpr size_t DQ_WG_SMEM = 6 * wg::TILE_BYTES + 1024;

__global__ void __launch_bounds__(wg::NT) flash_train_dkv_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ slopes, bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
    int steps, float scale, Dropout dr) {
  extern __shared__ unsigned char wsm[];
  const uint32_t Ks = wg::align1024(wsm), Vs = Ks + wg::TILE_BYTES;
  // stage st: Q at Ks + (2 + 2 st) tiles, dO right after; the rows' lse at
  // Ks + DKV_WG_ROWS + 512 st bytes, delta 256 bytes further
  const float* rows_s = reinterpret_cast<const float*>(wsm + (Ks + DKV_WG_ROWS - wg::smem_u32(wsm)));

  const int tid = threadIdx.x;
  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const float slope = slopes[bh % H];
  const size_t base = static_cast<size_t>(bh) * steps * DH;
  const size_t rbase = static_cast<size_t>(bh) * steps;
  const int k0 = kt * BT;
  const int nq = (steps + BT - 1) / BT;

  auto load_stage = [&](int qt, int st) {
    const uint32_t Qt = Ks + (2 + 2 * st) * wg::TILE_BYTES;
    wg::load_tile(Qt, q + base, qt * BT, steps, tid);
    wg::load_tile(Qt + wg::TILE_BYTES, dout + base, qt * BT, steps, tid);
    const uint32_t R = Ks + DKV_WG_ROWS + 512 * st;
    wg::load_rows(R, lse + rbase, qt * BT, steps, tid);
    wg::load_rows(R + 256, delta + rbase, qt * BT, steps, tid - BT);
  };
  wg::load_tile(Ks, k + base, k0, steps, tid);
  wg::load_tile(Vs, v + base, k0, steps, tid);
  load_stage(kt, 0);
  wg::cp_async_commit();

  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const int jr0 = wg::acc_row(tid, 0);  // this thread's key rows: jr0 and jr0 + 8

  for (int qt = kt; qt < nq; ++qt) {
    const int st = (qt - kt) & 1;
    const uint32_t Qt = Ks + (2 + 2 * st) * wg::TILE_BYTES, dOt = Qt + wg::TILE_BYTES;
    const float* lse_s = rows_s + 128 * st;
    const float* delta_s = lse_s + BT;
    wg::cp_async_wait<0>();
    wg::fence_proxy_async();
    __syncthreads();  // tile qt is in; every warp is done with the other stage
    if (qt + 1 < nq) load_stage(qt + 1, st ^ 1);
    wg::cp_async_commit();

    float sT[32], dpT[32];  // S^T and dP^T: rows are keys, columns queries
    wg::fence();
    wg::tile_abt(sT, Ks, Qt);
    wg::tile_abt(dpT, Vs, dOt);
    wg::commit();
    wg::wait<0>();
    wg::pin(sT);
    wg::pin(dpT);

    const int q0 = qt * BT;
    const bool masked = qt == kt || q0 + BT > steps;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = wg::acc_col(tid, i);
      const int j = k0 + jr0 + 8 * ((i >> 1) & 1), gi = q0 + c;
      const bool valid = !masked || (j <= gi && gi < steps);
      const float wv =
          valid ? __expf(sT[i] * scale + slope * static_cast<float>(j - gi) - lse_s[c]) : 0.f;
      float y = wv, dpv = dpT[i];
      if (dr.on) {
        const bool kp = valid && keep(dr, bh, gi, j);
        y = kp ? wv * dr.inv : 0.f;
        dpv = kp ? dpv * dr.inv : 0.f;
      }
      sT[i] = y;
      dpT[i] = wv * (dpv - delta_s[c]);
    }
    uint32_t ya[4][4], sa[4][4];
    wg::acc_to_a(sT, ya);  // Y^T and dS^T rounded to bf16
    wg::acc_to_a(dpT, sa);
    wg::pin(ya);
    wg::pin(sa);
    wg::pin(dv_acc);
    wg::pin(dk_acc);
    wg::fence();
    wg::tile_rs(dv_acc, ya, dOt);
    wg::tile_rs(dk_acc, sa, Qt);
    wg::commit();
    wg::wait<0>();
    wg::pin(dv_acc);
    wg::pin(dk_acc);
  }

#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int j = k0 + jr0 + 8 * ((i >> 1) & 1);
    if (j < steps) {
      const size_t off = base + static_cast<size_t>(j) * DH + wg::acc_col(tid, i);
      *reinterpret_cast<__nv_bfloat162*>(dk + off) =
          __floats2bfloat162_rn(scale * dk_acc[i], scale * dk_acc[i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off) = __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

__global__ void __launch_bounds__(wg::NT) flash_train_dq_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ slopes, bf16* __restrict__ dq, int H, int steps, float scale,
    Dropout dr) {
  extern __shared__ unsigned char wsm[];
  const uint32_t Qs = wg::align1024(wsm), dOs = Qs + wg::TILE_BYTES;
  // stage st: K at Qs + (2 + 2 st) tiles, V right after

  const int tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const float slope = slopes[bh % H];
  const size_t base = static_cast<size_t>(bh) * steps * DH;
  const size_t rbase = static_cast<size_t>(bh) * steps;
  const int q0 = qt * BT;

  wg::load_tile(Qs, q + base, q0, steps, tid);
  wg::load_tile(dOs, dout + base, q0, steps, tid);
  wg::load_tile(Qs + 2 * wg::TILE_BYTES, k + base, 0, steps, tid);
  wg::load_tile(Qs + 3 * wg::TILE_BYTES, v + base, 0, steps, tid);
  wg::cp_async_commit();

  const int row0 = wg::acc_row(tid, 0);  // this thread's query rows: row0 and row0 + 8
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = q0 + row0 + 8 * h;
    lse_r[h] = i < steps ? lse[rbase + i] : 0.f;
    delta_r[h] = i < steps ? delta[rbase + i] : 0.f;
  }
  float dq_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const uint32_t Kt = Qs + (2 + 2 * (kt & 1)) * wg::TILE_BYTES, Vt = Kt + wg::TILE_BYTES;
    wg::cp_async_wait<0>();
    wg::fence_proxy_async();
    __syncthreads();  // tile kt is in; every warp is done with the other stage
    if (kt < qt) {
      const uint32_t Kn = Qs + (4 - 2 * (kt & 1)) * wg::TILE_BYTES;
      wg::load_tile(Kn, k + base, (kt + 1) * BT, steps, tid);
      wg::load_tile(Kn + wg::TILE_BYTES, v + base, (kt + 1) * BT, steps, tid);
    }
    wg::cp_async_commit();

    float s[32], dp[32];
    wg::fence();
    wg::tile_abt(s, Qs, Kt);
    wg::tile_abt(dp, dOs, Vt);
    wg::commit();
    wg::wait<0>();
    wg::pin(s);
    wg::pin(dp);

    const int k0 = kt * BT;
    const bool masked = kt == qt || q0 + BT > steps;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const int gi = q0 + row0 + 8 * h, j = k0 + wg::acc_col(tid, i);
      const bool valid = !masked || (j <= gi && gi < steps);
      const float wv =
          valid ? __expf(s[i] * scale + slope * static_cast<float>(j - gi) - lse_r[h]) : 0.f;
      float dpv = dp[i];
      if (dr.on) dpv = valid && keep(dr, bh, gi, j) ? dpv * dr.inv : 0.f;
      s[i] = wv * (dpv - delta_r[h]);  // dS
    }
    uint32_t sa[4][4];
    wg::acc_to_a(s, sa);  // dS rounded to bf16
    wg::pin(sa);
    wg::pin(dq_acc);
    wg::fence();
    wg::tile_rs(dq_acc, sa, Kt);
    wg::commit();
    wg::wait<0>();
    wg::pin(dq_acc);
  }

#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = q0 + row0 + 8 * ((i >> 1) & 1);
    if (r < steps)
      *reinterpret_cast<__nv_bfloat162*>(dq + base + static_cast<size_t>(r) * DH + wg::acc_col(tid, i)) =
          __floats2bfloat162_rn(scale * dq_acc[i], scale * dq_acc[i + 1]);
  }
}

template <typename K>
int allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem)));
}

constexpr size_t FWD_SMEM = (3 * TILE + BT * PS) * sizeof(float);
constexpr size_t DKV_SMEM = (4 * TILE + 2 * BT * PS + 2 * BT) * sizeof(float);
constexpr size_t DQ_SMEM = (4 * TILE + BT * PS + 2 * BT) * sizeof(float);

bool bad_shape(int bh, int steps, int dh) { return dh != DH || bh < 1 || bh > 65535 || steps < 1; }

}  // namespace

// q, k, v, out: (bh, T, 64) with bh = B*H; slopes: (H,) f32; lse: (bh, T) f32.
// Dropout: keep where hash >= thresh when `on`; out scaled by `inv`.
// Returns cudaGetLastError().
extern "C" int vap_flash_train_fwd(const void* q, const void* k, const void* v,
                                   const void* slopes, void* out, void* lse, int bh, int H,
                                   int steps, int dh, float scale, uint32_t thresh, uint32_t seed,
                                   float inv, int on, int dtype, void* stream) {
  if (bad_shape(bh, steps, dh)) return static_cast<int>(cudaErrorInvalidValue);
  const Dropout dr{thresh, seed, inv, on};
  const dim3 grid((steps + BT - 1) / BT, bh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  VAP_DISPATCH_DTYPE(dtype, T, {
    auto kern = flash_train_fwd_kernel<T>;
    if (const int e = allow_smem(kern, FWD_SMEM)) return e;
    kern<<<grid, NT, FWD_SMEM, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                     static_cast<const T*>(v), static_cast<const float*>(slopes),
                                     static_cast<T*>(out), static_cast<float*>(lse), H, steps,
                                     scale, dr);
  });
  return static_cast<int>(cudaGetLastError());
}

// q, k, v, dout, dq, dk, dv: (bh, T, 64); lse, delta: (bh, T) f32; slopes (H,)
// f32. Launches the dK/dV kernel, then the dQ kernel, on `stream`: the
// tensor-core pair for bfloat16 (rows 16-byte aligned, the wrapper checks),
// the CUDA-core pair for float32. Returns cudaGetLastError().
extern "C" int vap_flash_train_bwd(const void* q, const void* k, const void* v, const void* dout,
                                   const void* lse, const void* delta, const void* slopes,
                                   void* dq, void* dk, void* dv, int bh, int H, int steps, int dh,
                                   float scale, uint32_t thresh, uint32_t seed, float inv, int on,
                                   int dtype, void* stream) {
  if (bad_shape(bh, steps, dh)) return static_cast<int>(cudaErrorInvalidValue);
  const Dropout dr{thresh, seed, inv, on};
  const dim3 grid((steps + BT - 1) / BT, bh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(delta);
  const float* sp = static_cast<const float*>(slopes);
  if (dtype == vap::kBF16) {  // the tensor-core kernels
    if (const int e = allow_smem(flash_train_dkv_wgmma_kernel, DKV_WG_SMEM)) return e;
    if (const int e = allow_smem(flash_train_dq_wgmma_kernel, DQ_WG_SMEM)) return e;
    const bf16* qp = static_cast<const bf16*>(q);
    const bf16* kp = static_cast<const bf16*>(k);
    const bf16* vp = static_cast<const bf16*>(v);
    const bf16* dop = static_cast<const bf16*>(dout);
    flash_train_dkv_wgmma_kernel<<<grid, wg::NT, DKV_WG_SMEM, st>>>(
        qp, kp, vp, dop, lp, dp, sp, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, steps, scale,
        dr);
    const int e = static_cast<int>(cudaGetLastError());
    if (e) return e;
    flash_train_dq_wgmma_kernel<<<grid, wg::NT, DQ_WG_SMEM, st>>>(
        qp, kp, vp, dop, lp, dp, sp, static_cast<bf16*>(dq), H, steps, scale, dr);
  } else if (dtype == vap::kF32) {  // the CUDA-core kernels
    auto dkv = flash_train_dkv_kernel<float>;
    auto dqk = flash_train_dq_kernel<float>;
    if (const int e = allow_smem(dkv, DKV_SMEM)) return e;
    if (const int e = allow_smem(dqk, DQ_SMEM)) return e;
    const float* qp = static_cast<const float*>(q);
    const float* kp = static_cast<const float*>(k);
    const float* vp = static_cast<const float*>(v);
    const float* dop = static_cast<const float*>(dout);
    dkv<<<grid, NT, DKV_SMEM, st>>>(qp, kp, vp, dop, lp, dp, sp, static_cast<float*>(dk),
                                     static_cast<float*>(dv), H, steps, scale, dr);
    const int e = static_cast<int>(cudaGetLastError());
    if (e) return e;
    dqk<<<grid, NT, DQ_SMEM, st>>>(qp, kp, vp, dop, lp, dp, sp, static_cast<float*>(dq), H, steps,
                                    scale, dr);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
