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
// Each direction dispatches on the dtype: bfloat16 runs the tensor-core
// kernels; float32 runs them in 3xTF32 (one-pass TF32 would break the
// bars; three products a product, csrc/wgmma.cuh, keep about 2^-22 of
// each term).
//
// Every kernel is instantiated for head widths Dh = 32, 64 and 128 (the
// model's 256 over 8, 4 and 2 heads); the wrapper passes Dh and the entry
// points dispatch on it.
//
// The forward runs one block per (bh, 64-query tile), query tiles
// scheduled last-first (longest key loops first). The backward is two
// kernels:
// - dkv: one block per (bh, 64-key tile) holding the dK, dV accumulators;
//   it walks the query tiles from the diagonal down.
// - dq: one block per (bh, 64-query tile) holding dQ; it walks the key
//   tiles up to the diagonal.
// The bfloat16 kernels keep that split and run it on the tensor cores, in
// the FlashAttention-3 arrangement (csrc/wgmma.cuh), one warpgroup (128
// threads) per block:
// - `flash_train_fwd_wgmma_kernel` (K6): the inference Kernel A
//   (csrc/flash_alibi.cu `flash_alibi_wgmma_kernel`) with the training
//   contract. Per key tile S = Q K^T on `wgmma` (Q resident, K/V through
//   the ring), the ALiBi bias and the causal test on the accumulator's
//   (row, column) map (the test only on the diagonal tile), the online
//   softmax over the quad that holds a row, and O += P V with P rounded
//   from the accumulator into register A fragments. The row sum l adds
//   every visible key's p before the mask; then a dropped p is zeroed
//   (the hash of the global (bh, q0 + row, k0 + column)) before it is
//   rounded. The exponentials are `expf`, not `__expf`: lse goes to the
//   bf16 backward and is held to 5e-6. out = O * inv / l, and lse = m +
//   log l in f32, written once per row by the quad's first lane.
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
// An operand of head width Dh is Dh / 64 swizzled 64 x 64 tiles side by
// side, or at Dh = 32 one tile with zero columns 32 .. 63 (wg::Head): the
// score products run Dh / 16 k-steps, and each output runs one m64n64
// accumulator per 64 columns (at Dh = 32 one, its upper half dropped).
// The streamed tiles (K/V in fwd and dq, Q/dO and the rows' lse/delta in
// dkv) go through a two-stage cp.async ring, the next tile landing while
// the current one multiplies; rows past `steps` are zero-filled by the
// copies' src-size, and `valid = j <= i && i < steps` keeps a padded query
// row out of dK and dV. Masks are evaluated only on the diagonal tile and
// a ragged last query tile.
// The float32 backward (`flash_train_dkv_tf32x3_kernel`,
// `flash_train_dq_tf32x3_kernel`) is the bf16 pair in 3xTF32: S^T = K Q^T
// and dP^T = V dO^T in dkv, S = Q K^T and dP = dO V^T in dq, read K-major
// as they are stored, dP summed a k-step at a time with FADD
// (wgmma.cuh `tile_abt_tf32x3_nearest`: straight in the tensor cores'
// truncating accumulator, dP shrinks and dS = W (dP - delta) loses its
// zero row sums); dV += Y^T dO, dK += dS^T Q and dQ += dS K take their A
// from the split accumulator (in the permuted k-order of wgmma.cuh) and
// dO, Q, K as B operands written transposed. Every tile is split on its
// way from global memory into shared memory, so none goes through
// cp.async; one stage, one block an SM (dkv 193.5 KB and dq 161 KB of
// shared memory at Dh 64 and 128).
// The float32 forward (`flash_train_fwd_tf32x3_kernel`, K6) is the
// inference kernel's 3xTF32 plan (csrc/flash_alibi.cu
// `flash_alibi_tf32x3_kernel`: Q, K, V^T split into tf32 halves on their way
// into shared memory, V^T in the permuted key order, O in the `wgmma`
// accumulator across key tiles, one stage, the next key tile's global reads
// in registers at Dh <= 64) under the bf16 forward's training contract: the
// row sum l adds every visible key's p before the mask, a dropped p is
// zeroed by the hash of its true (bh, q0 + row, k0 + column) from the
// accumulator's map before p is split into the permuted A fragments, out =
// O * inv / l, lse = m + log l written once a row, the exponentials `expf`.
// At Dh <= 64 S is the 3xTF32 product (`tile_abt_tf32x3`) that the float32
// backward recomputes, so W = exp(S - lse) there meets the forward's S; at
// Dh = 128 the forward sums S a k-step at a time to nearest (16 truncating
// k-steps broke its 5e-6 bar at rate 0.5), which the backward's 5e-5 bars
// absorb.
// No atomics: the backward is deterministic.
//
// Bound on the card: the forward sits near the ridge at T=1000 and is bound
// by its bytes; the backward's five products over the causal pairs bound it
// by operations; in float32 both by operations (three TF32 products a
// product at 495 TFLOP/s). Every kernel runs its products on the tensor
// cores, which leaves the per-score work (exponential, mask hash, about ten
// integer operations; in float32 also the split of every operand) as their
// floor.

#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

namespace wg = vap::wg;

constexpr int BT = 64;  // rows and keys per tile

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

// ---- float32: the forward on the tensor cores in 3xTF32 -------------------
// The inference kernel's float32 plan (csrc/flash_alibi.cu
// `flash_alibi_tf32x3_kernel`, its shared memory and registers wg::F32Tiles)
// under the training contract of `flash_train_fwd_wgmma_kernel`. At DH = 128
// S sums each k-step's products in a fresh accumulator with FADD (wgmma.cuh
// tile_abt_tf32x3_nearest): its 16 k-steps straight in the truncating
// accumulator put out 5.0e-6 from its plain version at T=3000, rate 0.5 on
// the H100 (bar 5e-6; the CPU emulation halves the error so); the two
// accumulators fit where the prefetch registers are not used.
template <int DH>
constexpr bool NEAREST_S = DH > wg::TILE;

template <int DH>
__global__ void __launch_bounds__(wg::NT) flash_train_fwd_tf32x3_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ slopes, float* __restrict__ out, float* __restrict__ lse, int H, int steps,
    float scale, Dropout dr) {
  using L = wg::F32Tiles<DH>;
  extern __shared__ unsigned char wsm[];
  const uint32_t Qh = wg::align1024(wsm), Ql = Qh + L::OP, Kh = Ql + L::OP, Kl = Kh + L::OP;
  const uint32_t Vh = Kl + L::OP, Vl = Vh + 2 * L::VPANEL;

  const int tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const float slope = slopes[bh % H];
  const size_t base = static_cast<size_t>(bh) * steps * DH;
  const int q0 = qt * BT;

  if (DH < wg::TILE)  // V^T rows DH .. 63: zeros, the O columns past DH
    for (int p = 0; p < 4; ++p) wg::zero_shared(Vh + p * L::VPANEL + DH * 128, (wg::TILE - DH) * 128, tid);
  wg::load_f32_tile<DH>(q + base, q0, steps, DH, 0, tid,
                        [&](int r, int c, float4 x) { wg::store_kmajor(Qh, Ql, wg::TILE_BYTES, r, c, x); });

  float o[L::OPANELS][32];
#pragma unroll
  for (int p = 0; p < L::OPANELS; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  const int row0 = wg::acc_row(tid, 0);  // this thread's rows: row0 and row0 + 8
  const int gi0 = q0 + row0;

  auto place_k = [&](int r, int c, float4 x) { wg::store_kmajor(Kh, Kl, wg::TILE_BYTES, r, c, x); };
  auto place_v = [&](int r, int c, float4 x) { wg::store_trans(Vh, Vl, L::VPANEL, r, c, x); };
  float4 kn[L::PREFETCH ? DH / 8 : 1], vn[L::PREFETCH ? DH / 8 : 1];  // the next tile's K and V pieces
  if (L::PREFETCH) {
    wg::fetch_f32<DH>(kn, k + base, 0, steps, DH, 0, tid);
    wg::fetch_f32<DH>(vn, v + base, 0, steps, DH, 0, tid);
  }

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // every warp's products of the previous tile have retired
    if (L::PREFETCH) {
      wg::place_f32<DH>(kn, tid, place_k);
      wg::place_f32<DH>(vn, tid, place_v);
    } else {
      wg::load_f32_tile<DH>(k + base, k0, steps, DH, 0, tid, place_k);
      wg::load_f32_tile<DH>(v + base, k0, steps, DH, 0, tid, place_v);
    }
    wg::fence_proxy_async();
    __syncthreads();  // the tiles are in

    float s[32];
    if constexpr (NEAREST_S<DH>) {
      float f[2][32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      wg::tile_abt_tf32x3_nearest<DH>(s, f, Qh, Ql, Kh, Kl);  // fences, commits and waits
    } else {
      wg::fence();
      wg::tile_abt_tf32x3<DH>(s, Qh, Ql, Kh, Kl, 0);
      wg::commit();
      if (L::PREFETCH && kt < qt) {  // the next tile's loads fly while this one multiplies
        wg::fetch_f32<DH>(kn, k + base, k0 + BT, steps, DH, 0, tid);
        wg::fetch_f32<DH>(vn, v + base, k0 + BT, steps, DH, 0, tid);
      }
      wg::wait<0>();
    }
    wg::pin(s);

    const bool masked = kt == qt;  // the diagonal tile: keys past some row
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const int j = k0 + wg::acc_col(tid, i), gi = gi0 + 8 * h;
      float val = s[i] * scale + slope * static_cast<float>(j - gi);
      if (masked && j > gi) val = -CUDART_INF_F;
      s[i] = val;
      mx[h] = fmaxf(mx[h], val);
    }
    float mu[2], corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], wg::quad_max(mx[h]));
      mu[h] = m_new == -CUDART_INF_F ? 0.f : m_new;  // no visible key yet: p = 0, not NaN
      corr[h] = expf(m[h] - mu[h]);
      m[h] = m_new;
      l[h] *= corr[h];  // l is this thread's share of the row sum until the end
    }
    // p at the accumulator's true (row, column): the row sum, then the mask,
    // both before p is split into the permuted A fragments
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      float p = expf(s[i] - mu[h]);
      l[h] += p;  // the denominator sums every visible key, dropped or not
      if (dr.on && !keep(dr, bh, gi0 + 8 * h, k0 + wg::acc_col(tid, i))) p = 0.f;
      s[i] = p;
#pragma unroll
      for (int pn = 0; pn < L::OPANELS; ++pn) o[pn][i] *= corr[h];
    }

    uint32_t ph[8][4], pl[8][4];
    wg::acc_to_tf32x3(s, ph, pl);  // p split, in the permuted key order of V^T
    wg::pin(ph);
    wg::pin(pl);
#pragma unroll
    for (int pn = 0; pn < L::OPANELS; ++pn) wg::pin(o[pn]);
    wg::fence();
#pragma unroll
    for (int pn = 0; pn < L::OPANELS; ++pn)
      wg::tile_rs_tf32x3(o[pn], ph, pl, Vh + pn * wg::TILE_BYTES, Vl + pn * wg::TILE_BYTES, L::VPANEL, 1);
    wg::commit();
    wg::wait<0>();
#pragma unroll
    for (int pn = 0; pn < L::OPANELS; ++pn) wg::pin(o[pn]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = wg::quad_sum(l[h]);
    const int i = gi0 + 8 * h;
    if ((tid & 3) == 0 && i < steps) lse[static_cast<size_t>(bh) * steps + i] = m[h] + logf(l[h]);
  }
#pragma unroll
  for (int pn = 0; pn < L::OPANELS; ++pn)
#pragma unroll
    for (int i = 0; i < L::OUT_ELEMS; i += 2) {
      const int h = (i >> 1) & 1;
      const int r = gi0 + 8 * h;
      if (r < steps)
        *reinterpret_cast<float2*>(out + base + static_cast<size_t>(r) * DH + pn * wg::TILE + wg::acc_col(tid, i)) =
            make_float2(o[pn][i] * dr.inv / l[h], o[pn][i + 1] * dr.inv / l[h]);
    }
}

// ---- bfloat16: the tensor-core kernels ------------------------------------
using bf16 = __nv_bfloat16;

template <int DH>
__global__ void __launch_bounds__(wg::NT) flash_train_fwd_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ slopes, bf16* __restrict__ out, float* __restrict__ lse, int H,
    int steps, float scale, Dropout dr) {
  using HD = wg::Head<DH>;
  constexpr uint32_t HB = HD::BYTES;
  extern __shared__ unsigned char wsm[];
  const uint32_t Qs = wg::align1024(wsm);
  // stage st: K at Qs + (1 + 2 st) operands, its V right after

  const int tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const float slope = slopes[bh % H];
  const size_t base = static_cast<size_t>(bh) * steps * DH;
  const int q0 = qt * BT;

  wg::load_head<DH>(Qs, q + base, q0, steps, tid);
  wg::load_head<DH>(Qs + HB, k + base, 0, steps, tid);
  wg::load_head<DH>(Qs + 2 * HB, v + base, 0, steps, tid);
  wg::cp_async_commit();

  float o[HD::PANELS][32];
#pragma unroll
  for (int p = 0; p < HD::PANELS; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  const int row0 = wg::acc_row(tid, 0);  // this thread's rows: row0 and row0 + 8
  const int gi0 = q0 + row0;

  for (int kt = 0; kt <= qt; ++kt) {
    const uint32_t Kt = Qs + (1 + 2 * (kt & 1)) * HB, Vt = Kt + HB;
    wg::cp_async_wait<0>();
    wg::fence_proxy_async();
    __syncthreads();  // tile kt is in; every warp is done with the other stage
    if (kt < qt) {
      const uint32_t Kn = Qs + (3 - 2 * (kt & 1)) * HB;
      wg::load_head<DH>(Kn, k + base, (kt + 1) * BT, steps, tid);
      wg::load_head<DH>(Kn + HB, v + base, (kt + 1) * BT, steps, tid);
    }
    wg::cp_async_commit();

    float s[32];
    wg::fence();
    wg::tile_abt<DH>(s, Qs, Kt);
    wg::commit();
    wg::wait<0>();
    wg::pin(s);

    const int k0 = kt * BT;
    const bool masked = kt == qt;  // the diagonal tile: keys past some row
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const int j = k0 + wg::acc_col(tid, i), gi = gi0 + 8 * h;
      float val = s[i] * scale + slope * static_cast<float>(j - gi);
      if (masked && j > gi) val = -CUDART_INF_F;
      s[i] = val;
      mx[h] = fmaxf(mx[h], val);
    }
    float mu[2], corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], wg::quad_max(mx[h]));
      mu[h] = m_new == -CUDART_INF_F ? 0.f : m_new;  // no visible key yet: p = 0, not NaN
      corr[h] = expf(m[h] - mu[h]);
      m[h] = m_new;
      l[h] *= corr[h];  // l is this thread's share of the row sum until the end
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      float p = expf(s[i] - mu[h]);
      l[h] += p;  // the denominator sums every visible key, dropped or not
      if (dr.on && !keep(dr, bh, gi0 + 8 * h, k0 + wg::acc_col(tid, i))) p = 0.f;
      s[i] = p;
#pragma unroll
      for (int pn = 0; pn < HD::PANELS; ++pn) o[pn][i] *= corr[h];
    }

    uint32_t pa[4][4];
    wg::acc_to_a(s, pa);  // p rounded to bf16 before the value product
    wg::pin(pa);
#pragma unroll
    for (int pn = 0; pn < HD::PANELS; ++pn) wg::pin(o[pn]);
    wg::fence();
#pragma unroll
    for (int pn = 0; pn < HD::PANELS; ++pn) wg::tile_rs(o[pn], pa, Vt + pn * wg::TILE_BYTES);
    wg::commit();
    wg::wait<0>();
#pragma unroll
    for (int pn = 0; pn < HD::PANELS; ++pn) wg::pin(o[pn]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = wg::quad_sum(l[h]);
    const int i = gi0 + 8 * h;
    if ((tid & 3) == 0 && i < steps) lse[static_cast<size_t>(bh) * steps + i] = m[h] + logf(l[h]);
  }
#pragma unroll
  for (int pn = 0; pn < HD::PANELS; ++pn)
#pragma unroll
    for (int i = 0; i < HD::OUT_ELEMS; i += 2) {
      const int h = (i >> 1) & 1;
      const int r = gi0 + 8 * h;
      if (r < steps)
        *reinterpret_cast<__nv_bfloat162*>(out + base + static_cast<size_t>(r) * DH + pn * wg::TILE +
                                           wg::acc_col(tid, i)) =
            __floats2bfloat162_rn(o[pn][i] * dr.inv / l[h], o[pn][i + 1] * dr.inv / l[h]);
    }
}

// shared memory of the tensor-core kernels, each with the slack to align to
// 1024. fwd: Q, then the ring's two stages of (K, V). dkv: K, V, then two
// stages of (Q, dO) operands (`dkv_rows` bytes in all) and of the rows'
// (lse, delta). dq: Q, dO, then two stages of (K, V).
template <int DH>
constexpr size_t fwd_wg_smem() {
  return 5 * wg::Head<DH>::BYTES + 1024;
}
template <int DH>
__host__ __device__ constexpr uint32_t dkv_rows() {
  return 6 * wg::Head<DH>::BYTES;
}
template <int DH>
constexpr size_t dkv_wg_smem() {
  return dkv_rows<DH>() + 2 * 2 * BT * sizeof(float) + 1024;
}
template <int DH>
constexpr size_t dq_wg_smem() {
  return 6 * wg::Head<DH>::BYTES + 1024;
}

template <int DH>
__global__ void __launch_bounds__(wg::NT) flash_train_dkv_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ slopes, bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
    int steps, float scale, Dropout dr) {
  using HD = wg::Head<DH>;
  constexpr uint32_t HB = HD::BYTES;
  extern __shared__ unsigned char wsm[];
  const uint32_t Ks = wg::align1024(wsm), Vs = Ks + HB;
  // stage st: Q at Ks + (2 + 2 st) operands, dO right after; the rows' lse
  // at Ks + dkv_rows + 512 st bytes, delta 256 bytes further
  const float* rows_s = reinterpret_cast<const float*>(wsm + (Ks + dkv_rows<DH>() - wg::smem_u32(wsm)));

  const int tid = threadIdx.x;
  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const float slope = slopes[bh % H];
  const size_t base = static_cast<size_t>(bh) * steps * DH;
  const size_t rbase = static_cast<size_t>(bh) * steps;
  const int k0 = kt * BT;
  const int nq = (steps + BT - 1) / BT;

  auto load_stage = [&](int qt, int st) {
    const uint32_t Qt = Ks + (2 + 2 * st) * HB;
    wg::load_head<DH>(Qt, q + base, qt * BT, steps, tid);
    wg::load_head<DH>(Qt + HB, dout + base, qt * BT, steps, tid);
    const uint32_t R = Ks + dkv_rows<DH>() + 512 * st;
    wg::load_rows(R, lse + rbase, qt * BT, steps, tid);
    wg::load_rows(R + 256, delta + rbase, qt * BT, steps, tid - BT);
  };
  wg::load_head<DH>(Ks, k + base, k0, steps, tid);
  wg::load_head<DH>(Vs, v + base, k0, steps, tid);
  load_stage(kt, 0);
  wg::cp_async_commit();

  float dk_acc[HD::PANELS][32], dv_acc[HD::PANELS][32];
#pragma unroll
  for (int p = 0; p < HD::PANELS; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[p][i] = dv_acc[p][i] = 0.f;
  const int jr0 = wg::acc_row(tid, 0);  // this thread's key rows: jr0 and jr0 + 8

  for (int qt = kt; qt < nq; ++qt) {
    const int st = (qt - kt) & 1;
    const uint32_t Qt = Ks + (2 + 2 * st) * HB, dOt = Qt + HB;
    const float* lse_s = rows_s + 128 * st;
    const float* delta_s = lse_s + BT;
    wg::cp_async_wait<0>();
    wg::fence_proxy_async();
    __syncthreads();  // tile qt is in; every warp is done with the other stage
    if (qt + 1 < nq) load_stage(qt + 1, st ^ 1);
    wg::cp_async_commit();

    float sT[32], dpT[32];  // S^T and dP^T: rows are keys, columns queries
    wg::fence();
    wg::tile_abt<DH>(sT, Ks, Qt);
    wg::tile_abt<DH>(dpT, Vs, dOt);
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
#pragma unroll
    for (int pn = 0; pn < HD::PANELS; ++pn) {
      wg::pin(dv_acc[pn]);
      wg::pin(dk_acc[pn]);
    }
    wg::fence();
#pragma unroll
    for (int pn = 0; pn < HD::PANELS; ++pn) {
      wg::tile_rs(dv_acc[pn], ya, dOt + pn * wg::TILE_BYTES);
      wg::tile_rs(dk_acc[pn], sa, Qt + pn * wg::TILE_BYTES);
    }
    wg::commit();
    wg::wait<0>();
#pragma unroll
    for (int pn = 0; pn < HD::PANELS; ++pn) {
      wg::pin(dv_acc[pn]);
      wg::pin(dk_acc[pn]);
    }
  }

#pragma unroll
  for (int pn = 0; pn < HD::PANELS; ++pn)
#pragma unroll
    for (int i = 0; i < HD::OUT_ELEMS; i += 2) {
      const int j = k0 + jr0 + 8 * ((i >> 1) & 1);
      if (j < steps) {
        const size_t off = base + static_cast<size_t>(j) * DH + pn * wg::TILE + wg::acc_col(tid, i);
        *reinterpret_cast<__nv_bfloat162*>(dk + off) =
            __floats2bfloat162_rn(scale * dk_acc[pn][i], scale * dk_acc[pn][i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + off) = __floats2bfloat162_rn(dv_acc[pn][i], dv_acc[pn][i + 1]);
      }
    }
}

template <int DH>
__global__ void __launch_bounds__(wg::NT) flash_train_dq_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ slopes, bf16* __restrict__ dq, int H, int steps, float scale,
    Dropout dr) {
  using HD = wg::Head<DH>;
  constexpr uint32_t HB = HD::BYTES;
  extern __shared__ unsigned char wsm[];
  const uint32_t Qs = wg::align1024(wsm), dOs = Qs + HB;
  // stage st: K at Qs + (2 + 2 st) operands, V right after

  const int tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const float slope = slopes[bh % H];
  const size_t base = static_cast<size_t>(bh) * steps * DH;
  const size_t rbase = static_cast<size_t>(bh) * steps;
  const int q0 = qt * BT;

  wg::load_head<DH>(Qs, q + base, q0, steps, tid);
  wg::load_head<DH>(dOs, dout + base, q0, steps, tid);
  wg::load_head<DH>(Qs + 2 * HB, k + base, 0, steps, tid);
  wg::load_head<DH>(Qs + 3 * HB, v + base, 0, steps, tid);
  wg::cp_async_commit();

  const int row0 = wg::acc_row(tid, 0);  // this thread's query rows: row0 and row0 + 8
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = q0 + row0 + 8 * h;
    lse_r[h] = i < steps ? lse[rbase + i] : 0.f;
    delta_r[h] = i < steps ? delta[rbase + i] : 0.f;
  }
  float dq_acc[HD::PANELS][32];
#pragma unroll
  for (int p = 0; p < HD::PANELS; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[p][i] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const uint32_t Kt = Qs + (2 + 2 * (kt & 1)) * HB, Vt = Kt + HB;
    wg::cp_async_wait<0>();
    wg::fence_proxy_async();
    __syncthreads();  // tile kt is in; every warp is done with the other stage
    if (kt < qt) {
      const uint32_t Kn = Qs + (4 - 2 * (kt & 1)) * HB;
      wg::load_head<DH>(Kn, k + base, (kt + 1) * BT, steps, tid);
      wg::load_head<DH>(Kn + HB, v + base, (kt + 1) * BT, steps, tid);
    }
    wg::cp_async_commit();

    float s[32], dp[32];
    wg::fence();
    wg::tile_abt<DH>(s, Qs, Kt);
    wg::tile_abt<DH>(dp, dOs, Vt);
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
#pragma unroll
    for (int pn = 0; pn < HD::PANELS; ++pn) wg::pin(dq_acc[pn]);
    wg::fence();
#pragma unroll
    for (int pn = 0; pn < HD::PANELS; ++pn) wg::tile_rs(dq_acc[pn], sa, Kt + pn * wg::TILE_BYTES);
    wg::commit();
    wg::wait<0>();
#pragma unroll
    for (int pn = 0; pn < HD::PANELS; ++pn) wg::pin(dq_acc[pn]);
  }

#pragma unroll
  for (int pn = 0; pn < HD::PANELS; ++pn)
#pragma unroll
    for (int i = 0; i < HD::OUT_ELEMS; i += 2) {
      const int r = q0 + row0 + 8 * ((i >> 1) & 1);
      if (r < steps)
        *reinterpret_cast<__nv_bfloat162*>(dq + base + static_cast<size_t>(r) * DH + pn * wg::TILE +
                                           wg::acc_col(tid, i)) =
            __floats2bfloat162_rn(scale * dq_acc[pn][i], scale * dq_acc[pn][i + 1]);
    }
}

// ---- float32: the backward on the tensor cores in 3xTF32 -------------------
// Both kernels contract S and dP over the head dimension in CH-wide chunks
// (CH = min(DH, 64): one chunk at DH <= 64, two at 128), each chunk of an
// operand K-major in shared memory (64 x CH, CH / 32 panels of 8 KB, hi and
// lo). A block makes one 64-column panel of its outputs (blockIdx.z: one,
// or two at DH = 128, each block recomputing S and dP), whose B operand is
// transposed (64 rows: the panel's head columns, zeros past DH = 32; x 64
// contraction columns in two 32-column panels of 8 KB; hi and lo), so the
// registers a thread needs are those of DH = 64 at every width. Each
// output takes its product with one tile in a fresh accumulator, added to
// the running sum with FFMA: a running sum fed straight by `wgmma` keeps its
// truncation errors, up to 3 x 8 a tile, and over 16 query tiles dV lands
// 4.7e-5 from its plain version on a 5e-5 bar, the fresh sums 5.5e-6
// (tests/test_torch_flash_tf32x3.py).
template <int DH>
struct BwdTiles {
  static constexpr int CH = DH < wg::TILE ? DH : wg::TILE;  // head columns a chunk and an output panel
  static constexpr int CHUNKS = DH / CH;
  static constexpr int PANELS = CHUNKS;
  static constexpr uint32_t OP = CH * 256;                // one half of a 64 x CH K-major chunk
  static constexpr uint32_t TR = 2 * wg::TILE_BYTES;      // one half of a transposed operand
  static constexpr int OUT_ELEMS = DH < wg::TILE ? 16 : 32;
  // dkv: K, V, Q, dO chunks, Q^T and dO^T, the rows' lse and delta; dq: Q,
  // dO, K, V chunks and K^T; each with the slack to align to 1024
  static constexpr size_t DKV_SMEM = 8 * OP + 4 * TR + 2 * BT * sizeof(float) + 1024;
  static constexpr size_t DQ_SMEM = 8 * OP + 2 * TR + 1024;
};

// zeros in rows DH .. 63 of `halves` transposed halves from `t` (DH = 32)
template <int DH>
__device__ __forceinline__ void zero_pad_rows(uint32_t t, int halves, int tid) {
  if (DH < wg::TILE)
    for (int p = 0; p < 2 * halves; ++p) wg::zero_shared(t + p * wg::TILE_BYTES + DH * 128, (wg::TILE - DH) * 128, tid);
}

template <int DH>
__global__ void __launch_bounds__(wg::NT) flash_train_dkv_tf32x3_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ slopes, float* __restrict__ dk, float* __restrict__ dv, int H, int steps,
    float scale, Dropout dr) {
  using L = BwdTiles<DH>;
  constexpr int CH = L::CH;
  extern __shared__ unsigned char wsm[];
  const uint32_t Kh = wg::align1024(wsm), Kl = Kh + L::OP, Vh = Kl + L::OP, Vl = Vh + L::OP;
  const uint32_t Qh = Vl + L::OP, Ql = Qh + L::OP, Oh = Ql + L::OP, Ol = Oh + L::OP;  // Q and dO
  const uint32_t Qth = Ol + L::OP, Qtl = Qth + L::TR, Oth = Qtl + L::TR, Otl = Oth + L::TR;
  float* lse_s = reinterpret_cast<float*>(wsm + (Otl + L::TR - wg::smem_u32(wsm)));
  float* delta_s = lse_s + BT;

  const int tid = threadIdx.x;
  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const int pn = blockIdx.z;  // the output panel: head columns CH pn ..
  const float slope = slopes[bh % H];
  const size_t base = static_cast<size_t>(bh) * steps * DH;
  const size_t rbase = static_cast<size_t>(bh) * steps;
  const int k0 = kt * BT;
  const int nq = (steps + BT - 1) / BT;

  auto load_kv = [&](int c) {
    wg::load_f32_tile<CH>(k + base, k0, steps, DH, c * CH, tid,
                          [&](int r, int cc, float4 x) { wg::store_kmajor(Kh, Kl, wg::TILE_BYTES, r, cc, x); });
    wg::load_f32_tile<CH>(v + base, k0, steps, DH, c * CH, tid,
                          [&](int r, int cc, float4 x) { wg::store_kmajor(Vh, Vl, wg::TILE_BYTES, r, cc, x); });
  };
  // chunk c of the query tile's Q and dO, and from the output panel's chunk
  // their transposes
  auto load_qdo = [&](int q0, int c) {
    const bool panel = c == pn;
    wg::load_f32_tile<CH>(q + base, q0, steps, DH, c * CH, tid, [&](int r, int cc, float4 x) {
      wg::store_kmajor(Qh, Ql, wg::TILE_BYTES, r, cc, x);
      if (panel) wg::store_trans(Qth, Qtl, wg::TILE_BYTES, r, cc, x);
    });
    wg::load_f32_tile<CH>(dout + base, q0, steps, DH, c * CH, tid, [&](int r, int cc, float4 x) {
      wg::store_kmajor(Oh, Ol, wg::TILE_BYTES, r, cc, x);
      if (panel) wg::store_trans(Oth, Otl, wg::TILE_BYTES, r, cc, x);
    });
  };
  zero_pad_rows<DH>(Qth, 4, tid);
  if (L::CHUNKS == 1) load_kv(0);

  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const int jr0 = wg::acc_row(tid, 0);  // this thread's key rows: jr0 and jr0 + 8

  for (int qt = kt; qt < nq; ++qt) {
    const int q0 = qt * BT;
    float sT[32], dpT[32], f[2][32];  // S^T and dP^T: rows are keys, columns queries
#pragma unroll
    for (int i = 0; i < 32; ++i) dpT[i] = 0.f;
#pragma unroll
    for (int c = 0; c < L::CHUNKS; ++c) {
      __syncthreads();  // every warp's products that read these tiles have retired
      if (L::CHUNKS > 1) load_kv(c);
      load_qdo(q0, c);
      if (c == 0) {
        const int g = q0 + (tid & (BT - 1));
        (tid < BT ? lse_s : delta_s)[tid & (BT - 1)] = g < steps ? (tid < BT ? lse : delta)[rbase + g] : 0.f;
      }
      wg::fence_proxy_async();
      __syncthreads();  // the tiles are in
      wg::fence();
      wg::tile_abt_tf32x3<CH>(sT, Kh, Kl, Qh, Ql, c);
      wg::commit();
      wg::tile_abt_tf32x3_nearest<CH>(dpT, f, Vh, Vl, Oh, Ol);  // waits for S^T too
      wg::pin(sT);
      wg::pin(dpT);
    }

    const bool masked = qt == kt || q0 + BT > steps;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = wg::acc_col(tid, i);
      const int j = k0 + jr0 + 8 * ((i >> 1) & 1), gi = q0 + c;
      const bool valid = !masked || (j <= gi && gi < steps);
      const float wv = valid ? expf(sT[i] * scale + slope * static_cast<float>(j - gi) - lse_s[c]) : 0.f;
      float y = wv, dpv = dpT[i];
      if (dr.on) {
        const bool kp = valid && keep(dr, bh, gi, j);
        y = kp ? wv * dr.inv : 0.f;
        dpv = kp ? dpv * dr.inv : 0.f;
      }
      sT[i] = y;
      dpT[i] = wv * (dpv - delta_s[c]);
    }

    // dV += Y^T dO and dK += dS^T Q over this query tile, each in a fresh
    // accumulator
    float fresh[32];
    uint32_t ah[8][4], al[8][4];
    wg::acc_to_tf32x3(sT, ah, al);
    wg::pin(ah);
    wg::pin(al);
    wg::fence();
    wg::tile_rs_tf32x3(fresh, ah, al, Oth, Otl, wg::TILE_BYTES, 0);
    wg::commit();
    wg::wait<0>();
    wg::pin(fresh);
#pragma unroll
    for (int i = 0; i < 32; ++i) dv_acc[i] += fresh[i];
    wg::pin(dpT);  // dS^T is split only now, not while dV's products are in flight
    wg::acc_to_tf32x3(dpT, ah, al);
    wg::pin(ah);
    wg::pin(al);
    wg::fence();
    wg::tile_rs_tf32x3(fresh, ah, al, Qth, Qtl, wg::TILE_BYTES, 0);
    wg::commit();
    wg::wait<0>();
    wg::pin(fresh);
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[i] += fresh[i];
  }

#pragma unroll
  for (int i = 0; i < L::OUT_ELEMS; i += 2) {
    const int j = k0 + jr0 + 8 * ((i >> 1) & 1);
    if (j < steps) {
      const size_t off = base + static_cast<size_t>(j) * DH + pn * CH + wg::acc_col(tid, i);
      *reinterpret_cast<float2*>(dk + off) = make_float2(scale * dk_acc[i], scale * dk_acc[i + 1]);
      *reinterpret_cast<float2*>(dv + off) = make_float2(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(wg::NT) flash_train_dq_tf32x3_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ slopes, float* __restrict__ dq, int H, int steps, float scale, Dropout dr) {
  using L = BwdTiles<DH>;
  constexpr int CH = L::CH;
  extern __shared__ unsigned char wsm[];
  const uint32_t Qh = wg::align1024(wsm), Ql = Qh + L::OP, Oh = Ql + L::OP, Ol = Oh + L::OP;  // Q and dO
  const uint32_t Kh = Ol + L::OP, Kl = Kh + L::OP, Vh = Kl + L::OP, Vl = Vh + L::OP;
  const uint32_t Kth = Vl + L::OP, Ktl = Kth + L::TR;

  const int tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int pn = blockIdx.z;  // the output panel: head columns CH pn ..
  const float slope = slopes[bh % H];
  const size_t base = static_cast<size_t>(bh) * steps * DH;
  const size_t rbase = static_cast<size_t>(bh) * steps;
  const int q0 = qt * BT;

  auto load_qdo = [&](int c) {
    wg::load_f32_tile<CH>(q + base, q0, steps, DH, c * CH, tid,
                          [&](int r, int cc, float4 x) { wg::store_kmajor(Qh, Ql, wg::TILE_BYTES, r, cc, x); });
    wg::load_f32_tile<CH>(dout + base, q0, steps, DH, c * CH, tid,
                          [&](int r, int cc, float4 x) { wg::store_kmajor(Oh, Ol, wg::TILE_BYTES, r, cc, x); });
  };
  // chunk c of key tile k0's K and V, and from the output panel's chunk K^T
  auto load_kv = [&](int k0, int c) {
    const bool panel = c == pn;
    wg::load_f32_tile<CH>(k + base, k0, steps, DH, c * CH, tid, [&](int r, int cc, float4 x) {
      wg::store_kmajor(Kh, Kl, wg::TILE_BYTES, r, cc, x);
      if (panel) wg::store_trans(Kth, Ktl, wg::TILE_BYTES, r, cc, x);
    });
    wg::load_f32_tile<CH>(v + base, k0, steps, DH, c * CH, tid,
                          [&](int r, int cc, float4 x) { wg::store_kmajor(Vh, Vl, wg::TILE_BYTES, r, cc, x); });
  };
  zero_pad_rows<DH>(Kth, 2, tid);
  if (L::CHUNKS == 1) load_qdo(0);

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
    const int k0 = kt * BT;
    float s[32], dp[32], f[2][32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = 0.f;
#pragma unroll
    for (int c = 0; c < L::CHUNKS; ++c) {
      __syncthreads();  // every warp's products that read these tiles have retired
      if (L::CHUNKS > 1) load_qdo(c);
      load_kv(k0, c);
      wg::fence_proxy_async();
      __syncthreads();  // the tiles are in
      wg::fence();
      wg::tile_abt_tf32x3<CH>(s, Qh, Ql, Kh, Kl, c);
      wg::commit();
      wg::tile_abt_tf32x3_nearest<CH>(dp, f, Oh, Ol, Vh, Vl);  // waits for S too
      wg::pin(s);
      wg::pin(dp);
    }

    const bool masked = kt == qt || q0 + BT > steps;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const int gi = q0 + row0 + 8 * h, j = k0 + wg::acc_col(tid, i);
      const bool valid = !masked || (j <= gi && gi < steps);
      const float wv = valid ? expf(s[i] * scale + slope * static_cast<float>(j - gi) - lse_r[h]) : 0.f;
      float dpv = dp[i];
      if (dr.on) dpv = valid && keep(dr, bh, gi, j) ? dpv * dr.inv : 0.f;
      s[i] = wv * (dpv - delta_r[h]);  // dS
    }

    // dQ += dS K over this key tile, in a fresh accumulator
    float fresh[32];
    uint32_t ah[8][4], al[8][4];
    wg::acc_to_tf32x3(s, ah, al);
    wg::pin(ah);
    wg::pin(al);
    wg::fence();
    wg::tile_rs_tf32x3(fresh, ah, al, Kth, Ktl, wg::TILE_BYTES, 0);
    wg::commit();
    wg::wait<0>();
    wg::pin(fresh);
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[i] += fresh[i];
  }

#pragma unroll
  for (int i = 0; i < L::OUT_ELEMS; i += 2) {
    const int r = q0 + row0 + 8 * ((i >> 1) & 1);
    if (r < steps)
      *reinterpret_cast<float2*>(dq + base + static_cast<size_t>(r) * DH + pn * CH + wg::acc_col(tid, i)) =
          make_float2(scale * dq_acc[i], scale * dq_acc[i + 1]);
  }
}

template <typename K>
int allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem)));
}

template <int DH>
int train_fwd(const void* q, const void* k, const void* v, const float* slopes, void* out, float* lse,
              int bh, int H, int steps, float scale, const Dropout& dr, int dtype, cudaStream_t st) {
  const dim3 grid((steps + BT - 1) / BT, bh);
  if (dtype == vap::kBF16) {  // the tensor-core kernel
    auto kern = flash_train_fwd_wgmma_kernel<DH>;
    if (const int e = allow_smem(kern, fwd_wg_smem<DH>())) return e;
    kern<<<grid, wg::NT, fwd_wg_smem<DH>(), st>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                                  static_cast<const bf16*>(v), slopes, static_cast<bf16*>(out),
                                                  lse, H, steps, scale, dr);
  } else if (dtype == vap::kF32) {  // the 3xTF32 tensor-core kernel
    auto kern = flash_train_fwd_tf32x3_kernel<DH>;
    if (const int e = allow_smem(kern, wg::F32Tiles<DH>::SMEM)) return e;
    kern<<<grid, wg::NT, wg::F32Tiles<DH>::SMEM, st>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                                   static_cast<const float*>(v), slopes, static_cast<float*>(out),
                                                   lse, H, steps, scale, dr);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename DKV, typename DQ>
int launch_bwd_pair(DKV dkv, DQ dqk, int panels, size_t dkv_sm, size_t dq_sm, const void* q, const void* k,
                    const void* v, const void* dout, const float* lse, const float* delta,
                    const float* slopes, void* dq, void* dk, void* dv, int bh, int H, int steps,
                    float scale, const Dropout& dr, cudaStream_t st) {
  if (const int e = allow_smem(dkv, dkv_sm)) return e;
  if (const int e = allow_smem(dqk, dq_sm)) return e;
  const dim3 grid((steps + BT - 1) / BT, bh, panels);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  dkv<<<grid, wg::NT, dkv_sm, st>>>(qp, kp, vp, dop, lse, delta, slopes, static_cast<T*>(dk), static_cast<T*>(dv),
                                H, steps, scale, dr);
  const int e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  dqk<<<grid, wg::NT, dq_sm, st>>>(qp, kp, vp, dop, lse, delta, slopes, static_cast<T*>(dq), H, steps, scale, dr);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int train_bwd(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, const float* slopes, void* dq, void* dk, void* dv, int bh, int H,
              int steps, float scale, const Dropout& dr, int dtype, cudaStream_t st) {
  if (dtype == vap::kBF16)  // the tensor-core kernels
    return launch_bwd_pair<bf16>(flash_train_dkv_wgmma_kernel<DH>, flash_train_dq_wgmma_kernel<DH>, 1,
                                 dkv_wg_smem<DH>(), dq_wg_smem<DH>(), q, k, v, dout, lse, delta, slopes, dq,
                                 dk, dv, bh, H, steps, scale, dr, st);
  if (dtype == vap::kF32)  // the 3xTF32 tensor-core kernels, one block an output panel
    return launch_bwd_pair<float>(flash_train_dkv_tf32x3_kernel<DH>, flash_train_dq_tf32x3_kernel<DH>,
                                  BwdTiles<DH>::PANELS, BwdTiles<DH>::DKV_SMEM, BwdTiles<DH>::DQ_SMEM, q, k, v,
                                  dout, lse, delta, slopes, dq, dk, dv, bh, H, steps, scale, dr, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool bad_shape(int bh, int steps) { return bh < 1 || bh > 65535 || steps < 1; }

}  // namespace

// q, k, v, out: (bh, T, dh) with bh = B*H and dh 32, 64 or 128; slopes: (H,)
// f32; lse: (bh, T) f32. Dropout: keep where hash >= thresh when `on`; out
// scaled by `inv`. The tensor-core kernel for bfloat16, the 3xTF32
// tensor-core kernel for float32 (both read 16-byte pieces: rows 16-byte
// aligned, the wrapper checks). Returns cudaGetLastError().
extern "C" int vap_flash_train_fwd(const void* q, const void* k, const void* v,
                                   const void* slopes, void* out, void* lse, int bh, int H,
                                   int steps, int dh, float scale, uint32_t thresh, uint32_t seed,
                                   float inv, int on, int dtype, void* stream) {
  if (bad_shape(bh, steps)) return static_cast<int>(cudaErrorInvalidValue);
  const Dropout dr{thresh, seed, inv, on};
  const float* sp = static_cast<const float*>(slopes);
  float* lp = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return train_fwd<32>(q, k, v, sp, out, lp, bh, H, steps, scale, dr, dtype, st);
    case 64: return train_fwd<64>(q, k, v, sp, out, lp, bh, H, steps, scale, dr, dtype, st);
    case 128: return train_fwd<128>(q, k, v, sp, out, lp, bh, H, steps, scale, dr, dtype, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q, k, v, dout, dq, dk, dv: (bh, T, dh), dh 32, 64 or 128; lse, delta:
// (bh, T) f32; slopes (H,) f32. Launches the dK/dV kernel, then the dQ
// kernel, on `stream`: the tensor-core pair for bfloat16, the 3xTF32
// tensor-core pair for float32 (rows 16-byte aligned, the wrapper checks).
// Returns cudaGetLastError().
extern "C" int vap_flash_train_bwd(const void* q, const void* k, const void* v, const void* dout,
                                   const void* lse, const void* delta, const void* slopes,
                                   void* dq, void* dk, void* dv, int bh, int H, int steps, int dh,
                                   float scale, uint32_t thresh, uint32_t seed, float inv, int on,
                                   int dtype, void* stream) {
  if (bad_shape(bh, steps)) return static_cast<int>(cudaErrorInvalidValue);
  const Dropout dr{thresh, seed, inv, on};
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(delta);
  const float* sp = static_cast<const float*>(slopes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return train_bwd<32>(q, k, v, dout, lp, dp, sp, dq, dk, dv, bh, H, steps, scale, dr, dtype, st);
    case 64: return train_bwd<64>(q, k, v, dout, lp, dp, sp, dq, dk, dv, bh, H, steps, scale, dr, dtype, st);
    case 128: return train_bwd<128>(q, k, v, dout, lp, dp, sp, dq, dk, dv, bh, H, steps, scale, dr, dtype, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
