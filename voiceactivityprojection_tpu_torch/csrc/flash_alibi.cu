// Causal ALiBi attention with the online softmax. Replaces the TPU kernels
// of voiceactivityprojection_tpu/ops/flash_alibi.py `_single_block_kernel`
// (:122, with its schedule variants `_v2` :167, `_v3` :223, `_v4` :270,
// `_v5` :332 and `_tri` :404), `_flash_kernel` (:54) and
// `_flash_offset_kernel` (:590), which compute the same function for Tq
// query rows at global offset `off` of a Tk-key timeline (off = 0 and
// Tq = Tk for all but the last):
//
//   s_ij = (q_i . k_j) * scale + slope_h * (j - (off + i))   for j <= off + i (else masked)
//   out_i = sum_j softmax_j(s_i)_j v_j
//
// with f32 scores and softmax, the probabilities rounded to v's type before
// the value product (as the TPU kernels do), f32 sums, output in q's type.
// `vap_flash_alibi` (K4/K5) runs instantiations whose offset is 0 and
// Tk = Tq at compile time; `vap_flash_alibi_offset` (K10) the ones that
// read them. Each is instantiated for head widths Dh = 32, 64 and 128 (the
// model's 256 over 8, 4 and 2 heads); both entry points dispatch on Dh and
// on the dtype code:
//
// - bfloat16: `flash_alibi_wgmma_kernel`, on the tensor cores. One
//   warpgroup (128 threads) per (batch*head, 64-query tile). S = Q K^T is
//   Dh / 16 `wgmma` m64n64k16 k-steps with Q and the key tile read from
//   shared memory through descriptors (csrc/wgmma.cuh: an operand is Dh /
//   64 swizzled 64 x 64 tiles, or at Dh = 32 one with zero columns 32 ..
//   63, and O one m64n64 accumulator per 64 columns); the
//   ALiBi bias, the causal test (only in tiles that reach past the tile's
//   first query row: the diagonal and, for K10, a ragged edge), the online
//   softmax (row max and sum over the 4 lanes of a quad) and the rescale of
//   O all run in the accumulator registers; P is rounded pairwise to bf16
//   straight into the A fragments of O += P V, whose V tile is the B
//   operand read MN-major. K/V tiles stream through a two-stage ring of
//   `cp.async` 16-byte copies into the 128-byte-swizzled layout: the next
//   tile lands while the current one multiplies; Q is loaded once. cp.async
//   rather than TMA: a tensor map per tensor and launch would be encoded on
//   the host (cuTensorMapEncodeTiled) on every call, while 128 threads
//   issuing four 16-byte copies each fill an 8 KB tile, and the copies'
//   src-size 0 writes the zero rows past Tq / Tk without reading past the
//   tensor. Rows of a tile with no visible key yet keep m = -inf and use 0
//   in its place, so exp(-inf - -inf) never happens.
// - float32: `flash_alibi_tf32x3_kernel`, the same plan on the tensor cores
//   in 3xTF32 (csrc/wgmma.cuh): each float32 operand split into tf32 hi and
//   lo, and each product taken as A_lo B_hi + A_hi B_lo + A_hi B_hi
//   (m64n64k8 tf32 `wgmma`), which keeps about 2^-22 of each term: one-pass
//   TF32 (2^-11) would break the 5e-6 bar, three passes do not. tf32 reads
//   its shared-memory operands K-major only, so V, whose contraction runs
//   down its rows, lands transposed (Dh rows x 64 keys); the tiles cannot
//   be copied as bytes by cp.async, since each is split on its way in:
//   every thread reads 16-byte pieces from global memory (L2), splits them
//   and stores hi and lo (Q once, K and V^T each key tile). S = Q K^T reads
//   Q's and K's halves from shared memory; P is split in registers into
//   the A fragments of O += P V, whose k-order inside each group of 8 keys
//   is permuted to the accumulator's (column 2t at k-position t, 2t + 1 at
//   t + 4), and V^T is written in that order. O accumulates in the `wgmma`
//   accumulator across key tiles. The exponentials are `expf`. One stage
//   of shared memory (64, 96 and 192 KB at Dh = 32, 64, 128: three, two and
//   one block an SM); at Dh <= 64 the next key tile's global reads are
//   issued into registers right after S's products, so they fly while this
//   tile multiplies, and are split into shared memory at the next tile.
//
// Both walk the 64-key tiles from 0 up to the tile that holds the key of
// the tile's last real query row (global row off + q0 + 63, or off + Tq - 1
// in a ragged last tile): the bound compares global row indices, not tile
// indices, so an offset that is not a multiple of 64 ends the walk on the
// right tile. Query tiles are scheduled last-first (longest key walks
// first). Offsets into q/out use Tq and into k/v use Tk, in size_t
// (bh * Tk * Dh passes 2^31 at an hour of audio).
//
// Bound on the card: K4 at B=64, H=4, T=1000 by its bytes in bf16 (250 FLOP
// per byte of I/O, below the H100's ~295 ridge); K10's shards (Tq = 7500
// rows over up to 30000 keys) by their operations, and in float32 every
// shape by its operations (three TF32 products a product at 495 TFLOP/s).
// The designs keep S and P in registers, so what is left besides the
// products is the softmax's exponentials and the loads (and in float32 the
// split of every operand).

#include <math_constants.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

namespace wg = vap::wg;

// ---- float32: 3xTF32 on the tensor cores ----------------------------------
// Shared memory and registers of the f32 kernel at head width DH: wg::F32Tiles
// (csrc/wgmma.cuh), which the training forward shares.
using wg::F32Tiles;

template <int DH, bool OFFSET>
__global__ void __launch_bounds__(wg::NT) flash_alibi_tf32x3_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ slopes, float* __restrict__ out, int H, int Tq, int Tk_arg, int offset_arg,
    float scale) {
  using L = F32Tiles<DH>;
  const int Tk = OFFSET ? Tk_arg : Tq;
  const int q_offset = OFFSET ? offset_arg : 0;
  extern __shared__ unsigned char wsm[];
  const uint32_t Qh = wg::align1024(wsm), Ql = Qh + L::OP, Kh = Ql + L::OP, Kl = Kh + L::OP;
  const uint32_t Vh = Kl + L::OP, Vl = Vh + 2 * L::VPANEL;

  const int tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const float slope = slopes[bh % H];
  const size_t q_base = static_cast<size_t>(bh) * Tq * DH;
  const size_t kv_base = OFFSET ? static_cast<size_t>(bh) * Tk * DH : q_base;
  const int q0 = qt * wg::TILE;
  const int kt_last = OFFSET ? min(Tk - 1, q_offset + min(q0 + wg::TILE, Tq) - 1) / wg::TILE : qt;

  if (DH < wg::TILE)  // V^T rows DH .. 63: zeros, the O columns past DH
    for (int p = 0; p < 4; ++p) wg::zero_shared(Vh + p * L::VPANEL + DH * 128, (wg::TILE - DH) * 128, tid);
  wg::load_f32_tile<DH>(q + q_base, q0, Tq, DH, 0, tid,
                        [&](int r, int c, float4 x) { wg::store_kmajor(Qh, Ql, wg::TILE_BYTES, r, c, x); });

  float o[L::OPANELS][32];
#pragma unroll
  for (int p = 0; p < L::OPANELS; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  const int row0 = wg::acc_row(tid, 0);  // this thread's rows: row0 and row0 + 8
  const int gi0 = q_offset + q0 + row0;

  auto place_k = [&](int r, int c, float4 x) { wg::store_kmajor(Kh, Kl, wg::TILE_BYTES, r, c, x); };
  auto place_v = [&](int r, int c, float4 x) { wg::store_trans(Vh, Vl, L::VPANEL, r, c, x); };
  float4 kn[L::PREFETCH ? DH / 8 : 1], vn[L::PREFETCH ? DH / 8 : 1];  // the next tile's K and V pieces
  if (L::PREFETCH) {
    wg::fetch_f32<DH>(kn, k + kv_base, 0, Tk, DH, 0, tid);
    wg::fetch_f32<DH>(vn, v + kv_base, 0, Tk, DH, 0, tid);
  }

  for (int kt = 0; kt <= kt_last; ++kt) {
    const int k0 = kt * wg::TILE;
    __syncthreads();  // every warp's products of the previous tile have retired
    if (L::PREFETCH) {
      wg::place_f32<DH>(kn, tid, place_k);
      wg::place_f32<DH>(vn, tid, place_v);
    } else {
      wg::load_f32_tile<DH>(k + kv_base, k0, Tk, DH, 0, tid, place_k);
      wg::load_f32_tile<DH>(v + kv_base, k0, Tk, DH, 0, tid, place_v);
    }
    wg::fence_proxy_async();
    __syncthreads();  // the tiles are in

    float s[32];
    wg::fence();
    wg::tile_abt_tf32x3<DH>(s, Qh, Ql, Kh, Kl, 0);
    wg::commit();
    if (L::PREFETCH && kt < kt_last) {  // the next tile's loads fly while this one multiplies
      wg::fetch_f32<DH>(kn, k + kv_base, k0 + wg::TILE, Tk, DH, 0, tid);
      wg::fetch_f32<DH>(vn, v + kv_base, k0 + wg::TILE, Tk, DH, 0, tid);
    }
    wg::wait<0>();
    wg::pin(s);

    const bool masked = k0 + wg::TILE - 1 > q_offset + q0;  // a key past some row of the tile
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
      const float p = expf(s[i] - mu[h]);
      l[h] += p;
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
  for (int h = 0; h < 2; ++h) l[h] = wg::quad_sum(l[h]);
#pragma unroll
  for (int pn = 0; pn < L::OPANELS; ++pn)
#pragma unroll
    for (int i = 0; i < L::OUT_ELEMS; i += 2) {
      const int h = (i >> 1) & 1;
      const int lq = q0 + row0 + 8 * h;
      if (lq < Tq)
        *reinterpret_cast<float2*>(out + q_base + static_cast<size_t>(lq) * DH + pn * wg::TILE +
                                   wg::acc_col(tid, i)) = make_float2(o[pn][i] / l[h], o[pn][i + 1] / l[h]);
    }
}

// ---- bfloat16: the tensor-core kernel --------------------------------------
using bf16 = __nv_bfloat16;
// Q, then the ring's two stages of (K, V), plus the slack to align to 1024
template <int DH>
constexpr size_t wg_smem() {
  return 5 * wg::Head<DH>::BYTES + 1024;
}

template <int DH, bool OFFSET>
__global__ void __launch_bounds__(wg::NT) flash_alibi_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ slopes, bf16* __restrict__ out, int H, int Tq, int Tk_arg,
    int offset_arg, float scale) {
  using HD = wg::Head<DH>;
  constexpr uint32_t HB = HD::BYTES;
  const int Tk = OFFSET ? Tk_arg : Tq;
  const int q_offset = OFFSET ? offset_arg : 0;
  extern __shared__ unsigned char wsm[];
  const uint32_t Qs = wg::align1024(wsm);
  // stage st: K at Qs + (1 + 2 st) operands, its V right after

  const int tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const float slope = slopes[bh % H];
  const size_t q_base = static_cast<size_t>(bh) * Tq * DH;
  const size_t kv_base = OFFSET ? static_cast<size_t>(bh) * Tk * DH : q_base;
  const int q0 = qt * wg::TILE;
  const int kt_last = OFFSET ? min(Tk - 1, q_offset + min(q0 + wg::TILE, Tq) - 1) / wg::TILE : qt;

  wg::load_head<DH>(Qs, q + q_base, q0, Tq, tid);
  wg::load_head<DH>(Qs + HB, k + kv_base, 0, Tk, tid);
  wg::load_head<DH>(Qs + 2 * HB, v + kv_base, 0, Tk, tid);
  wg::cp_async_commit();

  float o[HD::PANELS][32];
#pragma unroll
  for (int p = 0; p < HD::PANELS; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  const int row0 = wg::acc_row(tid, 0);  // this thread's rows: row0 and row0 + 8
  const int gi0 = q_offset + q0 + row0;

  for (int kt = 0; kt <= kt_last; ++kt) {
    const uint32_t Kt = Qs + (1 + 2 * (kt & 1)) * HB, Vt = Kt + HB;
    wg::cp_async_wait<0>();
    wg::fence_proxy_async();
    __syncthreads();  // tile kt is in; every warp is done with the other stage
    if (kt < kt_last) {
      const uint32_t Kn = Qs + (3 - 2 * (kt & 1)) * HB;
      wg::load_head<DH>(Kn, k + kv_base, (kt + 1) * wg::TILE, Tk, tid);
      wg::load_head<DH>(Kn + HB, v + kv_base, (kt + 1) * wg::TILE, Tk, tid);
    }
    wg::cp_async_commit();

    float s[32];
    wg::fence();
    wg::tile_abt<DH>(s, Qs, Kt);
    wg::commit();
    wg::wait<0>();
    wg::pin(s);

    const int k0 = kt * wg::TILE;
    const bool masked = k0 + wg::TILE - 1 > q_offset + q0;  // a key past some row of the tile
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
      corr[h] = __expf(m[h] - mu[h]);
      m[h] = m_new;
      l[h] *= corr[h];  // l is this thread's share of the row sum until the end
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const float p = __expf(s[i] - mu[h]);
      l[h] += p;
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
  for (int h = 0; h < 2; ++h) l[h] = wg::quad_sum(l[h]);
#pragma unroll
  for (int pn = 0; pn < HD::PANELS; ++pn)
#pragma unroll
    for (int i = 0; i < HD::OUT_ELEMS; i += 2) {
      const int h = (i >> 1) & 1;
      const int lq = q0 + row0 + 8 * h;
      if (lq < Tq) {
        const __nv_bfloat162 pair = __floats2bfloat162_rn(o[pn][i] / l[h], o[pn][i + 1] / l[h]);
        *reinterpret_cast<__nv_bfloat162*>(out + q_base + static_cast<size_t>(lq) * DH +
                                           pn * wg::TILE + wg::acc_col(tid, i)) = pair;
      }
    }
}

template <typename K>
int allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem)));
}

template <int DH, bool OFFSET>
int launch_f32(const void* q, const void* k, const void* v, const void* slopes, void* out, int bh,
               int H, int Tq, int Tk, int q_offset, float scale, cudaStream_t st) {
  auto kern = flash_alibi_tf32x3_kernel<DH, OFFSET>;
  constexpr size_t smem = F32Tiles<DH>::SMEM;
  if (const int e = allow_smem(kern, smem)) return e;
  const dim3 grid((Tq + wg::TILE - 1) / wg::TILE, bh);
  kern<<<grid, wg::NT, smem, st>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                   static_cast<const float*>(v), static_cast<const float*>(slopes),
                                   static_cast<float*>(out), H, Tq, Tk, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, bool OFFSET>
int launch_bf16(const void* q, const void* k, const void* v, const void* slopes, void* out, int bh,
                int H, int Tq, int Tk, int q_offset, float scale, cudaStream_t st) {
  auto kern = flash_alibi_wgmma_kernel<DH, OFFSET>;
  constexpr size_t smem = wg_smem<DH>();
  if (const int e = allow_smem(kern, smem)) return e;
  const dim3 grid((Tq + wg::TILE - 1) / wg::TILE, bh);
  kern<<<grid, wg::NT, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(slopes), static_cast<bf16*>(out), H, Tq, Tk, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, bool OFFSET>
int launch_dh(const void* q, const void* k, const void* v, const void* slopes, void* out, int bh,
              int H, int Tq, int Tk, int q_offset, float scale, int dtype, cudaStream_t st) {
  if (dtype == vap::kBF16) return launch_bf16<DH, OFFSET>(q, k, v, slopes, out, bh, H, Tq, Tk, q_offset, scale, st);
  if (dtype == vap::kF32) return launch_f32<DH, OFFSET>(q, k, v, slopes, out, bh, H, Tq, Tk, q_offset, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool OFFSET>
int launch(const void* q, const void* k, const void* v, const void* slopes, void* out, int bh,
           int H, int Tq, int Tk, int q_offset, int dh, float scale, int dtype, cudaStream_t st) {
  switch (dh) {
    case 32: return launch_dh<32, OFFSET>(q, k, v, slopes, out, bh, H, Tq, Tk, q_offset, scale, dtype, st);
    case 64: return launch_dh<64, OFFSET>(q, k, v, slopes, out, bh, H, Tq, Tk, q_offset, scale, dtype, st);
    case 128: return launch_dh<128, OFFSET>(q, k, v, slopes, out, bh, H, Tq, Tk, q_offset, scale, dtype, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v, out: (bh, T, dh) with bh = B*H; slopes: (H,) f32; dh 32, 64 or 128;
// bf16 rows 16-byte aligned (the wrapper checks). Returns cudaGetLastError().
extern "C" int vap_flash_alibi(const void* q, const void* k, const void* v, const void* slopes,
                               void* out, int bh, int H, int steps, int dh, float scale,
                               int dtype, void* stream) {
  return launch<false>(q, k, v, slopes, out, bh, H, steps, steps, 0, dh, scale, dtype,
                       static_cast<cudaStream_t>(stream));
}

// q, out: (bh, Tq, dh); k, v: (bh, Tk, dh): query row i sits at global row
// q_offset + i of the key timeline; 0 <= q_offset and q_offset + Tq <= Tk
// (the wrapper checks). Returns cudaGetLastError().
extern "C" int vap_flash_alibi_offset(const void* q, const void* k, const void* v,
                                      const void* slopes, void* out, int bh, int H, int Tq,
                                      int Tk, int q_offset, int dh, float scale, int dtype,
                                      void* stream) {
  if (q_offset < 0 || Tq < 1 || q_offset + Tq > Tk) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(q, k, v, slopes, out, bh, H, Tq, Tk, q_offset, dh, scale, dtype,
                      static_cast<cudaStream_t>(stream));
}
