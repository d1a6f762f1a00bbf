// One CPC conv layer fused with ChannelNorm and ReLU (the conv stack runs
// it five times). Replaces the TPU kernel `_kernel` of
// voiceactivityprojection_tpu/ops/conv_stack_fused.py (:101), which keeps
// all five layers of a row tile in VMEM; here each layer is one launch and
// its output goes to device memory once, read once by the next.
//
//   out[r, t, c] = relu(ChannelNorm_c(b[c] + sum_{tap, ci} x[r, t*s - p + tap, ci] * w[tap, ci, c]))
//
// ChannelNorm: per position, mean and UNBIASED variance over the 256
// channels, (z - mean) * rsqrt(var + 1e-5) * gamma + beta.
//
// Both kernels are implicit GEMMs: a block computes a tile of positions x
// all 256 channels (so the norm statistics of a position stay in the
// block), the im2col operand gathered from the feature-last input as it is
// loaded (zero outside [0, n_in): the symmetric padding) and never stored,
// and the epilogue adds the bias, normalises, applies the ReLU and writes
// the tile once.
//
// - bfloat16, Cin = 256 (conv1-conv4): `conv_cn_relu_wgmma_kernel`, on the
//   tensor cores (csrc/wgmma.cuh). One warpgroup (128 threads) per (row r,
//   64 output positions): M = 64 positions, N = 256 channels, K = k * 256
//   in chunks of 64 (one tap, 64 input channels: 32 chunks for conv1, 16
//   for the others). Position t's A row is the 128 contiguous bytes
//   x[r, t*s - p + tap, c0 : c0 + 64], one swizzled tile row of eight
//   16-byte cp.async copies, zero-filled through the copy's src-size
//   outside [0, n_in) and past n_out. B is four 64 x 64 tiles per chunk,
//   one per 64-channel group, cut straight from the (k*256, 256) row-major
//   weights: that is the MN-major operand layout (the descriptor's
//   transpose bit), so the wrapper makes no copy of w. Each k-step issues
//   four m64n64k16 `wgmma` products into float acc[4][32] (128 registers
//   a thread). A stage (A + four B tiles, 40 KB) rides a two-stage
//   cp.async ring, the next chunk landing while the current one
//   multiplies; 81 KB of shared memory gives two blocks an SM. In the
//   epilogue a row's 256 columns sit in the four lanes of a quad (64
//   each), so its mean and unbiased variance are quad sums of the
//   thread's partial sums, taken in two passes over the registers.
// - float32, Cin = 256 (conv1-conv4): `conv_cn_relu_tf32x3_kernel`, on the
//   tensor cores in 3xTF32. Each operand is split as hi = wg::tf32_rna(v),
//   lo = wg::tf32_rna(v - hi), and the f32 accumulators take x_hi w_hi +
//   x_hi w_lo + x_lo w_hi; the dropped x_lo w_lo is below 2^-22 of |x w|,
//   and one-pass TF32 (2^-11) would break the 1e-4 bar of the f32 stack.
//   The split products are exact to about 7e-7 of the stack's output, but
//   the tensor cores' accumulation truncates: the stack lands 4.4-4.9e-5
//   from its plain version (R = 8 to 128 x 20 s), against 5.5e-6 for the
//   CUDA-core kernel, so about half of the bar is used. A deeper
//   contraction would need each chunk's products in a fresh accumulator,
//   added to the running sum with FFMA (128 more registers a thread). tf32 `wgmma` (m64nNk8) reads both shared-memory operands
//   K-major only, so the wrapper first writes w's hi and lo as K-major
//   (k, 256 out, 256 in) copies (`split_tf32_kmajor_kernel`, one launch a
//   layer: 2 x 2 MB for conv1), and x's im2col rows are already K-major:
//   each thread reads its A fragments from the f32 tile and splits them in
//   registers (A from registers). Two warpgroups a block share the B tiles:
//   M = 128 positions (64 a warpgroup), N = 256 channels, K in chunks of 32
//   (one tap, 32 input channels: one 128-byte row of f32, the layout of the
//   bf16 kernel's swizzled tiles); a chunk is 4 k-steps x 3 products x 4
//   channel groups of m64n64k8. A stage (two A tiles, B hi and B lo: 80 KB)
//   rides a two-stage cp.async ring, one block an SM. The epilogue is the
//   bf16 kernel's, a warpgroup on its 64 positions, stored in f32.
// - conv0 in both dtypes (Cin = 1, a 10-deep contraction, where tensor
//   cores do not pay): `conv_cn_relu_kernel`, on the CUDA cores. A block of
//   256 threads computes a 64 x 256 tile; the contraction runs in chunks of
//   16, the next chunk loaded into registers while the current one is
//   multiplied from shared memory, inputs widened to f32 there; each
//   position's statistics are reduced over the 16 threads of a half-warp
//   that hold its channels. (It also takes f32 with Cin = 256 through
//   vap_conv_cn_relu, the route of the first port, which
//   tools/f32_route_turns.py times beside the 3xTF32 kernel.)
//
// Bound: operations (conv1's 2048-deep contraction holds most of the
// stack's FLOPs; about 1,000 FLOP per byte of its input and output). The
// bf16 kernel moves the products onto the tensor cores; every block
// re-reads the whole w (1 MB for conv1) from L2, 32 KB a chunk against
// 8 KB of x, so at M = 64 the L2 traffic is next in line. The 3xTF32
// kernel does three TF32 products for each f32 one: 3 x 3.1 TFLOP at 495
// TFLOP/s is 19 ms a B = 64 request against the 46.7 ms that the f32 FFMA
// rate allows; it reads 64 KB of w (hi and lo) a chunk for 128 positions.

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BM = 64;        // positions per block
constexpr int BN = 256;       // output channels (all of them)
constexpr int BK = 16;        // contraction chunk
constexpr int NT = 256;       // threads: 16 x 16, each owning 4 positions x 16 channels
constexpr int AST = BM + 4;   // row stride of the transposed im2col chunk

template <typename T>
__global__ void __launch_bounds__(NT) conv_cn_relu_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
    const T* __restrict__ gamma, const T* __restrict__ beta, T* __restrict__ out,
    int n_in, int n_out, int cin, int ktot, int stride, int pad) {
  __shared__ __align__(16) float As[BK][AST];  // As[kk][m]
  __shared__ __align__(16) float Bs[BK][BN];   // Bs[kk][c]

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // channel group: channels tx*4 + 64*j + q
  const int ty = tid >> 4;   // position group: positions ty*4 + i
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * BM;
  const T* xr = x + static_cast<size_t>(row) * n_in * cin;

  float a_reg[4];
  float b_reg[16];
  const int a_kk = tid & 15;
  const int a_m = tid >> 4;

  auto load_chunk = [&](int k0) {
    const int kg = k0 + a_kk;
    int tap = 0, ci = 0;
    const bool kin = kg < ktot;
    if (kin) {
      tap = kg / cin;
      ci = kg - tap * cin;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = (t0 + a_m + 16 * i) * stride - pad + tap;
      float v = 0.f;
      if (kin && t >= 0 && t < n_in) v = vap::to_f32(xr[static_cast<size_t>(t) * cin + ci]);
      a_reg[i] = v;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int idx = tid + NT * i;
      const int kr = k0 + (idx >> 8);
      b_reg[i] = kr < ktot ? vap::to_f32(w[static_cast<size_t>(kr) * BN + (idx & 255)]) : 0.f;
    }
  };
  auto store_chunk = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[a_kk][a_m + 16 * i] = a_reg[i];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int idx = tid + NT * i;
      Bs[idx >> 8][idx & 255] = b_reg[i];
    }
  };

  float acc[4][16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;

  const int nchunks = (ktot + BK - 1) / BK;
  load_chunk(0);
  store_chunk();
  __syncthreads();
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) load_chunk((c + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float bv[16];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4 + 64 * j]);
        bv[4 * j] = b.x;
        bv[4 * j + 1] = b.y;
        bv[4 * j + 2] = b.z;
        bv[4 * j + 3] = b.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
    if (c + 1 < nchunks) {
      store_chunk();
      __syncthreads();
    }
  }

  // epilogue: bias, ChannelNorm (unbiased), affine, ReLU, one write
  float bch[16], gch[16], ech[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int ch = tx * 4 + 64 * (j >> 2) + (j & 3);
    bch[j] = vap::to_f32(bias[ch]);
    gch[j] = vap::to_f32(gamma[ch]);
    ech[j] = vap::to_f32(beta[ch]);
  }
  T* outr = out + static_cast<size_t>(row) * n_out * BN;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      acc[i][j] += bch[j];
      s += acc[i][j];
    }
    const float mean = vap::half_warp_sum(s) * (1.f / BN);
    float d2 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float d = acc[i][j] - mean;
      d2 += d * d;
    }
    const float var = vap::half_warp_sum(d2) * (1.f / (BN - 1));
    const float inv = rsqrtf(var + 1e-5f);
    const int t = t0 + ty * 4 + i;
    if (t < n_out) {
      T* o = outr + static_cast<size_t>(t) * BN;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int ch = tx * 4 + 64 * (j >> 2) + (j & 3);
        o[ch] = vap::from_f32<T>(fmaxf((acc[i][j] - mean) * inv * gch[j] + ech[j], 0.f));
      }
    }
  }
}

// ---- bfloat16, Cin = 256: the tensor-core kernel ----------------------------
namespace wg = vap::wg;
using bf16 = __nv_bfloat16;
constexpr int WG_CIN = 256;
constexpr int WG_STAGE = 5 * wg::TILE_BYTES;            // A, then the four B tiles
constexpr size_t WG_SMEM = 2 * WG_STAGE + 1024;         // two stages plus the 1024 alignment slack
static_assert(BM == wg::TILE, "both kernels share the grid: 64 positions a block");

__global__ void __launch_bounds__(wg::NT, 2) conv_cn_relu_wgmma_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, const bf16* __restrict__ bias,
    const bf16* __restrict__ gamma, const bf16* __restrict__ beta, bf16* __restrict__ out, int n_in,
    int n_out, int ktaps, int stride, int pad) {
  extern __shared__ unsigned char wsm[];
  const uint32_t S0 = wg::align1024(wsm);  // stage st at S0 + st * WG_STAGE

  const int tid = threadIdx.x;
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * wg::TILE;
  const int nrows = min(wg::TILE, n_out - t0);
  const bf16* xr = x + static_cast<size_t>(row) * n_in * WG_CIN;
  const int nchunks = ktaps * (WG_CIN / wg::TILE);

  // chunk kc: tap kc / 4, input channels 64 (kc % 4) ..; its weight rows kc * 64 ..
  auto load_chunk = [&](int kc, int st) {
    const uint32_t A = S0 + st * WG_STAGE;
    const int tap = kc >> 2, c0 = (kc & 3) * wg::TILE;
    wg::load_tile_rows(A, xr + c0, t0 * stride - pad + tap, stride, n_in, nrows, WG_CIN, tid);
#pragma unroll
    for (int g = 0; g < 4; ++g)
      wg::load_tile_rows(A + (1 + g) * wg::TILE_BYTES, w + g * wg::TILE, kc * wg::TILE, 1,
                         ktaps * WG_CIN, wg::TILE, BN, tid);
  };
  load_chunk(0, 0);
  wg::cp_async_commit();

  float acc[4][32];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[g][i] = 0.f;

  for (int kc = 0; kc < nchunks; ++kc) {
    const int st = kc & 1;
    wg::cp_async_wait<0>();
    wg::fence_proxy_async();
    __syncthreads();  // chunk kc is in; every warp is done with the other stage
    if (kc + 1 < nchunks) load_chunk(kc + 1, st ^ 1);
    wg::cp_async_commit();

    const uint32_t A = S0 + st * WG_STAGE;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        wg::mma_ss<1>(acc[g], wg::desc_k(A, kk), wg::desc_mn(A + (1 + g) * wg::TILE_BYTES, kk), 1);
    wg::commit();
    wg::wait<0>();
#pragma unroll
    for (int g = 0; g < 4; ++g) wg::pin(acc[g]);
  }

  // epilogue. Element i of group g is row acc_row(tid, i), channel 64 g +
  // acc_col(tid, i); with i = 4 c8 + 2 h + e that is row row0 + 8 h,
  // channel 64 g + 8 c8 + cq + e.
  const int row0 = wg::acc_row(tid, 0), cq = 2 * (tid & 3);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float b = __bfloat162float(bias[64 * g + 8 * c8 + cq + e]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[g][4 * c8 + 2 * h + e] += b;
          sum[h] += acc[g][4 * c8 + 2 * h + e];
        }
      }
  float mean[2], d2[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) mean[h] = wg::quad_sum(sum[h]) * (1.f / BN);
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float d = acc[g][i] - mean[(i >> 1) & 1];
      d2[(i >> 1) & 1] += d * d;
    }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) inv[h] = rsqrtf(wg::quad_sum(d2[h]) * (1.f / (BN - 1)) + 1e-5f);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + row0 + 8 * h;
    if (t >= n_out) continue;
    bf16* o = out + (static_cast<size_t>(row) * n_out + t) * BN + cq;
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int c8 = 0; c8 < 8; ++c8) {
        const int ch = 64 * g + 8 * c8 + cq;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          y[e] = fmaxf((acc[g][4 * c8 + 2 * h + e] - mean[h]) * inv[h] * __bfloat162float(gamma[ch + e]) +
                           __bfloat162float(beta[ch + e]),
                       0.f);
        *reinterpret_cast<__nv_bfloat162*>(o + 64 * g + 8 * c8) = __floats2bfloat162_rn(y[0], y[1]);
      }
  }
}

// ---- float32, Cin = 256: 3xTF32 on the tensor cores ------------------------
constexpr int TF_WG = 2;                                   // warpgroups a block, 64 positions each
constexpr int TF_BM = TF_WG * wg::TILE;                    // positions a block
constexpr int TF_KC = 32;                                  // a chunk: 32 f32 input channels of one tap
constexpr int TF_B_BYTES = BN * 128;                       // 256 channels x 32 k, K-major (32 KB)
constexpr int TF_STAGE = TF_WG * wg::TILE_BYTES + 2 * TF_B_BYTES;  // the A tiles, B hi, B lo
constexpr size_t TF_SMEM = 2 * TF_STAGE + 1024;            // two stages plus the 1024 alignment slack

// rows [0, rows) of a tile of 128-byte f32 rows under the 128-byte swizzle:
// row r <- the 32 floats at src + g * ld with g = g0 + r * gstep, zeros
// where r >= nrows or g lies outside [0, glim)
__device__ __forceinline__ void load_rows_f32(uint32_t tile, const float* __restrict__ src, int g0, int gstep,
                                              int glim, int nrows, int rows, int ld, int tid) {
  for (int idx = tid; idx < rows * 8; idx += TF_WG * wg::NT) {
    const int r = idx >> 3, c = idx & 7;
    const int g = g0 + r * gstep;
    const bool ok = r < nrows && g >= 0 && g < glim;
    wg::cp_async16(tile + wg::swz(r, c), src + static_cast<size_t>(ok ? g : 0) * ld + c * 4, ok);
  }
}

// w (k, 256 in, 256 out) -> hi, lo (k, 256 out, 256 in): w's tf32 halves,
// K-major, through a 32 x 32 tile (grid (8, 8, k), block (32, 8))
__global__ void split_tf32_kmajor_kernel(const float* __restrict__ w, float* __restrict__ hi,
                                         float* __restrict__ lo) {
  __shared__ float tile[32][33];
  const int tap = blockIdx.z, i0 = 32 * blockIdx.y, o0 = 32 * blockIdx.x;
  for (int j = threadIdx.y; j < 32; j += 8)
    tile[j][threadIdx.x] = w[(static_cast<size_t>(tap) * BN + i0 + j) * BN + o0 + threadIdx.x];
  __syncthreads();
  for (int j = threadIdx.y; j < 32; j += 8) {
    const float v = tile[threadIdx.x][j];  // input i0 + x, output o0 + j
    const uint32_t h = wg::tf32_rna(v);
    const size_t o = (static_cast<size_t>(tap) * BN + o0 + j) * BN + i0 + threadIdx.x;
    hi[o] = __uint_as_float(h);
    lo[o] = __uint_as_float(wg::tf32_rna(v - __uint_as_float(h)));
  }
}

__global__ void __launch_bounds__(TF_WG * wg::NT, 1) conv_cn_relu_tf32x3_kernel(
    const float* __restrict__ x, const float* __restrict__ w_hi, const float* __restrict__ w_lo,
    const float* __restrict__ bias, const float* __restrict__ gamma, const float* __restrict__ beta,
    float* __restrict__ out, int n_in, int n_out, int ktaps, int stride, int pad) {
  extern __shared__ unsigned char tsm[];
  const uint32_t S0 = wg::align1024(tsm);  // stage st at S0 + st * TF_STAGE: A0, A1, B hi, B lo

  const int tid = threadIdx.x;
  // the warpgroup, read from lane 0 so the compiler knows it is warp-uniform
  const int q = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int wt = tid & 127;
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * TF_BM;
  const float* xr = x + static_cast<size_t>(row) * n_in * WG_CIN;
  const int nchunks = ktaps * (WG_CIN / TF_KC);

  // chunk kc: tap kc / 8, input channels 32 (kc % 8) ..
  auto load_chunk = [&](int kc, int st) {
    const uint32_t base = S0 + st * TF_STAGE;
    const int tap = kc >> 3, c0 = (kc & 7) * TF_KC;
#pragma unroll
    for (int a = 0; a < TF_WG; ++a) {
      const int ta = t0 + a * wg::TILE;
      load_rows_f32(base + a * wg::TILE_BYTES, xr + c0, ta * stride - pad + tap, stride, n_in,
                    min(wg::TILE, n_out - ta), wg::TILE, WG_CIN, tid);
    }
    const uint32_t b = base + TF_WG * wg::TILE_BYTES;
    load_rows_f32(b, w_hi + c0, tap * BN, 1, ktaps * BN, BN, BN, WG_CIN, tid);
    load_rows_f32(b + TF_B_BYTES, w_lo + c0, tap * BN, 1, ktaps * BN, BN, BN, WG_CIN, tid);
  };
  load_chunk(0, 0);
  wg::cp_async_commit();

  float acc[4][32];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[g][i] = 0.f;

  // the thread's A fragment rows and its columns within a k-step
  const int fr = wg::acc_row(wt, 0), fc = wt & 3;
  for (int kc = 0; kc < nchunks; ++kc) {
    const int st = kc & 1;
    wg::cp_async_wait<0>();
    wg::fence_proxy_async();
    __syncthreads();  // chunk kc is in; every warp is done with the other stage
    if (kc + 1 < nchunks) load_chunk(kc + 1, st ^ 1);
    wg::cp_async_commit();

    const uint32_t A = S0 + st * TF_STAGE + q * wg::TILE_BYTES;
    const uint32_t Bh = S0 + st * TF_STAGE + TF_WG * wg::TILE_BYTES, Bl = Bh + TF_B_BYTES;
    const unsigned char* a_gen = tsm + (A - wg::smem_u32(tsm));
    // A fragments of the 4 k-steps, split: register f holds row fr + 8 (f % 2),
    // column 8 kk + fc + 4 (f / 2)
    uint32_t ahi[4][4], alo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int r = fr + 8 * (f & 1), col = 8 * kk + fc + 4 * (f >> 1);
        const float v = *reinterpret_cast<const float*>(a_gen + wg::swz(r, col >> 2) + 4 * (col & 3));
        ahi[kk][f] = wg::tf32_rna(v);
        alo[kk][f] = wg::tf32_rna(v - __uint_as_float(ahi[kk][f]));
      }
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        wg::mma_tf32_rs(acc[g], alo[kk], wg::desc_k(Bh + g * wg::TILE_BYTES, kk));
        wg::mma_tf32_rs(acc[g], ahi[kk], wg::desc_k(Bl + g * wg::TILE_BYTES, kk));
        wg::mma_tf32_rs(acc[g], ahi[kk], wg::desc_k(Bh + g * wg::TILE_BYTES, kk));
      }
    wg::commit();
    wg::wait<0>();
#pragma unroll
    for (int g = 0; g < 4; ++g) wg::pin(acc[g]);
  }

  // epilogue, the bf16 kernel's on this warpgroup's 64 positions
  const int row0 = wg::acc_row(wt, 0) + q * wg::TILE, cq = 2 * (wt & 3);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float b = bias[64 * g + 8 * c8 + cq + e];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[g][4 * c8 + 2 * h + e] += b;
          sum[h] += acc[g][4 * c8 + 2 * h + e];
        }
      }
  float mean[2], d2[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) mean[h] = wg::quad_sum(sum[h]) * (1.f / BN);
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float d = acc[g][i] - mean[(i >> 1) & 1];
      d2[(i >> 1) & 1] += d * d;
    }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) inv[h] = rsqrtf(wg::quad_sum(d2[h]) * (1.f / (BN - 1)) + 1e-5f);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + row0 + 8 * h;
    if (t >= n_out) continue;
    float* o = out + (static_cast<size_t>(row) * n_out + t) * BN + cq;
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int c8 = 0; c8 < 8; ++c8) {
        const int ch = 64 * g + 8 * c8 + cq;
        float2 y;
        y.x = fmaxf((acc[g][4 * c8 + 2 * h] - mean[h]) * inv[h] * gamma[ch] + beta[ch], 0.f);
        y.y = fmaxf((acc[g][4 * c8 + 2 * h + 1] - mean[h]) * inv[h] * gamma[ch + 1] + beta[ch + 1], 0.f);
        *reinterpret_cast<float2*>(o + 64 * g + 8 * c8) = y;
      }
  }
}

}  // namespace

// x: (rows, n_in, cin) feature-last (cin = 1 for raw samples); w: (k, cin, 256);
// b, gamma, beta: (256,); out: (rows, n_out, 256). bfloat16 with cin = 256
// runs the tensor-core kernel (x and w 16-byte aligned, the wrapper
// checks); the rest the CUDA-core one (float32 with cin = 256 too: the
// wrapper sends that to vap_conv_cn_relu_tf32x3). Returns cudaGetLastError().
extern "C" int vap_conv_cn_relu(const void* x, const void* w, const void* b, const void* gamma,
                                const void* beta, void* out, int rows, int n_in, int n_out,
                                int cin, int k, int stride, int pad, int dtype, void* stream) {
  const dim3 grid((n_out + BM - 1) / BM, rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vap::kBF16 && cin == WG_CIN) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_cn_relu_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(WG_SMEM));
    if (e != cudaSuccess) return static_cast<int>(e);
    conv_cn_relu_wgmma_kernel<<<grid, wg::NT, WG_SMEM, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(b),
        static_cast<const bf16*>(gamma), static_cast<const bf16*>(beta), static_cast<bf16*>(out), n_in,
        n_out, k, stride, pad);
    return static_cast<int>(cudaGetLastError());
  }
  VAP_DISPATCH_DTYPE(dtype, T,
                     conv_cn_relu_kernel<T><<<grid, NT, 0, st>>>(
                         static_cast<const T*>(x), static_cast<const T*>(w),
                         static_cast<const T*>(b), static_cast<const T*>(gamma),
                         static_cast<const T*>(beta), static_cast<T*>(out), n_in, n_out, cin,
                         k * cin, stride, pad));
  return static_cast<int>(cudaGetLastError());
}

// w: (k, 256, 256) float32 as (tap, in, out) -> w_split (2, k, 256, 256):
// w's tf32 hi, then lo, each (tap, out, in). Returns cudaGetLastError().
extern "C" int vap_conv_split_tf32(const void* w, void* w_split, int k, void* stream) {
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  float* hi = static_cast<float*>(w_split);
  split_tf32_kmajor_kernel<<<dim3(BN / 32, WG_CIN / 32, k), dim3(32, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), hi, hi + static_cast<size_t>(k) * WG_CIN * BN);
  return static_cast<int>(cudaGetLastError());
}

// float32, cin = 256: the 3xTF32 kernel. x: (rows, n_in, 256), 16-byte
// aligned; w_split: vap_conv_split_tf32's (2, k, 256, 256); b, gamma, beta:
// (256,); out: (rows, n_out, 256). Returns cudaGetLastError().
extern "C" int vap_conv_cn_relu_tf32x3(const void* x, const void* w_split, const void* b, const void* gamma,
                                       const void* beta, void* out, int rows, int n_in, int n_out, int k,
                                       int stride, int pad, void* stream) {
  const cudaError_t e = cudaFuncSetAttribute(conv_cn_relu_tf32x3_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(TF_SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* hi = static_cast<const float*>(w_split);
  conv_cn_relu_tf32x3_kernel<<<dim3((n_out + TF_BM - 1) / TF_BM, rows), TF_WG * wg::NT, TF_SMEM,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), hi, hi + static_cast<size_t>(k) * WG_CIN * BN, static_cast<const float*>(b),
      static_cast<const float*>(gamma), static_cast<const float*>(beta), static_cast<float*>(out), n_in, n_out, k,
      stride, pad);
  return static_cast<int>(cudaGetLastError());
}
