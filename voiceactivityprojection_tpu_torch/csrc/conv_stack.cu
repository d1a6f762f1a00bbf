// One CPC conv layer fused with ChannelNorm and ReLU (the conv stack runs
// it five times). Replaces the TPU kernel `_kernel` of
// voiceactivityprojection_tpu/ops/conv_stack_fused.py (:101).
//
//   out[r, t, c] = relu(ChannelNorm_c(b[c] + sum_{tap, ci} x[r, t*s - p + tap, ci] * w[tap, ci, c]))
//
// ChannelNorm: per position, mean and UNBIASED variance over the 256
// channels, (z - mean) * rsqrt(var + 1e-5) * gamma + beta.
//
// Implicit GEMM: a block computes a BM x 256 tile (BM positions, every
// channel, so the norm statistics of a position stay in the block). The
// contraction runs over K*Cin in chunks of BK; the im2col operand is
// gathered from the feature-last input as it is loaded (zero outside
// [0, n_in), which is the symmetric padding) and never stored. The next
// chunk is loaded into registers while the current one is multiplied from
// shared memory. Inputs are widened to f32 in shared memory; products and
// sums are f32. The epilogue adds the bias, reduces each position's
// statistics over the 16 threads of a half-warp that hold its channels,
// and writes the tile once.
//
// Bound: operations (conv1: 2048-deep contraction). This version uses the
// CUDA cores, not the tensor cores.

#include "common.cuh"

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

}  // namespace

// x: (rows, n_in, cin) feature-last (cin = 1 for raw samples); w: (k, cin, 256);
// b, gamma, beta: (256,); out: (rows, n_out, 256). Returns cudaGetLastError().
extern "C" int vap_conv_cn_relu(const void* x, const void* w, const void* b, const void* gamma,
                                const void* beta, void* out, int rows, int n_in, int n_out,
                                int cin, int k, int stride, int pad, int dtype, void* stream) {
  const dim3 grid((n_out + BM - 1) / BM, rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  VAP_DISPATCH_DTYPE(dtype, T,
                     conv_cn_relu_kernel<T><<<grid, NT, 0, st>>>(
                         static_cast<const T*>(x), static_cast<const T*>(w),
                         static_cast<const T*>(b), static_cast<const T*>(gamma),
                         static_cast<const T*>(beta), static_cast<T*>(out), n_in, n_out, cin,
                         k * cin, stride, pad));
  return static_cast<int>(cudaGetLastError());
}
