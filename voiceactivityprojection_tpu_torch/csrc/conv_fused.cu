// The CPC encoder's first two conv layers, each with ChannelNorm and ReLU,
// with conv0's output kept on chip. Replaces the TPU kernel `_fused_kernel`
// of voiceactivityprojection_tpu/ops/conv_fused.py (:82):
//
//   z0[t, c] = relu(CN_c(b0[c] + sum_{tap<10} x[5 t - 3 + tap] w0[tap, c]))          0 <= t < n0
//   z1[u, c] = relu(CN_c(b1[c] + sum_{tap<8, ci} z0p[4 u - 2 + tap, ci] w1[tap, ci, c]))  0 <= u < n1
//
// x is zero outside [0, n) (conv0's symmetric padding); z0p is z0 on
// [0, n0) and literal zero outside (conv1's padding: a conv of zero samples
// is not zero, so those positions are masked, not computed). ChannelNorm:
// per position, mean and unbiased variance over the 256 channels,
// (z - mean) * rsqrt(var + 1e-5) * gamma + beta, in f32. z0 is rounded to
// the I/O type where it is stored, as the TPU kernel rounds its conv1
// windows (conv_fused.py:172-174) and the plain version each layer's output.
//
// One block of 256 threads (8 warps) per (row, tile of TT = 32 conv1
// outputs):
//   1. the 665 raw samples the tile reads go to shared memory (f32);
//   2. each warp computes conv0 positions of the tile's 4*TT + 4 = 132
//      (10-tap dot products, lane l owning channels 4l + 128j + q), their
//      ChannelNorm (warp reductions) and ReLU, and stores them, or zeros
//      outside [0, n0), to a 132 x 256 tile in shared memory in the I/O type
//      (135 KB in f32, 68 KB in bf16: opted in above 48 KB);
//   3. conv1 is a (TT x 2048) . (2048 x 256) product from shared memory:
//      row u of the im2col operand is the contiguous run of z0 tile
//      elements from position 4u on, so it is never gathered. W1 streams
//      through shared memory in 32-deep chunks (widened to f32), the next
//      chunk loaded into registers while the current one is multiplied.
//      Warp w owns output rows 4w..4w+3, lane l the same 8 channels as in 2;
//   4. the epilogue adds the bias, applies ChannelNorm (warp reductions) and
//      ReLU to the f32 accumulators and writes the tile once.
// conv0's (R, n0, 256) output, 4.2 GB in bf16 at R=128 x 20 s, never goes
// to device memory; the packed-4 layout, block-sum/expand matrices and
// colsum mean of the TPU kernel (conv_fused.py:8-24, 130-160) are Mosaic
// workarounds and have no counterpart here.
//
// Bound: operations (conv1's 2048-deep contraction: about 1,000 FLOP per
// byte of input and output). This version multiplies on the CUDA cores in
// f32, not the tensor cores.

#include "common.cuh"

namespace {

constexpr int C = 256;          // channels
constexpr int K0 = 10, S0 = 5, P0 = 3;
constexpr int K1 = 8, S1 = 4, P1 = 2;
constexpr int TT = 32;                         // conv1 outputs per block
constexpr int NP = S1 * (TT - 1) + K1;         // conv0 positions a tile reads: 132
constexpr int NS = S0 * (NP - 1) + K0;         // raw samples those read: 665
constexpr int NS_PAD = (NS + 3) / 4 * 4;
constexpr int KTOT = K1 * C;                   // conv1 contraction: 2048
constexpr int BK = 32;                         // W1 rows per chunk
constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int ROWS_PER_WARP = TT / NWARP;      // 4
constexpr size_t BS_BYTES = static_cast<size_t>(BK) * C * sizeof(float);
constexpr size_t XS_BYTES = static_cast<size_t>(NS_PAD) * sizeof(float);

static_assert(ROWS_PER_WARP == 4, "the GEMM tile assumes 4 rows per warp");
static_assert(KTOT % BK == 0, "W1 chunks must tile the contraction");

template <typename T>
constexpr size_t smem_bytes() {
  return BS_BYTES + XS_BYTES + static_cast<size_t>(NP) * C * sizeof(T);
}

// the 8 channels of lane l: 4l + 128j + q, e = 4j + q
__device__ __forceinline__ int channel(int lane, int e) { return lane * 4 + 128 * (e >> 2) + (e & 3); }

template <typename T>
__global__ void __launch_bounds__(NT) conv01_kernel(
    const T* __restrict__ x, const T* __restrict__ w0, const T* __restrict__ b0,
    const T* __restrict__ g0, const T* __restrict__ e0, const T* __restrict__ w1,
    const T* __restrict__ b1, const T* __restrict__ g1, const T* __restrict__ e1,
    T* __restrict__ out, int n, int n0, int n1) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Bs = reinterpret_cast<float*>(smem);                       // BK x C
  float* xs = reinterpret_cast<float*>(smem + BS_BYTES);            // NS
  T* z0s = reinterpret_cast<T*>(smem + BS_BYTES + XS_BYTES);        // NP x C

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.y;
  const int u0 = blockIdx.x * TT;        // first conv1 output of the tile
  const int t0_first = S1 * u0 - P1;     // conv0 position of tile slot 0
  const int s_first = S0 * t0_first - P0;  // sample read by slot 0's tap 0

  // 1. the tile's raw samples, zero outside [0, n)
  const T* xr = x + static_cast<size_t>(row) * n;
  for (int i = tid; i < NS; i += NT) {
    const int g = s_first + i;
    xs[i] = (g >= 0 && g < n) ? vap::to_f32(xr[g]) : 0.f;
  }
  float w0r[K0][8], cb[8], cg[8], ce[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int ch = channel(lane, e);
#pragma unroll
    for (int tap = 0; tap < K0; ++tap) w0r[tap][e] = vap::to_f32(w0[tap * C + ch]);
    cb[e] = vap::to_f32(b0[ch]);
    cg[e] = vap::to_f32(g0[ch]);
    ce[e] = vap::to_f32(e0[ch]);
  }
  __syncthreads();

  // 2. conv0 + ChannelNorm + ReLU into the shared tile, zeros outside [0, n0)
  for (int p = warp; p < NP; p += NWARP) {
    float a[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) a[e] = 0.f;
#pragma unroll
    for (int tap = 0; tap < K0; ++tap) {
      const float xv = xs[S0 * p + tap];
#pragma unroll
      for (int e = 0; e < 8; ++e) a[e] = fmaf(xv, w0r[tap][e], a[e]);
    }
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      a[e] += cb[e];
      s += a[e];
    }
    const float mean = vap::warp_sum(s) * (1.f / C);
    float d2 = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float d = a[e] - mean;
      d2 += d * d;
    }
    const float inv = rsqrtf(vap::warp_sum(d2) * (1.f / (C - 1)) + 1e-5f);
    const int t0 = t0_first + p;
    const bool valid = t0 >= 0 && t0 < n0;
    T* zp = z0s + p * C;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float val = valid ? fmaxf((a[e] - mean) * inv * cg[e] + ce[e], 0.f) : 0.f;
      zp[channel(lane, e)] = vap::from_f32<T>(val);
    }
  }

  // 3. conv1: rows 4*warp + i of the (TT x 2048) . (2048 x 256) product
  float b_reg[BK];
  auto load_chunk = [&](int k0) {
#pragma unroll
    for (int i = 0; i < BK; ++i) b_reg[i] = vap::to_f32(w1[static_cast<size_t>(k0 + i) * C + tid]);
  };
  auto store_chunk = [&]() {
#pragma unroll
    for (int i = 0; i < BK; ++i) Bs[i * C + tid] = b_reg[i];
  };
  float acc[ROWS_PER_WARP][8];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;

  // im2col row u starts at tile position S1 * u; its element k is z0s[S1 * u * C + k]
  const T* arow = z0s + static_cast<size_t>(S1) * ROWS_PER_WARP * warp * C;
  load_chunk(0);
  store_chunk();
  __syncthreads();  // the z0 tile and the first W1 chunk are in place
  constexpr int NCHUNK = KTOT / BK;
  for (int c = 0; c < NCHUNK; ++c) {
    if (c + 1 < NCHUNK) load_chunk((c + 1) * BK);
    const T* ac = arow + c * BK;
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float av[ROWS_PER_WARP];
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i) av[i] = vap::to_f32(ac[i * S1 * C + kk]);
      const float4 bl = *reinterpret_cast<const float4*>(&Bs[kk * C + lane * 4]);
      const float4 bh = *reinterpret_cast<const float4*>(&Bs[kk * C + lane * 4 + 128]);
      const float bv[8] = {bl.x, bl.y, bl.z, bl.w, bh.x, bh.y, bh.z, bh.w};
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(av[i], bv[e], acc[i][e]);
    }
    __syncthreads();
    if (c + 1 < NCHUNK) {
      store_chunk();
      __syncthreads();
    }
  }

  // 4. bias, ChannelNorm (unbiased), affine, ReLU, one write
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int ch = channel(lane, e);
    cb[e] = vap::to_f32(b1[ch]);
    cg[e] = vap::to_f32(g1[ch]);
    ce[e] = vap::to_f32(e1[ch]);
  }
  T* outr = out + static_cast<size_t>(row) * n1 * C;
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      acc[i][e] += cb[e];
      s += acc[i][e];
    }
    const float mean = vap::warp_sum(s) * (1.f / C);
    float d2 = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float d = acc[i][e] - mean;
      d2 += d * d;
    }
    const float inv = rsqrtf(vap::warp_sum(d2) * (1.f / (C - 1)) + 1e-5f);
    const int u = u0 + ROWS_PER_WARP * warp + i;
    if (u < n1) {
      T* o = outr + static_cast<size_t>(u) * C;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o[channel(lane, e)] = vap::from_f32<T>(fmaxf((acc[i][e] - mean) * inv * cg[e] + ce[e], 0.f));
    }
  }
}

template <typename T>
int launch(const void* x, const void* w0, const void* b0, const void* g0, const void* e0,
           const void* w1, const void* b1, const void* g1, const void* e1, void* out, int rows,
           int n, int n0, int n1, cudaStream_t st) {
  auto kern = conv01_kernel<T>;
  constexpr size_t smem = smem_bytes<T>();
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n1 + TT - 1) / TT, rows);
  kern<<<grid, NT, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w0), static_cast<const T*>(b0),
      static_cast<const T*>(g0), static_cast<const T*>(e0), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(g1), static_cast<const T*>(e1),
      static_cast<T*>(out), n, n0, n1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (rows, n) samples; w0: (10, 1, 256); w1: (8, 256, 256); b*, g*, e*:
// (256,) conv bias, norm scale, norm shift; out: (rows, n1, 256) with
// n0 = (n + 6 - 10) / 5 + 1 and n1 = (n0 + 4 - 8) / 4 + 1, which the caller
// passes as a check. Returns cudaGetLastError().
extern "C" int vap_conv01(const void* x, const void* w0, const void* b0, const void* g0,
                          const void* e0, const void* w1, const void* b1, const void* g1,
                          const void* e1, void* out, int rows, int n, int n1, int dtype,
                          void* stream) {
  const int n0 = (n + 2 * P0 - K0) / S0 + 1;
  if (n0 < 1 || n1 < 1 || n1 != (n0 + 2 * P1 - K1) / S1 + 1 || rows < 1 || rows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  VAP_DISPATCH_DTYPE(dtype, T,
                     return launch<T>(x, w0, b0, g0, e0, w1, b1, g1, e1, out, rows, n, n0, n1, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
