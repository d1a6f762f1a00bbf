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
// Two routes, by dtype alone, both on the tensor cores:
// - bfloat16: `conv01_wgmma_kernel` of csrc/conv01_wgmma.cuh, conv0 and
//   conv1 on `wgmma`, conv0 stored polyphase in shared memory as conv1's A
//   operand, W1 streamed by TMA into an mbarrier ring (its header has the
//   design).
// - float32: `conv01_tf32x3_kernel` of csrc/conv01_tf32x3.cuh, conv0 in f32
//   FFMA one group of 32 channels at a time, conv1 in 3xTF32 on `wgmma`
//   with W1's tf32 halves pre-split K-major (K1's split kernel), whose
//   truncating accumulation keeps the 1e-4 bar of float32 as K1's conv1
//   does (its header has the design).
// A launch either kernel refuses returns an error; nothing falls back.
// conv0's (R, n0, 256) output, 4.2 GB in bf16 at R=128 x 20 s, never goes
// to device memory; the packed-4 layout, block-sum/expand matrices and
// colsum mean of the TPU kernel (conv_fused.py:8-24, 130-160) are Mosaic
// workarounds and have no counterpart here.
//
// Bound: operations (conv1's 2048-deep contraction: about 1,000 FLOP per
// byte of input and output).

#include "common.cuh"
#include "conv01_tf32x3.cuh"
#include "conv01_wgmma.cuh"

namespace {

constexpr int K0 = 10, S0 = 5, P0 = 3;
constexpr int K1 = 8, S1 = 4, P1 = 2;

// launches each kernel has taken, for showing which route ran: [0] the
// bfloat16 kernel, [1] the float32 3xTF32 kernel (host-side counts)
long long g_launches[2] = {0, 0};

int conv01_f32(const void* x, const void* w0, const void* b0, const void* g0, const void* e0, const void* w1,
               const void* b1, const void* g1, const void* e1, void* out, int rows, int n, int n0, int n1,
               cudaStream_t st) {
  namespace c = vap::c01f;
  // 16-byte cp.async reads W1's halves
  if (reinterpret_cast<uintptr_t>(w1) & 15) return static_cast<int>(cudaErrorMisalignedAddress);
  const float* hi = static_cast<const float*>(w1);
  const c::Params p{static_cast<const float*>(x),  static_cast<const float*>(w0), static_cast<const float*>(b0),
                    static_cast<const float*>(g0), static_cast<const float*>(e0), hi,
                    hi + static_cast<size_t>(c::K1) * c::C * c::C,   static_cast<const float*>(b1),
                    static_cast<const float*>(g1), static_cast<const float*>(e1), static_cast<float*>(out),
                    n, n0, n1};
  const cudaError_t e =
      cudaFuncSetAttribute(c::conv01_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, c::SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n1 + c::TU - 1) / c::TU, rows);
  c::conv01_tf32x3_kernel<<<grid, c::NT, c::SMEM_BYTES, st>>>(p);
  const cudaError_t le = cudaGetLastError();
  if (le == cudaSuccess) ++g_launches[1];
  return static_cast<int>(le);
}

// ---- the bfloat16 route ---------------------------------------------------------
int conv01_bf16(const void* x, const void* w0, const void* b0, const void* g0, const void* e0, const void* w1,
                const void* b1, const void* g1, const void* e1, void* out, int rows, int n, int n0, int n1,
                cudaStream_t st) {
  namespace c = vap::c01;
  using bf = __nv_bfloat16;
  // TMA reads W1 and 16-byte loads w0: both start on a 16-byte boundary
  if ((reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w0)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const c::Params p{static_cast<const bf*>(x), static_cast<const bf*>(w0), static_cast<const bf*>(b0),
                    static_cast<const bf*>(g0), static_cast<const bf*>(e0), static_cast<const bf*>(b1),
                    static_cast<const bf*>(g1), static_cast<const bf*>(e1), static_cast<bf*>(out),
                    n, n0, n1};
  vap::wg::EncodeTiled encode = vap::wg::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // W1 as a (2048 rows, 256 columns) bf16 matrix; a box is 32 rows x 64
  // columns (128 bytes, the swizzle's width)
  CUtensorMap map;
  const cuuint64_t dims[2] = {c::C, c::KTOT};
  const cuuint64_t strides[1] = {c::C * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {64, c::STAGE_ROWS};
  const cuuint32_t estr[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w1), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e =
      cudaFuncSetAttribute(c::conv01_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, c::SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n1 + c::TU - 1) / c::TU, rows);
  c::conv01_wgmma_kernel<<<grid, c::NT, c::SMEM_BYTES, st>>>(map, p);
  const cudaError_t le = cudaGetLastError();
  if (le == cudaSuccess) ++g_launches[0];
  return static_cast<int>(le);
}

bool shape_ok(int rows, int n, int n0, int n1) {
  return n0 >= 1 && n1 >= 1 && n1 == (n0 + 2 * P1 - K1) / S1 + 1 && rows >= 1 && rows <= 65535;
}

}  // namespace

// x: (rows, n) samples; w0: (10, 1, 256); b*, g*, e*: (256,) conv bias,
// norm scale, norm shift; out: (rows, n1, 256) with n0 = (n + 6 - 10) / 5
// + 1 and n1 = (n0 + 4 - 8) / 4 + 1, which the caller passes as a check.
// bfloat16: w1 (8, 256, 256), the tensor-core kernel (w0 and w1 16-byte
// aligned). float32: w1 is W1's tf32 split (2, 8, 256 out, 256 in), hi then
// lo, as csrc/conv_stack.cu's vap_conv_split_tf32 writes it (16-byte
// aligned), the 3xTF32 kernel. Returns cudaGetLastError() or the launch's
// refusal.
extern "C" int vap_conv01(const void* x, const void* w0, const void* b0, const void* g0,
                          const void* e0, const void* w1, const void* b1, const void* g1,
                          const void* e1, void* out, int rows, int n, int n1, int dtype,
                          void* stream) {
  const int n0 = (n + 2 * P0 - K0) / S0 + 1;
  if (!shape_ok(rows, n, n0, n1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vap::kBF16)
    return conv01_bf16(x, w0, b0, g0, e0, w1, b1, g1, e1, out, rows, n, n0, n1, st);
  if (dtype == vap::kF32) return conv01_f32(x, w0, b0, g0, e0, w1, b1, g1, e1, out, rows, n, n0, n1, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launches each kernel of this library has taken since it was loaded.
extern "C" void vap_conv01_kernel_launches(long long* bf16_wgmma, long long* f32_tf32x3) {
  *bf16_wgmma = g_launches[0];
  *f32_tf32x3 = g_launches[1];
}

// The bfloat16 kernel's shared bytes a CTA and conv1 outputs a CTA
// (checked against ops/conv_fused.py's reckoning).
extern "C" int vap_conv01_wgmma_info(int* smem, int* tile) {
  *smem = vap::c01::SMEM_BYTES;
  *tile = vap::c01::TU;
  return 0;
}

// The same of the float32 kernel.
extern "C" int vap_conv01_tf32x3_info(int* smem, int* tile) {
  *smem = vap::c01f::SMEM_BYTES;
  *tile = vap::c01f::TU;
  return 0;
}
