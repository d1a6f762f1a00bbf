// K13: the transformer's float32 projections, y = x W^T, on the tensor
// cores in 3xTF32 (every q / k / v / output projection of
// models/transformer.py and ops/attention.py, the FFN's two matrices and the
// combinator, forward and backward).
//
// It replaces no TPU kernel: the JAX package leaves these products to XLA
// (voiceactivityprojection_tpu/models/transformer.py, ops/attention.py).
// On the card cuBLAS runs a float32 product with TF32 off on the CUDA cores
// (67 TFLOP/s of FFMA at most); one TF32 pass on the tensor cores is not
// float32 (2^-11 a product). 3xTF32 is: each operand v is split as hi =
// rna(v), lo = rna(v - hi), both tf32, and x W^T = x_lo W_hi + x_hi W_lo +
// x_hi W_hi (the dropped x_lo W_lo is below 2^-22 of each product), three
// m64nNk8 tf32 `wgmma` products at 495 TFLOP/s.
//
// Bound on this card: operations at three TF32 products (3 x 0.89 TFLOP a
// B = 64 x 20 s request: 5.4 ms), with the bytes close behind (each
// projection reads its input and writes its output once: 11.5 GB, 3.4 ms
// at 3.35 TB/s). K = 256 is near the ridge, so the design keeps the
// loads, the products and the stores of the output apart in time:
// - one producer warp streams 32-float-deep k-chunks of A and of W's hi and
//   lo by TMA (128-byte swizzle) into a ring of mbarrier stages;
// - two consumer warpgroups of 64 rows (BM = 128) each read their A
//   fragments from the stage into registers and split them there (tf32
//   `wgmma` reads shared memory K-major only; A from registers needs no
//   second tile), then issue the chunk's 4 k-steps x 3 products into a
//   fresh m64nBN accumulator (BN = 128, or 64 for a width of 64 x odd) and
//   add it to the running sum with FADD: the tensor cores' accumulation
//   truncates, so a sum fed straight by `wgmma` drifts toward zero (2.3e-6
//   of the largest output at K = 256, 6.1e-6 at 768 against 3.7e-7 and
//   4.2e-7 so, at the same speed; cuBLAS in FFMA 7.8e-7 and 1.4e-6). The
//   other warpgroup's products run while one splits its next fragments or
//   adds its last chunk;
// - the CTAs are persistent (one an SM) and walk the output tiles with the
//   N tiles of one row block next to each other (A read once from device
//   memory, then from L2); the producer runs ahead into the next tile while
//   the consumers store the last one from registers, so a tile's epilogue
//   overlaps the next tile's loads.
// W's halves are split once per weight version by `split_tf32_kernel`
// (ops/linear.py keeps them), which also writes W^T's halves for dX; their
// tensor maps are encoded once with them, in the same call. A launch
// encodes only its activations' maps; the device binding and the shared
// memory attribute are set once a thread and once a device, so the host's
// part of a launch stays near a plain kernel launch's.
//
// The backward runs the same kernel: dX = dY W with W^T's halves as B; dW
// = dY^T X (WGRAD) with dY and X streamed as they lie (the contraction runs
// down their rows), dY read transposed out of its stage into registers and
// X transposed and split in shared memory by the consumers (no transposed
// copy in device memory), the contraction (16,000-128,000 rows) cut into
// slices whose partial tiles `slice_sum_kernel` adds in a fixed order (no
// atomics).
//
// Epilogues: the exact-erf GELU (the FFN's up-projection without autograd)
// and a residual added to the output (where no dropout lies between).

#include <atomic>
#include <cstring>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

namespace wg = vap::wg;

__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// ---- m64nBNk8 tf32 products, A from registers, B K-major ---------------------
#define VAP_F8(d, i)                                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
      "+f"(d[i + 7])
#define VAP_F32(d, i) VAP_F8(d, i), VAP_F8(d, i + 8), VAP_F8(d, i + 16), VAP_F8(d, i + 24)

template <int BN> struct Mma;
template <> struct Mma<64> {
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int acc) {
    wg::mma_tf32_rs(d, a, b, acc);
  }
};
template <> struct Mma<128> {
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : VAP_F32(d, 0), VAP_F32(d, 32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};
template <int N>
__device__ __forceinline__ void pin_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---- the GEMM -----------------------------------------------------------------
constexpr int KC = 32;             // floats of a k-chunk: one 128-byte swizzle row
constexpr int SMEM_LIMIT = 232448; // one CTA an SM

struct Params {
  float* out;             // (M, ldo), or slice s at out + s * slice_stride
  const float* residual;  // (M, ldo) added to the output, or null
  int M, N;               // output rows and columns (N a multiple of BN)
  int kchunks;            // the contraction in KC-float chunks
  int ldo;
  int gelu;               // exact-erf GELU on the output
  int slices, slice_chunks;
  long long slice_stride;
};

// BN output columns and BM = 64 NWG rows a tile (NWG consumer
// warpgroups). A stage holds A's chunk and B's halves. WGRAD (dW = dY^T X):
// both operands are row-major (contraction, columns) matrices, dY and X, so
// a stage holds each chunk's KC contraction rows x BM (BN) columns as
// panels of 32 x 32 floats, as they lie; A is read transposed out of its
// panels into registers, and the consumers write B's halves K-major into
// one of two buffers beside the ring (tf32 `wgmma` reads shared memory
// K-major only).
template <int BN_, bool WGRAD_>
struct Cfg {
  static constexpr int BN = BN_, NWG = 2, BM = 64 * NWG;
  static constexpr bool WGRAD = WGRAD_;
  static constexpr int A_BYTES = BM * KC * 4;
  static constexpr int B_BYTES = BN * KC * 4;  // one half, or X's panels
  static constexpr int STAGE = A_BYTES + (WGRAD ? 1 : 2) * B_BYTES;
  static constexpr int SPLIT_BYTES = WGRAD ? 4 * B_BYTES : 0;  // two buffers of B's halves
  static constexpr int STAGES_FIT = (SMEM_LIMIT - 1024 - 256 - SPLIT_BYTES) / STAGE;
  static constexpr int STAGES = STAGES_FIT > 6 ? 6 : STAGES_FIT;
  static constexpr int SMEM = STAGES * STAGE + SPLIT_BYTES + 1024 + 16 * STAGES;
  static constexpr int NT = NWG * 128 + 32;  // the consumers, then the producer warp
  static_assert(STAGES >= 2, "a ring of at least two stages");
  static_assert(SMEM <= SMEM_LIMIT, "one CTA an SM");
};

// the byte offset of float (row r, column c) of a stage's transposed
// operand: 32 x 32 panels side by side, each 32 rows of 128 bytes swizzled
__device__ __forceinline__ uint32_t panel_off(int r, int c) {
  return (c >> 5) * 4096 + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) + 4 * (c & 3);
}

__device__ __forceinline__ void decode_tile(int t, int tiles_n, int slices, int& mt, int& nt, int& sl) {
  sl = t % slices;
  const int rest = t / slices;
  nt = rest % tiles_n;
  mt = rest / tiles_n;
}

__device__ __forceinline__ float gelu_erf(float x) {
  return x * 0.5f * (1.0f + erff(x * 0.70710678118654752440f));
}

template <class C>
__global__ void __launch_bounds__(C::NT, 1)
    gemm_tf32x3_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bhmap,
                       const __grid_constant__ CUtensorMap blmap, const Params p) {
  extern __shared__ uint8_t raw[];
  const uint32_t S = wg::align1024(raw);
  const uint32_t split = S + C::STAGES * C::STAGE;  // WGRAD: B's halves, two buffers
  const uint32_t full = split + C::SPLIT_BYTES, empty = full + 8 * C::STAGES;
  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int tiles_m = (p.M + C::BM - 1) / C::BM, tiles_n = p.N / C::BN;
  const int tiles = tiles_m * tiles_n * p.slices;

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      wg::mbar_init(full + 8 * s, 1);
      wg::mbar_init(empty + 8 * s, C::NWG);
    }
    wg::fence_mbar_init();
  }
  __syncthreads();

  if (warp == 4 * C::NWG) {
    // ---- the producer: one thread keeps the ring full ----------------------
    if ((tid & 31) == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int mt, nt, sl;
        decode_tile(t, tiles_n, p.slices, mt, nt, sl);
        const int c0 = sl * p.slice_chunks, c1 = min(p.kchunks, c0 + p.slice_chunks);
        for (int c = c0; c < c1; ++c) {
          wg::mbar_wait(empty + 8 * stage, phase ^ 1);  // the consumers released the stage's last chunk
          const uint32_t base = S + stage * C::STAGE, bar = full + 8 * stage;
          wg::mbar_expect_tx(bar, C::STAGE);
          if constexpr (C::WGRAD) {
#pragma unroll
            for (int pn = 0; pn < C::BM / 32; ++pn) wg::tma_load(base + pn * 4096, &amap, mt * C::BM + 32 * pn, KC * c, bar);
#pragma unroll
            for (int pn = 0; pn < C::BN / 32; ++pn)
              wg::tma_load(base + C::A_BYTES + pn * 4096, &bhmap, nt * C::BN + 32 * pn, KC * c, bar);
          } else {
            wg::tma_load(base, &amap, KC * c, mt * C::BM, bar);
            wg::tma_load(base + C::A_BYTES, &bhmap, KC * c, nt * C::BN, bar);
            wg::tma_load(base + C::A_BYTES + C::B_BYTES, &blmap, KC * c, nt * C::BN, bar);
          }
          if (++stage == C::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- the consumers ---------------------------------------------------------
  const int q = warp >> 2;  // warpgroup: rows 64 q .. 64 q + 63 of a tile
  const int wt = tid & 127;
  const int fr = wg::acc_row(wt, 0), fc = wt & 3;
  constexpr int NACC = C::BN / 2;
  // WGRAD: B's halves of the chunk at src (X's panels) into the buffer at
  // hi (lo one half further), K-major: a thread splits X's column n (B's
  // row n) over GS groups of four contraction rows, each into one 16-byte
  // chunk of each half
  auto split_b = [&](uint32_t src, uint32_t hi) {
    constexpr int GS = C::BN / 32;
    const int n = tid % C::BN, g0 = tid / C::BN * GS;
#pragma unroll
    for (int g = g0; g < g0 + GS; ++g) {
      uint32_t vh[4], vl[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = ld_shared_f32(src + panel_off(4 * g + j, n));
        vh[j] = wg::tf32_rna(v);
        vl[j] = wg::tf32_rna(v - __uint_as_float(vh[j]));
      }
      wg::st_shared_v4(hi + wg::swz(n, g), vh[0], vh[1], vh[2], vh[3]);
      wg::st_shared_v4(hi + C::B_BYTES + wg::swz(n, g), vl[0], vl[1], vl[2], vl[3]);
    }
  };
  int stage = 0, it = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int mt, nt, sl;
    decode_tile(t, tiles_n, p.slices, mt, nt, sl);
    const int c0 = sl * p.slice_chunks, c1 = min(p.kchunks, c0 + p.slice_chunks);
    float acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

    for (int c = c0; c < c1; ++c, ++it) {
      wg::mbar_wait(full + 8 * stage, phase);
      const uint32_t base = S + stage * C::STAGE;
      uint32_t bh = base + C::A_BYTES;
      if constexpr (C::WGRAD) {
        // this chunk's halves of B into buffer it % 2, which chunk it - 2
        // read last: every warpgroup waited for those products before the
        // barrier of chunk it - 1
        bh = split + (it & 1) * 2 * C::B_BYTES;
        split_b(base + C::A_BYTES, bh);
        wg::fence_proxy_async();
        asm volatile("bar.sync 1, %0;\n" ::"n"(C::NWG * 128) : "memory");  // both warpgroups' halves written
      }
      const uint32_t bl = bh + C::B_BYTES;
      // the A fragments of the chunk's 4 k-steps, split: register f holds
      // row fr + 8 (f % 2), column 8 kk + fc + 4 (f / 2) of the warpgroup's rows
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int r = 64 * q + fr + 8 * (f & 1), k = 8 * kk + fc + 4 * (f >> 1);
          uint32_t addr;
          if constexpr (C::WGRAD)  // row k of the panels, column r
            addr = base + panel_off(k, r);
          else
            addr = base + r * 128 + (((k >> 2) ^ (r & 7)) << 4) + 4 * (k & 3);
          const float v = ld_shared_f32(addr);
          ahi[kk][f] = wg::tf32_rna(v);
          alo[kk][f] = wg::tf32_rna(v - __uint_as_float(ahi[kk][f]));
        }
      // the chunk's 12 products into a fresh accumulator, added to acc
      float f[NACC];
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        Mma<C::BN>::rs(f, alo[kk], wg::desc_k(bh, kk), kk > 0);
        Mma<C::BN>::rs(f, ahi[kk], wg::desc_k(bl, kk), 1);
        Mma<C::BN>::rs(f, ahi[kk], wg::desc_k(bh, kk), 1);
      }
      wg::commit();
      wg::wait<0>();
      pin_acc(f);
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] += f[i];
      if (wt == 0) wg::mbar_arrive(empty + 8 * stage);  // the warpgroup's products have read the stage
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // ---- epilogue: rows fr, fr + 8 of the warpgroup, two columns a group of 8
    float* out = p.out + static_cast<long long>(sl) * p.slice_stride;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = mt * C::BM + 64 * q + fr + 8 * h;
      if (row >= p.M) continue;
      const size_t o = static_cast<size_t>(row) * p.ldo + nt * C::BN + 2 * fc;
#pragma unroll
      for (int j = 0; j < C::BN / 8; ++j) {
        float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        if (p.gelu) {
          v.x = gelu_erf(v.x);
          v.y = gelu_erf(v.y);
        }
        if (p.residual != nullptr) {
          const float2 r = *reinterpret_cast<const float2*>(p.residual + o + 8 * j);
          v.x = r.x + v.x;
          v.y = r.y + v.y;
        }
        *reinterpret_cast<float2*>(out + o + 8 * j) = v;
      }
    }
  }
}

// ---- the split of the weights into their tf32 halves ---------------------------
// Up to three row-major (rows_i, cols) weights stacked along the rows (R =
// their sum): hi, lo (R, cols) their halves as they lie, hiT, loT (cols, R)
// transposed. Grid (cols / 32, R / 32, both rounded up), block (32, 8): a
// 32 x 32 tile through shared memory.
struct Sources {
  const float* p[3];
  int rows[3];
};

__device__ __forceinline__ void split_store(float* hi, float* lo, size_t o, float v) {
  const uint32_t h = wg::tf32_rna(v);
  hi[o] = __uint_as_float(h);
  lo[o] = __uint_as_float(wg::tf32_rna(v - __uint_as_float(h)));
}

__global__ void split_tf32_kernel(const Sources src, int R, int cols, float* __restrict__ hi,
                                  float* __restrict__ lo, float* __restrict__ hiT, float* __restrict__ loT) {
  __shared__ float tile[32][33];
  const int r0 = 32 * blockIdx.y, c0 = 32 * blockIdx.x;
  const int c = c0 + threadIdx.x;
  for (int j = threadIdx.y; j < 32; j += 8) {
    const int r = r0 + j;
    float v = 0.f;
    if (r < R && c < cols) {
      int i = 0, rr = r;
      while (rr >= src.rows[i]) rr -= src.rows[i++];
      v = src.p[i][static_cast<size_t>(rr) * cols + c];
      split_store(hi, lo, static_cast<size_t>(r) * cols + c, v);
    }
    tile[j][threadIdx.x] = v;
  }
  __syncthreads();
  const int r = r0 + threadIdx.x;
  for (int j = threadIdx.y; j < 32; j += 8) {
    const int cc = c0 + j;
    if (r < R && cc < cols) split_store(hiT, loT, static_cast<size_t>(cc) * R + r, tile[threadIdx.x][j]);
  }
}

// out[i] = sum over s of ws[s n + i], s in order: the slices of dW (n a multiple of 4)
__global__ void slice_sum_kernel(const float4* __restrict__ ws, float4* __restrict__ out, long long n4, int slices) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 a = ws[i];
  for (int s = 1; s < slices; ++s) {
    const float4 b = ws[static_cast<long long>(s) * n4 + i];
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  out[i] = a;
}

// ---- host side ------------------------------------------------------------------
// a row-major (rows, cols) float32 matrix with rows ld floats apart, read in
// boxes of box_rows x 32 floats under the 128-byte swizzle; zeros outside
bool encode(CUtensorMap* map, const void* base, int rows, int cols, int ld, int box_rows) {
  wg::EncodeTiled fn = wg::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * sizeof(float)};
  const cuuint32_t box[2] = {KC, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// the kernel's variants, by the id ops/linear.py passes
using V0 = Cfg<128, false>;  // forward and dX, N % 128 == 0
using V1 = Cfg<64, false>;   // forward and dX, N % 64 == 0
using V2 = Cfg<128, true>;   // dW, N % 128 == 0
using V3 = Cfg<64, true>;    // dW, N % 64 == 0

// bind this host thread to the device's primary context, once a thread and
// device: a thread of the autograd engine can reach a launch before any
// other runtime call of its own, and the attribute below is then refused
cudaError_t bind_device(int* dev) {
  thread_local int bound = -1;
  cudaError_t e = cudaGetDevice(dev);
  if (e == cudaSuccess && *dev != bound) {
    e = cudaSetDevice(*dev);
    if (e == cudaSuccess) bound = *dev;
  }
  return e;
}

// the variant's dynamic shared memory, set once a device (every device
// past the 64th at each launch)
template <class C>
cudaError_t smem_attribute(int dev) {
  static std::atomic<unsigned long long> set{0};
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (bit != 0 && (set.load(std::memory_order_acquire) & bit) != 0) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(gemm_tf32x3_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e == cudaSuccess) set.fetch_or(bit, std::memory_order_release);
  return e;
}

template <class C>
int launch(const void* a, int wgrad, int lda, const void* b, int ldb, const void* b_maps, const Params& p, int kdim,
           cudaStream_t st) {
  if (static_cast<bool>(wgrad) != C::WGRAD || p.N % C::BN != 0 || (!C::WGRAD && b_maps == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = bind_device(&dev);
  if (e == cudaSuccess) e = smem_attribute<C>(dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap am, bhm, blm;
  bool ok;
  if (C::WGRAD) {
    ok = encode(&am, a, kdim, p.M, lda, 32) && encode(&bhm, b, kdim, p.N, ldb, 32);
  } else {
    ok = encode(&am, a, p.M, kdim, lda, C::BM);
    std::memcpy(&bhm, b_maps, sizeof(CUtensorMap));
    std::memcpy(&blm, static_cast<const char*>(b_maps) + sizeof(CUtensorMap), sizeof(CUtensorMap));
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = static_cast<long long>((p.M + C::BM - 1) / C::BM) * (p.N / C::BN) * p.slices;
  const int grid = static_cast<int>(tiles < sm_count() ? tiles : sm_count());
  gemm_tf32x3_kernel<C><<<grid, C::NT, C::SMEM, st>>>(am, bhm, blm, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (M, N) [+ slice s at out + s * M * ldo] = A B^T in 3xTF32 over a
// contraction of kdim floats (read in 32-float chunks, zeros past kdim, so
// kdim need not be a multiple of 32): A (M, kdim) row-major with rows lda
// floats apart; B's halves (N, kdim) read through the two tensor maps at
// b_maps, as vap_linear_split wrote them (b and ldb not read); with wgrad
// (variants 2, 3) A is the (kdim, M) matrix at a and B the (kdim, N) matrix
// at b, rows ldb floats apart, both as they lie (b_maps not read). Each
// slice sums slice_chunks 32-float chunks of the contraction.
// gelu: the exact-erf GELU of the output; residual (M, ldo) or null: added
// to it. Every pointer 16-byte aligned, lda, ldb multiples of 4, ldo even.
// Returns cudaGetLastError() or the refusal of a shape (cudaErrorInvalidValue).
extern "C" int vap_linear_gemm(const void* a, int wgrad, int lda, const void* b, int ldb, const void* b_maps,
                               void* out, const void* residual, int M, int N, int kdim, int ldo, int gelu,
                               int slices, int slice_chunks, int variant, void* stream) {
  const int kchunks = (kdim + KC - 1) / KC;
  if (M < 1 || N < 1 || kdim < 1 || slices < 1 || slice_chunks < 1 ||
      static_cast<long long>(slices) * slice_chunks < kchunks || (lda | ldb) % 4 != 0 || ldo % 2 != 0 ||
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(out) |
        reinterpret_cast<uintptr_t>(residual)) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<float*>(out), static_cast<const float*>(residual), M, N, kchunks, ldo, gelu,
                 slices, slice_chunks, static_cast<long long>(M) * ldo};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {
    case 0: rc = launch<V0>(a, wgrad, lda, b, ldb, b_maps, p, kdim, st); break;
    case 1: rc = launch<V1>(a, wgrad, lda, b, ldb, b_maps, p, kdim, st); break;
    case 2: rc = launch<V2>(a, wgrad, lda, b, ldb, b_maps, p, kdim, st); break;
    case 3: rc = launch<V3>(a, wgrad, lda, b, ldb, b_maps, p, kdim, st); break;
    default: break;
  }
  return rc;
}

// Up to three row-major float32 weights (rows a_rows, b_rows, c_rows; a
// null pointer with 0 rows past the last), cols wide, stacked along the
// rows into R = their sum: halves (2, R, cols) their tf32 hi then lo,
// halves_t (2, cols, R) the same transposed. maps, if not null (4 x 128
// bytes, any alignment): the tensor maps vap_linear_gemm's b_maps takes,
// halves' hi and lo as the forward variants read them, then halves_t's as
// the dX variants do (each at its rows' tile width, 128 or 64).
extern "C" int vap_linear_split(const void* a, const void* b, const void* c, int a_rows, int b_rows, int c_rows,
                                int cols, void* halves, void* halves_t, void* maps, void* stream) {
  const int R = a_rows + b_rows + c_rows;
  if (cols < 1 || a_rows < 1 || b_rows < 0 || c_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (maps != nullptr) {
    if (R % 64 != 0 || cols % 64 != 0) return static_cast<int>(cudaErrorInvalidValue);
    const float* h = static_cast<const float*>(halves);
    const float* t = static_cast<const float*>(halves_t);
    const size_t n = static_cast<size_t>(R) * cols;
    CUtensorMap m[4];
    if (!encode(&m[0], h, R, cols, cols, R % 128 == 0 ? 128 : 64) ||
        !encode(&m[1], h + n, R, cols, cols, R % 128 == 0 ? 128 : 64) ||
        !encode(&m[2], t, cols, R, R, cols % 128 == 0 ? 128 : 64) ||
        !encode(&m[3], t + n, cols, R, R, cols % 128 == 0 ? 128 : 64))
      return static_cast<int>(cudaErrorInvalidValue);
    std::memcpy(maps, m, sizeof(m));
  }
  const Sources s{{static_cast<const float*>(a), static_cast<const float*>(b), static_cast<const float*>(c)},
                  {a_rows, b_rows, c_rows}};
  const size_t n = static_cast<size_t>(R) * cols;
  float* h = static_cast<float*>(halves);
  float* t = static_cast<float*>(halves_t);
  const dim3 grid((cols + 31) / 32, (R + 31) / 32);
  split_tf32_kernel<<<grid, dim3(32, 8), 0, static_cast<cudaStream_t>(stream)>>>(s, R, cols, h, h + n, t, t + n);
  return static_cast<int>(cudaGetLastError());
}

// out (n floats, n a multiple of 4, 16-byte aligned) = the sum of the
// slices ws[s n .. s n + n), s = 0 .. slices - 1 in order
extern "C" int vap_linear_slice_sum(const void* ws, void* out, long long n, int slices, void* stream) {
  if (n < 4 || n % 4 != 0 || slices < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = n / 4;
  slice_sum_kernel<<<static_cast<unsigned>((n4 + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(ws), static_cast<float4*>(out), n4, slices);
  return static_cast<int>(cudaGetLastError());
}
