// One attention row per (stream, channel, head) over the K/V rings of the
// KV-cache streamers (inference/streaming_kv.py), in one pass over the
// rings. Replaces no TPU kernel: the JAX package computes the row with two
// XLA einsums outside its Pallas kernels
// (voiceactivityprojection_tpu/inference/streaming_kv.py:147, :156), and
// the port computed it with two torch.einsums (cuBLAS gemv) and the
// elementwise passes between them. It is the plain version of
// ops/kv_attention.py `attn_row_reference`, term for term:
//
//   s_j   = (q . k_j) * scale - slope_h * age_j,   age_j = (pos - j) mod T
//   s_j   = -inf where age_j >= n_valid[stream]
//   out   = sum_j softmax_j(s)_j v_j
//
// in float32 FFMA throughout (no TF32), with the age and the mask computed
// here from the write cursor `pos` and the per-stream valid counts. The
// cursor is read from device memory, so that no host value of it is baked
// into a launch and a CUDA graph replays the row as the cursor moves; a
// cursor outside [0, T) is checked here on the card and makes the row NaN.
// q is (S, 2, H, Dh), the rings (S, 2, H, T, Dh) as init_kv_state lays them
// out, the output (S, 2, H * Dh). With `swap` (the cross rows) query
// channel c reads ring channel 1 - c by index, so neither ring nor query is
// copied to swap the channels.
//
// Bound on the card: bytes. A row reads its K and V blocks, 2 x T x Dh
// floats (512 KB at T = 1,000, Dh = 64), for 4 FLOP a slot and head
// element: about 0.5 FLOP a byte, far below any compute limit, so the
// design only has to keep HBM busy:
//
// - Each row's K and V are one contiguous block each. A group of Dh / 4
//   lanes owns one slot: lane i loads bytes [16 i, 16 i + 16) of the slot's
//   key and value rows as float4, so a warp's load covers whole slot rows
//   (512 contiguous bytes at Dh = 64) and every ring byte is read once, by
//   the lane that uses it. The loads carry the evict-first streaming hint
//   (`__ldcs`, `ld.global.cs`): a ring (1 GB at S = 512) is read once a
//   tick, so caching it would only evict other data.
// - A group issues kUnroll slots' K and V loads before it uses any, and a
//   CTA of 128 threads runs 128 / (Dh / 4) groups: 16 KB in flight a CTA
//   at Dh = 64, and with several CTAs an SM that is over 100 KB an SM,
//   enough to cover HBM's latency at full bandwidth. The loaded registers
//   are the in-flight buffer: each value is used once, by the thread that
//   loaded it, so staging it through shared memory (cp.async or TMA) would
//   add a copy and a barrier and save no byte.
// - Each group keeps an online max, sum and Dh / 4 floats of output
//   accumulator a lane; the kUnroll scores of an iteration come from one
//   butterfly over the group's lanes (every lane ends with the same sum, so
//   the group's max and sum agree), and the rescale is one exp per
//   iteration. The CTA's groups are merged through shared memory at the
//   end.
// - Only valid slots are read: the ages 0 .. n_valid - 1 are at most two
//   ranges of slots (pos - n + 1 .. pos, wrapping past 0), so a stream
//   whose ring has not filled yet reads only its filled slots.
// - One CTA a row at every S. Few rows (S = 1 has 8) leave most SMs idle,
//   but such a row takes about 0.02 ms on the device, less than the host
//   takes to launch it, and the host paces the hops and ticks at small S
//   (PERF.md, K12).
//
// Instantiated for Dh = 32, 64 and 128 (the model's 256 over 8, 4 and 2
// heads), dispatched on Dh.

#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 4;  // slots a group has in flight

// the sum over the `lanes` lanes of a group (aligned lanes of one warp); a
// butterfly, so every lane of the group gets the same sum
template <int lanes>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = lanes / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// weight of a group's partial with max m against the overall max M (0 for
// a group that saw no valid slot)
__device__ __forceinline__ float part_weight(float m, float M) {
  return m == -CUDART_INF_F ? 0.f : expf(m - M);
}

// One CTA per row r = (s * 2 + c) * H + h, writing the normalised row to
// out[r * Dh ..].
template <int Dh>
__global__ void __launch_bounds__(kThreads) kv_row_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ slopes, const int* __restrict__ n_valid, float* __restrict__ out, int H, int T,
    const long long* __restrict__ pos_at, float scale, int swap) {
  constexpr int kLanes = Dh / 4;               // lanes a slot
  constexpr int kGroups = kThreads / kLanes;   // slots a CTA loads at once, per unrolled step
  constexpr int kStep = kGroups * kUnroll;     // slots an iteration

  __shared__ float s_m[kGroups], s_l[kGroups];
  __shared__ float4 s_acc[kGroups][kLanes];

  const int row = blockIdx.x;
  const long long cursor = *pos_at;
  if (cursor < 0 || cursor >= T) {  // the same for every thread of the CTA
    if (threadIdx.x < Dh) out[static_cast<size_t>(row) * Dh + threadIdx.x] = CUDART_NAN_F;
    return;
  }
  const int pos = static_cast<int>(cursor);
  const int h = row % H;
  const int sc = row / H;  // s * 2 + c
  const int s = sc >> 1;
  const int c_ring = swap ? (sc & 1) ^ 1 : (sc & 1);
  const size_t ring_row = (static_cast<size_t>(s * 2 + c_ring) * H + h) * T * Dh;
  const float4* K = reinterpret_cast<const float4*>(k + ring_row);
  const float4* V = reinterpret_cast<const float4*>(v + ring_row);

  const int g = threadIdx.x / kLanes;
  const int lane = threadIdx.x - g * kLanes;
  const float4 q4 = reinterpret_cast<const float4*>(q + static_cast<size_t>(row) * Dh)[lane];
  const float slope = slopes[h];
  const int n = min(n_valid[s], T);

  // the valid slots, ages 0 .. n - 1: [a0, a1) and [b0, b1)
  int a0, a1, b0 = 0, b1 = 0;
  if (n >= T) {
    a0 = 0;
    a1 = T;
  } else if (pos - n + 1 >= 0) {
    a0 = pos - n + 1;
    a1 = pos + 1;
  } else {
    a0 = 0;
    a1 = pos + 1;
    b0 = T + pos - n + 1;
    b1 = T;
  }

  float m = -CUDART_INF_F, l = 0.f;
  float4 acc = zero4();
#pragma unroll 1
  for (int part = 0; part < 2; ++part) {
    const int lo = part ? b0 : a0;
    const int hi = part ? b1 : a1;
#pragma unroll 1
    for (int base = lo; base < hi; base += kStep) {
      float4 kk[kUnroll], vv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + u * kGroups + g;
        if (j < hi) {
          kk[u] = __ldcs(K + static_cast<size_t>(j) * kLanes + lane);
          vv[u] = __ldcs(V + static_cast<size_t>(j) * kLanes + lane);
        } else {
          kk[u] = zero4();
          vv[u] = zero4();
        }
      }
      float sj[kUnroll];
      float mx = m;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + u * kGroups + g;
        float d = q4.x * kk[u].x;
        d = fmaf(q4.y, kk[u].y, d);
        d = fmaf(q4.z, kk[u].z, d);
        d = fmaf(q4.w, kk[u].w, d);
        d = group_sum<kLanes>(d);
        int age = pos - j;
        if (age < 0) age += T;
        sj[u] = j < hi ? __fsub_rn(__fmul_rn(d, scale), __fmul_rn(slope, static_cast<float>(age)))
                       : -CUDART_INF_F;
        mx = fmaxf(mx, sj[u]);
      }
      const float ref = mx == -CUDART_INF_F ? 0.f : mx;
      const float alpha = expf(m - ref);
      l *= alpha;
      acc.x *= alpha;
      acc.y *= alpha;
      acc.z *= alpha;
      acc.w *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = expf(sj[u] - ref);
        l += p;
        acc.x = fmaf(p, vv[u].x, acc.x);
        acc.y = fmaf(p, vv[u].y, acc.y);
        acc.z = fmaf(p, vv[u].z, acc.z);
        acc.w = fmaf(p, vv[u].w, acc.w);
      }
      m = mx;
    }
  }

  // merge the CTA's groups
  if (lane == 0) {
    s_m[g] = m;
    s_l[g] = l;
  }
  s_acc[g][lane] = acc;
  __syncthreads();
  if (threadIdx.x >= Dh) return;
  const int d = threadIdx.x;
  float M = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < kGroups; ++i) M = fmaxf(M, s_m[i]);
  float L = 0.f, O = 0.f;
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const float w = part_weight(s_m[i], M);
    L = fmaf(s_l[i], w, L);
    O = fmaf(reinterpret_cast<const float*>(&s_acc[i][0])[d], w, O);
  }
  out[static_cast<size_t>(row) * Dh + d] = O / L;
}

template <int Dh>
int launch(const float* q, const float* k, const float* v, const float* slopes, const int* n_valid, float* out,
           int rows, int H, int T, const long long* pos_at, float scale, int swap, cudaStream_t st) {
  kv_row_kernel<Dh><<<rows, kThreads, 0, st>>>(q, k, v, slopes, n_valid, out, H, T, pos_at, scale, swap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (S, 2, H, Dh), k and v (S, 2, H, T, Dh), slopes (H,), out (S, 2, H * Dh):
// float32, contiguous, 16-byte aligned; n_valid (S,) int32; pos_at one int64
// in device memory, the slot just written, 0 <= *pos_at < T (checked on the
// card: the rows turn NaN outside). One launch. Returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape it does not take).
extern "C" int vap_kv_attention_row(const void* q, const void* k, const void* v, const void* slopes,
                                    const void* n_valid, void* out, int S, int H, int T, int Dh,
                                    const void* pos_at, float scale, int swap, void* stream) {
  const long long rows = 2LL * S * H;
  if (S < 1 || H < 1 || T < 1 || pos_at == nullptr || rows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* sf = static_cast<const float*>(slopes);
  const auto* nv = static_cast<const int*>(n_valid);
  const auto* pa = static_cast<const long long*>(pos_at);
  auto* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int r = static_cast<int>(rows);
  switch (Dh) {
    case 32:
      return launch<32>(qf, kf, vf, sf, nv, of, r, H, T, pa, scale, swap, st);
    case 64:
      return launch<64>(qf, kf, vf, sf, nv, of, r, H, T, pa, scale, swap, st);
    case 128:
      return launch<128>(qf, kf, vf, sf, nv, of, r, H, T, pa, scale, swap, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
