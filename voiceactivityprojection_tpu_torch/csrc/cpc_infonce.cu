// K14: the CPC loss's InfoNCE scoring (train/cpc_pretrain.py cpc_loss),
// forward and backward, one CTA a context row. Replaces no TPU kernel: the
// JAX package scores the negatives with XLA einsums
// (voiceactivityprojection_tpu/train/cpc_pretrain.py cpc_loss), and the
// port did it with a gather into a (B, Tc, N, C) tensor, one batched gemv a
// head and, in the backward, one gradient of that tensor a head and a
// scatter into z. It is ops/cpc_infonce.py `infonce_reference`, term for
// term: for a context row (b, t) and head k (0-based, predicting t + k + 1)
//
//   s_pos[k]  = P[k] . z[b, t + k + 1]
//   s_n[k]    = P[k] . z[idx[b, t, n]]                      n < N
//   loss      = mean over k, b, t of  lse_k - s_pos[k],  lse_k = log(e^s_pos + sum_n e^s_n)
//   hit[k]    = s_pos[k] >= every s_n[k]          (argmax's first index is the positive)
//
// in float32 FFMA (no TF32), with P = preds[k, b, t] (K <= 16) and z the
// (B * T, 256) encodings.
//
// Bound on the card: operations, with every byte from L2. A context row
// scores K + N rows of z (its K positives, then its N negatives) against K
// predictions: 2 (K + N) K C FLOP, 2.9 GFLOP a step at B=32, T=128, K=12,
// N=128 (43 us at 67 TFLOP/s); the backward adds dP = dS^T Z and dZ = dS P,
// twice that again. The rows are gathered from z (4.2 MB, which stays in
// the 50 MB L2), so no (B, Tc, N, C) tensor is written.
//
// - The list of a context row: entry j < K is the positive of head j, entry
//   K + n the negative idx[b, t, n]. The entries are streamed in chunks of
//   kRows whole rows of z with 16-byte cp.async loads (kStages stages, two
//   chunks in flight while one is scored, one barrier a chunk); an index outside [0, B * T) is
//   not read and makes the row's loss NaN (and its gradients NaN, no dz
//   written for it), as K12 marks a bad cursor.
// - Scoring: a warp scores kBatch rows at once. Lane l holds the K
//   predictions' float4 columns l and l + 32 in registers (read once a
//   context row), sums its 8 columns of every (row, head) in a fixed order
//   and the warp adds the 32 partials in a reduce-scatter over the lanes
//   (Scatter: halve while even, then a butterfly), after which each (row,
//   head) score is whole in one lane (two at K = 12). So a z value read
//   from shared memory feeds K FFMAs and the predictions are never read
//   from shared memory in the loop. Every entry, positive or negative, in
//   any slot, is summed by the same tree, so a negative that is the
//   positive's row ties it exactly, and the backward's recomputed scores
//   are the forward's bit for bit.
// - Forward: the lane holding a (row, head) score keeps that slot's online
//   max and sum of exp and its largest negative; the slots of a head are
//   merged in a fixed order. The kernel writes each (k, b, t)'s
//   log-sum-exp (saved for the backward) and its loss and hit; a one-CTA
//   kernel sums them in a fixed order (in double), so the loss is the same
//   bit for bit from run to run.
// - Backward: the scores are recomputed (cheaper than saving K (N + 1) of
//   them a row) and dS = g / (K B Tc) (softmax - onehot_pos) goes to shared
//   memory. Each warp adds dz[row] += sum_k dS[r][k] P[k] for its rows from
//   the predictions in its registers with 16-byte red.global.add into dz
//   (4.2 MB, in L2); thread (p, q) sums dP[k][q] += dS[r][k] z_r[q] over the
//   rows of parity p for every head, in registers, and the two parities are
//   added in shared memory and written once at the end. The order of the
//   additions into dz changes from run to run; dP's and the loss's do not.
// - What bounds it in practice: each pass streams 520 MB of gathered rows
//   from L2 (K + N = 140 rows of 1 KB a context row), which alone takes
//   about 0.16 ms on the card, and the scoring's reduce-scatter and the
//   pipeline's barriers leave the FFMA pipes about a fifth busy (PERF.md,
//   K14).
//
// One instantiation a rounded-up head count KP = 4, 8, 12, 16 (padded heads
// read zero predictions and get no gradient).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kC = 256;                   // encoding width (the configs' hiddenEncoder)
constexpr int kC4 = kC / 4;               // float4 a row
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 4;                 // list rows a warp scores at once
constexpr int kRows = kWarps * kBatch;    // list rows a chunk
constexpr int kMaxK = 16;
constexpr int kStages = 4;                // chunks in shared memory: two in flight while one is scored
constexpr int kRowSlots = kStages + 1;    // chunks whose z rows are known at once
constexpr int kFinishThreads = 1024;

// halvings of n partial sums over a warp's lanes (offsets 16, 8, ...):
// while n is even, at most five
constexpr int halvings(int n, int h = 0) { return h < 5 && n % 2 == 0 ? halvings(n / 2, h + 1) : h; }

// The reduce-scatter of a warp's kBatch x KP scores: each lane starts with
// its partial sum of every (row, head) and ends with kLeft whole sums, of
// indices base(lane) + i; lanes that differ in the bits below the last
// halving's offset hold the same sums.
template <int KP>
struct Scatter {
  static constexpr int kN = kBatch * KP;
  static constexpr int kH = halvings(kN);
  static constexpr int kLeft = kN >> kH;
  static constexpr int kDup = (16 >> (kH - 1)) - 1;
  static_assert(kH >= 1 && kH <= 5, "a warp's scores halve at least once");
  __device__ static int base(int lane) {
    int b = 0;
#pragma unroll
    for (int s = 0; s < kH; ++s) b += (lane & (16 >> s)) ? (kN >> (s + 1)) : 0;
    return b;
  }
};

template <int KP>
struct Smem {
  static constexpr int kZ = kStages * kRows * kC;  // the stages of a chunk's rows
  static constexpr int kP = KP * kC;               // the context row's predictions
  static constexpr int kS = kRows * KP;            // a chunk's dS (backward)
  static constexpr int kState = 3 * kRows * KP;    // each (warp, batch row)'s max, sum, largest negative a head
  static constexpr int kFloats = kZ + kP + kS + kState + 2 * KP;  // + the positives' scores, the lse
  static constexpr size_t bytes = sizeof(float) * kFloats + sizeof(int) * (kRowSlots * kRows + 1);
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // zero fill without a read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_behind() {  // all but the kStages - 2 newest groups landed
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

__device__ __forceinline__ void red_add4(float* dst, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(dst), v);  // red.global.add.v4.f32 on sm_90
}

// the index a negative list entry j reads (0 for the others), fetched a
// chunk before list_row needs it
__device__ __forceinline__ long long list_index(int j, int K, int N, const long long* idx_row) {
  return j >= K && j < K + N ? idx_row[j - K] : 0;
}

// the z row of list entry j of the context row at z row zt0: j < K the
// positive of head j, then the N negatives (index v); -1 for an index
// outside [0, BT), -2 past the list
__device__ __forceinline__ int list_row(int j, long long v, int K, int N, int zt0, int BT) {
  if (j < K) return zt0 + 1 + j;
  if (j >= K + N) return -2;
  return (v >= 0 && v < BT) ? static_cast<int>(v) : -1;
}

// the chunk's rows into a stage (rows < 0 zero-filled)
__device__ __forceinline__ void load_chunk(float* stage, const int* rows, const float* z) {
#pragma unroll
  for (int i = 0; i < kRows * kC4 / kThreads; ++i) {
    const int p = threadIdx.x + i * kThreads;
    const int r = p / kC4, q = p - r * kC4;
    const int zr = rows[r];
    cp_async16(stage + r * kC + 4 * q, z + static_cast<size_t>(zr >= 0 ? zr : 0) * kC + 4 * q, zr >= 0);
  }
}

// the context row's K predictions, zero rows up to KP
template <int KP>
__device__ __forceinline__ void load_preds(float* ps, const float* prow, long long ps_k, int K) {
#pragma unroll
  for (int i = 0; i < KP * kC4 / kThreads; ++i) {
    const int p = threadIdx.x + i * kThreads;
    const int k = p / kC4, q = p - k * kC4;
    cp_async16(ps + k * kC + 4 * q, prow + (k < K ? k * ps_k : 0) + 4 * q, k < K);
  }
}

// step ST of the reduce-scatter: a halving at offset 16 >> ST while
// Scatter says so, then butterflies (every index known at compile time, so
// v stays in registers)
template <int KP, int ST>
__device__ __forceinline__ void scatter(float (&v)[Scatter<KP>::kN], int lane) {
  using X = Scatter<KP>;
  if constexpr (ST < 5) {
    constexpr int o = 16 >> ST;
    if constexpr (ST < X::kH) {
      constexpr int half = X::kN >> (ST + 1);
      const bool up = lane & o;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float send = up ? v[i] : v[i + half];
        const float keep = up ? v[i + half] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
    } else {
#pragma unroll
      for (int i = 0; i < X::kLeft; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
    }
    scatter<KP, ST + 1>(v, lane);
  }
}

// The scores of list rows r0 .. r0 + kBatch - 1 of a chunk against the K
// predictions, which lane holds as p0[k] = P[k][lane], p1[k] = P[k][lane +
// 32] (float4 columns): each lane sums its 8 columns of every (row, head)
// in a fixed order, then the warp's reduce-scatter (Scatter) adds the 32
// partials in one tree. Every row, positive or negative, in any slot, is
// summed by the same tree, so equal rows score equal bit for bit.
template <int KP>
__device__ __forceinline__ void score_batch(const float* zc, int r0, const float4 (&p0)[KP], const float4 (&p1)[KP],
                                            int lane, float (&out)[Scatter<KP>::kLeft]) {
  using X = Scatter<KP>;
  float v[X::kN];
#pragma unroll
  for (int rb = 0; rb < kBatch; ++rb) {
    const float4* zr = reinterpret_cast<const float4*>(zc + (r0 + rb) * kC);
    const float4 a = zr[lane], b = zr[lane + 32];
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      float t = a.x * p0[k].x;
      t = fmaf(a.y, p0[k].y, t);
      t = fmaf(a.z, p0[k].z, t);
      t = fmaf(a.w, p0[k].w, t);
      t = fmaf(b.x, p1[k].x, t);
      t = fmaf(b.y, p1[k].y, t);
      t = fmaf(b.z, p1[k].z, t);
      t = fmaf(b.w, p1[k].w, t);
      v[rb * KP + k] = t;
    }
  }
  scatter<KP, 0>(v, lane);
#pragma unroll
  for (int i = 0; i < X::kLeft; ++i) out[i] = v[i];
}

// the context row's predictions for a lane, from shared memory
template <int KP>
__device__ __forceinline__ void lane_preds(const float* ps, int lane, float4 (&p0)[KP], float4 (&p1)[KP]) {
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    p0[k] = reinterpret_cast<const float4*>(ps + k * kC)[lane];
    p1[k] = reinterpret_cast<const float4*>(ps + k * kC)[lane + 32];
  }
}

__device__ __forceinline__ void online(float& m, float& l, float v) {
  if (v > m) {
    l = fmaf(l, expf(m - v), 1.f);
    m = v;
  } else {
    l += expf(v - m);
  }
}

struct Args {
  const float* z;
  const float* preds;
  const long long* idx;
  int T, Tc, N, K, BT;
  long long ps_k, ps_b, ps_t;
};

// The pipeline both kernels share: chunk c of the list is in stage
// c % kStages, its z rows in slot c % kRowSlots, with the next kStages - 2
// chunks in flight; body(c, stage, rows) runs once chunk c has landed, on
// every thread. One barrier a chunk: it makes chunk c and the rows of
// chunk c + kStages - 1 visible, and frees the stage chunk c - 1 used,
// which chunk c + kStages - 1 is then loaded into.
template <int KP, typename Body>
__device__ __forceinline__ void stream_list(const Args& a, float* zs, float* ps, int* rows_s, int cta, Body body) {
  const int b = cta / a.Tc, t = cta - b * a.Tc;
  const int zt0 = b * a.T + t;
  const long long* idx_row = a.idx + static_cast<size_t>(cta) * a.N;
  const int tid = threadIdx.x;
  const int chunks = (a.K + a.N + kRows - 1) / kRows;
  long long ahead = 0;  // the index of entry tid of the next chunk to be made known
  if (tid < kRows) {
#pragma unroll
    for (int c = 0; c < kStages - 1; ++c) {
      const int j = c * kRows + tid;
      rows_s[c * kRows + tid] = list_row(j, list_index(j, a.K, a.N, idx_row), a.K, a.N, zt0, a.BT);
    }
    ahead = list_index((kStages - 1) * kRows + tid, a.K, a.N, idx_row);
  }
  __syncthreads();
  load_preds<KP>(ps, a.preds + b * a.ps_b + t * a.ps_t, a.ps_k, a.K);
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) load_chunk(zs + c * kRows * kC, rows_s + c * kRows, a.z);
    cp_async_commit();  // empty groups past the list keep the wait uniform
  }
#pragma unroll 1
  for (int c = 0; c < chunks; ++c) {
    const int next = c + kStages - 1;
    int* next_rows = rows_s + (next % kRowSlots) * kRows;
    if (tid < kRows) {  // the index was read a chunk ahead, so no load waits at the barrier
      if (next < chunks) next_rows[tid] = list_row(next * kRows + tid, ahead, a.K, a.N, zt0, a.BT);
      ahead = list_index((next + 1) * kRows + tid, a.K, a.N, idx_row);
    }
    cp_async_wait_behind();
    __syncthreads();
    if (next < chunks) load_chunk(zs + (next % kStages) * kRows * kC, next_rows, a.z);
    cp_async_commit();
    body(c, zs + (c % kStages) * kRows * kC, rows_s + (c % kRowSlots) * kRows);
  }
}

template <int KP>
__global__ void __launch_bounds__(kThreads) infonce_fwd_kernel(Args a, float* __restrict__ lse_out,
                                                               float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  using S = Smem<KP>;
  using X = Scatter<KP>;
  float* zs = reinterpret_cast<float*>(smem4);
  float* ps = zs + S::kZ;
  float* st = ps + S::kP + S::kS;
  float* pos_s = st + S::kState;
  int* rows_s = reinterpret_cast<int*>(zs + S::kFloats);
  int* bad_s = rows_s + kRowSlots * kRows;

  const int cta = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int K = a.K;
  const int base = X::base(lane);
  const bool keeper = (lane & X::kDup) == 0;
  if (threadIdx.x == 0) *bad_s = 0;

  float4 p0[KP], p1[KP];
  float m[X::kLeft], l[X::kLeft], mx[X::kLeft];
#pragma unroll
  for (int i = 0; i < X::kLeft; ++i) {
    m[i] = mx[i] = -CUDART_INF_F;
    l[i] = 0.f;
  }
  stream_list<KP>(a, zs, ps, rows_s, cta, [&](int c, const float* zc, const int* rc) {
    if (c == 0) lane_preds<KP>(ps, lane, p0, p1);
    float v[X::kLeft];
    score_batch<KP>(zc, warp * kBatch, p0, p1, lane, v);
    if (!keeper) return;
#pragma unroll
    for (int i = 0; i < X::kLeft; ++i) {
      const int x = base + i, k = x % KP, r = warp * kBatch + x / KP;
      const int zr = rc[r], j = c * kRows + r;
      if (zr == -1) *bad_s = 1;
      if (zr < 0 || k >= K || (j < K && j != k)) continue;  // a positive counts for its own head only
      if (j < K) pos_s[k] = v[i];
      else mx[i] = fmaxf(mx[i], v[i]);
      online(m[i], l[i], v[i]);
    }
  });

  // each (warp, batch row, head) state is one lane's slot i
  if (keeper) {
#pragma unroll
    for (int i = 0; i < X::kLeft; ++i) {
      const int x = base + i, k = x % KP, slot = warp * kBatch + x / KP;
      st[k * kRows + slot] = m[i];
      st[(KP + k) * kRows + slot] = l[i];
      st[(2 * KP + k) * kRows + slot] = mx[i];
    }
  }
  __syncthreads();
  if (threadIdx.x < KP) {  // the row's losses and hits as (2, KP), padded heads 0
    const int k = threadIdx.x;
    float* out = part + static_cast<size_t>(cta) * 2 * KP;
    if (k >= K) {
      out[k] = out[KP + k] = 0.f;
      return;
    }
    float M = -CUDART_INF_F, MX = -CUDART_INF_F;
    for (int i = 0; i < kRows; ++i) {
      M = fmaxf(M, st[k * kRows + i]);
      MX = fmaxf(MX, st[(2 * KP + k) * kRows + i]);
    }
    float L = 0.f;
    for (int i = 0; i < kRows; ++i) {
      const float mi = st[k * kRows + i];
      if (mi != -CUDART_INF_F) L = fmaf(st[(KP + k) * kRows + i], expf(mi - M), L);
    }
    const float lse = M + logf(L);
    const float pos = pos_s[k];
    lse_out[static_cast<size_t>(k) * gridDim.x + cta] = lse;
    out[k] = *bad_s ? CUDART_NAN_F : lse - pos;
    out[KP + k] = pos >= MX ? 1.f : 0.f;
  }
}

// loss = the sum of the rows' losses over (K rows), in double in a fixed
// order (thread i takes rows i, i + kFinishThreads, ..., then a butterfly a
// warp and the warps in order); stats[0] the mean of the K accuracies,
// stats[1 + k] head k's accuracy. part is (rows, 2, KP).
template <int KP>
__global__ void __launch_bounds__(kFinishThreads) infonce_finish_kernel(const float* __restrict__ part, int K,
                                                                        int rows, float* __restrict__ loss,
                                                                        float* __restrict__ stats) {
  constexpr int kFinishWarps = kFinishThreads / 32;
  __shared__ double w_loss[KP][kFinishWarps];
  __shared__ int w_hit[KP][kFinishWarps];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  double sl[KP];
  int sh[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    sl[k] = 0.0;
    sh[k] = 0;
  }
  for (int r = tid; r < rows; r += kFinishThreads) {
    const float4* row = reinterpret_cast<const float4*>(part + static_cast<size_t>(r) * 2 * KP);
#pragma unroll
    for (int k4 = 0; k4 < KP / 4; ++k4) {
      const float4 lv = row[k4], hv = row[KP / 4 + k4];
      sl[4 * k4] += lv.x;
      sl[4 * k4 + 1] += lv.y;
      sl[4 * k4 + 2] += lv.z;
      sl[4 * k4 + 3] += lv.w;
      sh[4 * k4] += hv.x != 0.f;
      sh[4 * k4 + 1] += hv.y != 0.f;
      sh[4 * k4 + 2] += hv.z != 0.f;
      sh[4 * k4 + 3] += hv.w != 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < KP; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sl[k] += __shfl_xor_sync(0xffffffffu, sl[k], off);
      sh[k] += __shfl_xor_sync(0xffffffffu, sh[k], off);
    }
    if (lane == 0) {
      w_loss[k][warp] = sl[k];
      w_hit[k][warp] = sh[k];
    }
  }
  __syncthreads();
  if (tid < K) {  // head tid over the warps in order
    double lk = 0.0;
    int hk = 0;
    for (int w = 0; w < kFinishWarps; ++w) {
      lk += w_loss[tid][w];
      hk += w_hit[tid][w];
    }
    w_loss[tid][0] = lk;
    w_hit[tid][0] = hk;
  }
  __syncthreads();
  if (tid == 0) {
    double total = 0.0;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) {
      total += w_loss[k][0];
      const float ak = static_cast<float>(w_hit[k][0]) / static_cast<float>(rows);
      stats[1 + k] = ak;
      acc += ak;
    }
    *loss = static_cast<float>(total / (static_cast<double>(K) * rows));
    stats[0] = acc / static_cast<float>(K);
  }
}

template <int KP>
__global__ void __launch_bounds__(kThreads) infonce_bwd_kernel(Args a, const float* __restrict__ lse,
                                                               const float* __restrict__ g_ptr, float inv_count,
                                                               float* __restrict__ dz, float* __restrict__ dpreds) {
  extern __shared__ float4 smem4[];
  using S = Smem<KP>;
  using X = Scatter<KP>;
  float* zs = reinterpret_cast<float*>(smem4);
  float* ps = zs + S::kZ;
  float* ds_s = ps + S::kP;
  float* lse_s = ds_s + S::kS + S::kState + KP;
  int* rows_s = reinterpret_cast<int*>(zs + S::kFloats);

  const int cta = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int rp = threadIdx.x / kC4, q = threadIdx.x - rp * kC4;  // dP: rows of parity rp, float4 column q
  const int K = a.K;
  const int base = X::base(lane);
  const bool keeper = (lane & X::kDup) == 0;
  if (threadIdx.x < K) lse_s[threadIdx.x] = lse[static_cast<size_t>(threadIdx.x) * gridDim.x + cta];
  const float coef = *g_ptr * inv_count;

  float4 p0[KP], p1[KP], dp[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) dp[k] = make_float4(0.f, 0.f, 0.f, 0.f);

  stream_list<KP>(a, zs, ps, rows_s, cta, [&](int c, const float* zc, const int* rc) {
    if (c == 0) lane_preds<KP>(ps, lane, p0, p1);
    {
      float v[X::kLeft];
      score_batch<KP>(zc, warp * kBatch, p0, p1, lane, v);
      if (keeper) {
#pragma unroll
        for (int i = 0; i < X::kLeft; ++i) {
          const int x = base + i, k = x % KP, r = warp * kBatch + x / KP;
          const int zr = rc[r], j = c * kRows + r;
          float d = 0.f;
          if (zr != -2 && k < K && (j >= K || j == k)) {
            const float p = expf(v[i] - lse_s[k]);
            d = coef * (j < K ? p - 1.f : p);
            if (zr == -1) d = CUDART_NAN_F;
          }
          ds_s[r * KP + k] = d;
        }
      }
    }
    __syncthreads();  // the chunk's dS
    // dz of the warp's rows: sum_k dS[r][k] P[k], the lane's two columns
#pragma unroll 1
    for (int rb = 0; rb < kBatch; ++rb) {
      const int r = warp * kBatch + rb;
      const int zr = rc[r];
      if (zr < 0) continue;
      const float4* d4 = reinterpret_cast<const float4*>(ds_s + r * KP);
      float4 o0 = make_float4(0.f, 0.f, 0.f, 0.f), o1 = o0;
#pragma unroll
      for (int k4 = 0; k4 < KP / 4; ++k4) {
        const float4 dv = d4[k4];
        const float d[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 4 * k4 + e;
          o0.x = fmaf(d[e], p0[k].x, o0.x);
          o0.y = fmaf(d[e], p0[k].y, o0.y);
          o0.z = fmaf(d[e], p0[k].z, o0.z);
          o0.w = fmaf(d[e], p0[k].w, o0.w);
          o1.x = fmaf(d[e], p1[k].x, o1.x);
          o1.y = fmaf(d[e], p1[k].y, o1.y);
          o1.z = fmaf(d[e], p1[k].z, o1.z);
          o1.w = fmaf(d[e], p1[k].w, o1.w);
        }
      }
      red_add4(dz + static_cast<size_t>(zr) * kC + 4 * lane, o0);
      red_add4(dz + static_cast<size_t>(zr) * kC + 4 * (lane + 32), o1);
    }
    // dP at column q: the chunk's rows of parity rp, every head
#pragma unroll 1
    for (int r = rp; r < kRows; r += kThreads / kC4) {
      if (rc[r] == -2) continue;
      const float4 zv = reinterpret_cast<const float4*>(zc + r * kC)[q];
      const float4* d4 = reinterpret_cast<const float4*>(ds_s + r * KP);
#pragma unroll
      for (int k4 = 0; k4 < KP / 4; ++k4) {
        const float4 dv = d4[k4];
        const float d[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 4 * k4 + e;
          dp[k].x = fmaf(d[e], zv.x, dp[k].x);
          dp[k].y = fmaf(d[e], zv.y, dp[k].y);
          dp[k].z = fmaf(d[e], zv.z, dp[k].z);
          dp[k].w = fmaf(d[e], zv.w, dp[k].w);
        }
      }
    }
  });

  // dP: the odd rows' sums through the (idle) stages, then one write
  __syncthreads();
  float4* half = reinterpret_cast<float4*>(zs);
  if (rp == 1) {
#pragma unroll
    for (int k = 0; k < KP; ++k) half[k * kC4 + q] = dp[k];
  }
  __syncthreads();
  if (rp == 0) {
    const int b = cta / a.Tc, t = cta - b * a.Tc;
    float* out = dpreds + b * a.ps_b + t * a.ps_t;
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      if (k >= K) break;
      const float4 o = half[k * kC4 + q];
      reinterpret_cast<float4*>(out + k * a.ps_k)[q] =
          make_float4(dp[k].x + o.x, dp[k].y + o.y, dp[k].z + o.z, dp[k].w + o.w);
    }
  }
}

template <int KP>
int forward(const Args& a, int rows, float* lse, float* part, float* loss, float* stats, cudaStream_t st) {
  const size_t smem = Smem<KP>::bytes;
  cudaError_t e = cudaFuncSetAttribute(infonce_fwd_kernel<KP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  infonce_fwd_kernel<KP><<<rows, kThreads, smem, st>>>(a, lse, part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  infonce_finish_kernel<KP><<<1, kFinishThreads, 0, st>>>(part, a.K, rows, loss, stats);
  return static_cast<int>(cudaGetLastError());
}

template <int KP>
int backward(const Args& a, int rows, const float* lse, const float* g, float inv_count, float* dz, float* dpreds,
             cudaStream_t st) {
  const size_t smem = Smem<KP>::bytes;
  cudaError_t e = cudaFuncSetAttribute(infonce_bwd_kernel<KP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  infonce_bwd_kernel<KP><<<rows, kThreads, smem, st>>>(a, lse, g, inv_count, dz, dpreds);
  return static_cast<int>(cudaGetLastError());
}

bool make_args(Args& a, const void* z, const void* preds, const void* idx, int B, int T, int Tc, int N, int K,
               long long ps_k, long long ps_b, long long ps_t) {
  const long long bt = static_cast<long long>(B) * T;
  if (B < 1 || Tc < 1 || N < 1 || K < 1 || K > kMaxK || Tc + K > T || bt > 0x7fffffffLL ||
      static_cast<long long>(B) * Tc * kMaxK > 0x7fffffffLL || (ps_k | ps_b | ps_t) % 4 != 0)
    return false;
  a = Args{static_cast<const float*>(z), static_cast<const float*>(preds), static_cast<const long long*>(idx),
           T, Tc, N, K, static_cast<int>(bt), ps_k, ps_b, ps_t};
  return true;
}

}  // namespace

// z (B * T, 256) float32 contiguous; preds (K, B, Tc, 256) float32 with
// element strides ps_k, ps_b, ps_t (multiples of 4) and unit stride last,
// 16-byte aligned; idx (B, Tc, N) int64 contiguous; K <= 16, Tc + K <= T.
// Writes lse (K, B * Tc), part (B * Tc, 2, KP) (each row's losses and hits,
// KP = K rounded up to a multiple of 4),
// the loss (one float) and stats (1 + K): two launches. Returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape it does not take).
extern "C" int vap_cpc_infonce_forward(const void* z, const void* preds, const void* idx, void* lse, void* part,
                                       void* loss, void* stats, int B, int T, int Tc, int N, int K, long long ps_k,
                                       long long ps_b, long long ps_t, void* stream) {
  Args a;
  if (!make_args(a, z, preds, idx, B, T, Tc, N, K, ps_k, ps_b, ps_t))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* l = static_cast<float*>(lse);
  auto* p = static_cast<float*>(part);
  auto* o = static_cast<float*>(loss);
  auto* s = static_cast<float*>(stats);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = B * Tc;
  switch ((K + 3) / 4) {
    case 1: return forward<4>(a, rows, l, p, o, s, st);
    case 2: return forward<8>(a, rows, l, p, o, s, st);
    case 3: return forward<12>(a, rows, l, p, o, s, st);
    default: return forward<16>(a, rows, l, p, o, s, st);
  }
}

// The backward of the loss for the upstream gradient *g (one float in
// device memory): dz (B * T, 256), zeroed by the caller, gets the
// encodings' gradient by atomic adds; dpreds (the strides of preds) is
// written whole. lse from the forward. One launch.
extern "C" int vap_cpc_infonce_backward(const void* z, const void* preds, const void* idx, const void* lse,
                                        const void* g, void* dz, void* dpreds, int B, int T, int Tc, int N, int K,
                                        long long ps_k, long long ps_b, long long ps_t, void* stream) {
  Args a;
  if (!make_args(a, z, preds, idx, B, T, Tc, N, K, ps_k, ps_b, ps_t) || g == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* l = static_cast<const float*>(lse);
  const auto* gp = static_cast<const float*>(g);
  const float inv = static_cast<float>(1.0 / (static_cast<double>(K) * B * Tc));
  auto* d = static_cast<float*>(dz);
  auto* dp = static_cast<float*>(dpreds);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = B * Tc;
  switch ((K + 3) / 4) {
    case 1: return backward<4>(a, rows, l, gp, inv, d, dp, st);
    case 2: return backward<8>(a, rows, l, gp, inv, d, dp, st);
    case 3: return backward<12>(a, rows, l, gp, inv, d, dp, st);
    default: return backward<16>(a, rows, l, gp, inv, d, dp, st);
  }
}
