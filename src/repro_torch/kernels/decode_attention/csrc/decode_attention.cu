// Decode attention (one query token against a KV cache) with GQA, a valid
// length read on the device and an optional sliding window, for Hopper
// (sm_90a): a split-KV pass and a merge pass.
//
// Replaces: decode_attention_pallas / _kernel in
// src/repro/kernels/decode_attention/kernel.py.
//
// q (B, 1, H, D), caches (B, S, KH, D), out (B, 1, H, D), all of one type
// (float32 or bfloat16), contiguous; cur_len a device int32, the number of
// valid cache entries including the current token. Query head
// h = kh * G + g reads KV head kh, G = H / KH. A key k_pos is allowed when
// k_pos < cur_len, and k_pos > cur_len - 1 - window if window > 0. Scores
// are q . k * scale with q, k and p in fp32 (the reference's Pallas
// kernel keeps q and p in fp32; its plain jnp decode_attention rounds q
// to the cache type and p to the V type before its products; this kernel
// does not), and out = acc / max(l, 1e-30) in the input type.
//
// What bounds it on the H100: bytes. Each live key and value is read once
// and takes 2 G D FLOP against 2 D stored values, far under the card's
// 295 operations per byte; at the serving shape (B 16, cur_len 577,
// KH 8, D 128, bf16) the live K/V are 37.8 MB, 11 us at 3.35 TB/s.
// What the design does about it:
// - The keys are split into chunks of kSplit keys from key 0, and the grid
//   is (splits, KH x head groups, B): one CTA per (chunk, KV head, batch
//   row), for the GT query heads of the KV head that it serves (GT = 4 at
//   G = 4), so each K/V byte leaves device memory once for all of them.
//   At the serving shape (kSplit 128, the fastest of 32, 64, 128 and 256
//   on the card) that is 8 x 8 x 16 CTAs, 640 of them live. The split
//   count comes from S alone, so the host never reads cur_len.
// - A CTA whose chunk lies wholly past cur_len, or wholly before the
//   window, writes an empty partial (m = -1e30, l = 0) and exits; in the
//   last live chunk, keys past cur_len are not loaded, a warp's pass with
//   no live key computes no score, and P.V skips every dead key.
// - Loads are 16 bytes a lane: a key's row of D values is held by
//   LPK = D / 8 neighbouring lanes, 8 values each (a 128-wide bf16 row is
//   256 bytes, 16 lanes, so a warp covers two keys a load). Every load of
//   the CTA's K and V is issued before the first score is summed (V's
//   after the scores where they would not fit the registers).
// - q sits in fp32 registers (GT heads x the lane's 8 dims). A score is
//   the lane's 8 products in order, then a butterfly over the LPK lanes
//   of the key. One warp per head takes the chunk's max, p = exp(s - m)
//   and l = sum p over the chunk's keys. P.V accumulates each lane's 8
//   dims x GT heads in registers over the lane's keys in order; the key
//   slots of a warp add by butterfly, the warps in order through shared
//   memory. The partial (acc[GT][D], m, l) goes to an fp32 workspace of
//   shape (B, KH, splits, G, D + 2).
// - The merge pass (grid (H, B)) combines a row's live partials in split
//   order: m = max_s m_s, then l = sum_s l_s exp(m_s - m) and
//   acc = sum_s acc_s exp(m_s - m), and writes acc / max(l, 1e-30). Its
//   threads read the partials' (m, l) in parallel and their acc values
//   kBatch loads at a time.
// Both passes launch from the one C entry on the caller's stream; the
// kernel allocates nothing (the workspace comes from the caller).
//
// Determinism: a row's result depends on kSplit, D, cur_len and the window
// only, never on S (the cache's capacity; splits past cur_len are skipped
// by the merge), on B, or on which CTA finishes first. Every sum runs in a
// fixed order; no atomics. The reference's Pallas kernel instead carries
// (m, l, acc) through its KV blocks one after the other, rescaling at each
// block; the split form rounds differently (each chunk has its own max,
// and the partials are rescaled once, in the merge) and stays within the
// reference's tolerances of the plain version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSplit = 128;     // keys a CTA: the split unit
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kE = 8;           // values of a key row a lane holds
constexpr int kMergeThreads = 128;
constexpr int kBatch = 8;       // acc loads a merge thread issues at once
constexpr int kMinCtas = 2;     // split CTAs an SM must hold (3 and 4
                                // cap the registers below what kSplit
                                // 128 needs: slower on the card)
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// kE values of one key row: 16 bytes in bf16, 32 in fp32.
template <typename T>
struct alignas(16) Row {
  T v[kE];
};

// The lane's kE values of a row from ``src`` (its first value), zeros
// where !live and past ``nvalid`` values. vec: the values are 16-byte
// aligned and all valid, so they move 16 bytes a load.
template <typename T>
__device__ __forceinline__ Row<T> load_row(const T* src, int nvalid,
                                           bool live, bool vec) {
  Row<T> r;
  if (live && vec) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(&r);
#pragma unroll
    for (int i = 0; i < (int)(sizeof(Row<T>) / 16); ++i) d[i] = __ldg(s + i);
  } else {
#pragma unroll
    for (int e = 0; e < kE; ++e)
      r.v[e] = (live && e < nvalid) ? src[e] : T(0.f);
  }
  return r;
}

// One CTA: keys [split * kSplit, (split + 1) * kSplit) of KV head kh, batch
// row b, for query heads kh * G + g0 + [0, GT). LPK lanes a key.
template <typename T, int LPK, int GT>
__global__ void __launch_bounds__(kThreads, kMinCtas)
decode_attention_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, float* __restrict__ ws,
                              const int* __restrict__ cur_len, int S, int H,
                              int KH, int D, int window, float scale,
                              int n_splits, int vec) {
  constexpr int KPW = 32 / LPK;                 // keys a warp loads at once
  constexpr int KPP = kWarps * KPW;             // keys the CTA loads at once
  constexpr int ITER = (kSplit + KPP - 1) / KPP;
  constexpr int DW = LPK * kE;                  // dims the lanes cover, >= D
  // V's registers are loaded up front with K's when they fit
  constexpr bool kEarlyV = ITER * sizeof(Row<T>) / 4 <= 32;
  __shared__ float p_s[GT][kSplit];             // scores, then p
  __shared__ float red[kWarps][GT][DW];         // P.V partials by warp
  __shared__ float m_s[GT], l_s[GT];

  const int split = blockIdx.x, b = blockIdx.z;
  const int G = H / KH, groups = G / GT;
  const int kh = blockIdx.y / groups, g0 = (blockIdx.y % groups) * GT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cur = *cur_len;
  const int hi = min(cur, S);
  const int lo = window > 0 ? max(0, cur - window) : 0;
  const int k0 = split * kSplit;
  // the workspace row of (b, kh, split, head g0 + g): D acc values, m, l
  float* part = ws + (((size_t)b * KH + kh) * n_splits + split) * G * (D + 2) +
                (size_t)g0 * (D + 2);
  if (k0 >= hi || k0 + kSplit <= lo) {          // no live key: empty partial
    if (tid < GT) {
      part[(size_t)tid * (D + 2) + D] = kNeg;
      part[(size_t)tid * (D + 2) + D + 1] = 0.f;
    }
    return;
  }

  const int sub = lane / LPK;                   // the warp's key slot
  const int d0 = (lane % LPK) * kE;             // the lane's first dim
  const int nvalid = D - d0;
  const size_t kv_stride = (size_t)KH * D;      // between key positions
  const T* k_base = k + (size_t)b * S * kv_stride + (size_t)kh * D + d0;
  const T* v_base = v + (size_t)b * S * kv_stride + (size_t)kh * D + d0;

  // key slot of pass it: kk = it * KPP + warp * KPW + sub, within the chunk
  bool live[ITER];
  Row<T> kr[ITER], vr[ITER];
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int kk = it * KPP + warp * KPW + sub;
    const int pos = k0 + kk;
    live[it] = kk < kSplit && pos >= lo && pos < hi;
    kr[it] = load_row(k_base + (size_t)pos * kv_stride, nvalid,
                      live[it] && nvalid > 0, vec);
    if (kEarlyV)
      vr[it] = load_row(v_base + (size_t)pos * kv_stride, nvalid,
                        live[it] && nvalid > 0, vec);
  }

  float qf[GT][kE];
  const T* qh = q + ((size_t)b * H + (size_t)kh * G + g0) * D + d0;
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int e = 0; e < kE; ++e)
      qf[g][e] = e < nvalid ? to_f32(qh[(size_t)g * D + e]) : 0.f;

  // (1) scores: the lane's kE products in order, a butterfly over the
  // key; dead keys (and a warp's passes with no live key) score -1e30
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    float s[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) s[g] = 0.f;
    if (__any_sync(0xffffffffu, live[it])) {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
#pragma unroll
        for (int e = 0; e < kE; ++e)
          s[g] = fmaf(qf[g][e], to_f32(kr[it].v[e]), s[g]);
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
      }
    }
    const int kk = it * KPP + warp * KPW + sub;
    if (kk < kSplit && lane % LPK == 0) {
#pragma unroll
      for (int g = 0; g < GT; ++g) p_s[g][kk] = live[it] ? s[g] * scale : kNeg;
    }
  }
  if (!kEarlyV) {
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
      const int pos = k0 + it * KPP + warp * KPW + sub;
      vr[it] = load_row(v_base + (size_t)pos * kv_stride, nvalid,
                        live[it] && nvalid > 0, vec);
    }
  }
  __syncthreads();

  // (2) the chunk's softmax statistics, one warp per head
  if (warp < GT) {
    float* row = p_s[warp];
    float mx = kNeg;
    for (int c = lane; c < kSplit; c += 32) mx = fmaxf(mx, row[c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int c = lane; c < kSplit; c += 32) {
      const float p = expf(row[c] - mx);        // masked keys: exactly 0
      row[c] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      m_s[warp] = mx;
      l_s[warp] = sum;
    }
  }
  __syncthreads();

  // (3) P.V over the lane's keys in order, then over the warp's key slots
  float acc[GT][kE];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[g][e] = 0.f;
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    if (!live[it]) continue;
    const int kk = it * KPP + warp * KPW + sub;
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float p = p_s[g][kk];
#pragma unroll
      for (int e = 0; e < kE; ++e)
        acc[g][e] = fmaf(p, to_f32(vr[it].v[e]), acc[g][e]);
    }
  }
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int e = 0; e < kE; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int e = 0; e < kE; ++e) red[warp][g][d0 + e] = acc[g][e];
  }
  __syncthreads();

  // (4) the warps in order, and the partial out
  for (int i = tid; i < GT * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    float a = red[0][g][d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) a += red[w][g][d];
    part[(size_t)g * (D + 2) + d] = a;
  }
  if (tid < GT) {
    part[(size_t)tid * (D + 2) + D] = m_s[tid];
    part[(size_t)tid * (D + 2) + D + 1] = l_s[tid];
  }
}

// One CTA per (head, batch row): the live partials in split order. The
// partials' (m, l) come in parallel, kMergeThreads splits at a time, and
// each thread's acc values kBatch loads at a time; the sums stay in split
// order.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
decode_attention_merge_kernel(const float* __restrict__ ws, T* __restrict__ out,
                              int H, int KH, int D, int n_splits) {
  __shared__ float w_s[kMergeThreads];          // exp(m_s - m), -1: dead
  __shared__ float l_s[kMergeThreads];
  __shared__ float m_w[kMergeThreads / 32];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int G = H / KH, kh = h / G, g = h - kh * G;
  const size_t stride = (size_t)G * (D + 2);    // between splits
  const float* base = ws + ((size_t)b * KH + kh) * n_splits * stride +
                      (size_t)g * (D + 2);
  float m = kNeg;                               // max is exact in any order
  for (int s = tid; s < n_splits; s += kMergeThreads) {
    const float* p = base + s * stride;
    if (p[D + 1] > 0.f) m = fmaxf(m, p[D]);     // l > 0: a live partial
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((tid & 31) == 0) m_w[tid >> 5] = m;
  __syncthreads();
  m = m_w[0];
#pragma unroll
  for (int w = 1; w < kMergeThreads / 32; ++w) m = fmaxf(m, m_w[w]);

  float l = 0.f;
  float acc[(256 + kMergeThreads - 1) / kMergeThreads];
#pragma unroll
  for (int i = 0; i < (int)(sizeof(acc) / sizeof(float)); ++i) acc[i] = 0.f;
  for (int c0 = 0; c0 < n_splits; c0 += kMergeThreads) {
    const int cnt = min(kMergeThreads, n_splits - c0);
    __syncthreads();                            // the last chunk is read
    if (tid < cnt) {
      const float* p = base + (size_t)(c0 + tid) * stride;
      const float ls = p[D + 1];
      l_s[tid] = ls;
      w_s[tid] = ls > 0.f ? expf(p[D] - m) : -1.f;
    }
    __syncthreads();
    for (int s = 0; s < cnt; ++s)
      if (w_s[s] >= 0.f) l = fmaf(l_s[s], w_s[s], l);
#pragma unroll
    for (int i = 0; i < (int)(sizeof(acc) / sizeof(float)); ++i) {
      const int d = tid + i * kMergeThreads;
      if (d >= D) break;
      for (int s0 = 0; s0 < cnt; s0 += kBatch) {
        float x[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int s = s0 + u;
          x[u] = s < cnt && w_s[s] >= 0.f
                     ? base[(size_t)(c0 + s) * stride + d] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int s = s0 + u;
          if (s < cnt && w_s[s] >= 0.f) acc[i] = fmaf(x[u], w_s[s], acc[i]);
        }
      }
    }
  }
  l = fmaxf(l, 1e-30f);
  T* o = out + ((size_t)b * H + h) * D;
#pragma unroll
  for (int i = 0; i < (int)(sizeof(acc) / sizeof(float)); ++i) {
    const int d = tid + i * kMergeThreads;
    if (d < D) store(o + d, acc[i] / l);
  }
}

template <typename T, int LPK, int GT>
int launch(const void* q, const void* k, const void* v, void* out, float* ws,
           const int* cur_len, int B, int S, int H, int KH, int D, int window,
           float scale, int n_splits, int vec, cudaStream_t stream) {
  const dim3 grid(n_splits, KH * (H / KH / GT), B);
  decode_attention_split_kernel<T, LPK, GT><<<grid, kThreads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, ws, cur_len, S, H, KH, D, window,
      scale, n_splits, vec);
  int err = (int)cudaGetLastError();
  if (err) return err;
  decode_attention_merge_kernel<T><<<dim3(H, B), kMergeThreads, 0, stream>>>(
      ws, (T*)out, H, KH, D, n_splits);
  return (int)cudaGetLastError();
}

template <typename T, int LPK>
int by_group(const void* q, const void* k, const void* v, void* out, float* ws,
             const int* cur_len, int B, int S, int H, int KH, int D,
             int window, float scale, int n_splits, int vec, cudaStream_t s) {
  const int G = H / KH;
  if (G % 4 == 0) return launch<T, LPK, 4>(q, k, v, out, ws, cur_len, B, S, H, KH, D, window, scale, n_splits, vec, s);
  if (G % 2 == 0) return launch<T, LPK, 2>(q, k, v, out, ws, cur_len, B, S, H, KH, D, window, scale, n_splits, vec, s);
  return launch<T, LPK, 1>(q, k, v, out, ws, cur_len, B, S, H, KH, D, window, scale, n_splits, vec, s);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, float* ws,
             const int* cur_len, int B, int S, int H, int KH, int D,
             int window, float scale, int n_splits, int vec, cudaStream_t s) {
  if (D <= 16) return by_group<T, 2>(q, k, v, out, ws, cur_len, B, S, H, KH, D, window, scale, n_splits, vec, s);
  if (D <= 32) return by_group<T, 4>(q, k, v, out, ws, cur_len, B, S, H, KH, D, window, scale, n_splits, vec, s);
  if (D <= 64) return by_group<T, 8>(q, k, v, out, ws, cur_len, B, S, H, KH, D, window, scale, n_splits, vec, s);
  if (D <= 128) return by_group<T, 16>(q, k, v, out, ws, cur_len, B, S, H, KH, D, window, scale, n_splits, vec, s);
  return by_group<T, 32>(q, k, v, out, ws, cur_len, B, S, H, KH, D, window, scale, n_splits, vec, s);
}

}  // namespace

extern "C" {

// The split unit, in keys: the workspace holds ceil(S / this) splits.
int decode_attention_split_keys() { return kSplit; }

// Launches decode attention on ``stream``: the split pass, then the merge
// pass. Allocates nothing (``out`` and the fp32 workspace ``ws`` of
// B * KH * n_splits * G * (D + 2) floats come from the caller) and reads
// ``cur_len`` on the device, so the caller never syncs. dtype: 0 float32,
// 1 bfloat16 (q, caches and out alike); window 0 means none. Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for
// shapes it does not take: D > 256, H not a multiple of KH, more than
// 65,535 heads or batch rows, or n_splits other than ceil(S / kSplit).
int decode_attention(const void* q, const void* k, const void* v, void* out,
                     void* ws, const int* cur_len, int dtype, int B, int S,
                     int H, int KH, int D, int n_splits, int window,
                     float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KH <= 0 || H % KH || D <= 0 ||
      D > 256 || H > 65535 || B > 65535 || window < 0 ||
      n_splits != (S + kSplit - 1) / kSplit)
    return (int)cudaErrorInvalidValue;
  const size_t esize = dtype == 0 ? 4 : 2;
  // 16-byte loads need every row start 16-byte aligned
  const int vec = D % kE == 0 && (D * esize) % 16 == 0 &&
                  (uintptr_t)q % 16 == 0 && (uintptr_t)k % 16 == 0 &&
                  (uintptr_t)v % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  float* w = (float*)ws;
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, w, cur_len, B, S, H, KH, D, window, scale, n_splits, vec, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, w, cur_len, B, S, H, KH, D, window, scale, n_splits, vec, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
