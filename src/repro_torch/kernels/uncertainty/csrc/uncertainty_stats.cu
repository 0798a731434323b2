// Fused uncertainty scores over the vocab axis, for Hopper (sm_90a).
//
// Replaces: uncertainty_stats_pallas / _kernel in
// src/repro/kernels/uncertainty/kernel.py.
//
// logits (N, V), float32, bfloat16 or float16, row-major and contiguous;
// out (4, N) float32, rows [lc, mc, rc, es]. Each row is summarised by
// four statistics and never by a softmax:
//   m1  the max,
//   m2  the runner-up, with only the leftmost occurrence of the max
//       knocked out, so a tied top-2 gives m2 == m1 (mc = 0, rc = 1
//       exactly),
//   se  sum_j exp(l_j - m1),
//   sl  sum_j l_j exp(l_j - m1).
// The finish is the reference's _fin: lse = m1 + log(se), p1 = exp(m1 -
// lse), p2 = exp(m2 - lse), lc = 1 - p1, mc = -(p1 - p2), rc = p2 / p1,
// es = lse - sl / se.
//
// What bounds it on the H100: bytes. Each logit is read once and costs
// one exp and a few FMAs, far under the card's 295 operations per byte,
// so the bound is one read of the logits at 3.35 TB/s (at (16, 152,064)
// fp32: 9.7 MB, 2.9 us; at (4,096, 152,064): 2.5 GB, 0.74 ms).
// What the design does about it: a split over V and a merge.
// - Split pass: S CTAs a row, S = ceil(V / E) with E = kThreads * kUnits
//   * (16 bytes / element size) (8,192 fp32 or 16,384 bf16/fp16 logits:
//   32 KB), so at the decode shape (16 rows) the grid is 16 * 19 CTAs over
//   the 132 SMs where one CTA a row left 116 idle. Thread t of a split takes
//   the 16-byte units t, t + kThreads, ... of its contiguous share, loads
//   kBatch units before it computes, takes the batch's max first and then
//   its exps (independent of each other), so loads and exps overlap.
// - Merge pass: a warp a row reads the S partials (m1, m2, se, sl) at
//   once; m1 and m2 merge exactly (max and min); the rescaled sums add up
//   in split order; then _fin.
//
// Determinism: a row's scores depend on V and the dtype alone, never on N
// or on the rows beside it. S and E are fixed by them; a thread's units
// and their order are fixed; 4-byte loads where the rows are not 16-byte
// aligned read the same elements in the same order. Inside a split the
// kThreads states merge through a fixed shuffle tree in each warp and a
// fixed tree over the warps; the merge is exactly symmetric in its two
// operands (m1 = max, m2 = max(min(m1a, m1b), m2a, m2b), sums rescaled to
// the new max and added, every product and sum rounded on its own), so
// the tree's result does not depend on which lane holds which operand. A
// tied top-2 gives m2 == m1 whether the two maxima share a split or not.
// No atomics.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = 8;       // 16-byte units a thread in a split
constexpr int kBatch = 4;       // units a thread loads before it computes
constexpr int kMergeWarps = 4;  // rows a merge CTA
constexpr int kMaxSplits = 512;
constexpr float kNeg = -1e30f;

struct Stats {
  float m1, m2, se, sl;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// Elements a 16-byte unit.
template <typename T>
__host__ __device__ constexpr int unit_elems() { return 16 / (int)sizeof(T); }

template <typename T>
__host__ __device__ constexpr int split_elems() {
  return kThreads * kUnits * unit_elems<T>();
}

// One unit's elements as floats: a 16-byte load when VEC, else one load an
// element (the same elements in the same order).
template <typename T, bool VEC>
__device__ __forceinline__ void load_unit(const T* p, int valid,
                                          float (&out)[unit_elems<T>()]) {
  constexpr int E = unit_elems<T>();
  if constexpr (VEC) {
    if (valid >= E) {
      const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(p));
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < E; ++i) out[i] = to_f32(e[i]);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < E; ++i) out[i] = i < valid ? to_f32(p[i]) : kNeg;
}

// Merge two partial states; symmetric in a and b, bit for bit.
__device__ __forceinline__ Stats merge(const Stats& a, const Stats& b) {
  Stats r;
  r.m1 = fmaxf(a.m1, b.m1);
  r.m2 = fmaxf(fminf(a.m1, b.m1), fmaxf(a.m2, b.m2));
  const float ca = expf(a.m1 - r.m1), cb = expf(b.m1 - r.m1);
  r.se = __fadd_rn(__fmul_rn(a.se, ca), __fmul_rn(b.se, cb));
  r.sl = __fadd_rn(__fmul_rn(a.sl, ca), __fmul_rn(b.sl, cb));
  return r;
}

__device__ __forceinline__ Stats shfl_xor(const Stats& s, int off) {
  Stats o;
  o.m1 = __shfl_xor_sync(0xffffffffu, s.m1, off);
  o.m2 = __shfl_xor_sync(0xffffffffu, s.m2, off);
  o.se = __shfl_xor_sync(0xffffffffu, s.se, off);
  o.sl = __shfl_xor_sync(0xffffffffu, s.sl, off);
  return o;
}

// Split pass: CTA b takes row b / S, columns [(b % S) * E, ... + E).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
uncertainty_stats_split_kernel(const T* __restrict__ logits,
                               float4* __restrict__ part, int V, int S) {
  constexpr int UE = unit_elems<T>();
  constexpr int E = split_elems<T>();
  __shared__ Stats warp_part[kWarps];
  const int row = blockIdx.x / S;
  const int split = blockIdx.x % S;
  const int c0 = split * E;
  const int len = min(E, V - c0);
  const T* x = logits + (size_t)row * V + c0;
  const int tid = threadIdx.x;

  Stats s = {kNeg, kNeg, 0.f, 0.f};
#pragma unroll
  for (int k0 = 0; k0 < kUnits; k0 += kBatch) {
    float v[kBatch][UE];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int e0 = (tid + (k0 + k) * kThreads) * UE;
      load_unit<T, VEC>(x + e0, len - e0, v[k]);
    }
    // the batch's max and runner-up, in element order
    float m1 = s.m1, m2 = s.m2;
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
#pragma unroll
      for (int i = 0; i < UE; ++i) {
        if (v[k][i] > m1) {
          m2 = m1;
          m1 = v[k][i];
        } else {
          m2 = fmaxf(m2, v[k][i]);
        }
      }
    const float scale = expf(s.m1 - m1);      // 1 when the max holds
    float se = __fmul_rn(s.se, scale), sl = __fmul_rn(s.sl, scale);
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
#pragma unroll
      for (int i = 0; i < UE; ++i) {
        if (v[k][i] > kNeg) {                  // kNeg: past the row's end
          const float e = expf(v[k][i] - m1);
          se = __fadd_rn(se, e);
          sl = fmaf(e, v[k][i], sl);
        }
      }
    s = Stats{m1, m2, se, sl};
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = merge(s, shfl_xor(s, off));
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) warp_part[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kWarps ? warp_part[lane] : Stats{kNeg, kNeg, 0.f, 0.f};
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s = merge(s, shfl_xor(s, off));
    if (lane == 0)
      part[(size_t)row * S + split] = make_float4(s.m1, s.m2, s.se, s.sl);
  }
}

// Merge pass: one warp a row over its S partials, then _fin.
__global__ void __launch_bounds__(kMergeWarps * 32)
uncertainty_stats_merge_kernel(const float4* __restrict__ part,
                               float* __restrict__ out, int N, int S) {
  __shared__ float terms[kMergeWarps][2][kMaxSplits];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kMergeWarps + warp;
  if (row >= N) return;                     // the whole warp
  const float4* p = part + (size_t)row * S;
  float m1 = kNeg, m2 = kNeg;
  for (int k = lane; k < S; k += 32) {
    const float4 q = __ldg(p + k);
    m2 = fmaxf(fminf(m1, q.x), fmaxf(m2, q.y));
    m1 = fmaxf(m1, q.x);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o1 = __shfl_xor_sync(0xffffffffu, m1, off);
    const float o2 = __shfl_xor_sync(0xffffffffu, m2, off);
    m2 = fmaxf(fminf(m1, o1), fmaxf(m2, o2));
    m1 = fmaxf(m1, o1);
  }
  for (int k = lane; k < S; k += 32) {
    const float4 q = __ldg(p + k);
    const float c = expf(q.x - m1);
    terms[warp][0][k] = __fmul_rn(q.z, c);
    terms[warp][1][k] = __fmul_rn(q.w, c);
  }
  __syncwarp();
  if (lane == 0) {
    float se = 0.f, sl = 0.f;
    for (int k = 0; k < S; ++k) {            // split order
      se = __fadd_rn(se, terms[warp][0][k]);
      sl = __fadd_rn(sl, terms[warp][1][k]);
    }
    se = fmaxf(se, 1e-30f);
    const float lse = m1 + logf(se);
    const float p1 = expf(m1 - lse);
    const float p2 = expf(m2 - lse);
    out[row] = 1.f - p1;                            // lc
    out[(size_t)N + row] = -(p1 - p2);              // mc
    out[2 * (size_t)N + row] = p2 / fmaxf(p1, 1e-12f);  // rc
    out[3 * (size_t)N + row] = lse - sl / se;       // es
  }
}

template <typename T>
int launch(const void* logits, float* out, float* work, int N, int V,
           cudaStream_t s) {
  const int S = (V + split_elems<T>() - 1) / split_elems<T>();
  if (S > kMaxSplits || (long long)N * S > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  float4* part = reinterpret_cast<float4*>(work);
  const bool vec = ((size_t)V * sizeof(T)) % 16 == 0 &&
                   ((uintptr_t)logits & 15) == 0;
  if (vec)
    uncertainty_stats_split_kernel<T, true><<<N * S, kThreads, 0, s>>>(
        (const T*)logits, part, V, S);
  else
    uncertainty_stats_split_kernel<T, false><<<N * S, kThreads, 0, s>>>(
        (const T*)logits, part, V, S);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  uncertainty_stats_merge_kernel<<<(N + kMergeWarps - 1) / kMergeWarps,
                                   kMergeWarps * 32, 0, s>>>(part, out, N, S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Logits a split CTA reads for this dtype (0 float32, 1 bfloat16, 2
// float16), or 0 for an unknown dtype: S = ceil(V / this).
int uncertainty_stats_split_elems(int dtype) {
  switch (dtype) {
    case 0: return split_elems<float>();
    case 1: return split_elems<__nv_bfloat16>();
    case 2: return split_elems<__half>();
    default: return 0;
  }
}

// Launches the split and merge passes on ``stream``; allocates nothing
// (``out`` (4, N) and the scratch ``work``, 4 floats a (row, split), come
// from the caller). Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for an unknown dtype, an empty shape or more than
// 512 splits a row.
int uncertainty_stats(const void* logits, int dtype, float* out, float* work,
                      int N, int V, void* stream) {
  if (N <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch<float>(logits, out, work, N, V, s);
    case 1: return launch<__nv_bfloat16>(logits, out, work, N, V, s);
    case 2: return launch<__half>(logits, out, work, N, V, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
