// Fused uncertainty scores over the vocab axis, for Hopper (sm_90a).
//
// Replaces: uncertainty_stats_pallas / _kernel in
// src/repro/kernels/uncertainty/kernel.py.
//
// logits (N, V), float32, bfloat16 or float16, row-major and contiguous;
// out (4, N) float32, rows [lc, mc, rc, es]. One streaming pass over each
// row keeps four running statistics and never writes a softmax:
//   m1  the running max,
//   m2  the runner-up, with only the leftmost occurrence of the max
//       knocked out, so a tied top-2 gives m2 == m1 (mc = 0, rc = 1
//       exactly),
//   se  sum_j exp(l_j - m1),
//   sl  sum_j l_j exp(l_j - m1),
// both sums rescaled by exp(m1_old - m1_new) when the max moves. The
// finish is the reference's _fin: lse = m1 + log(se), p1 = exp(m1 - lse),
// p2 = exp(m2 - lse), lc = 1 - p1, mc = -(p1 - p2), rc = p2 / p1,
// es = lse - sl / se.
//
// What bounds it on the H100: bytes. Each logit is read once and costs
// one exp and a few FMAs, far under the card's 295 operations per byte,
// so the bound is one read of the logits at 3.35 TB/s (at (16, 152,064)
// fp32: 9.7 MB, 2.9 us; at (4,096, 152,064): 2.5 GB, 0.74 ms).
// What the design does about it, simply this time: one block of 512
// threads per row; threads stride over V with coalesced loads, four
// loads in flight per thread before their updates. At N = 16 only 16 of
// 132 SMs work; a split over V with a second merge pass is later work.
//
// Determinism: a row's scores depend on V alone, never on N or on the
// rows beside it. Each thread takes its columns tid, tid + 512, ... in
// order; the 512 partial states merge through a fixed shuffle tree in
// each warp and a fixed tree over the 16 warps. The merge is exactly
// symmetric in its two operands (m1 = max, m2 = max(min(m1a, m1b), m2a,
// m2b), sums rescaled to the new max and added), so the tree's result
// does not depend on which lane holds which operand. No atomics.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;

struct Stats {
  float m1, m2, se, sl;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// Fold one logit into a thread's running state.
__device__ __forceinline__ void update(Stats& s, float x) {
  if (x > s.m1) {
    const float scale = expf(s.m1 - x);   // 0 while m1 is still kNeg
    s.se = s.se * scale + 1.f;
    s.sl = s.sl * scale + x;
    s.m2 = s.m1;
    s.m1 = x;
  } else {
    s.m2 = fmaxf(s.m2, x);                 // x == m1: a tie, m2 = m1
    const float e = expf(x - s.m1);
    s.se += e;
    s.sl = fmaf(e, x, s.sl);
  }
}

// Merge two partial states; symmetric in a and b, bit for bit.
__device__ __forceinline__ Stats merge(const Stats& a, const Stats& b) {
  Stats r;
  r.m1 = fmaxf(a.m1, b.m1);
  r.m2 = fmaxf(fminf(a.m1, b.m1), fmaxf(a.m2, b.m2));
  const float ca = expf(a.m1 - r.m1), cb = expf(b.m1 - r.m1);
  r.se = a.se * ca + b.se * cb;
  r.sl = a.sl * ca + b.sl * cb;
  return r;
}

__device__ __forceinline__ Stats warp_merge(Stats s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Stats o;
    o.m1 = __shfl_xor_sync(0xffffffffu, s.m1, off);
    o.m2 = __shfl_xor_sync(0xffffffffu, s.m2, off);
    o.se = __shfl_xor_sync(0xffffffffu, s.se, off);
    o.sl = __shfl_xor_sync(0xffffffffu, s.sl, off);
    s = merge(s, o);
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
uncertainty_stats_kernel(const T* __restrict__ logits, float* __restrict__ out,
                         int N, int V) {
  __shared__ Stats part[kWarps];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const T* x = logits + (size_t)row * V;

  Stats s = {kNeg, kNeg, 0.f, 0.f};
  int c = tid;
  for (; c + 3 * kThreads < V; c += 4 * kThreads) {
    const float x0 = to_f32(x[c]);
    const float x1 = to_f32(x[c + kThreads]);
    const float x2 = to_f32(x[c + 2 * kThreads]);
    const float x3 = to_f32(x[c + 3 * kThreads]);
    update(s, x0);
    update(s, x1);
    update(s, x2);
    update(s, x3);
  }
  for (; c < V; c += kThreads) update(s, to_f32(x[c]));

  s = warp_merge(s);
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) part[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kWarps ? part[lane] : Stats{kNeg, kNeg, 0.f, 0.f};
    s = warp_merge(s);
    if (lane == 0) {
      const float se = fmaxf(s.se, 1e-30f);
      const float lse = s.m1 + logf(se);
      const float p1 = expf(s.m1 - lse);
      const float p2 = expf(s.m2 - lse);
      out[row] = 1.f - p1;                          // lc
      out[(size_t)N + row] = -(p1 - p2);            // mc
      out[2 * (size_t)N + row] = p2 / fmaxf(p1, 1e-12f);  // rc
      out[3 * (size_t)N + row] = lse - s.sl / se;   // es
    }
  }
}

}  // namespace

extern "C" {

// Launches the scoring pass on ``stream``; allocates nothing (``out``
// comes from the caller). dtype: 0 float32, 1 bfloat16, 2 float16.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for an unknown dtype or an empty shape.
int uncertainty_stats(const void* logits, int dtype, float* out, int N, int V,
                      void* stream) {
  if (N <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(N), block(kThreads);
  switch (dtype) {
    case 0:
      uncertainty_stats_kernel<float><<<grid, block, 0, s>>>(
          (const float*)logits, out, N, V);
      break;
    case 1:
      uncertainty_stats_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
          (const __nv_bfloat16*)logits, out, N, V);
      break;
    case 2:
      uncertainty_stats_kernel<__half><<<grid, block, 0, s>>>(
          (const __half*)logits, out, N, V);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
