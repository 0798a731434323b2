// Decode attention (one query token against a KV cache) with GQA, a valid
// length read on the device and an optional sliding window, for Hopper
// (sm_90a).
//
// Replaces: decode_attention_pallas / _kernel in
// src/repro/kernels/decode_attention/kernel.py.
//
// q (B, 1, H, D), caches (B, S, KH, D), out (B, 1, H, D), all of one type
// (float32 or bfloat16), contiguous; cur_len a device int32, the number of
// valid cache entries including the current token. Query head
// h = kh * G + g reads KV head kh, G = H / KH. A key k_pos is allowed when
// k_pos < cur_len, and k_pos > cur_len - 1 - window if window > 0. The
// softmax is online over KV blocks of ``kb`` keys, in fp32:
//   m' = max(m, max_j s_j), corr = exp(m - m'), l' = l * corr + sum_j p_j,
//   acc' = acc * corr + sum_j p_j v_j, p_j = exp(s_j - m'),
// masked scores being -1e30, and out = acc / max(l, 1e-30) in the input
// type: the arithmetic of the reference's kernel, which keeps q and p in
// fp32 (the reference's plain jnp decode_attention rounds q to the cache
// type and p to the V type before its products; this kernel does not).
//
// Blocks wholly past cur_len, or wholly before the window's first key,
// are skipped. That is exact: in the reference a fully masked leading
// block leaves p = exp(0) = 1 garbage in (l, acc), which the first live
// block multiplies by corr = exp(-1e30 - m) = 0. With cur_len < 1 (no
// live key) the kernel writes zeros; serving never asks for that.
//
// What bounds it on the H100: bytes. Each live key and value is read once
// and takes 2 G D FLOP against 2 D stored values, far under the card's
// 295 operations per byte; at the serving shape (B 16, cur_len 577,
// KH 8, D 128, bf16) the live K/V are 37.8 MB, 11 us.
// What the design does about it, simply this time: one block of 256
// threads per (KV head, batch row), the G query rows of that KV head in
// shared memory as fp32, so each K/V element leaves device memory once
// for all G heads. Scores: one warp per key, its lanes over D (coalesced
// rows), a fixed butterfly per query row. Softmax: one warp per query
// row. Values: each thread owns fixed (g, d) outputs and sums the block's
// keys in order. At B 16, KH 8 that is 128 blocks for 132 SMs; a split
// over the keys with a merge pass, and the wide loads, are later work.
//
// Determinism: a row's result depends on kb, D and cur_len only. Every
// sum runs in a fixed order; no atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;
constexpr size_t kMaxSmem = 48 * 1024;   // no opt-in carve needed

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Dynamic shared memory, in floats:
//   q_s [G][D], acc_s [G][D], p_s [G][kb], m_s, l_s, c_s [G]
template <typename T, int DJ>   // lane owns dims lane + 32 j, j < DJ
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out,
                        const int* __restrict__ cur_len, int S, int H, int KH,
                        int D, int kb, int window, float scale) {
  extern __shared__ float smem[];
  const int G = H / KH;
  float* q_s = smem;
  float* acc_s = q_s + G * D;
  float* p_s = acc_s + G * D;
  float* m_s = p_s + G * kb;
  float* l_s = m_s + G;
  float* c_s = l_s + G;

  const int kh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cur = *cur_len;
  const size_t head0 = ((size_t)b * H + (size_t)kh * G) * D;
  for (int e = tid; e < G * D; e += kThreads) {
    q_s[e] = to_f32(q[head0 + e]);
    acc_s[e] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNeg;
    l_s[g] = 0.f;
  }

  // live keys: [lo, hi)
  const int hi = min(cur, S);
  const int lo = window > 0 ? max(0, cur - window) : 0;
  const int first = lo / kb;
  const int last = hi > lo ? (hi - 1) / kb : first - 1;
  const size_t kv_stride = (size_t)KH * D;      // between key positions
  const T* k_base = k + (size_t)b * S * kv_stride + (size_t)kh * D;
  const T* v_base = v + (size_t)b * S * kv_stride + (size_t)kh * D;
  __syncthreads();

  for (int blk = first; blk <= last; ++blk) {
    const int k0 = blk * kb;
    const int nk = min(kb, S - k0);

    // (1) scores s[g][j] = q_g . k_j * scale, one warp per key
    for (int j = warp; j < nk; j += kWarps) {
      const int k_pos = k0 + j;
      const bool ok = k_pos < cur && (window <= 0 || k_pos > cur - 1 - window);
      const T* k_row = k_base + (size_t)k_pos * kv_stride;
      float kr[DJ];
#pragma unroll
      for (int i = 0; i < DJ; ++i) {
        const int d = lane + 32 * i;
        kr[i] = d < D ? to_f32(k_row[d]) : 0.f;
      }
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < DJ; ++i) {
          const int d = lane + 32 * i;
          if (d < D) part = fmaf(q_s[g * D + d], kr[i], part);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (lane == 0) p_s[g * kb + j] = ok ? part * scale : kNeg;
      }
    }
    __syncthreads();

    // (2) online-softmax statistics, one warp per query row
    for (int g = warp; g < G; g += kWarps) {
      float* row = p_s + g * kb;
      float mx = kNeg;
      for (int c = lane; c < nk; c += 32) mx = fmaxf(mx, row[c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_cur = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < nk; c += 32) {
        const float p = expf(row[c] - m_cur);
        row[c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_prev - m_cur);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_cur;
      }
    }
    __syncthreads();

    // (3) acc = acc * corr + p . v, each thread over its own (g, d)
    for (int e = tid; e < G * D; e += kThreads) {
      const int g = e / D, d = e - g * D;
      const float* p_row = p_s + g * kb;
      const T* v_col = v_base + (size_t)k0 * kv_stride + d;
      float a = acc_s[e] * c_s[g];
      for (int j = 0; j < nk; ++j)
        a = fmaf(p_row[j], to_f32(v_col[(size_t)j * kv_stride]), a);
      acc_s[e] = a;
    }
    __syncthreads();
  }

  // (4) normalise and store
  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D;
    store(out + head0 + e, acc_s[e] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T, int DJ>
int launch(const void* q, const void* k, const void* v, void* out,
           const int* cur_len, int B, int S, int H, int KH, int D, int kb,
           int window, float scale, size_t smem, cudaStream_t stream) {
  const dim3 grid(KH, B);
  decode_attention_kernel<T, DJ><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, cur_len, S, H, KH, D,
      kb, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             const int* cur_len, int B, int S, int H, int KH, int D, int kb,
             int window, float scale, size_t smem, cudaStream_t s) {
  if (D <= 32) return launch<T, 1>(q, k, v, out, cur_len, B, S, H, KH, D, kb, window, scale, smem, s);
  if (D <= 64) return launch<T, 2>(q, k, v, out, cur_len, B, S, H, KH, D, kb, window, scale, smem, s);
  if (D <= 128) return launch<T, 4>(q, k, v, out, cur_len, B, S, H, KH, D, kb, window, scale, smem, s);
  return launch<T, 8>(q, k, v, out, cur_len, B, S, H, KH, D, kb, window, scale, smem, s);
}

}  // namespace

extern "C" {

// Launches decode attention on ``stream``; allocates nothing (``out``
// comes from the caller) and reads ``cur_len`` on the device, so the
// caller never syncs. dtype: 0 float32, 1 bfloat16 (q, caches and out
// alike); window 0 means none. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for shapes it does not take: D > 256,
// H not a multiple of KH, or shared memory
// 4 (2 G D + G kb + 3 G) bytes over 48 KB.
int decode_attention(const void* q, const void* k, const void* v, void* out,
                     const int* cur_len, int dtype, int B, int S, int H,
                     int KH, int D, int kb, int window, float scale,
                     void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KH <= 0 || H % KH || D <= 0 ||
      D > 256 || kb <= 0 || KH > 65535 || B > 65535 || window < 0)
    return (int)cudaErrorInvalidValue;
  const size_t G = (size_t)(H / KH);
  const size_t smem = sizeof(float) * (2 * G * D + G * kb + 3 * G);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, cur_len, B, S, H, KH, D, kb, window, scale, smem, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, cur_len, B, S, H, KH, D, kb, window, scale, smem, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
