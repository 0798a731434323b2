// Flash-attention forward with GQA, causal and sliding-window masks, for
// Hopper (sm_90a), fp32.
//
// Replaces: flash_attention_pallas / _kernel in
// src/repro/kernels/flash_attention/kernel.py.
//
// q (B, Sq, H, D) and k, v (B, Skv, KH, D), all fp32 and contiguous; out
// (B, Sq, H, D). Query head h reads KV head h / G, G = H / KH. A key is
// allowed when k_pos < Skv, and k_pos <= q_pos if causal, and
// k_pos > q_pos - window if window > 0. The softmax is online over KV
// blocks of ``kb`` keys, with fp32 carries m, l, acc:
//   m' = max(m, max_j s_j), corr = exp(m - m'), l' = l * corr + sum_j p_j,
//   acc' = acc * corr + sum_j p_j v_j, p_j = exp(s_j - m'),
// masked scores being -1e30, and out = acc / max(l, 1e-30): the arithmetic
// of the reference's chunked attention at kv_chunk = kb.
//
// What bounds it on the H100: fp32 operations. At the text path's shape
// (B 32, S 512, H 32, KH 8, D 128, causal) the two products are
// 4·B·H·D·S(S+1)/2 ≈ 6.9e10 FLOP against ≈ 0.1 GB of q, k, v and out, so
// the 67 TFLOP/s of the fp32 units (TF32 is off on every parity path)
// sets the bound, ≈ 1 ms; the bytes alone take ≈ 0.03 ms.
// What the design does about it, simply this time: one block of 256
// threads per (64 query rows, head, batch). The query tile sits in shared
// memory, transposed; K and V stream through one shared tile of 64 keys.
// Each thread holds a 4x4 micro-tile of scores (4 rows x 4 keys), so 8
// shared-memory reads feed 16 FMAs, and a 4 x D/16 slice of acc in
// registers. The block's scores
// for a whole KV block stay in shared memory between the two products,
// so the online-softmax update has the KV block as its unit, as in the
// reference. KV blocks wholly past the causal diagonal of the block's
// last row are skipped: for every row they are exact no-ops (p = 0 and
// corr = 1 exactly). wgmma, TMA and a KV stream shared by the G heads of
// one KV head are later work.
//
// Determinism: a row's result depends on kb and D only, never on Sq, on
// which block holds it or on the caller's query tiling. Every dot product
// sums over d in order, every row's max and sum run lane-strided over the
// block's keys with a fixed shuffle tree, and acc adds keys in order. No
// atomics.
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int KT = 64;          // keys per shared-memory tile
constexpr int kThreads = 256;   // a 16 x 16 grid: tx picks keys/dims, ty rows
constexpr float kNeg = -1e30f;

// Dynamic shared memory, in floats:
//   qt  [D][BQ + 1]   the query tile, transposed (padded row: no bank clash)
//   kv  [D][KT + 1]   one K tile, transposed; or one V tile [KT][D]
//   ps  [BQ][kb]      the block's scores, then its probabilities
//   m_s, l_s, c_s [BQ] running max, running sum, this block's correction
template <int DJ>   // each thread's output dims: tx + 16 j, j < DJ; D <= 16 DJ
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 int Sq, int Skv, int H, int KH, int D, int kb, int causal,
                 int window, float scale) {
  extern __shared__ float smem[];
  float* qt = smem;
  float* kvs = qt + D * (BQ + 1);
  float* ps = kvs + D * (KT + 1);
  float* m_s = ps + BQ * kb;
  float* l_s = m_s + BQ;
  float* c_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const size_t q_stride = (size_t)H * D;    // between query positions
  const size_t kv_stride = (size_t)KH * D;  // between key positions
  const float* qh = q + (size_t)b * Sq * q_stride + (size_t)h * D;
  const float* kh_base = k + (size_t)b * Skv * kv_stride + (size_t)kh * D;
  const float* vh_base = v + (size_t)b * Skv * kv_stride + (size_t)kh * D;

  for (int e = tid; e < BQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    qt[d * (BQ + 1) + r] =
        (q0 + r < Sq) ? qh[(size_t)(q0 + r) * q_stride + d] : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  int last = (Skv + kb - 1) / kb - 1;
  if (causal) last = min(last, (min(q0 + BQ, Sq) - 1) / kb);
  __syncthreads();

  for (int blk = 0; blk <= last; ++blk) {
    const int kv0 = blk * kb;
    const int nkeys = min(kb, Skv - kv0);   // keys of this block that exist

    // (1) scores s = q.k * scale of the whole block, one KT-key tile at a time
    for (int t0 = 0; t0 < kb; t0 += KT) {
      const int nt = min(KT, kb - t0);
      for (int e = tid; e < KT * D; e += kThreads) {
        const int r = e / D, d = e - r * D;
        kvs[d * (KT + 1) + r] = (t0 + r < nkeys)
            ? kh_base[(size_t)(kv0 + t0 + r) * kv_stride + d] : 0.f;
      }
      __syncthreads();
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float a[4], c[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qt[d * (BQ + 1) + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) c[j] = kvs[d * (KT + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int q_pos = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          if (col < nt) {
            const int k_pos = kv0 + t0 + col;
            bool ok = k_pos < Skv;
            if (causal) ok = ok && k_pos <= q_pos;
            if (window > 0) ok = ok && k_pos > q_pos - window;
            ps[r * kb + t0 + col] = ok ? s[i][j] * scale : kNeg;
          }
        }
      }
      __syncthreads();
    }

    // (2) online-softmax statistics: each warp owns BQ / 8 rows
    {
      const int warp = tid >> 5, lane = tid & 31;
      for (int rr = 0; rr < BQ / 8; ++rr) {
        const int r = warp * (BQ / 8) + rr;
        float* row = ps + r * kb;
        float mx = kNeg;
        for (int c = lane; c < kb; c += 32) mx = fmaxf(mx, row[c]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_prev = m_s[r];
        const float m_cur = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int c = lane; c < kb; c += 32) {
          const float p = expf(row[c] - m_cur);
          row[c] = p;
          sum += p;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) {
          const float corr = expf(m_prev - m_cur);
          c_s[r] = corr;
          l_s[r] = l_s[r] * corr + sum;
          m_s[r] = m_cur;
        }
      }
    }
    __syncthreads();

    // (3) acc = acc * corr + p.v, one KT-key tile of V at a time
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    for (int t0 = 0; t0 < kb; t0 += KT) {
      const int nt = min(KT, kb - t0);
      for (int e = tid; e < KT * D; e += kThreads) {
        const int r = e / D, d = e - r * D;
        kvs[r * D + d] = (t0 + r < nkeys)
            ? vh_base[(size_t)(kv0 + t0 + r) * kv_stride + d] : 0.f;
      }
      __syncthreads();
      for (int c = 0; c < nt; ++c) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * kb + t0 + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const int d = tx + 16 * j;
          const float vv = d < D ? kvs[c * D + d] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
      __syncthreads();
    }
  }

  // (4) normalise and store the block's real rows
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r < Sq) {
      const float l = fmaxf(l_s[r], 1e-30f);
      float* o = out + ((size_t)b * Sq + q0 + r) * q_stride + (size_t)h * D;
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        if (d < D) o[d] = acc[i][j] / l;
      }
    }
  }
}

constexpr int kMaxDevices = 64;
std::mutex carve_mutex;

template <int DJ>
int launch(const float* q, const float* k, const float* v, float* out, int B,
           int Sq, int Skv, int H, int KH, int D, int kb, int causal,
           int window, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)D * (BQ + 1) + (size_t)D * (KT + 1) +
                       (size_t)BQ * kb + 3 * BQ);
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  {
    // The largest carve granted so far, per device: the attribute is set
    // when a launch needs more, not on every launch.
    static size_t carved[kMaxDevices] = {};
    std::lock_guard<std::mutex> hold(carve_mutex);
    if (smem > carved[dev]) {
      int optin = 0;
      err = (int)cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (err) return err;
      if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
      err = (int)cudaFuncSetAttribute(
          flash_fwd_kernel<DJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err) return err;
      carved[dev] = smem;
    }
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<DJ><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, Sq, Skv, H, KH, D, kb, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the forward on ``stream``; allocates nothing (``out`` comes
// from the caller). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for shapes the kernel does not take: D > 256, or
// shared-memory tiles (4 bytes x (D (BQ + 1) + D (KT + 1) + BQ kb + 3 BQ))
// larger than the device's opt-in limit per block.
int flash_attention_fwd_f32(const float* q, const float* k, const float* v,
                            float* out, int B, int Sq, int Skv, int H, int KH,
                            int D, int kb, int causal, int window,
                            float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || KH <= 0 || H % KH ||
      D <= 0 || D > 256 || kb <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 16) return launch<1>(q, k, v, out, B, Sq, Skv, H, KH, D, kb, causal, window, scale, s);
  if (D <= 32) return launch<2>(q, k, v, out, B, Sq, Skv, H, KH, D, kb, causal, window, scale, s);
  if (D <= 64) return launch<4>(q, k, v, out, B, Sq, Skv, H, KH, D, kb, causal, window, scale, s);
  if (D <= 128) return launch<8>(q, k, v, out, B, Sq, Skv, H, KH, D, kb, causal, window, scale, s);
  return launch<16>(q, k, v, out, B, Sq, Skv, H, KH, D, kb, causal, window, scale, s);
}

}  // extern "C"
