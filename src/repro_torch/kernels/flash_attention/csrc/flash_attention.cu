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
// the 67 TFLOP/s of the fp32 units (TF32 is off on every parity path, and
// nothing here emulates fp32 on the tensor cores) sets the bound,
// ≈ 1 ms; the bytes alone take ≈ 0.03 ms. So the products must be fed
// from registers, with few shared-memory reads per FMA.
// What the design does about it:
// - One CTA of 256 threads (16 x 16) per (BQ query rows, head, batch):
//   BQ = 128 rows (8 a thread) where the shared memory allows, else 64
//   (4 a thread); warp w holds the consecutive rows from BQ·w/8, its two
//   ty interleaved. D is zero-padded inside to DP = 64, 128 or 256. The
//   query tile stays in shared memory, row-major; the heaviest causal
//   tiles are scheduled first. At the text shape: 4,096 CTAs of 128
//   rows, one an SM (199 KB of shared memory).
// - Scores come in sub-tiles of KT = 64 keys (4 a thread, keys tx + 16 j):
//   an 8 x 4 register micro-tile fed by float4 reads of the row-major Q
//   tile and K stage, 12 vector reads per 128 FMAs. The rows and keys a
//   quarter-warp reads fall in distinct bank groups (padded rows).
// - P.V: each thread holds an RPT x DP/16 slice of acc (its rows, dims
//   tx·DP/16 + e), fed per key by float4 reads of p (stored key-major, a
//   thread's rows adjacent) and of the V stage.
// - K (64 keys x up to 128 dims: a whole sub-tile at D 128) and V (64
//   keys x DP dims at DP 128) stream through a ring of 2 shared-memory
//   stages filled by 16-byte cp.async copies (4-byte ones when D is not
//   a multiple of 4), zero-filled past Skv and D; the copies of stage
//   n + 1 run under the products of stage n. Two large stages beat three
//   small ones: each stage ends in a barrier of the whole CTA.
// - The block's scores stay in shared memory between the two products, so
//   the online-softmax update keeps the KV block as its unit, as in the
//   reference. KV blocks wholly past the causal diagonal of the tile's
//   last row are skipped: for every row they are exact no-ops (p = 0 and
//   corr = 1 exactly). Inside the diagonal's blocks a warp skips the
//   score products of a sub-tile that starts past its last row and the
//   P.V products of the keys past it: exact (those scores are masked
//   whatever they hold, their p is exactly 0) and uniform across the
//   warp, so no second code path.
//
// Determinism: a row's result depends on kb and D only, never on Sq, on
// the tile size, on which CTA holds it or on the caller's query tiling.
// Every score sums d = 0 … D-1 in order with fmaf (the zero dims past D
// add exact zeros); each row's max and sum run over the thread's keys in
// key-slot order and then a fixed butterfly over the 16 threads of the
// row, an order fixed by kb; acc adds the block's keys in order. No
// atomics.
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;   // a 16 x 16 grid: tx keys / dims, ty rows
constexpr int KPT = 4;          // keys a thread in a score sub-tile
constexpr int KT = 16 * KPT;    // keys of a score sub-tile
constexpr int DK = 128;         // dims of a K stage (at most DP)
constexpr int STAGES = 2;       // cp.async ring depth
constexpr float kNeg = -1e30f;

// Asynchronous copies global -> shared of 16 or 4 bytes; they zero-fill
// when !ok (the source is then not read, but must be a valid address).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies a rows x cols tile (row stride ``gstride`` floats in global,
// ``ld`` in shared) from rows [0, nrows) and cols [0, ncols) of ``src``,
// zero-filling the rest (whose copies name ``base``, a valid address).
// vec: 16-byte copies (cols, ncols, gstride and src multiples of 4
// floats).
__device__ __forceinline__ void stage_tile(float* dst, int ld,
                                           const float* src,
                                           const float* base, size_t gstride,
                                           int rows, int cols, int nrows,
                                           int ncols, bool vec) {
  if (vec) {
    const int per_row = cols / 4;
    for (int e = threadIdx.x; e < rows * per_row; e += kThreads) {
      const int r = e / per_row, c = 4 * (e - r * per_row);
      const bool ok = r < nrows && c < ncols;
      cp_async16(dst + r * ld + c, ok ? src + r * gstride + c : base, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
      const int r = e / cols, c = e - r * cols;
      const bool ok = r < nrows && c < ncols;
      cp_async4(dst + r * ld + c, ok ? src + r * gstride + c : base, ok);
    }
  }
}

// The tile row of a thread's i-th row: warp w = ty / 2 holds the 2·RPT
// consecutive rows from 2·RPT·w, its two ty interleaved (the two rows a
// warp reads at once are neighbours, in other bank groups).
template <int RPT>
__device__ __forceinline__ int row_of(int ty, int i) {
  return (ty >> 1) * (2 * RPT) + (ty & 1) + 2 * i;
}

// Products of one K stage into the score micro-tile: rows row_of(ty, i),
// keys tx + 16 j, dims [c·DKS, (c + 1)·DKS) of the Q tile.
template <int RPT, int LDQ, int DKS>
__device__ __forceinline__ void score_products(float (&s)[RPT][KPT],
                                               const float* qs,
                                               const float* st, int tx,
                                               int ty, int c) {
#pragma unroll 2
  for (int d4 = 0; d4 < DKS; d4 += 4) {
    float4 a[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      a[i] = *reinterpret_cast<const float4*>(
          &qs[row_of<RPT>(ty, i) * LDQ + c * DKS + d4]);
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const float4 kk = *reinterpret_cast<const float4*>(
          &st[(tx + 16 * j) * (DKS + 4) + d4]);
      // each dot product stays one fmaf chain over d ascending
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        s[i][j] = fmaf(a[i].x, kk.x, s[i][j]);
        s[i][j] = fmaf(a[i].y, kk.y, s[i][j]);
        s[i][j] = fmaf(a[i].z, kk.z, s[i][j]);
        s[i][j] = fmaf(a[i].w, kk.w, s[i][j]);
      }
    }
  }
}

// acc += p.v over the V stage's nt keys (block keys key0 + [0, nt)), in
// order.
template <int RPT, int DPT, int LDP, int LDV>
__device__ __forceinline__ void pv_products(float (&acc)[RPT][DPT],
                                            const float* ps, const float* st,
                                            int tx, int ty, int key0,
                                            int nt) {
#pragma unroll 8
  for (int cc = 0; cc < nt; ++cc) {
    const int key = key0 + cc;
    float pr[RPT], vv[DPT];
#pragma unroll
    for (int i4 = 0; i4 < RPT; i4 += 4) {
      const float4 x = *reinterpret_cast<const float4*>(
          &ps[key * LDP + ty * RPT + i4]);
      pr[i4] = x.x;
      pr[i4 + 1] = x.y;
      pr[i4 + 2] = x.z;
      pr[i4 + 3] = x.w;
    }
#pragma unroll
    for (int e4 = 0; e4 < DPT; e4 += 4) {
      const float4 x =
          *reinterpret_cast<const float4*>(&st[cc * LDV + tx * DPT + e4]);
      vv[e4] = x.x;
      vv[e4 + 1] = x.y;
      vv[e4 + 2] = x.z;
      vv[e4 + 3] = x.w;
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[i][e] = fmaf(pr[i], vv[e], acc[i][e]);
  }
}

// (2) The online-softmax update over a whole KV block, for the thread's
// rows row_of(ty, i): the row's max, then p = exp(s - m') in place of s
// and its sum, key slots in order, then a butterfly over the row's 16
// threads (lanes tx of a half-warp); acc *= corr, and the row's (m, l)
// in ms, ls.
template <int RPT, int DPT, int LDP>
__device__ __forceinline__ void block_softmax(float (&acc)[RPT][DPT],
                                              float* ps, float* ms, float* ls,
                                              int tx, int ty, int nsub,
                                              int kb) {
  float mx[RPT], sum[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    mx[i] = kNeg;
    sum[i] = 0.f;
  }
  for (int tt = 0; tt < nsub; ++tt) {
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int key = tt * KT + tx + 16 * j;
      if (key < kb) {
#pragma unroll
        for (int i4 = 0; i4 < RPT; i4 += 4) {
          const float4 x = *reinterpret_cast<const float4*>(
              &ps[key * LDP + ty * RPT + i4]);
          mx[i4] = fmaxf(mx[i4], x.x);
          mx[i4 + 1] = fmaxf(mx[i4 + 1], x.y);
          mx[i4 + 2] = fmaxf(mx[i4 + 2], x.z);
          mx[i4 + 3] = fmaxf(mx[i4 + 3], x.w);
        }
      }
    }
  }
  float mnew[RPT], corr[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
    const float m_prev = ms[row_of<RPT>(ty, i)];
    mnew[i] = fmaxf(m_prev, mx[i]);
    corr[i] = expf(m_prev - mnew[i]);
  }
  for (int tt = 0; tt < nsub; ++tt) {
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int key = tt * KT + tx + 16 * j;
      if (key < kb) {
#pragma unroll
        for (int i4 = 0; i4 < RPT; i4 += 4) {
          float4* px =
              reinterpret_cast<float4*>(&ps[key * LDP + ty * RPT + i4]);
          float4 x = *px;
          x.x = expf(x.x - mnew[i4]);
          x.y = expf(x.y - mnew[i4 + 1]);
          x.z = expf(x.z - mnew[i4 + 2]);
          x.w = expf(x.w - mnew[i4 + 3]);
          sum[i4] += x.x;
          sum[i4 + 1] += x.y;
          sum[i4 + 2] += x.z;
          sum[i4 + 3] += x.w;
          *px = x;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], off);
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] *= corr[i];
  }
  __syncwarp();                       // the row's threads read ms
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = row_of<RPT>(ty, i);
      ls[row] = ls[row] * corr[i] + sum[i];
      ms[row] = mnew[i];
    }
  }
}

// Shared memory, in floats:
//   qs   [BQ][DP + 4]          the query tile, row-major
//   ring [STAGES][SLOT]        K stages [KT][DKS + 4] or V [KV][DP + 4]
//   ps   [kb][BQ + 4]          the block's scores, then p, key-major; a
//                              thread's i-th row sits at ty·RPT + i
//   ms, ls [BQ]                running max and sum of each row
template <int RPT, int DP>
struct Plan {
  static constexpr int BQ = 16 * RPT;
  static constexpr int LDQ = DP + 4;
  static constexpr int LDP = BQ + 4;
  static constexpr int DPT = DP / 16;     // acc dims a thread
  static constexpr int LDV = DP + 4;
  static constexpr int DKS = DK < DP ? DK : DP;   // dims of a K stage
  static constexpr int LDK = DKS + 4;     // a K stage's row, padded
  static constexpr int SLOT = KT * LDK;   // floats a stage: K or V tile
  static constexpr int KV =               // keys of a V stage: 2^k
      SLOT / LDV >= 128 ? 128 : SLOT / LDV >= 64 ? 64 : 32;
  static constexpr int NC = DP / DKS;     // K stages a score sub-tile
  static_assert(RPT % 4 == 0 && DPT % 4 == 0, "float4 rows and dims");
  static_assert(KV > 0 && DP % DKS == 0, "a V stage holds keys");
  static size_t smem_bytes(int kb) {
    return sizeof(float) * ((size_t)BQ * LDQ + (size_t)STAGES * SLOT +
                            (size_t)kb * LDP + 2 * BQ);
  }
};

template <int RPT, int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 int Sq, int Skv, int H, int KH, int D, int kb, int causal,
                 int window, float scale, int vec) {
  using P = Plan<RPT, DP>;
  constexpr int BQ = P::BQ, LDQ = P::LDQ, LDP = P::LDP, DPT = P::DPT;
  constexpr int KV = P::KV, LDV = P::LDV, NC = P::NC, SLOT = P::SLOT;
  constexpr int DKS = P::DKS, LDK = P::LDK;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ring = qs + BQ * LDQ;
  float* ps = ring + STAGES * SLOT;
  float* ms = ps + (size_t)kb * LDP;
  float* ls = ms + BQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const size_t q_stride = (size_t)H * D;    // between query positions
  const size_t kv_stride = (size_t)KH * D;  // between key positions
  const float* qh = q + (size_t)b * Sq * q_stride + (size_t)h * D;
  const float* kh_base = k + (size_t)b * Skv * kv_stride + (size_t)kh * D;
  const float* vh_base = v + (size_t)b * Skv * kv_stride + (size_t)kh * D;

  int nblk = (Skv + kb - 1) / kb;
  if (causal) nblk = min(nblk, (min(q0 + BQ, Sq) - 1) / kb + 1);
  const int nsub = (kb + KT - 1) / KT;      // score sub-tiles a block
  const int nk = nsub * NC;                 // K stages a block
  const int per_blk = nk + (kb + KV - 1) / KV;
  const int total = nblk * per_blk;

  // stage n of the stream: a block's K stages (sub-tile, dim chunk), then
  // its V stages
  auto issue = [&](int n) {
    if (n >= total) return;
    const int blk = n / per_blk, r = n - blk * per_blk;
    const int kv0 = blk * kb, nkeys = min(kb, Skv - kv0);
    float* st = ring + (n % STAGES) * SLOT;
    if (r < nk) {
      const int t = r / NC, c = r - t * NC;
      const float* src = kh_base + (size_t)(kv0 + t * KT) * kv_stride;
      stage_tile(st, LDK, src + c * DKS, kh_base, kv_stride, KT, DKS,
                 nkeys - t * KT, D - c * DKS, vec);
    } else {
      const int u = r - nk;
      stage_tile(st, LDV, vh_base + (size_t)(kv0 + u * KV) * kv_stride,
                 vh_base, kv_stride, KV, DP, nkeys - u * KV, D, vec);
    }
  };

  stage_tile(qs, LDQ, qh + (size_t)q0 * q_stride, qh, q_stride, BQ, DP,
             Sq - q0, D, vec);
  for (int n = 0; n < STAGES - 1; ++n) {
    issue(n);
    cp_async_commit();                      // the first group holds Q too
  }
  if (tid < BQ) {
    ms[tid] = kNeg;
    ls[tid] = 0.f;
  }

  float acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
  int n = 0;                                // the stream's next stage
  auto next_stage = [&]() -> const float* {
    cp_async_wait<STAGES - 2>();            // this thread's copies of n
    __syncthreads();                        // everyone's; n - 1 is done
    issue(n + STAGES - 1);
    cp_async_commit();
    return ring + (n++ % STAGES) * SLOT;
  };

  // causal: keys past the warp's last row are masked for every row of the
  // warp; it skips the score products of a sub-tile that starts past it
  // (the scores are masked whatever they hold) and the P.V products of
  // such keys (p is exactly 0: each row's own key keeps its max above
  // -1e30)
  const int warp_last =
      causal ? q0 + (ty >> 1) * (2 * RPT) + 2 * RPT - 1 : Skv + kb;
  for (int blk = 0; blk < nblk; ++blk) {
    const int kv0 = blk * kb;
    // (1) scores, a sub-tile of KT keys at a time, DKS dims a stage
    for (int t = 0; t < nsub; ++t) {
      float s[RPT][KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
      for (int c = 0; c < NC; ++c) {
        const float* st = next_stage();
        if (kv0 + t * KT <= warp_last)
          score_products<RPT, LDQ, DKS>(s, qs, st, tx, ty, c);
      }
      // scale and mask into ps; each thread reads back only its own
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int key = t * KT + tx + 16 * j;
        if (key < kb) {
          const int k_pos = kv0 + key;
#pragma unroll
          for (int i4 = 0; i4 < RPT; i4 += 4) {
            float val[4];
#pragma unroll
            for (int ii = 0; ii < 4; ++ii) {
              const int q_pos = q0 + row_of<RPT>(ty, i4 + ii);
              bool ok = k_pos < Skv;
              if (causal) ok = ok && k_pos <= q_pos;
              if (window > 0) ok = ok && k_pos > q_pos - window;
              val[ii] = ok ? s[i4 + ii][j] * scale : kNeg;
            }
            *reinterpret_cast<float4*>(&ps[key * LDP + ty * RPT + i4]) =
                make_float4(val[0], val[1], val[2], val[3]);
          }
        }
      }
    }

    block_softmax<RPT, DPT, LDP>(acc, ps, ms, ls, tx, ty, nsub, kb);

    // (3) acc += p.v over the block's keys in order, KV a stage
    for (int u = 0; u * KV < kb; ++u) {
      const float* st = next_stage();
      const int nt = min(min(KV, kb - u * KV), warp_last - kv0 - u * KV + 1);
      if (nt > 0)
        pv_products<RPT, DPT, LDP, LDV>(acc, ps, st, tx, ty, u * KV, nt);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // (4) normalise and store the tile's real rows
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = row_of<RPT>(ty, i);
    if (q0 + row < Sq) {
      const float l = fmaxf(ls[row], 1e-30f);
      float* o = out + ((size_t)b * Sq + q0 + row) * q_stride + (size_t)h * D;
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        const int d = tx * DPT + e;
        if (d < D) o[d] = acc[i][e] / l;
      }
    }
  }
}

constexpr int kMaxDevices = 64;
std::mutex carve_mutex;

template <int RPT, int DP>
int launch(const float* q, const float* k, const float* v, float* out, int B,
           int Sq, int Skv, int H, int KH, int D, int kb, int causal,
           int window, float scale, int vec, size_t smem, int dev,
           cudaStream_t stream) {
  {
    // The largest carve granted so far, per device and instance: the
    // attribute is set when a launch needs more, not on every launch.
    static size_t carved[kMaxDevices] = {};
    std::lock_guard<std::mutex> hold(carve_mutex);
    if (smem > carved[dev]) {
      const int err = (int)cudaFuncSetAttribute(
          flash_fwd_kernel<RPT, DP>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err) return err;
      carved[dev] = smem;
    }
  }
  const dim3 grid((Sq + Plan<RPT, DP>::BQ - 1) / Plan<RPT, DP>::BQ, H, B);
  flash_fwd_kernel<RPT, DP><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, Sq, Skv, H, KH, D, kb, causal, window, scale, vec);
  return (int)cudaGetLastError();
}

// 128 query rows a CTA where the tiles fit the card's opt-in shared
// memory, else 64; cudaErrorInvalidValue when neither fits.
template <int DP>
int by_rows(const float* q, const float* k, const float* v, float* out, int B,
            int Sq, int Skv, int H, int KH, int D, int kb, int causal,
            int window, float scale, int vec, cudaStream_t s) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int optin = 0;
  err = (int)cudaDeviceGetAttribute(&optin,
                                    cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    dev);
  if (err) return err;
  if constexpr (DP <= 128) {
    const size_t smem = Plan<8, DP>::smem_bytes(kb);
    if (smem <= (size_t)optin)
      return launch<8, DP>(q, k, v, out, B, Sq, Skv, H, KH, D, kb, causal, window, scale, vec, smem, dev, s);
  }
  const size_t smem = Plan<4, DP>::smem_bytes(kb);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  return launch<4, DP>(q, k, v, out, B, Sq, Skv, H, KH, D, kb, causal, window, scale, vec, smem, dev, s);
}

}  // namespace

extern "C" {

// Launches the forward on ``stream``; allocates nothing (``out`` comes
// from the caller). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for shapes the kernel does not take: D > 256, or
// shared-memory tiles (4 bytes x (BQ (DP + 4) + 2 · 8,704 + kb (BQ + 4)
// + 2 BQ), DP = D rounded up to 64, 128 or 256, BQ = 64) larger than the
// device's opt-in limit per block.
int flash_attention_fwd_f32(const float* q, const float* k, const float* v,
                            float* out, int B, int Sq, int Skv, int H, int KH,
                            int D, int kb, int causal, int window,
                            float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || KH <= 0 || H % KH ||
      D <= 0 || D > 256 || kb <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  // 16-byte copies need every row start 16-byte aligned
  const int vec = D % 4 == 0 && (uintptr_t)q % 16 == 0 &&
                  (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 64) return by_rows<64>(q, k, v, out, B, Sq, Skv, H, KH, D, kb, causal, window, scale, vec, s);
  if (D <= 128) return by_rows<128>(q, k, v, out, B, Sq, Skv, H, KH, D, kb, causal, window, scale, vec, s);
  return by_rows<256>(q, k, v, out, B, Sq, Skv, H, KH, D, kb, causal, window, scale, vec, s);
}

}  // extern "C"
