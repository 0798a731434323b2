// The per-row-block body shared by the fused greedy round (greedy_round.cu)
// and its block-masked variant (gated_greedy_round.cu), for Hopper (sm_90a).
//
// One CTA of kThreads threads owns ``rows`` consecutive pool rows starting
// at ``row0``. It folds the queued centers [c_from, r) into each row's
// running min sq-dist, writes the new min-dist, and emits one
// (max score, lowest row index) pair for the block. The two kernels differ
// only around this body (which rows are live, which centers are pending,
// whether rows listed in ``sel`` are masked), so every row's floats come
// from the same code in both: an all-live, zero-pending gated round equals
// the plain round bit for bit.
//
// Per-row arithmetic, fixed whatever the block size or N:
//   difference form (the plain round at R == 1): sum_j (x_j - c_j)^2
//   matmul form (otherwise): max(x2 + c2 - 2 x.c, 0)
// Each sum runs over j in lane-strided order (lane l adds j = l, l+32, ...
// in sequence) and then through a fixed xor-shuffle tree, so a row's value
// depends on neither its block nor its neighbours. The min over centers
// (fminf) is exact and order-independent. Score ties resolve to the lowest
// row index by an explicit (value desc, index asc) reduction: no float
// atomics anywhere.
//
// Layout: warp w owns rows [row0 + w*rpw, row0 + (w+1)*rpw), rpw =
// ceil(rows / kWarps), visited in passes of 32 rows in which lane k keeps
// row k's running min. Each pass stages the queued centers in shared
// memory, ``chunk`` at a time, and streams its rows from global memory
// (coalesced: neighbouring lanes read neighbouring floats).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace round_block {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 3.4e38f;
// shared memory for one chunk of centers (plus their squared norms)
constexpr int kCenterSmemBytes = 64 * 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// (value desc, index asc): true when (v, i) should replace (bv, bi)
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Centers staged per chunk for an (N, d) pool and R queued centers: the
// most that fit kCenterSmemBytes, at most max(r, 1); 0 when d is too wide.
inline int center_chunk(int d, int r) {
  int chunk = kCenterSmemBytes / (int)((d + 1) * sizeof(float));
  const int cap = r > 1 ? r : 1;
  return chunk > cap ? cap : chunk;
}

inline size_t center_smem_bytes(int d, int chunk) {
  return (size_t)chunk * (d + 1) * sizeof(float);
}

// Folds centers [c_from, r) into rows [row0, row0 + rows) and writes the
// block's (max, argmax) pair to bmax[block], barg[block]. ``sel`` (may be
// null) lists r pool rows to mask to -1; ``w`` (may be null) weights the
// score. Rows with nm < 0 and rows past n score -BIG, pinned before the
// weight multiply. Every thread of the CTA must call it (it syncs).
__device__ void fold_rows(const float* __restrict__ x,
                          const float* __restrict__ mind,
                          const float* __restrict__ centers,
                          const int* __restrict__ sel,
                          const float* __restrict__ w,
                          float* __restrict__ nmind,
                          float* __restrict__ bmax,
                          int* __restrict__ barg,
                          int n, int d, int r, int row0, int rows,
                          int c_from, bool diff_form, int chunk, int block) {
  extern __shared__ float smem[];
  float* cs = smem;                        // (chunk, d) centers
  float* c2s = smem + (size_t)chunk * d;   // (chunk,) their squared norms
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rpw = (rows + kWarps - 1) / kWarps;
  const int wrow0 = row0 + warp * rpw;
  const int wlim = min(min(wrow0 + rpw, row0 + rows), n);
  const int passes = (rpw + 31) / 32;       // uniform across the CTA

  float v = -kBig;                           // this lane's best (score, row)
  int vi = row0;
  for (int p = 0; p < passes; ++p) {
    const int prow0 = wrow0 + p * 32;
    const int count = max(0, min(32, wlim - prow0));   // uniform per warp
    float best = kBig;       // lane k: running min over centers of row k
    float x2_lane = 0.f;     // lane k: ||x||^2 of row k (matmul form)
    if (!diff_form) {
      for (int k = 0; k < count; ++k) {
        const float* xr = x + (size_t)(prow0 + k) * d;
        float s = 0.f;
#pragma unroll 4
        for (int j = lane; j < d; j += 32) s = fmaf(xr[j], xr[j], s);
        s = warp_sum(s);
        if (lane == k) x2_lane = s;
      }
    }
    for (int c0 = c_from; c0 < r; c0 += chunk) {
      const int cn = min(chunk, r - c0);
      __syncthreads();
      for (int t = threadIdx.x; t < cn * d; t += kThreads)
        cs[t] = centers[(size_t)c0 * d + t];
      __syncthreads();
      if (!diff_form) {
        for (int c = warp; c < cn; c += kWarps) {
          float s = 0.f;
          for (int j = lane; j < d; j += 32)
            s = fmaf(cs[c * d + j], cs[c * d + j], s);
          s = warp_sum(s);
          if (lane == 0) c2s[c] = s;
        }
        __syncthreads();
      }
      for (int k = 0; k < count; ++k) {
        const float* xr = x + (size_t)(prow0 + k) * d;
        float rmin = kBig;
        for (int c = 0; c < cn; ++c) {
          const float* cr = cs + c * d;
          float dist;
          if (diff_form) {
            float s = 0.f;
#pragma unroll 4
            for (int j = lane; j < d; j += 32) {
              const float df = xr[j] - cr[j];
              s = fmaf(df, df, s);
            }
            dist = warp_sum(s);
          } else {
            float s = 0.f;
#pragma unroll 4
            for (int j = lane; j < d; j += 32) s = fmaf(xr[j], cr[j], s);
            s = warp_sum(s);
            const float x2 = __shfl_sync(0xffffffffu, x2_lane, k);
            dist = fmaxf(x2 + c2s[c] - 2.0f * s, 0.0f);
          }
          rmin = fminf(rmin, dist);
        }
        if (lane == k) best = fminf(best, rmin);
      }
    }
    // fold into the running min-dist, mask, score
    if (lane < count) {
      const int row = prow0 + lane;
      float nm = fminf(mind[row], best);
      if (sel != nullptr) {
        bool hit = false;
        for (int j = 0; j < r; ++j) hit |= (sel[j] == row);
        if (hit) nm = -1.0f;
      }
      nmind[row] = nm;
      if (!(nm < 0.0f)) {
        const float sc = (w != nullptr) ? nm * w[row] : nm;
        if (better(sc, row, v, vi)) { v = sc; vi = row; }
      }
    }
  }

  // the block's (max, lowest index) pair
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, vi, off);
    if (better(ov, oi, v, vi)) { v = ov; vi = oi; }
  }
  if (lane == 0) { red_v[warp] = v; red_i[warp] = vi; }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bv = red_v[0];
    int bi = red_i[0];
    for (int q = 1; q < kWarps; ++q)
      if (better(red_v[q], red_i[q], bv, bi)) { bv = red_v[q]; bi = red_i[q]; }
    bmax[block] = bv;
    barg[block] = bi;
  }
}

}  // namespace round_block
