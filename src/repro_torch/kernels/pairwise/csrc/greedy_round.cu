// One fused k-center greedy round, for Hopper (sm_90a).
//
// Replaces: greedy_round_pallas / _greedy_kernel in
// src/repro/kernels/pairwise/kernel.py.
//
// What it computes, in one read of the (N, d) pool:
//   dmin[i]  = min over the R queued centers of ||x_i - c_j||^2
//              (difference form when R == 1, x² + c² − 2x·c clamped at 0
//              otherwise, as the plain version does)
//   nmind[i] = min(mind[i], dmin[i]), then -1 for rows listed in sel_idx
//   score[i] = nmind[i] * w[i] (or nmind[i] unweighted); rows with
//              nmind < 0 and rows past N score -BIG, pinned BEFORE the
//              weight multiply so a zero weight cannot revive them
//   per block: (max score, lowest row index reaching it)
// The host picks the first block holding the global max (torch.argmax),
// so exact ties go to the lowest pool index whatever the block size.
//
// What bounds it on the H100: at R == 1 (every k-center round) it is HBM
// bytes — N*d*4 read for 2*N*d operations, far below the card's ratio of
// operations to bytes. At R = r_block (the Core-Set warm start) the
// 2*N*R*d fp32 FMAs bound it.
// What the design does about it: each warp owns one row at a time and
// reads it with neighbouring lanes on neighbouring addresses, so the pool
// streams once, coalesced; the centers sit in shared memory, staged in
// chunks, and every center chunk reuses the row from L1. Nothing but the
// (N,) min-dist and one (max, argmax) pair per block is written. Each
// row's sum over d runs in a fixed order (lane-strided partial sums, then
// a fixed shuffle tree), so a row's result depends on neither N nor the
// block size. No float atomics: the per-block argmax is an explicit
// (value desc, index asc) reduction.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__global__ void greedy_round_kernel(const float* __restrict__ x,
                                    const float* __restrict__ mind,
                                    const float* __restrict__ centers,
                                    const int* __restrict__ sel,
                                    const float* __restrict__ w,
                                    float* __restrict__ nmind,
                                    float* __restrict__ bmax,
                                    int* __restrict__ barg,
                                    int n, int d, int r, int rows_per_block,
                                    int chunk) {
  extern __shared__ float smem[];
  float* cs = smem;                    // (chunk, d) centers
  float* c2s = smem + (size_t)chunk * d;  // (chunk,) their squared norms
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * rows_per_block;
  const int rows_per_warp = rows_per_block / kWarps;

  // per-warp state for its rows, held by lane k for row k (rows_per_warp <= 32)
  float best_d = kBig;   // running min over centers for row (warp, lane)
  float x2_lane = 0.f;   // ||x||^2 of that row (identity form only)

  if (r > 1) {
    for (int k = 0; k < rows_per_warp; ++k) {
      const int row = row0 + warp * rows_per_warp + k;
      float s = 0.f;
      if (row < n) {
        const float* xr = x + (size_t)row * d;
        #pragma unroll 4
        for (int j = lane; j < d; j += 32) s = fmaf(xr[j], xr[j], s);
      }
      s = warp_sum(s);
      if (lane == k) x2_lane = s;
    }
  }

  for (int c0 = 0; c0 < r; c0 += chunk) {
    const int cn = min(chunk, r - c0);
    __syncthreads();
    for (int t = threadIdx.x; t < cn * d; t += kThreads)
      cs[t] = centers[(size_t)c0 * d + t];
    __syncthreads();
    if (r > 1) {
      for (int c = warp; c < cn; c += kWarps) {
        float s = 0.f;
        for (int j = lane; j < d; j += 32) s = fmaf(cs[c * d + j], cs[c * d + j], s);
        s = warp_sum(s);
        if (lane == 0) c2s[c] = s;
      }
      __syncthreads();
    }
    for (int k = 0; k < rows_per_warp; ++k) {
      const int row = row0 + warp * rows_per_warp + k;
      if (row >= n) break;                 // uniform across the warp
      const float* xr = x + (size_t)row * d;
      float rmin = kBig;
      for (int c = 0; c < cn; ++c) {
        const float* cr = cs + c * d;
        float dist;
        if (r == 1) {
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
      if (lane == k) best_d = fminf(best_d, rmin);
    }
  }

  // fold into the running min-dist, mask, score, and reduce
  float v = -kBig;
  int vi = row0 + warp * rows_per_warp;
  if (lane < rows_per_warp) {
    const int row = row0 + warp * rows_per_warp + lane;
    vi = row;
    if (row < n) {
      float nm = fminf(mind[row], best_d);
      bool hit = false;
      for (int j = 0; j < r; ++j) hit |= (sel[j] == row);
      if (hit) nm = -1.0f;
      nmind[row] = nm;
      if (!(nm < 0.0f)) v = (w != nullptr) ? nm * w[row] : nm;
    }
  }
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
    bmax[blockIdx.x] = bv;
    barg[blockIdx.x] = bi;
  }
}

}  // namespace

extern "C" {

// Rows each thread block owns; the wrapper sizes the partials with it.
int greedy_round_rows_per_block() { return kWarps * 8; }

// Launches one fused round on ``stream``; allocates nothing. ``w`` may be
// null (unweighted). Outputs: nmind (n,), bmax/barg (ceil(n / rows),).
// Returns cudaGetLastError() after the launch.
int greedy_round_f32(const float* x, const float* mind, const float* centers,
                     const int* sel, const float* w, float* nmind,
                     float* bmax, int* barg, int n, int d, int r,
                     void* stream) {
  if (n <= 0 || d <= 0 || r <= 0) return (int)cudaErrorInvalidValue;
  const int rows = greedy_round_rows_per_block();
  int chunk = kCenterSmemBytes / (int)((d + 1) * sizeof(float));
  if (chunk < 1) return (int)cudaErrorInvalidValue;   // d too wide
  if (chunk > r) chunk = r;
  const size_t smem = (size_t)chunk * (d + 1) * sizeof(float);
  cudaFuncSetAttribute(greedy_round_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int blocks = (n + rows - 1) / rows;
  greedy_round_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      x, mind, centers, sel, w, nmind, bmax, barg, n, d, r, rows, chunk);
  return (int)cudaGetLastError();
}

}  // extern "C"
