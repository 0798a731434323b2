// Min and argmin over M centers of ||x_i - c_j||^2, for Hopper (sm_90a).
//
// Replaces: pairwise_min_argmin_pallas / _kernel in
// src/repro/kernels/pairwise/kernel.py.
//
// For each row i of x (N, d): min_j max(x²_i + c²_j − 2 x_i·c_j, 0) and
// the lowest j reaching it, without ever writing the (N, M) matrix.
//
// What bounds it on the H100: at DBAL's shapes (N = 10·budget rows, M =
// budget centers, d = 512) it is fp32 operations — 2·N·M·d FMAs against
// (N + M)·d·4 bytes read, about M/2 operations per byte. TF32 is off, so
// the tensor cores are not in play and the ceiling is the 67 TFLOP/s of
// the fp32 units.
// What the design does about it: a register-tiled product. A block owns
// 64 rows and walks every center in 64-center tiles; a 16x16 thread grid
// holds a 4x4 micro-tile of dot products each, fed from shared-memory
// tiles of x and c (16 features deep), so each value loaded from shared
// memory feeds four FMAs. Each dot product accumulates over d in one
// fixed order. Every thread keeps a running (min, argmin) for its four
// rows over the centers it visits, in ascending center order with a
// strict <, and the 16 threads sharing a row reduce their pairs with the
// explicit rule (value asc, index asc): ties go to the lowest center.
// The ragged edges of N, M and d are masked in the kernel, not padded.
// Squared norms come from a small first pass (``sq_norms_kernel``) into
// scratch the wrapper allocates.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // rows per block
constexpr int BN = 64;   // centers per tile
constexpr int BK = 16;   // features per shared-memory stage
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // centers per thread
constexpr int kThreads = (BM / TM) * (BN / TN);   // 256
constexpr float kBig = 3.4e38f;

__global__ void sq_norms_kernel(const float* __restrict__ a, float* __restrict__ out,
                                int rows, int d) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* ar = a + (size_t)row * d;
  float s = 0.f;
  for (int j = lane; j < d; j += 32) s = fmaf(ar[j], ar[j], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[row] = s;
}

__global__ void __launch_bounds__(kThreads)
min_argmin_kernel(const float* __restrict__ x, const float* __restrict__ c,
                  const float* __restrict__ x2, const float* __restrict__ c2,
                  float* __restrict__ out_min, int* __restrict__ out_arg,
                  int n, int m, int d) {
  __shared__ float xs[BK][BM];     // transposed tiles: [feature][row]
  __shared__ float cs[BK][BN];
  __shared__ float red_v[BN / TN][BM];
  __shared__ int red_i[BN / TN][BM];

  const int tx = threadIdx.x % (BN / TN);   // center group
  const int ty = threadIdx.x / (BN / TN);   // row group
  const int row0 = blockIdx.x * BM;

  float best[TM];
  int besti[TM];
#pragma unroll
  for (int a = 0; a < TM; ++a) { best[a] = kBig; besti[a] = 0; }

  float xn[TM];
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int row = row0 + ty * TM + a;
    xn[a] = row < n ? x2[row] : 0.f;
  }

  for (int col0 = 0; col0 < m; col0 += BN) {
    float acc[TM][TN];
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int b = 0; b < TN; ++b) acc[a][b] = 0.f;

    for (int k0 = 0; k0 < d; k0 += BK) {
      // each thread stages 4 values of each tile (BM*BK / 256 = 4)
      for (int t = threadIdx.x; t < BM * BK; t += kThreads) {
        const int rr = t / BK, kk = t % BK;
        const int row = row0 + rr, k = k0 + kk;
        xs[kk][rr] = (row < n && k < d) ? x[(size_t)row * d + k] : 0.f;
        const int col = col0 + rr;
        cs[kk][rr] = (col < m && k < d) ? c[(size_t)col * d + k] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float xa[TM], cb[TN];
#pragma unroll
        for (int a = 0; a < TM; ++a) xa[a] = xs[kk][ty * TM + a];
#pragma unroll
        for (int b = 0; b < TN; ++b) cb[b] = cs[kk][tx * TN + b];
#pragma unroll
        for (int a = 0; a < TM; ++a)
#pragma unroll
          for (int b = 0; b < TN; ++b) acc[a][b] = fmaf(xa[a], cb[b], acc[a][b]);
      }
      __syncthreads();
    }
    // distances for this tile; ascending center order, strict <
#pragma unroll
    for (int b = 0; b < TN; ++b) {
      const int col = col0 + tx * TN + b;
      if (col < m) {
        const float cn = c2[col];
#pragma unroll
        for (int a = 0; a < TM; ++a) {
          const float dist = fmaxf(xn[a] + cn - 2.0f * acc[a][b], 0.0f);
          if (dist < best[a]) { best[a] = dist; besti[a] = col; }
        }
      }
    }
  }

  // reduce the (min, argmin) pairs of the BN/TN threads sharing each row
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    red_v[tx][ty * TM + a] = best[a];
    red_i[tx][ty * TM + a] = besti[a];
  }
  __syncthreads();
  if (threadIdx.x < BM) {
    const int rr = threadIdx.x;
    float bv = red_v[0][rr];
    int bi = red_i[0][rr];
    for (int q = 1; q < BN / TN; ++q) {
      const float v = red_v[q][rr];
      const int i = red_i[q][rr];
      if (v < bv || (v == bv && i < bi)) { bv = v; bi = i; }
    }
    const int row = row0 + rr;
    if (row < n) { out_min[row] = bv; out_arg[row] = bi; }
  }
}

}  // namespace

extern "C" {

// Launches the norm pass and the min/argmin pass on ``stream``; allocates
// nothing (x2 (n,) and c2 (m,) are scratch from the caller). Returns
// cudaGetLastError() after the launches.
int pairwise_min_argmin_f32(const float* x, const float* c, float* x2,
                            float* c2, float* out_min, int* out_arg, int n,
                            int m, int d, void* stream) {
  if (n <= 0 || m <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int warps = 8;
  sq_norms_kernel<<<(n + warps - 1) / warps, warps * 32, 0, s>>>(x, x2, n, d);
  int err = (int)cudaGetLastError();
  if (err) return err;
  sq_norms_kernel<<<(m + warps - 1) / warps, warps * 32, 0, s>>>(c, c2, m, d);
  err = (int)cudaGetLastError();
  if (err) return err;
  min_argmin_kernel<<<(n + BM - 1) / BM, kThreads, 0, s>>>(
      x, c, x2, c2, out_min, out_arg, n, m, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
