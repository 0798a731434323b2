// Min and argmin over M centers of ||x_i - c_j||^2, for Hopper (sm_90a).
//
// Replaces: pairwise_min_argmin_pallas / _kernel in
// src/repro/kernels/pairwise/kernel.py.
//
// For each row i of x (N, d): min_j max(x²_i + c²_j − 2 x_i·c_j, 0) and
// the lowest j reaching it, without ever writing the (N, M) matrix.
//
// What bounds it on the H100: at DBAL's shapes (N = 10·budget rows, M =
// budget centers, d = 512) and the text path's (2,048 × 256, d = 4,096)
// it is fp32 operations — 2·N·M·d FLOP against (N + M)·d·4 bytes read,
// about M/2 operations per byte. TF32 is off, so the tensor cores are not
// in play and the ceiling is the 67 TFLOP/s of the fp32 units.
// What the design does about it:
// - The grid covers row tiles × center tiles, so a small pool still
//   fills the card (2,048 × 256 is 512 CTAs of 32 × 32, where one CTA per
//   64 rows gave 32 CTAs on 132 SMs). The tile (BM rows × BN centers) is
//   a launch parameter; the wrapper (``ops.argmin_plan``) picks the
//   largest tile whose grid holds at least two CTAs per SM
//   (``scripts/kernel_variants.py`` times every tile at the main paths'
//   shapes).
// - Each thread holds an 8 × 4 register micro-tile of dot products (rows
//   ty + i·BM/8, centers tx + j·BN/4), fed by 16-byte shared-memory loads
//   of four features of a row: 12 loads for 128 FMAs.
// - The x and c tiles are staged row-major with rows padded to 20 floats
//   (the 8 rows or centers a quarter-warp reads fall in 8 distinct bank
//   groups) through a ring of 3 shared-memory stages, filled by 16-byte
//   cp.async copies (4-byte ones when d is not a multiple of 4) that mask
//   the ragged edges of N, M and d with zeros; the copies of stage k + 2
//   run under the products of stage k.
// - Each CTA writes its rows' (min, argmin) over its center tile to
//   scratch of shape (center tiles, N); a second small pass merges the
//   tiles in ascending order under (value asc, index asc).
//
// Exactness: every (row, center) distance is computed as the first,
// row-tiled version of this kernel computed it, whatever the tile: x²
// and c² from ``sq_norms_kernel``, the dot product as one thread's fmaf
// chain over d ascending from 0 (zero features past d add +0), dist =
// fmaxf(xn + cn − 2·acc, 0). Minima combine only under (value asc,
// index asc), so ties go to the lowest center for every tile, and the
// outputs are bit-identical across tile plans, across row subsets and
// to that version. No atomics and no split over d (that would reorder
// the dot products).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 16;       // features per stage
constexpr int KP = BK + 4;   // a staged row, padded: 20 floats
constexpr int STAGES = 3;    // cp.async ring depth
constexpr int TM = 8;        // rows per thread
constexpr int TN = 4;        // centers per thread
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

// Asynchronous copies global -> shared of 16 or 4 bytes; they zero-fill
// when !ok (the source is then not read, but must still be a valid
// address).
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
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// (value asc, index asc): is (v, i) before (bv, bi)?
__device__ __forceinline__ bool before(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

template <int BM, int BN>
struct Tile {
  static constexpr int kThreads = (BM / TM) * (BN / TN);
  float xs[STAGES][BM][KP];   // [stage][row][feature]
  float cs[STAGES][BN][KP];   // [stage][center][feature]
};

// Stages features [k0, k0 + BK) of the CTA's rows and centers. VEC: d is
// a multiple of 4 and the arrays 16-byte aligned, so a row's features
// move 4 at a time; a warp reads 64-byte runs of 8 rows.
template <int BM, int BN, bool VEC>
__device__ __forceinline__ void stage_tiles(Tile<BM, BN>& t, int st,
                                            const float* __restrict__ x,
                                            const float* __restrict__ c,
                                            int row0, int col0, int k0,
                                            int n, int m, int d) {
  constexpr int W = VEC ? 4 : 1;          // features a copy
  for (int e = threadIdx.x; e < (BM + BN) * (BK / W);
       e += Tile<BM, BN>::kThreads) {
    const int r = e / (BK / W), kk = W * (e % (BK / W)), k = k0 + kk;
    const bool is_x = r < BM;
    const int i = is_x ? row0 + r : col0 + r - BM;
    const bool ok = i < (is_x ? n : m) && k < d;
    const float* base = is_x ? x : c;
    float* dst = is_x ? &t.xs[st][r][kk] : &t.cs[st][r - BM][kk];
    const float* src = ok ? base + (size_t)i * d + k : base;
    if constexpr (VEC)
      cp_async16(dst, src, ok);
    else
      cp_async4(dst, src, ok);
  }
}

template <int BM, int BN, bool VEC>
__global__ void __launch_bounds__(Tile<BM, BN>::kThreads)
tile_min_argmin_kernel(const float* __restrict__ x,
                       const float* __restrict__ c,
                       const float* __restrict__ x2,
                       const float* __restrict__ c2,
                       float* __restrict__ part_min,
                       int* __restrict__ part_arg, int n, int m, int d) {
  constexpr int GX = BN / TN;               // threads along the centers
  constexpr int GY = BM / TM;               // threads along the rows
  static_assert(GX <= 32 && 32 % GX == 0, "a row's threads share a warp");
  __shared__ __align__(16) Tile<BM, BN> t;

  const int tx = threadIdx.x % GX;
  const int ty = threadIdx.x / GX;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int nk = (d + BK - 1) / BK;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      stage_tiles<BM, BN, VEC>(t, s, x, c, row0, col0, s * BK, n, m, d);
    cp_async_commit();                      // empty groups keep the count
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();            // this thread's copies of kt
    __syncthreads();                        // ... everyone's; kt-1 is read
    const int nt = kt + STAGES - 1;
    if (nt < nk)
      stage_tiles<BM, BN, VEC>(t, nt % STAGES, x, c, row0, col0, nt * BK, n,
                               m, d);
    cp_async_commit();
    const int st = kt % STAGES;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float4 a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(&t.xs[st][ty + i * GY][k4]);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        b[j] = *reinterpret_cast<const float4*>(&t.cs[st][tx + j * GX][k4]);
      // each dot product stays one fmaf chain over d ascending
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
        }
    }
  }
  cp_async_wait<0>();

  // distances of this tile; ascending center order, strict <
  float best[TM];
  int besti[TM];
  float xn[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + ty + i * GY;
    xn[i] = row < n ? x2[row] : 0.f;
    best[i] = kBig;
    besti[i] = 0;
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = col0 + tx + j * GX;
    if (col < m) {
      const float cn = c2[col];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float dist = fmaxf(xn[i] + cn - 2.0f * acc[i][j], 0.0f);
        if (dist < best[i]) { best[i] = dist; besti[i] = col; }
      }
    }
  }
  // the GX threads of a row group are GX consecutive lanes of one warp;
  // (value asc, index asc) is a total order, so every lane ends with the
  // same pair whatever the shuffle tree
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int off = GX / 2; off > 0; off >>= 1) {
      const float v = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int ix = __shfl_xor_sync(0xffffffffu, besti[i], off);
      if (before(v, ix, best[i], besti[i])) { best[i] = v; besti[i] = ix; }
    }
  }
  if (tx == 0) {
    float* pm = part_min + (size_t)blockIdx.y * n;
    int* pa = part_arg + (size_t)blockIdx.y * n;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = row0 + ty + i * GY;
      if (row < n) { pm[row] = best[i]; pa[row] = besti[i]; }
    }
  }
}

// One thread a row: the center tiles' pairs in ascending tile order.
__global__ void merge_tiles_kernel(const float* __restrict__ part_min,
                                   const int* __restrict__ part_arg,
                                   float* __restrict__ out_min,
                                   int* __restrict__ out_arg, int n,
                                   int tiles) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float bv = part_min[row];
  int bi = part_arg[row];
  for (int t = 1; t < tiles; ++t) {
    const float v = part_min[(size_t)t * n + row];
    const int i = part_arg[(size_t)t * n + row];
    if (before(v, i, bv, bi)) { bv = v; bi = i; }
  }
  out_min[row] = bv;
  out_arg[row] = bi;
}

template <int BM, int BN>
int launch_tiles(const float* x, const float* c, const float* x2,
                 const float* c2, float* part_min, int* part_arg, int n,
                 int m, int d, cudaStream_t s) {
  const dim3 grid((n + BM - 1) / BM, (m + BN - 1) / BN);
  constexpr int threads = Tile<BM, BN>::kThreads;
  if (d % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)c % 16 == 0)
    tile_min_argmin_kernel<BM, BN, true><<<grid, threads, 0, s>>>(
        x, c, x2, c2, part_min, part_arg, n, m, d);
  else
    tile_min_argmin_kernel<BM, BN, false><<<grid, threads, 0, s>>>(
        x, c, x2, c2, part_min, part_arg, n, m, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the norm pass, the tile pass over (rows / bm) x (centers / bn)
// CTAs and the merge pass on ``stream``; allocates nothing (x2 (n,), c2
// (m,) and the partials (ceil(m / bn), n) are scratch from the caller).
// The tile (bm, bn) is one of (128, 64), (64, 64), (32, 64), (32, 32);
// any other, or more than 65,535 center tiles, returns
// cudaErrorInvalidValue. Otherwise returns cudaGetLastError() after the
// launches.
int pairwise_min_argmin_f32(const float* x, const float* c, float* x2,
                            float* c2, float* part_min, int* part_arg,
                            float* out_min, int* out_arg, int n, int m,
                            int d, int bm, int bn, void* stream) {
  if (n <= 0 || m <= 0 || d <= 0 || bn <= 0 || (m + bn - 1) / bn > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int warps = 8;
  sq_norms_kernel<<<(n + warps - 1) / warps, warps * 32, 0, s>>>(x, x2, n, d);
  int err = (int)cudaGetLastError();
  if (err) return err;
  sq_norms_kernel<<<(m + warps - 1) / warps, warps * 32, 0, s>>>(c, c2, m, d);
  err = (int)cudaGetLastError();
  if (err) return err;
  if (bm == 128 && bn == 64)
    err = launch_tiles<128, 64>(x, c, x2, c2, part_min, part_arg, n, m, d, s);
  else if (bm == 64 && bn == 64)
    err = launch_tiles<64, 64>(x, c, x2, c2, part_min, part_arg, n, m, d, s);
  else if (bm == 32 && bn == 64)
    err = launch_tiles<32, 64>(x, c, x2, c2, part_min, part_arg, n, m, d, s);
  else if (bm == 32 && bn == 32)
    err = launch_tiles<32, 32>(x, c, x2, c2, part_min, part_arg, n, m, d, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err) return err;
  const int threads = 256;
  merge_tiles_kernel<<<(n + threads - 1) / threads, threads, 0, s>>>(
      part_min, part_arg, out_min, out_arg, n, (m + bn - 1) / bn);
  return (int)cudaGetLastError();
}

}  // extern "C"
