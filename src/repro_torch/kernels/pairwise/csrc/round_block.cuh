// The row bodies and the in-launch argmax shared by the fused greedy round
// (greedy_round.cu) and its block-masked variant (gated_greedy_round.cu),
// for Hopper (sm_90a).
//
// A CTA of kThreads threads owns a range of consecutive pool rows. It folds
// queued centers into each row's running min sq-dist, writes the new
// min-dist, and keeps the best (score, row) it saw; ``finish_round`` then
// writes the CTA's (max score, lowest row index) pair, and the last CTA to
// finish reduces every CTA's pair into the launch's one (score, index).
// The two kernels differ only around these bodies (which rows are live,
// which centers are pending, whether rows listed in ``sel`` are masked),
// so an all-live, zero-pending gated round equals the plain round bit for
// bit.
//
// A row's floats depend on d and the form alone, never on N, the rows a
// CTA owns, the grid, the tile or the rows beside it:
//
// Difference form (the plain round at R == 1): sum_j (x_j - c_j)^2.
//   The row is cut into chunks of 4 floats when d % 4 == 0 and d >= 128,
//   else of one float. G lanes own a row: G = 32 when the row has at least
//   32 chunks, else the largest power of two not above its chunk count
//   (so a 4-float chunk always has 32 lanes, and below d = 128 a lane adds
//   single floats). Lane l of the
//   group adds chunks l, l + G, l + 2G, ... in that order into one fmaf
//   chain (a chunk's floats in column order); the G partials then meet in
//   an xor tree (offsets G/2, ..., 1). IEEE addition commutes, so every
//   lane of the group ends with the same bits. 16-byte loads where the
//   rows are 16-byte aligned; the same chunks by 4-byte loads where they
//   are not (same order, same bits).
// Matmul form (the plain round at R > 1, the gated round at every R):
//   max(x2 + c2 - 2 x.c, 0), evaluated in double as fma(-2, x.c, x2 +
//   c2) and rounded to float once. x.c is one thread's float sum over d in
//   blocks of BK = 16 features: an fmaf chain over a block's features in
//   order, added to the running sum block by block from j = 0. x2 and c2
//   are one thread's fma chain in double over j = 0, 1, ..., d - 1. So a
//   far row's large norms carry no rounding of their own into its
//   distance (the tile's zero padding past d adds +0 exactly to all three).
// The min over centers (fminf) is exact and order-independent.
//
// Score ties resolve to the lowest row index by an explicit (value desc,
// index asc) order, inside a CTA and across CTAs: no float atomics. The
// only atomic is the integer ticket that elects the last CTA.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace round_block {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 3.4e38f;
// true: the last CTA to finish reduces the partials (an integer ticket);
// false: a one-CTA pass behind the round does (a second launch)
constexpr bool kTicket = true;
// chunks of row data in flight a lane in the difference form
constexpr int kInFlight = 4;
// CTAs an SM the matmul form's register budget is cut for
constexpr int kMatmulCtas = 2;

// ---------------------------------------------------------- the layout --
// Floats a chunk of a row: 4 when d % 4 == 0 and d >= 128, else 1.
__host__ __device__ inline int row_chunk(int d) {
  return d % 4 == 0 && d >= 128 ? 4 : 1;
}

// Lanes that own a row in the difference form (a function of d alone).
__host__ __device__ inline int row_lanes(int d) {
  const int q = d / row_chunk(d);
  int g = 1;
  while (g < 32 && 2 * g <= q) g *= 2;
  return g;
}

// The most chunks one lane takes of a row.
__host__ __device__ inline int lane_chunks(int d) {
  const int q = d / row_chunk(d), g = row_lanes(d);
  return (q + g - 1) / g;
}

// Chunks of a row a lane loads at once (U), by lane_chunks.
__host__ __device__ inline int chunks_in_flight(int d) {
  const int t = lane_chunks(d);
  return t <= 2 ? 2 : t <= 4 ? 4 : 8;
}

// Rows a lane group reads at once (P) for a given U.
__host__ __device__ constexpr int rows_in_flight(int u) {
  return kInFlight / u > 0 ? kInFlight / u : 1;
}

// (value desc, index asc): true when (v, i) should replace (bv, bi)
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// ------------------------------------------- the running min and score --
// Folds ``dist`` into row ``row``'s min-dist, masks it when selected,
// writes it and offers its score to the thread's best (v, vi). Rows with
// nm < 0 never score (pinned before the weight multiply).
__device__ __forceinline__ void fold_row(float dist, float m, float wt,
                                         bool hit, int row,
                                         float* __restrict__ nmind, float& v,
                                         int& vi) {
  float nm = fminf(m, dist);
  if (hit) nm = -1.0f;
  nmind[row] = nm;
  if (!(nm < 0.0f)) {
    const float sc = nm * wt;
    if (better(sc, row, v, vi)) { v = sc; vi = row; }
  }
}

// ---------------------------------------------------- difference form --
template <int W>
struct Chunk;
template <>
struct Chunk<4> {
  using T = float4;
  template <bool VEC>
  static __device__ __forceinline__ float4 load(const float* p) {
    if constexpr (VEC) {
      return __ldg(reinterpret_cast<const float4*>(p));
    } else {
      return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
    }
  }
  static __device__ __forceinline__ float4 zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ float add_sq_diff(float4 a, float4 b,
                                                      float s) {
    float df = a.x - b.x;
    s = fmaf(df, df, s);
    df = a.y - b.y;
    s = fmaf(df, df, s);
    df = a.z - b.z;
    s = fmaf(df, df, s);
    df = a.w - b.w;
    return fmaf(df, df, s);
  }
};
template <>
struct Chunk<1> {
  using T = float;
  template <bool VEC>
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float zero() { return 0.f; }
  static __device__ __forceinline__ float add_sq_diff(float a, float b,
                                                      float s) {
    const float df = a - b;
    return fmaf(df, df, s);
  }
};

// The difference form of rows row[0..P) (one step of a lane group; rows
// at or past ``end`` add nothing) against the one center ``c``: on return
// every lane of the group holds acc[p] for its row p. Lane gl keeps U
// chunks of each of its P rows in flight.
template <int W, bool VEC, int P, int U>
__device__ __forceinline__ void diff_sums(const float* __restrict__ x,
                                          const float* __restrict__ c,
                                          const int (&row)[P], int end,
                                          int d, float (&acc)[P]) {
  using C = Chunk<W>;
  const int G = row_lanes(d);
  const int gl = threadIdx.x & (G - 1);
  const int q = d / W;
  const int tmax = (q + G - 1) / G;
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = 0.f;
  for (int t0 = 0; t0 < tmax; t0 += U) {
    typename C::T xv[P][U];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int ch = gl + (t0 + u) * G;
        xv[p][u] = row[p] < end && ch < q
                       ? C::template load<VEC>(x + (size_t)row[p] * d +
                                               ch * W)
                       : C::zero();
      }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int ch = gl + (t0 + u) * G;
      if (ch < q) {
        const typename C::T cv = C::template load<VEC>(c + ch * W);
#pragma unroll
        for (int p = 0; p < P; ++p)
          acc[p] = C::add_sq_diff(xv[p][u], cv, acc[p]);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p)
    for (int off = G >> 1; off > 0; off >>= 1)
      acc[p] += __shfl_xor_sync(0xffffffffu, acc[p], off);
}

// Rows [row0, row0 + rows) (clipped at n) against the one center ``c``.
// Warp w's steps take S * P consecutive rows (S = 32 / G groups a warp, P
// rows a group), steps strided by kWarps. With FOLD each row's distance is
// folded into its min-dist and scored (``sel0`` is the one selected row or
// -1; ``w`` may be null); without, it only lowers ``tmin[row - row0]``
// (shared memory, the caller's running min over centers).
template <int W, bool VEC, int P, int U, bool FOLD = true>
__device__ void diff_rows(const float* __restrict__ x,
                          const float* __restrict__ c,
                          const float* __restrict__ mind, int sel0,
                          const float* __restrict__ w,
                          float* __restrict__ nmind, int n, int d, int row0,
                          int rows, float& v, int& vi,
                          float* tmin = nullptr) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int G = row_lanes(d);
  const int S = 32 / G;
  const int gl = lane & (G - 1);
  const int grp = lane / G;
  const int end = min(row0 + rows, n);
  for (int step = row0 + warp * S * P; step < end;      // uniform per warp
       step += kWarps * S * P) {
    int row[P];
    float acc[P], m[P], wt[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      row[p] = step + p * S + grp;
      if constexpr (FOLD) {
        const bool ok = row[p] < end && gl == 0;
        m[p] = ok ? __ldg(mind + row[p]) : 0.f;
        wt[p] = ok && w != nullptr ? __ldg(w + row[p]) : 1.f;
      }
    }
    diff_sums<W, VEC, P, U>(x, c, row, end, d, acc);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (gl == 0 && row[p] < end) {
        if constexpr (FOLD)
          fold_row(acc[p], m[p], wt[p], row[p] == sel0, row[p], nmind, v,
                   vi);
        else
          tmin[row[p] - row0] = fminf(tmin[row[p] - row0], acc[p]);
      }
    }
  }
}

// -------------------------------------------------------- matmul form --
constexpr int BK = 16;      // features a stage
constexpr int KP = BK + 4;  // a staged row, padded: 20 floats
constexpr int STAGES = 3;   // cp.async ring depth

// A thread holds TM rows x TN centers of dot products; GX threads share a
// row (consecutive lanes), GY = kThreads / GX rows of threads.
template <int TM_, int TN_, int GX_>
struct Tile {
  static constexpr int TM = TM_, TN = TN_, GX = GX_;
  static constexpr int GY = kThreads / GX;
  static constexpr int BM = GY * TM;
  static constexpr int BN = GX * TN;
  static_assert(GX <= 32 && 32 % GX == 0, "a row's threads share a warp");
};
using NarrowTile = Tile<1, 2, 4>;    // 64 rows x 8 centers: R <= 8
using WideTile = Tile<4, 4, 16>;     // 64 rows x 64 centers

template <class Tl>
struct TileSmem {
  float xs[STAGES][Tl::BM][KP];
  float cs[STAGES][Tl::BN][KP];
  unsigned char hit[Tl::BM];   // the row tile's rows listed in sel
};

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

// s + the squares of a's four floats, in double, in order.
__device__ __forceinline__ double sq4(float4 a, double s) {
  s = fma((double)a.x, (double)a.x, s);
  s = fma((double)a.y, (double)a.y, s);
  s = fma((double)a.z, (double)a.z, s);
  return fma((double)a.w, (double)a.w, s);
}

// Center k's row: centers[k] or, with ``cidx``, row cidx[k] of x.
__device__ __forceinline__ const float* center_row(
    const float* __restrict__ x, const float* __restrict__ centers,
    const int* __restrict__ cidx, int k, int d) {
  return cidx != nullptr ? x + (size_t)__ldg(cidx + k) * d
                         : centers + (size_t)k * d;
}

// Stages features [k0, k0 + BK) of rows [rt, rt + BM) (below ``end``) and
// centers [ct, ct + BN) (below r); the rest zero-fills.
template <class Tl, bool VEC>
__device__ __forceinline__ void stage(TileSmem<Tl>& t, int st,
                                      const float* __restrict__ x,
                                      const float* __restrict__ centers,
                                      const int* __restrict__ cidx, int rt,
                                      int end, int ct, int r, int k0, int d) {
  constexpr int V = VEC ? 4 : 1;
  for (int e = threadIdx.x; e < (Tl::BM + Tl::BN) * (BK / V);
       e += kThreads) {
    const int i = e / (BK / V), kk = V * (e % (BK / V)), k = k0 + kk;
    const bool is_x = i < Tl::BM;
    const int row = is_x ? rt + i : ct + i - Tl::BM;
    const bool ok = row < (is_x ? end : r) && k < d;
    const float* src = x;
    if (ok)
      src = (is_x ? x + (size_t)row * d : center_row(x, centers, cidx, row,
                                                     d)) + k;
    float* dst = is_x ? &t.xs[st][i][kk] : &t.cs[st][i - Tl::BM][kk];
    if constexpr (VEC)
      cp_async16(dst, src, ok);
    else
      cp_async4(dst, src, ok);
  }
}

// Rows [row0, row0 + rows) (clipped at n) against centers [c_from, r) in
// the matmul form, BM rows at a time; each row tile reads its rows once a
// center tile (x2 with the first), every center tile in one pass over d.
// ``sel`` (nsel entries, may be null) masks rows; ``w`` may be null.
// With ``forms`` (may be null) only centers k with forms[k] != 0 count.
// With ``tmin`` a row's min over those centers only lowers
// ``tmin[row - row0]`` (shared memory) and nothing is folded or scored.
template <class Tl, bool VEC>
__device__ void matmul_rows(TileSmem<Tl>& t, const float* __restrict__ x,
                            const float* __restrict__ centers,
                            const int* __restrict__ cidx,
                            const float* __restrict__ mind,
                            const int* __restrict__ sel, int nsel,
                            const float* __restrict__ w,
                            float* __restrict__ nmind, int n, int d, int r,
                            int row0, int rows, int c_from, float& v,
                            int& vi,
                            const signed char* __restrict__ forms = nullptr,
                            float* tmin = nullptr) {
  constexpr int TM = Tl::TM, TN = Tl::TN, GX = Tl::GX, GY = Tl::GY;
  const int tx = threadIdx.x % GX;
  const int ty = threadIdx.x / GX;
  const int end = min(row0 + rows, n);
  const int nk = (d + BK - 1) / BK;
  for (int rt = row0; rt < end; rt += Tl::BM) {
    if (sel != nullptr) {            // mark the tile's selected rows once
      __syncthreads();
      for (int i = threadIdx.x; i < Tl::BM; i += kThreads) t.hit[i] = 0;
      __syncthreads();
      for (int j = threadIdx.x; j < nsel; j += kThreads) {
        const int s = __ldg(sel + j);
        if (s >= rt && s < rt + Tl::BM) t.hit[s - rt] = 1;
      }
      __syncthreads();
    }
    float best[TM];
    double x2[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) { best[i] = kBig; x2[i] = 0.0; }
    for (int ct = c_from; ct < r; ct += Tl::BN) {
      const bool first = ct == c_from;
      float acc[TM][TN];
      double c2[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        c2[j] = 0.0;
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i][j] = 0.f;
      }
#pragma unroll
      for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nk)
          stage<Tl, VEC>(t, s, x, centers, cidx, rt, end, ct, r, s * BK, d);
        cp_async_commit();
      }
      for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        const int nt = kt + STAGES - 1;
        if (nt < nk)
          stage<Tl, VEC>(t, nt % STAGES, x, centers, cidx, rt, end, ct, r,
                         nt * BK, d);
        cp_async_commit();
        const int st = kt % STAGES;
        float bacc[TM][TN];                     // this block's dots
#pragma unroll
        for (int j = 0; j < TN; ++j)
#pragma unroll
          for (int i = 0; i < TM; ++i) bacc[i][j] = 0.f;
#pragma unroll
        for (int k4 = 0; k4 < BK; k4 += 4) {
          float4 a[TM], b[TN];
#pragma unroll
          for (int i = 0; i < TM; ++i)
            a[i] = *reinterpret_cast<const float4*>(
                &t.xs[st][ty + i * GY][k4]);
#pragma unroll
          for (int j = 0; j < TN; ++j)
            b[j] = *reinterpret_cast<const float4*>(
                &t.cs[st][tx + j * GX][k4]);
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              bacc[i][j] = fmaf(a[i].x, b[j].x, bacc[i][j]);
              bacc[i][j] = fmaf(a[i].y, b[j].y, bacc[i][j]);
              bacc[i][j] = fmaf(a[i].z, b[j].z, bacc[i][j]);
              bacc[i][j] = fmaf(a[i].w, b[j].w, bacc[i][j]);
            }
#pragma unroll
          for (int j = 0; j < TN; ++j) c2[j] = sq4(b[j], c2[j]);
          if (first) {
#pragma unroll
            for (int i = 0; i < TM; ++i) x2[i] = sq4(a[i], x2[i]);
          }
        }
#pragma unroll
        for (int j = 0; j < TN; ++j)
#pragma unroll
          for (int i = 0; i < TM; ++i)
            acc[i][j] = __fadd_rn(acc[i][j], bacc[i][j]);
      }
      cp_async_wait<0>();
      __syncthreads();            // the next tile's copies reuse the ring
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int k = ct + tx + j * GX;
        if (k < r && (forms == nullptr || __ldg(forms + k) != 0)) {
#pragma unroll
          for (int i = 0; i < TM; ++i)
            best[i] = fminf(best[i], __double2float_rn(fmax(
                fma(-2.0, (double)acc[i][j], __dadd_rn(x2[i], c2[j])),
                0.0)));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int off = GX / 2; off > 0; off >>= 1)
        best[i] = fminf(best[i], __shfl_xor_sync(0xffffffffu, best[i], off));
      const int row = rt + ty + i * GY;
      if (tx == 0 && row < end) {
        if (tmin != nullptr)
          tmin[row - row0] = fminf(tmin[row - row0], best[i]);
        else
          fold_row(best[i], __ldg(mind + row),
                   w != nullptr ? __ldg(w + row) : 1.f,
                   sel != nullptr && t.hit[row - rt], row, nmind, v, vi);
      }
    }
  }
}

// ------------------------------------------------------ the final argmax --
// The best (v, vi) over the CTA's threads, in thread 0.
__device__ __forceinline__ void cta_best(float& v, int& vi) {
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, vi, off);
    if (better(ov, oi, v, vi)) { v = ov; vi = oi; }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                 // red_* may still be read by a caller
  if (lane == 0) { red_v[warp] = v; red_i[warp] = vi; }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int q = 1; q < kWarps; ++q)
      if (better(red_v[q], red_i[q], v, vi)) { v = red_v[q]; vi = red_i[q]; }
  }
}

// Reduces the ``nb`` CTA pairs to one (score, index) into out[0], out[1]
// (the index's bits). One CTA; every thread must call it.
__device__ __forceinline__ void reduce_partials(const float* __restrict__ bmax,
                                                const int* __restrict__ barg,
                                                int nb, float* out) {
  float v = -kBig;
  int vi = 0x7fffffff;
  for (int b = threadIdx.x; b < nb; b += kThreads) {
    const float bv = __ldcg(bmax + b);
    const int bi = __ldcg(barg + b);
    if (better(bv, bi, v, vi)) { v = bv; vi = bi; }
  }
  cta_best(v, vi);
  if (threadIdx.x == 0) {
    out[0] = v;
    reinterpret_cast<int*>(out)[1] = vi;
  }
}

// Writes this CTA's (max, lowest index) pair to bmax/barg[blockIdx.x];
// with kTicket, the last CTA to finish (an integer ticket on ``ticket``,
// which it resets to 0 for the next launch on the stream) reduces every
// pair into out. Every thread of the CTA must call it.
__device__ __forceinline__ void finish_round(float v, int vi,
                                             float* __restrict__ bmax,
                                             int* __restrict__ barg,
                                             unsigned int* ticket,
                                             float* out) {
  __shared__ bool last;
  cta_best(v, vi);
  if (threadIdx.x == 0) {
    bmax[blockIdx.x] = v;
    barg[blockIdx.x] = vi;
    if constexpr (kTicket) {
      __threadfence();
      last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    }
  }
  if constexpr (kTicket) {
    __syncthreads();
    if (!last) return;
    __threadfence();
    reduce_partials(bmax, barg, gridDim.x, out);
    if (threadIdx.x == 0) *ticket = 0u;
  }
}

// The one-CTA final pass (kTicket == false).
__global__ void __launch_bounds__(kThreads)
final_argmax_kernel(const float* __restrict__ bmax,
                    const int* __restrict__ barg, int nb, float* out) {
  reduce_partials(bmax, barg, nb, out);
}

// Launches the final pass when there is no ticket.
inline int launch_final(const float* bmax, const int* barg, int nb,
                        float* out, cudaStream_t s) {
  if constexpr (!kTicket) {
    final_argmax_kernel<<<1, kThreads, 0, s>>>(bmax, barg, nb, out);
  }
  return (int)cudaGetLastError();
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace round_block
