// The block-masked (gated) greedy round, for Hopper (sm_90a).
//
// Replaces: gated_greedy_round_pallas / _gated_kernel in
// src/repro/kernels/pairwise/kernel.py.
//
// What it computes. Gate block b covers rows [b*nb, (b+1)*nb), nb =
// min(n_block, N), nn = ceil(N / nb) blocks.
//   live block (block_live[b] > 0): fold centers [block_pending[b], R) into
//     mind; center k in the difference form where forms[k] == 0 and in the
//     matmul form d = max(x² + c² − 2x·c, 0) where forms[k] == 1 or forms
//     is null (the matmul form at every R, R = 1 included, as
//     _gated_kernel and gated_greedy_round_ref do). Each form is the
//     plain round's own row body (round_block.cuh), and the min over
//     centers is exact, so folding entries [p, R) in one launch gives the
//     bits of one greedy_round launch per entry. A live block with nothing
//     pending reads no x row and scores its min-dists as they are.
//     score = nm * w (or nm); rows with nm < 0 and rows past N score -BIG.
//   dead block: reads no x row, copies mind through bit for bit, offers
//     the pair (-BIG, b*nb).
//   blocks = each gate block's (max score, lowest row index reaching it),
//     in block order; out = the same over all blocks, inside the launch,
//     so a caller needs no reduce on the host. Winner masking stays with
//     the caller.
//
// What bounds it on the H100: HBM bytes — the live rows' (live·nb, d)
// read plus three (N,) vectors (mind in, mind out, weights), against
// 2·live·d·R operations, far below the card's operations-to-bytes ratio
// at the R a fold takes (1, or a block's few pending centers).
// What the design does about it: a gate block is cut into row tiles of
// ``tile_rows`` rows, one CTA a tile (ops.gated_plan: B1's rows per CTA
// at this d), so a live gate block of 256 rows spreads over four SMs and
// a tenth of the pool live still puts a CTA on most SMs. A dead tile
// streams only its min-dist copy. A live tile keeps
// its rows' running min over centers in shared memory: the matmul tiles
// over the pending matmul-form centers (cp.async ring, x² and c² in the
// pass), then one difference-form pass a pending single center (16-byte
// chunks in flight a lane, as greedy_round.cu at R = 1), then one fold and
// score a row. Kernels that fold no matmul-form center are built without
// the matmul body, so their registers allow more CTAs an SM (such a kernel
// traps on a pending matmul-form center). The last CTA
// to finish (an integer ticket) merges each block's tiles in tile order
// into its pair and the blocks into the launch's pair; no float atomics.
// The tile size changes no float and no index.
#include "round_block.cuh"

namespace {

using namespace round_block;

// The most rows a tile: the shared running min holds one float a row.
constexpr int kMaxTileRows = 256;

struct Args {
  const float* x;
  const float* mind;
  const float* centers;
  const int* live;
  const int* pend;
  const signed char* forms;   // (r,) or null: every center the matmul form
  const float* w;
  float* nmind;
  float* bmax;                // (nn,) the blocks' pairs
  int* barg;
  float* tmax;                // (nn * tpb,) the tiles' pairs
  int* targ;
  unsigned int* ticket;
  float* out;
  int n, d, r, nb, tile, tpb, nn;
};

// Merges the tiles' pairs into the blocks' pairs (each block's tiles in
// order) and the blocks into out[0], out[1] (the index's bits). One CTA;
// every thread must call it.
__device__ __forceinline__ void reduce_tiles(const Args& a) {
  float gv = -kBig;
  int gi = 0x7fffffff;
  for (int b = threadIdx.x; b < a.nn; b += kThreads) {
    float bv = -kBig;
    int bi = 0x7fffffff;
    for (int t = 0; t < a.tpb; ++t) {
      const float tv = __ldcg(a.tmax + b * a.tpb + t);
      const int ti = __ldcg(a.targ + b * a.tpb + t);
      if (better(tv, ti, bv, bi)) { bv = tv; bi = ti; }
    }
    a.bmax[b] = bv;
    a.barg[b] = bi;
    if (better(bv, bi, gv, gi)) { gv = bv; gi = bi; }
  }
  cta_best(gv, gi);
  if (threadIdx.x == 0) {
    a.out[0] = gv;
    reinterpret_cast<int*>(a.out)[1] = gi;
  }
}

// Writes this tile's pair; with kTicket the last CTA to finish reduces.
__device__ __forceinline__ void finish_tile(float v, int vi, const Args& a) {
  __shared__ bool last;
  cta_best(v, vi);
  if (threadIdx.x == 0) {
    a.tmax[blockIdx.x] = v;
    a.targ[blockIdx.x] = vi;
    if constexpr (kTicket) {
      __threadfence();
      last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
    }
  }
  if constexpr (kTicket) {
    __syncthreads();
    if (!last) return;
    __threadfence();
    reduce_tiles(a);
    if (threadIdx.x == 0) *a.ticket = 0u;
  }
}

// One CTA a row tile. MM: whether the matmul body is built (a launch whose
// pending centers are all in the difference form takes MM = false).
template <int W, bool VEC, int U, bool MM, class Tl>
__global__ void __launch_bounds__(kThreads, MM ? kMatmulCtas : 1)
gated_greedy_round_kernel(Args a) {
  __shared__ float tmin[kMaxTileRows];
  __shared__ int s_lo, s_hi;
  constexpr int P = rows_in_flight(U);
  const int b = blockIdx.x / a.tpb;
  const int row0 = b * a.nb + (blockIdx.x % a.tpb) * a.tile;
  const int end = min(min(row0 + a.tile, (b + 1) * a.nb), a.n);
  const bool live = __ldg(a.live + b) > 0;           // uniform across the CTA
  const int c_from = live ? min(max(__ldg(a.pend + b), 0), a.r) : a.r;
  float v = -kBig;
  int vi = row0;
  if (c_from < a.r) {
    for (int i = threadIdx.x; i < end - row0; i += kThreads)
      tmin[i] = __int_as_float(0x7f800000);           // +inf
    int lo = c_from, hi = a.r;                        // matmul-form range
    if (a.forms != nullptr) {
      if (threadIdx.x == 0) { s_lo = a.r; s_hi = 0; }
      __syncthreads();
      for (int k = c_from + (int)threadIdx.x; k < a.r; k += kThreads)
        if (__ldg(a.forms + k) != 0) {
          atomicMin(&s_lo, k);
          atomicMax(&s_hi, k + 1);
        }
      __syncthreads();
      lo = s_lo;
      hi = s_hi;
    }
    __syncthreads();
    // mm = 0 promised no matmul-form center pending: a launch that breaks
    // it stops with a device fault rather than skip the center
    if constexpr (!MM) {
      if (lo < hi) __trap();
    }
    if constexpr (MM) {
      __shared__ __align__(16) TileSmem<Tl> t;
      if (lo < hi) {
        matmul_rows<Tl, VEC>(t, a.x, a.centers, nullptr, a.mind, nullptr, 0,
                             nullptr, a.nmind, end, a.d, hi, row0,
                             end - row0, lo, v, vi, a.forms, tmin);
        __syncthreads();        // the difference passes own rows otherwise
      }
    }
    if (a.forms != nullptr) {
      for (int k = c_from; k < a.r; ++k)
        if (__ldg(a.forms + k) == 0)
          diff_rows<W, VEC, P, U, false>(a.x, a.centers + (size_t)k * a.d,
                                         nullptr, -1, nullptr, nullptr, end,
                                         a.d, row0, end - row0, v, vi, tmin);
    }
    __syncthreads();
    for (int row = row0 + (int)threadIdx.x; row < end; row += kThreads) {
      const float nm = fminf(__ldg(a.mind + row), tmin[row - row0]);
      a.nmind[row] = nm;
      if (!(nm < 0.0f)) {
        const float sc = a.w != nullptr ? nm * __ldg(a.w + row) : nm;
        if (better(sc, row, v, vi)) { v = sc; vi = row; }
      }
    }
  } else {                      // dead, or live with nothing pending
    for (int row = row0 + (int)threadIdx.x; row < end; row += kThreads) {
      const float m = __ldg(a.mind + row);
      a.nmind[row] = m;
      if (live && !(m < 0.0f)) {
        const float sc = a.w != nullptr ? m * __ldg(a.w + row) : m;
        if (better(sc, row, v, vi)) { v = sc; vi = row; }
      }
    }
  }
  finish_tile(v, vi, a);
}

// The one-CTA final pass (kTicket == false).
__global__ void __launch_bounds__(kThreads) gated_final_kernel(Args a) {
  reduce_tiles(a);
}

template <int W, bool VEC, int U, bool MM>
void launch_tiles(const Args& a, int ctas, cudaStream_t s) {
  if constexpr (!MM)
    gated_greedy_round_kernel<W, VEC, U, false, NarrowTile>
        <<<ctas, kThreads, 0, s>>>(a);
  else if (a.r <= NarrowTile::BN)
    gated_greedy_round_kernel<W, VEC, U, true, NarrowTile>
        <<<ctas, kThreads, 0, s>>>(a);
  else
    gated_greedy_round_kernel<W, VEC, U, true, WideTile>
        <<<ctas, kThreads, 0, s>>>(a);
}

template <int W, bool VEC, bool MM>
void launch_u(const Args& a, int ctas, cudaStream_t s) {
  switch (chunks_in_flight(a.d)) {
    case 2: launch_tiles<W, VEC, 2, MM>(a, ctas, s); break;
    case 4: launch_tiles<W, VEC, 4, MM>(a, ctas, s); break;
    default: launch_tiles<W, VEC, 8, MM>(a, ctas, s);
  }
}

template <bool MM>
void launch_form(const Args& a, bool vec, int ctas, cudaStream_t s) {
  if (row_chunk(a.d) == 1)
    launch_u<1, false, MM>(a, ctas, s);
  else if (vec)
    launch_u<4, true, MM>(a, ctas, s);
  else
    launch_u<4, false, MM>(a, ctas, s);
}

}  // namespace

extern "C" {

// Launches one gated round on ``stream``; allocates nothing. ``live`` and
// ``pend`` hold ceil(n / min(n_block, n)) int32 entries; ``forms`` (r
// int8, 0 difference / 1 matmul form) and ``w`` may be null. ``mm`` = 0
// promises that no live block has a matmul-form center pending (forms
// given): the kernel without the matmul body runs, and a tile that finds
// one pending traps (the stream's next sync fails). Rows a tile:
// ``tile_rows`` (1..256, clipped to the gate block). Scratch ``part``
// holds 2 * nn + 2 * nn * ceil(nb / tile) floats: the blocks' pairs
// [max scores (nn) | index bits (nn)] first, in block order, then the
// tiles'. ``ticket`` is an int the caller zeroed once for this stream
// (each launch leaves it at 0). Outputs: nmind (n,), out = [score, index
// bits], the blocks' pairs. Returns cudaGetLastError() after the launch.
int gated_greedy_round_f32(const float* x, const float* mind,
                           const float* centers, const int* live,
                           const int* pend, const signed char* forms,
                           const float* w, float* nmind, float* part,
                           float* out, unsigned int* ticket, int n, int d,
                           int r, int n_block, int tile_rows, int mm,
                           void* stream) {
  if (n <= 0 || d <= 0 || r < 0 || n_block <= 0 || tile_rows <= 0 ||
      tile_rows > kMaxTileRows || (r > 0 && centers == nullptr) ||
      (!mm && r > 0 && forms == nullptr))
    return (int)cudaErrorInvalidValue;
  const int nb = n_block < n ? n_block : n;
  const int nn = (n + nb - 1) / nb;
  const int tile = tile_rows < nb ? tile_rows : nb;
  const int tpb = (nb + tile - 1) / tile;
  Args a{x, mind, centers, live, pend, forms, w, nmind, part,
         reinterpret_cast<int*>(part + nn), part + 2 * nn,
         reinterpret_cast<int*>(part + 2 * nn + nn * tpb), ticket, out, n, d,
         r, nb, tile, tpb, nn};
  const bool vec = d % 4 == 0 && aligned16(x) && aligned16(centers);
  cudaStream_t s = (cudaStream_t)stream;
  const int ctas = nn * tpb;
  if (mm)
    launch_form<true>(a, vec, ctas, s);
  else
    launch_form<false>(a, vec, ctas, s);
  int err = (int)cudaGetLastError();
  if (err || kTicket) return err;
  gated_final_kernel<<<1, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
