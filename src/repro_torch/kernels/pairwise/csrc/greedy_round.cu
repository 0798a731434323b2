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
//   out      = (max score, lowest row index reaching it), inside the launch
// The centers are R rows of their own, or (``cidx``) R rows of x by index,
// so a k-center round needs no gather of its center before the launch.
//
// What bounds it on the H100: at R == 1 (every k-center round) HBM bytes —
// N*d*4 read for 3*N*d operations, far below the card's operations per
// byte. At R = r_block (the Core-Set warm start) the 2*N*R*d fp32 FMAs.
// What the design does about it (round_block.cuh holds the bodies):
// - R == 1: a row is read by G lanes (32 from d = 128 up) with 16-byte
//   loads, each lane keeping kInFlight chunks in flight over one row or
//   several (P rows x U chunks, by d). Rows per CTA shrink with d and
//   with small pools (ops.round_plan), so the text pool (2,048 x 4,096)
//   and the prefilter's 8-256-row folds still spread over the SMs.
// - R > 1: register tiles of rows x centers fed by a cp.async ring; x² and
//   c² accumulate in the same pass as x·c, so a row is read once per
//   center tile, and no (row, center) pair pays a shuffle tree.
// - The argmax over CTAs happens in the launch: the last CTA to finish (an
//   integer ticket on a counter of the caller's stream) reduces every
//   CTA's pair, so the host launches nothing after it.
// Rows per CTA is a launch parameter: it changes no float and no index.
#include "round_block.cuh"

namespace {

using namespace round_block;

struct Args {
  const float* x;
  const float* mind;
  const float* centers;   // (r, d), or null with cidx
  const int* cidx;        // (r,) rows of x as centers, or null
  const int* sel;         // (r,) rows to mask, -1 for none
  const float* w;         // (n,) or null
  float* nmind;           // (n,)
  float* bmax;            // (blocks,)
  int* barg;              // (blocks,)
  unsigned int* ticket;   // the stream's counter, 0 between launches
  float* out;             // [score, index bits]
  int n, d, r, rows;
};

template <int W, bool VEC, int U>
__global__ void __launch_bounds__(kThreads) greedy_round_diff_kernel(Args a) {
  constexpr int P = rows_in_flight(U);
  const float* c = center_row(a.x, a.centers, a.cidx, 0, a.d);
  const int sel0 = __ldg(a.sel);
  const int row0 = blockIdx.x * a.rows;
  float v = -kBig;
  int vi = row0;
  diff_rows<W, VEC, P, U>(a.x, c, a.mind, sel0, a.w, a.nmind, a.n, a.d, row0,
                          a.rows, v, vi);
  finish_round(v, vi, a.bmax, a.barg, a.ticket, a.out);
}

template <class Tl, bool VEC>
__global__ void __launch_bounds__(kThreads, kMatmulCtas)
greedy_round_matmul_kernel(
    Args a) {
  __shared__ __align__(16) TileSmem<Tl> t;
  const int row0 = blockIdx.x * a.rows;
  float v = -kBig;
  int vi = row0;
  matmul_rows<Tl, VEC>(t, a.x, a.centers, a.cidx, a.mind, a.sel, a.r, a.w,
                       a.nmind, a.n, a.d, a.r, row0, a.rows, 0, v, vi);
  finish_round(v, vi, a.bmax, a.barg, a.ticket, a.out);
}

template <int W, bool VEC>
void launch_diff(const Args& a, int blocks, cudaStream_t s) {
  switch (chunks_in_flight(a.d)) {
    case 2:
      greedy_round_diff_kernel<W, VEC, 2><<<blocks, kThreads, 0, s>>>(a);
      break;
    case 4:
      greedy_round_diff_kernel<W, VEC, 4><<<blocks, kThreads, 0, s>>>(a);
      break;
    default:
      greedy_round_diff_kernel<W, VEC, 8><<<blocks, kThreads, 0, s>>>(a);
  }
}

template <class Tl>
void launch_matmul(const Args& a, bool vec, int blocks, cudaStream_t s) {
  if (vec)
    greedy_round_matmul_kernel<Tl, true><<<blocks, kThreads, 0, s>>>(a);
  else
    greedy_round_matmul_kernel<Tl, false><<<blocks, kThreads, 0, s>>>(a);
}

}  // namespace

extern "C" {

// The difference form's layout for width d: {floats a chunk, lanes a row,
// chunks in flight a lane (U), rows in flight a lane group (P)}.
void greedy_round_layout(int d, int* out) {
  out[0] = row_chunk(d);
  out[1] = row_lanes(d);
  out[2] = chunks_in_flight(d);
  out[3] = rows_in_flight(out[2]);
}

// Launches one fused round on ``stream``; allocates nothing. ``centers``
// (r, d) or ``cidx`` (r rows of x; then ``centers`` is ignored); ``w``
// may be null. Scratch ``part`` holds 2 * ceil(n / rows_per_block) floats;
// ``ticket`` is an int the caller zeroed once for this stream (each launch
// leaves it at 0). Outputs: nmind (n,), out = [score, index bits]. Returns
// cudaGetLastError() after the launch.
int greedy_round_f32(const float* x, const float* mind, const float* centers,
                     const int* cidx, const int* sel, const float* w,
                     float* nmind, float* part, float* out,
                     unsigned int* ticket, int n, int d, int r,
                     int rows_per_block, void* stream) {
  if (n <= 0 || d <= 0 || r <= 0 || rows_per_block <= 0 ||
      (centers == nullptr && cidx == nullptr))
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  Args a{x, mind, centers, cidx, sel, w, nmind, part,
         reinterpret_cast<int*>(part + blocks), ticket, out, n, d, r,
         rows_per_block};
  const bool vec = d % 4 == 0 && aligned16(x) &&
                   (cidx != nullptr || aligned16(centers));
  cudaStream_t s = (cudaStream_t)stream;
  if (r == 1) {
    if (row_chunk(d) == 1)
      launch_diff<1, false>(a, blocks, s);
    else if (vec)
      launch_diff<4, true>(a, blocks, s);
    else
      launch_diff<4, false>(a, blocks, s);
  } else if (r <= NarrowTile::BN) {
    launch_matmul<NarrowTile>(a, vec, blocks, s);
  } else {
    launch_matmul<WideTile>(a, vec, blocks, s);
  }
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return launch_final(a.bmax, a.barg, blocks, out, s);
}

}  // extern "C"
