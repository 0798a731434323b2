// The block-masked (gated) greedy round, for Hopper (sm_90a).
//
// Replaces: gated_greedy_round_pallas / _gated_kernel in
// src/repro/kernels/pairwise/kernel.py.
//
// What it computes. Gate block b covers rows [b*nb, (b+1)*nb), nb =
// min(n_block, N), nn = ceil(N / nb) blocks.
//   live block (block_live[b] > 0): fold centers [block_pending[b], R) into
//     mind with d = max(x² + c² − 2x·c, 0) — the matmul form at every R,
//     R = 1 included, as _gated_kernel and gated_greedy_round_ref do;
//     score = nm * w (or nm); rows with nm < 0 and rows past N score
//     -BIG.
//   dead block: reads no x row, copies mind through bit for bit, offers
//     the pair (-BIG, b*nb).
//   out = (max score, lowest row index reaching it), inside the launch, so
//     a caller folding once a slot needs no reduce on the host. Winner
//     masking stays with the caller.
//
// What bounds it on the H100: HBM bytes — the live rows' (live·nb, d)
// read plus three (N,) vectors (mind in, mind out, weights), against
// 2·live·d·R operations, far below the card's operations-to-bytes ratio
// at the R a round folds (1, or a block's few pending centers).
// What the design does about it: one CTA per gate block, so a dead block
// costs one CTA that streams only its (nb,) min-dist copy; a live block
// runs the matmul body shared with greedy_round.cu (round_block.cuh):
// register tiles of rows x centers over a cp.async ring, x² and c² in the
// same pass as x·c, a narrow tile (8 centers) when R <= 8; the last CTA to
// finish reduces the blocks' pairs (an integer ticket), no float atomics.
// Splitting a gate block over several CTAs is later work.
#include "round_block.cuh"

namespace {

using namespace round_block;

struct Args {
  const float* x;
  const float* mind;
  const float* centers;
  const int* live;
  const int* pend;
  const float* w;
  float* nmind;
  float* bmax;
  int* barg;
  unsigned int* ticket;
  float* out;
  int n, d, r, nb;
};

template <class Tl, bool VEC>
__global__ void __launch_bounds__(kThreads, kMatmulCtas)
gated_greedy_round_kernel(Args a) {
  __shared__ __align__(16) TileSmem<Tl> t;
  const int b = blockIdx.x;
  const int row0 = b * a.nb;
  float v = -kBig;
  int vi = row0;
  if (__ldg(a.live + b) <= 0) {              // uniform across the CTA
    const int end = min(row0 + a.nb, a.n);
    for (int row = row0 + (int)threadIdx.x; row < end; row += kThreads)
      a.nmind[row] = __ldg(a.mind + row);
  } else {
    const int c_from = min(max(__ldg(a.pend + b), 0), a.r);
    matmul_rows<Tl, VEC>(t, a.x, a.centers, nullptr, a.mind, nullptr, 0,
                         a.w, a.nmind, a.n, a.d, a.r, row0, a.nb, c_from, v,
                         vi);
  }
  finish_round(v, vi, a.bmax, a.barg, a.ticket, a.out);
}

template <class Tl>
void launch(const Args& a, bool vec, int blocks, cudaStream_t s) {
  if (vec)
    gated_greedy_round_kernel<Tl, true><<<blocks, kThreads, 0, s>>>(a);
  else
    gated_greedy_round_kernel<Tl, false><<<blocks, kThreads, 0, s>>>(a);
}

}  // namespace

extern "C" {

// Launches one gated round on ``stream``; allocates nothing. ``live`` and
// ``pend`` hold ceil(n / min(n_block, n)) int32 entries; ``w`` may be null.
// Scratch ``part`` holds 2 floats a gate block; ``ticket`` is an int the
// caller zeroed once for this stream (each launch leaves it at 0).
// Outputs: nmind (n,), out = [score, index bits]. Returns
// cudaGetLastError() after the launch.
int gated_greedy_round_f32(const float* x, const float* mind,
                           const float* centers, const int* live,
                           const int* pend, const float* w, float* nmind,
                           float* part, float* out, unsigned int* ticket,
                           int n, int d, int r, int n_block, void* stream) {
  if (n <= 0 || d <= 0 || r < 0 || n_block <= 0)
    return (int)cudaErrorInvalidValue;
  const int nb = n_block < n ? n_block : n;
  const int blocks = (n + nb - 1) / nb;
  Args a{x, mind, centers, live, pend, w, nmind, part,
         reinterpret_cast<int*>(part + blocks), ticket, out, n, d, r, nb};
  const bool vec = d % 4 == 0 && aligned16(x) && aligned16(centers);
  cudaStream_t s = (cudaStream_t)stream;
  if (r <= NarrowTile::BN)
    launch<NarrowTile>(a, vec, blocks, s);
  else
    launch<WideTile>(a, vec, blocks, s);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return launch_final(a.bmax, a.barg, blocks, out, s);
}

}  // extern "C"
