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
//     -BIG; one (max, lowest row index) pair per block.
//   dead block: reads no x row, copies mind through bit for bit, writes
//     the partial (-BIG, b*nb).
// The host takes the first max over the partials (torch.argmax), so ties
// go to the lowest index. Winner masking stays with the caller.
//
// What bounds it on the H100: HBM bytes — the live rows' (live·nb, d)
// read plus three (N,) vectors (mind in, mind out, weights), against
// 2·live·d·R operations, far below the card's operations-to-bytes ratio
// at the R a round folds (1, or a block's few pending centers).
// What the design does about it: one CTA per gate block, so a dead block
// costs one CTA that streams only its (nb,) min-dist copy; a live block
// runs the row-block body shared with greedy_round.cu (round_block.cuh):
// a warp per row, lane-strided partial sums and a fixed shuffle tree,
// centers staged in shared memory in chunks, no float atomics.
#include "round_block.cuh"

namespace {

using namespace round_block;

__global__ void gated_greedy_round_kernel(const float* __restrict__ x,
                                          const float* __restrict__ mind,
                                          const float* __restrict__ centers,
                                          const int* __restrict__ live,
                                          const int* __restrict__ pend,
                                          const float* __restrict__ w,
                                          float* __restrict__ nmind,
                                          float* __restrict__ bmax,
                                          int* __restrict__ barg,
                                          int n, int d, int r, int nb,
                                          int chunk) {
  const int b = blockIdx.x;
  const int row0 = b * nb;
  if (live[b] <= 0) {                      // uniform across the CTA
    const int end = min(row0 + nb, n);
    for (int row = row0 + (int)threadIdx.x; row < end; row += kThreads)
      nmind[row] = mind[row];
    if (threadIdx.x == 0) { bmax[b] = -kBig; barg[b] = row0; }
    return;
  }
  const int c_from = min(max(pend[b], 0), r);
  fold_rows(x, mind, centers, nullptr, w, nmind, bmax, barg, n, d, r, row0,
            nb, c_from, false, chunk, b);
}

}  // namespace

extern "C" {

// Launches one gated round on ``stream``; allocates nothing. ``live`` and
// ``pend`` hold ceil(n / min(n_block, n)) int32 entries; ``w`` may be null.
// Outputs: nmind (n,), bmax/barg (one per gate block). Returns
// cudaGetLastError() after the launch.
int gated_greedy_round_f32(const float* x, const float* mind,
                           const float* centers, const int* live,
                           const int* pend, const float* w, float* nmind,
                           float* bmax, int* barg, int n, int d, int r,
                           int n_block, void* stream) {
  if (n <= 0 || d <= 0 || r < 0 || n_block <= 0)
    return (int)cudaErrorInvalidValue;
  const int nb = n_block < n ? n_block : n;
  const int chunk = center_chunk(d, r);
  if (chunk < 1) return (int)cudaErrorInvalidValue;   // d too wide
  const size_t smem = center_smem_bytes(d, chunk);
  cudaFuncSetAttribute(gated_greedy_round_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int blocks = (n + nb - 1) / nb;
  gated_greedy_round_kernel<<<blocks, kThreads, smem,
                              (cudaStream_t)stream>>>(
      x, mind, centers, live, pend, w, nmind, bmax, barg, n, d, r, nb, chunk);
  return (int)cudaGetLastError();
}

}  // extern "C"
