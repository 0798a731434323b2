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
//   per block of ``rows_per_block`` rows: (max score, lowest row index)
// The host picks the first block holding the global max (torch.argmax),
// so exact ties go to the lowest pool index whatever the block size.
//
// What bounds it on the H100: at R == 1 (every k-center round) it is HBM
// bytes — N*d*4 read for 2*N*d operations, far below the card's ratio of
// operations to bytes. At R = r_block (the Core-Set warm start) the
// 2*N*R*d fp32 FMAs bound it.
// What the design does about it: the row-block body (round_block.cuh)
// gives each warp one row at a time, read with neighbouring lanes on
// neighbouring addresses, so the pool streams once, coalesced; centers sit
// in shared memory, staged in chunks. Rows per CTA is a launch parameter
// (the block picker measures it, kernels/pairwise/autotune.py); a row's
// floats and the lowest-index tie rule do not depend on it.
#include "round_block.cuh"

namespace {

using namespace round_block;

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
  fold_rows(x, mind, centers, sel, w, nmind, bmax, barg, n, d, r,
            blockIdx.x * rows_per_block, rows_per_block, 0, r == 1, chunk,
            blockIdx.x);
}

}  // namespace

extern "C" {

// Launches one fused round on ``stream``; allocates nothing. ``w`` may be
// null (unweighted). Outputs: nmind (n,), bmax/barg
// (ceil(n / rows_per_block),). Returns cudaGetLastError() after the launch.
int greedy_round_f32(const float* x, const float* mind, const float* centers,
                     const int* sel, const float* w, float* nmind,
                     float* bmax, int* barg, int n, int d, int r,
                     int rows_per_block, void* stream) {
  if (n <= 0 || d <= 0 || r <= 0 || rows_per_block <= 0)
    return (int)cudaErrorInvalidValue;
  const int chunk = center_chunk(d, r);
  if (chunk < 1) return (int)cudaErrorInvalidValue;   // d too wide
  const size_t smem = center_smem_bytes(d, chunk);
  cudaFuncSetAttribute(greedy_round_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  greedy_round_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      x, mind, centers, sel, w, nmind, bmax, barg, n, d, r, rows_per_block,
      chunk);
  return (int)cudaGetLastError();
}

}  // extern "C"
