"""Plain PyTorch versions of the pairwise squared-distance reductions and
the fused k-center greedy round (port of repro/kernels/pairwise/ref.py).

They are the CPU path of ``ops`` and the yardstick the CUDA kernels are
held against on the card. The formulas follow the reference exactly: the
difference form for a single center and the ``x² + c² − 2x·cᵀ`` identity
otherwise, and selected rows pinned to −BIG before the weight multiply.
"""
from __future__ import annotations

import torch

BIG = 3.4e38


def pairwise_sq_dists_ref(x, c):
    """x: (N,d), c: (M,d) -> (N,M) squared L2 distances (fp32)."""
    x = x.float()
    c = c.float()
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(c * c, dim=-1)
    d = x2 + c2[None, :] - 2.0 * (x @ c.T)
    return torch.clamp_min(d, 0.0)


def pairwise_min_and_argmin_ref(x, c):
    d = pairwise_sq_dists_ref(x, c)
    # torch.min(dim) does not promise the first of tied minima; argmin does
    idx = torch.argmin(d, dim=-1)
    return torch.gather(d, 1, idx[:, None])[:, 0], idx.to(torch.int32)


def tiled_min_and_argmin_ref(x, c, bn: int):
    """The min/argmin kernel's cut in plain form: the plain version over
    each tile of ``bn`` centers, then the kernel's merge pass — the tiles
    in ascending order under (value asc, index asc), so ties go to the
    lowest center whatever ``bn``."""
    best_v = best_i = None
    for t0 in range(0, c.shape[0], bn):
        v, i = pairwise_min_and_argmin_ref(x, c[t0:t0 + bn])
        i = i + t0
        if best_v is None:
            best_v, best_i = v, i
            continue
        take = (v < best_v) | ((v == best_v) & (i < best_i))
        best_v = torch.where(take, v, best_v)
        best_i = torch.where(take, i, best_i)
    return best_v, best_i


def greedy_round_ref(x, mind, centers, sel_idx, weights=None):
    """Plain version of the fused greedy round (contract in ``ops``).

    Weights only scale the argmax score; selected rows (nm < 0) are pinned
    to -BIG so they can never win — not even with zero weights, where
    -1 * 0 would tie legitimate zero-score rows.
    """
    N = x.shape[0]
    if centers.shape[0] == 1:
        diff = x.float() - centers[0].float()[None, :]
        dmin = torch.sum(diff * diff, dim=-1)
    else:
        dmin = torch.amin(pairwise_sq_dists_ref(x, centers), dim=-1)
    nm = torch.minimum(mind.float(), dmin)
    rows = torch.arange(N, device=x.device)
    hit = torch.any(rows[:, None] == sel_idx.to(rows.dtype)[None, :], dim=-1)
    nm = torch.where(hit, -1.0, nm)
    score = nm if weights is None else nm * weights.float()
    score = torch.where(nm < 0.0, -BIG, score)
    nxt = torch.argmax(score)
    return nm, nxt.to(torch.int32), score[nxt]


def gated_greedy_round_ref(x, mind, centers, block_live, block_pending,
                           weights=None, *, n_block: int = 256):
    """Plain version of the block-masked round (contract in ``ops``),
    vectorized over ALL rows with block/column masking: it touches the
    whole pool, so it is the kernel's yardstick, not a sublinear path.
    The matmul form holds at every R, R = 1 included."""
    N = x.shape[0]
    R = centers.shape[0]
    dev = x.device
    d2 = pairwise_sq_dists_ref(x, centers)                    # (N, R)
    blk = torch.arange(N, device=dev) // n_block
    live = block_live.to(dev)[blk] > 0                        # (N,)
    pend = block_pending.to(dev)[blk]                         # (N,)
    col = torch.arange(R, device=dev)[None, :]
    d2 = torch.where(col >= pend[:, None], d2, BIG)           # catch-up mask
    fold = torch.minimum(mind.float(), torch.amin(d2, dim=-1))
    nm = torch.where(live, fold, mind.float())
    score = nm if weights is None else nm * weights.float()
    score = torch.where(live & ~(nm < 0.0), score, -BIG)
    nxt = torch.argmax(score)
    return nm, nxt.to(torch.int32), score[nxt]
