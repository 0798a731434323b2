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
