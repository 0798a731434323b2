"""Plain PyTorch versions of the pairwise squared-distance reductions and
the fused k-center greedy round (port of repro/kernels/pairwise/ref.py).

They are the CPU path of ``ops`` and the yardstick the CUDA kernels are
held against on the card. The formulas follow the reference exactly: the
difference form for a single center and the ``x² + c² − 2x·cᵀ`` identity
otherwise, and selected rows pinned to −BIG before the weight multiply.

The rounds' distances (``pairwise_sq_dists_ref``, the difference form)
are, like the kernels' rows, functions of one row and one center alone:
no matrix product whose rounding follows the shape of the call, so a row
folded inside a slice, a padded bucket or the whole pool, against one
center or a batch of them, gets the same bits.
"""
from __future__ import annotations

import torch

BIG = 3.4e38
# elements of the (rows, centers, d) products one step of
# ``pairwise_sq_dists_ref`` materializes
_STEP_ELEMS = 1 << 24


def matmul_sq_dists_ref(x, c):
    """x: (N,d), c: (M,d) -> (N,M) squared L2 distances (fp32) through one
    matrix product: fast, but its rounding depends on the shapes."""
    x = x.float()
    c = c.float()
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(c * c, dim=-1)
    d = x2 + c2[None, :] - 2.0 * (x @ c.T)
    return torch.clamp_min(d, 0.0)


def pairwise_sq_dists_ref(x, c):
    """x: (N,d), c: (M,d) -> (N,M) squared L2 distances (fp32) by the
    matmul identity, each entry from its own row and center alone: x·c is
    a sum over d of the elementwise products (no BLAS blocking), so any
    subset of rows or centers gives the same bits."""
    x = x.float()
    c = c.float()
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(c * c, dim=-1)
    n, m = x.shape[0], c.shape[0]
    step = max(1, _STEP_ELEMS // max(m * x.shape[1], 1))
    dot = torch.cat([torch.sum(x[s:s + step, None, :] * c[None, :, :],
                               dim=-1) for s in range(0, n, step)]
                    ) if n else x.new_zeros((0, m))
    return torch.clamp_min(x2 + c2[None, :] - 2.0 * dot, 0.0)


def pairwise_min_dist_ref(x, c):
    return torch.min(pairwise_sq_dists_ref(x, c), dim=-1).values


def pairwise_argmin_ref(x, c):
    """Per-row argmin; ties go to the lowest center index."""
    return torch.argmin(pairwise_sq_dists_ref(x, c), dim=-1).to(torch.int32)


def diff_sq_dists_ref(x, center):
    """(N,) squared L2 distances to one center in the difference form."""
    diff = x.float() - center.float()[None, :]
    return torch.sum(diff * diff, dim=-1)


def pairwise_min_and_argmin_ref(x, c):
    d = matmul_sq_dists_ref(x, c)
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
        dmin = diff_sq_dists_ref(x, centers[0])
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
                           weights=None, *, n_block: int = 256, forms=None,
                           blocks: bool = False):
    """Plain version of the block-masked round (contract in ``ops``).

    Row ``i`` of a live block ``b`` folds centers ``[block_pending[b], R)``;
    center ``k`` takes the difference form where ``forms[k] == 0`` and the
    matmul form where it is 1 (every center the matmul form when ``forms``
    is None, R = 1 included). A live block with nothing pending scores its
    min-dists as they are; dead blocks pass them through. Only the live
    rows and the pending centers are computed: each distance depends on
    its row and center alone, so the bits are those of the whole (N, R)
    product. With ``blocks`` it also returns the (2, nn) per-block pairs
    of ``ops.gated_greedy_round``: row 0 each block's max score, row 1 the
    int32 bits of the lowest row index reaching it."""
    N = x.shape[0]
    R = centers.shape[0]
    dev = x.device
    nb = min(int(n_block), max(N, 1))
    blk = torch.arange(N, device=dev) // nb
    live = block_live.to(dev)[blk] > 0                        # (N,)
    pend = block_pending.to(dev).long().clamp(0, R)[blk]      # (N,)
    mind = mind.float()
    nm = mind.clone()
    fold = live & (pend < R)
    rows = torch.nonzero(fold).flatten()
    if rows.numel():
        lo = int(pend[rows].min())
        xs = x[rows]
        form = (torch.ones(R, dtype=torch.int64) if forms is None
                else forms.to("cpu").long())
        d2 = torch.full((rows.numel(), R), float("inf"), device=dev)
        mm = [k for k in range(lo, R) if form[k] != 0]
        if mm:
            d2[:, mm] = pairwise_sq_dists_ref(xs, centers[mm])
        for k in range(lo, R):
            if form[k] == 0:
                d2[:, k] = diff_sq_dists_ref(xs, centers[k])
        col = torch.arange(R, device=dev)[None, :]
        d2 = torch.where(col >= pend[rows][:, None], d2, float("inf"))
        nm[rows] = torch.minimum(mind[rows], torch.amin(d2, dim=-1))
    score = nm if weights is None else nm * weights.float()
    score = torch.where(live & ~(nm < 0.0), score, -BIG)
    nxt = torch.argmax(score)
    if not blocks:
        return nm, nxt.to(torch.int32), score[nxt]
    nn = -(-N // nb)
    padded = torch.full((nn * nb,), -BIG, device=dev)
    padded[:N] = score
    # argmax, unlike max(dim), promises the first of tied maxima
    barg = torch.argmax(padded.view(nn, nb), dim=1)
    bmax = padded.view(nn, nb).gather(1, barg[:, None])[:, 0]
    barg = (barg + torch.arange(nn, device=dev) * nb).to(torch.int32)
    pairs = torch.stack([bmax, barg.view(torch.float32)])
    return nm, nxt.to(torch.int32), score[nxt], pairs
