"""The model-only block rule of repro/kernels/pairwise/autotune.py.

``repro`` picks ``(n_block, r_block)`` for its fused greedy round from an
HBM-bytes model under a VMEM budget, and re-ranks by wall clock only on a
TPU. Off the TPU the model alone decides, and that is the rule copied here:
``r_block`` sets how many labeled centers ``ops.warm_start_min_dist``
folds per pool pass. The chunking is visible in the floats (a one-center
chunk takes the difference form), so the port must chunk as the reference
does on the CPU. A picker for Hopper's shared-memory and register budget
is a later piece of work; ``n_block`` does not change the port's results.
"""
from __future__ import annotations

import dataclasses

N_BLOCK_CANDIDATES = (64, 128, 256, 512, 1024)
R_BLOCK_CANDIDATES = (8, 32, 64, 128, 256, 512)

# the reference's TPU tile budget (half of ~16 MB VMEM per core)
VMEM_BUDGET_BYTES = 8 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class BlockChoice:
    n_block: int
    r_block: int


def _pad_to(x: int, m: int) -> int:
    return -(-x // m) * m


def round_hbm_bytes(n: int, d: int, dtype_bytes: float, n_block: int,
                    r_block: int) -> float:
    """Modeled bytes of ONE fused greedy round: pool read + min-dist
    read/write + weight read + per-block center re-fetch + partials."""
    nb = min(n_block, n)
    nn = -(-n // nb)
    np_ = nn * nb
    rp = _pad_to(max(r_block, 1), 8)
    pool = np_ * d * dtype_bytes
    vectors = 3 * 4 * np_
    centers = nn * rp * (d * 4 + 4)
    partials = nn * 2 * 4
    return pool + vectors + centers + partials


def tile_vmem_bytes(d: int, dtype_bytes: float, n_block: int,
                    r_block: int) -> float:
    rp = _pad_to(max(r_block, 1), 8)
    row = n_block * d * (dtype_bytes + 4)
    cen = rp * d * (dtype_bytes + 4)
    dist = n_block * rp * 4
    vecs = 4 * n_block * 4
    return row + cen + dist + vecs


def _feasible(d: int, dtype_bytes: float, n_block: int, r_block: int) -> bool:
    return tile_vmem_bytes(d, dtype_bytes, n_block, r_block) \
        <= VMEM_BUDGET_BYTES


def model_blocks(n: int, d: int, dtype_bytes: float = 4.0) -> BlockChoice:
    """The reference's model-only ``(n_block, r_block)`` for an (n, d)
    pool: the largest feasible row block by modeled bytes at R = 1, then
    the ``r_block`` with the fewest modeled bytes per folded center."""
    n_cands = [nb for nb in N_BLOCK_CANDIDATES
               if _feasible(d, dtype_bytes, nb, 8)] or [N_BLOCK_CANDIDATES[0]]
    best_nb = min(n_cands,
                  key=lambda nb: (round_hbm_bytes(n, d, dtype_bytes, nb, 1),
                                  -nb))
    r_cands = [rb for rb in R_BLOCK_CANDIDATES
               if _feasible(d, dtype_bytes, best_nb, rb)] or \
        [R_BLOCK_CANDIDATES[0]]
    best_rb = min(r_cands,
                  key=lambda rb: (round_hbm_bytes(n, d, dtype_bytes, best_nb,
                                                  rb) / rb, -rb))
    return BlockChoice(best_nb, best_rb)
