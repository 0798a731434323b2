"""Plain version of fused uncertainty scoring over logits (port of
repro/kernels/uncertainty/ref.py)."""
from __future__ import annotations

import torch


def uncertainty_stats_ref(logits):
    """logits: (N, V) -> dict of per-row scores (fp32).

    lc = 1 - p_max; mc = -(p1 - p2); rc = p2/p1; es = entropy(softmax).
    A tied top-2 gives p1 == p2, so mc == 0 and rc == 1 exactly.
    """
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    top2 = torch.topk(lg, 2, dim=-1).values
    p1 = torch.exp(top2[:, 0] - lse)
    p2 = torch.exp(top2[:, 1] - lse)
    p = torch.softmax(lg, dim=-1)
    es = -torch.sum(torch.where(p > 0, p * torch.log(torch.clamp_min(p, 1e-30)),
                                0.0), dim=-1)
    return {
        "lc": 1.0 - p1,
        "mc": -(p1 - p2),
        "rc": p2 / torch.clamp_min(p1, 1e-12),
        "es": es,
    }


def uncertainty_scores_ref(logits, kind: str):
    return uncertainty_stats_ref(logits)[kind]
