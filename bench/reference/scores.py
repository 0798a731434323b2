"""The four uncertainty scores of a row of logits, as plain arithmetic in
float64 (or, for the control, a lower precision) (higher is more
uncertain): least confidence ``lc = 1 - p1``, margin ``mc = -(p1 -
p2)``, ratio ``rc = p2 / p1`` and entropy ``es``, with p1 and p2 the two
largest probabilities of the softmax."""
from __future__ import annotations

import torch

KINDS = ("lc", "mc", "rc", "es")


def scores(logits: torch.Tensor, dtype=torch.float64) -> dict:
    """(N, V) logits -> {kind: (N,)}, each computed in ``dtype``."""
    lg = logits.to(dtype)
    lse = torch.logsumexp(lg, dim=-1)
    top = torch.topk(lg, 2, dim=-1).values
    p1 = torch.exp(top[:, 0] - lse)
    p2 = torch.exp(top[:, 1] - lse)
    p = torch.exp(lg - lse[:, None])
    return {"lc": 1.0 - p1, "mc": p2 - p1, "rc": p2 / p1,
            "es": lse - (p * lg).sum(-1)}
