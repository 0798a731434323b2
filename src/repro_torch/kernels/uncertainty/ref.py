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


NEG = -1e30


def uncertainty_stats_split_ref(logits, split: int):
    """What ``csrc/uncertainty_stats.cu`` computes, in plain PyTorch (its
    sums inside a split run in another order): each row's V logits, in fp32,
    cut into contiguous shares of ``split`` (the kernel's
    ``ops.SPLIT_ELEMS[dtype]``) from column 0; per share m1 = its max, m2 =
    its runner-up with only the leftmost max knocked out (-1e30 for a
    one-logit share), se = sum exp(l - m1), sl = sum l exp(l - m1); the
    shares then merged in split order, m1 = max m1_s, m2 = max(min(m1,
    m1_s), m2, m2_s) folded share by share, se = sum_s se_s exp(m1_s - m1),
    sl likewise; then the reference's finish. Same dict as
    ``uncertainty_stats_ref``; a tied top-2 gives mc == 0 and rc == 1
    exactly, whether the two maxima share a split or not."""
    lg = logits.float()
    m1 = m2 = se = sl = None
    parts = []
    for c0 in range(0, lg.shape[1], split):
        ch = lg[:, c0:c0 + split]
        if ch.shape[1] > 1:
            a, b = torch.topk(ch, 2, dim=-1).values.unbind(-1)
        else:
            a, b = ch[:, 0], torch.full_like(ch[:, 0], NEG)
        e = torch.exp(ch - a[:, None])
        parts.append((a, e.sum(-1), (ch * e).sum(-1)))
        if m1 is None:
            m1, m2 = a, b
        else:
            m2 = torch.maximum(torch.minimum(m1, a), torch.maximum(m2, b))
            m1 = torch.maximum(m1, a)
    for a, se_s, sl_s in parts:
        c = torch.exp(a - m1)
        se = se_s * c if se is None else se + se_s * c
        sl = sl_s * c if sl is None else sl + sl_s * c
    se = torch.clamp_min(se, 1e-30)
    lse = m1 + torch.log(se)
    p1 = torch.exp(m1 - lse)
    p2 = torch.exp(m2 - lse)
    return {
        "lc": 1.0 - p1,
        "mc": -(p1 - p2),
        "rc": p2 / torch.clamp_min(p1, 1e-12),
        "es": lse - sl / se,
    }
