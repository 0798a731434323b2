"""Plain versions of the decode-attention kernel (port of
repro/kernels/decode_attention/ref.py): the model layer's
``decode_attention``, which a CPU tensor takes, and
``decode_attention_split_ref``, the CUDA kernel's split arithmetic in plain
PyTorch, which only the tests call."""
from __future__ import annotations

import torch

from repro_torch.models.layers.attention import decode_attention

NEG = -1e30


def decode_attention_ref(q, k_cache, v_cache, cur_len, *, window=None,
                         scale=None):
    """q: (B,1,H,D); caches (B,S,KH,D); cur_len valid entries."""
    return decode_attention(q, k_cache, v_cache, cur_len, window=window,
                            scale=scale)


def decode_attention_split_ref(q, k_cache, v_cache, cur_len, *, window=None,
                               scale=None, split: int):
    """What ``csrc/decode_attention.cu`` computes, in plain PyTorch (its
    sums inside a chunk run in another order): keys in chunks of ``split``
    (the kernel's ``SPLIT_KEYS``) from key 0; per chunk with a live key, in fp32 (q,
    k, p and v alike), m_s = max of its live scores, p = exp(s - m_s),
    l_s = sum p, acc_s = sum p v; then the live chunks merged in chunk
    order, m = max m_s, l = sum l_s exp(m_s - m), acc = sum acc_s
    exp(m_s - m); out = acc / max(l, 1e-30) in q.dtype (zeros when no key
    is live). Same shapes as ``decode_attention_ref``."""
    B, _, H, D = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    scale = scale if scale is not None else D ** -0.5
    cur = int(cur_len)
    pos = torch.arange(S, device=q.device)
    ok = pos < cur
    if window is not None:
        ok &= pos > cur - 1 - window
    qf = q.float().reshape(B, KH, G, D)
    kf = k_cache.float().permute(0, 2, 1, 3)             # (B, KH, S, D)
    vf = v_cache.float().permute(0, 2, 1, 3)
    s = torch.einsum("bkgd,bksd->bkgs", qf, kf) * scale
    s = torch.where(ok, s, torch.full_like(s, NEG))
    m = torch.full((B, KH, G), NEG, device=q.device)
    parts = []
    for k0 in range(0, S, split):
        if not bool(ok[k0:k0 + split].any()):
            continue                                     # an empty partial
        sc = s[..., k0:k0 + split]
        m_s = sc.amax(-1)
        p = torch.exp(sc - m_s[..., None])
        parts.append((m_s, p.sum(-1), torch.einsum(
            "bkgs,bksd->bkgd", p, vf[:, :, k0:k0 + split])))
        m = torch.maximum(m, m_s)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for m_s, l_s, acc_s in parts:
        w = torch.exp(m_s - m)
        l = l + l_s * w
        acc = acc + acc_s * w[..., None]
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, 1, H, D).to(q.dtype)
