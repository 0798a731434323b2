"""Plain version of the decode-attention kernel: the model layer's
``decode_attention`` (port of repro/kernels/decode_attention/ref.py)."""
from __future__ import annotations

from repro_torch.models.layers.attention import decode_attention


def decode_attention_ref(q, k_cache, v_cache, cur_len, *, window=None,
                         scale=None):
    """q: (B,1,H,D); caches (B,S,KH,D); cur_len valid entries."""
    return decode_attention(q, k_cache, v_cache, cur_len, window=window,
                            scale=scale)
