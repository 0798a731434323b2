"""Plain version of the flash-attention kernel: the naive attention of the
model layer, same masking semantics (port of
repro/kernels/flash_attention/ref.py)."""
from __future__ import annotations

from typing import Optional

from repro_torch.models.layers.attention import naive_attention


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        kv_valid=None, scale: Optional[float] = None):
    """q: (B,Sq,H,D); k,v: (B,Skv,KH,D) -> (B,Sq,H,D)."""
    return naive_attention(q, k, v, causal=causal, window=window,
                           kv_valid=kv_valid, scale=scale)
