"""Rotary position embeddings, rotate-half convention, fp32 phases (port
of repro/models/layers/rope.py)."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return theta ** (-torch.arange(half, dtype=torch.float32, device=device)
                     / half)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D) or (..., S, D); positions: broadcastable to (..., S)."""
    dtype = x.dtype
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (D/2,)
    ang = positions[..., None].float() * freqs                # (..., S, D/2)
    if x.dim() == ang.dim() + 1:                              # head axis
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(dtype)
