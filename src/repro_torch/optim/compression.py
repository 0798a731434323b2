# Port of repro/optim/compression.py.
"""Gradient compression for cross-replica reduction.

Two composable schemes (both with exactness-preserving state):

  * top-k sparsification with error feedback (DGC-style): only the k largest
    |g| entries are reduced; the residual accumulates locally and is added
    back next step, so the optimizer sees an unbiased long-run gradient.
  * int8 quantization (per-tensor absmax scaling) around a sum over a
    ``torch.distributed`` group: 4x fewer bytes on the slow links.

``compressed_psum`` reduces over a process group, the port's stand-in
for the reference's ``data`` mesh axis (``launch.mesh``): an
``all_reduce`` MAX of the scale, then an ``all_reduce`` SUM of the int8
payload as int32. Rounding is half to even, as ``jnp.round``'s.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.common.tree import tree_leaves, tree_map, tree_unflatten


def topk_sparsify(g: torch.Tensor, frac: float,
                  err: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the top ``frac`` fraction of |g| (+ carried error); returns
    (sparse_g, new_error). Shapes preserved (zeros elsewhere)."""
    if err is not None:
        g = g + err
    flat = g.reshape(-1)
    k = max(int(flat.shape[0] * frac), 1)
    thresh = torch.topk(torch.abs(flat), k).values[-1]
    mask = torch.abs(g) >= thresh
    sparse = torch.where(mask, g, 0.0)
    return sparse, g - sparse


def int8_quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp_min(torch.max(torch.abs(g)), 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(g: torch.Tensor, group=None, *,
                    quantize: bool = True) -> torch.Tensor:
    """Sum of ``g`` over ``group``'s ranks with an int8 payload: quantize ->
    sum as int32 -> dequantize by the ranks' largest scale (conservative,
    deterministic). Every rank returns the same tensor."""
    if not quantize:
        total = g.clone()
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return total
    _, scale = int8_quantize(g)
    scale = scale.clone()
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.float() * scale


def make_compressed_grad_fn(frac: float = 0.05):
    """tree-level top-k + error feedback; returns (fn, init_state_fn)."""

    def init_state(grads):
        return tree_map(torch.zeros_like, grads)

    def compress(grads, err_state):
        outs = [topk_sparsify(g.float(), frac, e.float()) for g, e in
                zip(tree_leaves(grads), tree_leaves(err_state))]
        return (tree_unflatten(grads, [o[0] for o in outs]),
                tree_unflatten(grads, [o[1] for o in outs]))

    return compress, init_state
