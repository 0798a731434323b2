"""Token-choice MoE with capacity-based dispatch (port of
repro/models/layers/moe.py).

The semantics are the reference's: router logits are ``x`` in fp32 times
the fp32 router, softmax in fp32, top-k (ties to the lowest expert
index), the top-k values normalised by their sum. Tokens go in groups of
``gs = min(group_size, B*S)``; per group each expert takes
``C = max(ceil(gs * top_k / n_routed * capacity_factor), top_k)`` tokens,
by top-k rank first and position in the group second; a token past its
expert's capacity is dropped for that choice. Shared experts are a dense
SwiGLU with ``d_ff = n_shared * d_ff_expert``.

The reference dispatches with one-hot einsums (``gsec,gsd->egcd``), a
(G, S, E, C) tensor and ~5 TFLOP a layer at a 8,192-token prefill. Here
the same routing is a (G, E, C) table of token indices (``EMPTY`` where a
slot holds none): the tokens' rows are gathered into an (E, G*C, d)
buffer, which equals the one-hot einsum's bit for bit (each slot sums one
row times 1 and zeros), the expert SwiGLU is ``mlp_apply`` batched over
experts (three ``torch.bmm``; the reference computes them outside any
kernel too), and each
token sums its kept choices' outputs, weighted by the combine weights
cast to ``x.dtype``, in fp32 and casts once.

``routes=`` is a seam for tests and the card's agreement check, like the
draw seam in ``common/rng.py``: a ``RouteTape`` records every call's
routes (top-k indices and slots, in call order) or forces recorded ones
back, so a second run routes every token as the first did while its own
router probabilities weight the combine.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.param import ParamDecl
from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers.mlp import mlp_apply

EMPTY = -1              # a slot of the table that holds no token


def moe_decls(d_model: int, mo: MoEConfig):
    E, Fe = mo.n_routed, mo.d_ff_expert
    decls = {
        "router": ParamDecl((d_model, E), dtype=torch.float32),
        "w_in": ParamDecl((E, d_model, Fe)),
        "w_gate": ParamDecl((E, d_model, Fe)),
        "w_out": ParamDecl((E, Fe, d_model)),
    }
    if mo.n_shared:
        Fs = mo.n_shared * Fe
        decls["shared"] = {
            "w_in": ParamDecl((d_model, Fs)),
            "w_gate": ParamDecl((d_model, Fs)),
            "w_out": ParamDecl((Fs, d_model)),
        }
    return decls


def capacity(mo: MoEConfig, group_size: int) -> int:
    c = math.ceil(group_size * mo.top_k / mo.n_routed * mo.capacity_factor)
    return max(int(c), mo.top_k)


@dataclasses.dataclass
class Routes:
    """One call's routing: ``topi`` (G, S, K) expert indices in top-k
    order and ``slot`` (G, S, K) each choice's place in its expert's
    buffer, ``C`` where the choice was dropped."""
    topi: torch.Tensor
    slot: torch.Tensor


class RouteTape:
    """Records the routes of every ``moe_apply`` call it is passed to, in
    call order; built with ``force=`` recorded routes, hands them back in
    the same order instead."""

    def __init__(self, force: Optional[Sequence[Routes]] = None):
        self.recorded: List[Routes] = []
        self._force = None if force is None else list(force)

    def route(self, own: Routes) -> Routes:
        if self._force is None:
            self.recorded.append(own)
            return own
        if len(self.recorded) == len(self._force):
            raise IndexError(f"the tape forces {len(self._force)} calls")
        forced = self._force[len(self.recorded)]
        if forced.topi.shape != own.topi.shape:
            raise ValueError(f"forced routes {tuple(forced.topi.shape)} for "
                             f"a call routing {tuple(own.topi.shape)}")
        self.recorded.append(forced)
        return forced


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: values descending, equal
    values in index order (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(topi: torch.Tensor, n_routed: int, C: int) -> torch.Tensor:
    """(G, S, K) top-k indices -> (G, S, K) slots (``C`` where dropped):
    the reference's priority, top-k rank first, then position in the
    group. The reference carries each expert's fill from one rank to the
    next; the tokens an expert keeps at a rank are a prefix of those that
    chose it, so its fill before rank k is min(C, its choices at ranks
    < k), and every rank is placed at once."""
    mask = F.one_hot(topi, n_routed)                         # (G,S,K,E)
    counts = mask.sum(1)                                     # (G,K,E)
    fill = torch.clamp_max(torch.cumsum(counts, 1) - counts, C)
    pos = fill[:, None] + torch.cumsum(mask, 1) - mask
    mine = pos.gather(3, topi[..., None])[..., 0]            # (G,S,K)
    return torch.where(mine < C, mine, C)


def slot_table(r: Routes, n_routed: int, C: int) -> torch.Tensor:
    """(G, E, C) token index of every slot, ``EMPTY`` where none."""
    G, S, K = r.topi.shape
    flat = torch.where(r.slot < C, r.topi * C + r.slot, n_routed * C)
    table = torch.full((G, n_routed * C + 1), EMPTY, dtype=torch.long,
                       device=r.topi.device)
    tok = torch.arange(S, device=r.topi.device)[None, :, None].expand(G, S, K)
    # dropped choices all land in the one spare column, cut off below
    table.scatter_(1, flat.reshape(G, S * K), tok.reshape(G, S * K))
    return table[:, :n_routed * C].reshape(G, n_routed, C)


def moe_apply(params, x, mo: MoEConfig, norm_eps: float = 1e-6, *,
              routes: Optional[RouteTape] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,d) -> (out (B,S,d) in x.dtype, aux loss, a 0-d fp32)."""
    B, S, d = x.shape
    T = B * S
    gs = min(mo.group_size, T)
    G = T // gs
    if G * gs != T:
        raise ValueError(f"tokens {T} not divisible by group {gs}")
    E, K = mo.n_routed, mo.top_k
    xt = x.reshape(G, gs, d)

    logits = xt.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    C = capacity(mo, gs)
    r = top_k(probs, K)[1]
    r = Routes(r, route(r, E, C))
    if routes is not None:
        r = routes.route(r)
    topv = probs.gather(2, r.topi)
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)

    # load-balance aux loss (Switch-style): E * sum(frac_tokens * frac_probs)
    frac_probs = probs.mean((0, 1))
    route_mask = F.one_hot(r.topi, E).sum(2).float()        # (G,S,E)
    frac_tokens = route_mask.mean((0, 1)) / K
    aux = E * torch.sum(frac_probs * frac_tokens) * mo.aux_loss_alpha

    # dispatch: gather each slot's row (a zero row for an empty slot)
    g = torch.arange(G, device=x.device)[:, None, None]
    table = slot_table(r, E, C)                              # (G,E,C)
    rows = torch.where(table == EMPTY, T, table + g * gs)
    xpad = torch.cat([xt.reshape(T, d), xt.new_zeros((1, d))])
    ein = xpad[rows.permute(1, 0, 2).reshape(E, G * C)]      # (E,G*C,d)
    eout = mlp_apply(params, ein, "swiglu")                 # batched: (E,...)

    # combine: each token's kept choices, weights in x.dtype, summed in fp32
    epad = torch.cat([eout.reshape(E * G * C, d), eout.new_zeros((1, d))])
    at = torch.where(r.slot < C, r.topi * (G * C) + g * C + r.slot,
                     E * G * C)                              # (G,gs,K)
    w = topv.to(x.dtype).float()[..., None]
    out = (w * epad[at].float()).sum(2).to(x.dtype)

    if "shared" in params:
        out = out + mlp_apply(params["shared"], xt, "swiglu")
    return out.reshape(B, S, d), aux


def router_entropy(params, x, mo: MoEConfig):
    """Mean router entropy — exposed as a beyond-paper AL uncertainty
    signal."""
    logits = x.float() @ params["router"].float()
    p = torch.softmax(logits, dim=-1)
    return -torch.sum(p * torch.log(p + 1e-9), dim=-1)
