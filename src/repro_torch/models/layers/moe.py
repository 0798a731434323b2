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
router probabilities weight the combine. The training loss passes a
``RecomputeRoutes`` per checkpointed unit, which hands the backward's
recomputation the routes of the unit's first run. The aux loss is
differentiable through the router probabilities alone, as the
reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.param import ParamDecl
from repro_torch.common.spans import span
from repro_torch.configs.base import MoEConfig
from repro_torch.distributed import partition
from repro_torch.distributed.partition import ac
from repro_torch.models.layers.mlp import mlp_apply

EMPTY = -1              # a slot of the table that holds no token


def moe_decls(d_model: int, mo: MoEConfig):
    E, Fe = mo.n_routed, mo.d_ff_expert
    decls = {
        "router": ParamDecl((d_model, E), ("embed", "expert"),
                            dtype=torch.float32),
        "w_in": ParamDecl((E, d_model, Fe), ("expert", "embed", "ff")),
        "w_gate": ParamDecl((E, d_model, Fe), ("expert", "embed", "ff")),
        "w_out": ParamDecl((E, Fe, d_model), ("expert", "ff", "embed")),
    }
    if mo.n_shared:
        Fs = mo.n_shared * Fe
        decls["shared"] = {
            "w_in": ParamDecl((d_model, Fs), ("embed", "ff")),
            "w_gate": ParamDecl((d_model, Fs), ("embed", "ff")),
            "w_out": ParamDecl((Fs, d_model), ("ff", "embed")),
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


class RecomputeRoutes:
    """The routes of one unit under ``torch.utils.checkpoint``: its first
    run routes through ``tape`` (a ``RouteTape``, or none) and keeps each
    MoE call's routes; the backward's recomputation (``begin`` restarts
    the count) gets the same routes back, so the tape records or forces
    each call once and the recomputed forward routes as the first did."""

    def __init__(self, tape: Optional[RouteTape] = None):
        self.tape = tape
        self.kept: List[Routes] = []
        self.at = 0

    def begin(self) -> "RecomputeRoutes":
        self.at = 0
        return self

    def route(self, own: Routes) -> Routes:
        if self.at == len(self.kept):
            self.kept.append(own if self.tape is None
                             else self.tape.route(own))
        self.at += 1
        return self.kept[self.at - 1]


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


def _route(router, xt, mo: MoEConfig, routes: Optional[RouteTape]):
    """(G, gs, d) tokens -> (routes, normalised top-k weights, router
    probabilities)."""
    logits = xt.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    C = capacity(mo, xt.shape[1])
    r = top_k(probs, mo.top_k)[1]
    r = Routes(r, route(r, mo.n_routed, C))
    if routes is not None:
        r = routes.route(r)
    topv = probs.gather(2, r.topi)
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
    return r, topv, probs


def _balance_fracs(probs, r: Routes, mo: MoEConfig):
    """The load-balance loss's two (E,) means over the groups: router
    probability and the share of routed choices."""
    frac_probs = probs.mean((0, 1))
    route_mask = F.one_hot(r.topi, mo.n_routed).sum(2).float()  # (G,S,E)
    return frac_probs, route_mask.mean((0, 1)) / mo.top_k


def _dispatch(xt, r: Routes, g, E: int, C: int, lo: int, hi: int):
    """Each slot's row (a zero row for an empty slot) of experts [lo, hi):
    (hi - lo, G*C, d). ``g``: the group indices, (G, 1, 1)."""
    G, gs, d = xt.shape
    T = G * gs
    table = slot_table(r, E, C)                              # (G,E,C)
    if (lo, hi) != (0, E):
        table = table[:, lo:hi]
    rows = torch.where(table == EMPTY, T, table + g * gs)
    xpad = torch.cat([xt.reshape(T, d), xt.new_zeros((1, d))])
    return xpad[rows.permute(1, 0, 2).reshape(-1, G * C)]    # (E',G*C,d)


def _combine(eout, r: Routes, topv, g, C: int, dtype,
             lo: Optional[int] = None):
    """Each token's kept choices, weights in ``dtype``, summed in fp32:
    (G, gs, d) fp32. ``lo``: ``eout`` holds experts [lo, lo + E') only,
    and the other choices add nothing."""
    E, GC, d = eout.shape
    G = GC // C
    epad = torch.cat([eout.reshape(E * G * C, d), eout.new_zeros((1, d))])
    e, keep = r.topi, r.slot < C
    if lo is not None:
        e = e - lo
        keep = keep & (e >= 0) & (e < E)
    at = torch.where(keep, e * (G * C) + g * C + r.slot,
                     E * G * C)                              # (G,gs,K)
    w = topv.to(dtype).float()[..., None]
    return (w * epad[at].float()).sum(2)


class _Whole:
    """``moe_apply``'s edges on plain tensors: every token and every
    expert here, nothing to wrap or reduce."""
    lead = None

    def __init__(self, x, gs: int, E: int):
        self.tokens, self.lo, self.hi, self.part = x, 0, E, None

    def local(self, t, *logical):
        return t

    def mean(self, t):
        return t

    def experts(self, ein, shape):
        return ein

    def tokens_out(self, out, dtype):
        return out.to(dtype)


class _Shards:
    """``moe_apply``'s edges on DTensors (the dry run's trace), as the
    reference's one-hot einsums shard. Each rank routes the groups of the
    tokens it holds; where a group spans ranks (a decode step's few
    tokens) the tokens are gathered first and every rank routes them all.
    Each rank dispatches to its own experts, [lo, hi) (the experts shard
    over ``model`` where their count divides it); the experts' products
    run on DTensors (the weights' FSDP dims gathered by DTensor); each
    rank's combine is its experts' share of each token's choices, a
    partial sum over ``model`` that ``tokens_out`` reduces. The balance
    loss's means are averaged over the batch ranks."""

    def __init__(self, x, gs: int, E: int):
        self.x, self.mesh = x, x.device_mesh
        self.rules = rules = partition.active_rules()
        self.lead = "batch"
        xl = partition.to_local(x, "batch", None, None)
        if (xl.shape[0] * x.shape[1]) % gs:
            self.lead = None
            xl = partition.to_local(x, None, None, None)
        self.tokens = xl
        m = rules.mesh_shape.get("model", 1)
        self.part = ("expert" if E % m == 0 and "model" in rules.mesh_axes
                     else None)
        self.lo, self.hi = 0, E
        if self.part:
            self.lo = self.mesh.get_local_rank("model") * (E // m)
            self.hi = self.lo + E // m

    def local(self, t, *logical):
        return partition.to_local(t, *logical)

    def mean(self, t):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        split = self.rules.batch_axes() if self.lead else ()
        mean = [Partial("avg") if a in split else Replicate()
                for a in self.rules.mesh_axes]
        return (DTensor.from_local(t, self.mesh, mean, run_check=False)
                .redistribute(self.mesh, [Replicate()] * len(mean)))

    def experts(self, ein, shape):
        return partition.from_local(ein, self.x, shape, self.part,
                                    self.lead, None)

    def tokens_out(self, out, dtype):
        from torch.distributed.tensor import DTensor, Partial
        pl = list(self.rules.placements((self.lead, None, None),
                                        self.x.shape))
        if self.part:
            pl[self.rules.mesh_axes.index("model")] = Partial()
        out = DTensor.from_local(out, self.mesh, pl, run_check=False)
        return ac(out, "batch", None, None).to(dtype)


def moe_apply(params, x, mo: MoEConfig, norm_eps: float = 1e-6, *,
              routes: Optional[RouteTape] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,d) -> (out (B,S,d) in x.dtype, aux loss, a 0-d fp32). On
    DTensors the same body runs between ``_Shards``' edges."""
    B, S, d = x.shape
    T = B * S
    gs = min(mo.group_size, T)
    G = T // gs
    if G * gs != T:
        raise ValueError(f"tokens {T} not divisible by group {gs}")
    E, C = mo.n_routed, capacity(mo, gs)
    at = (_Shards if partition.is_dtensor(x) else _Whole)(x, gs, E)
    xt = at.tokens.reshape(-1, gs, d)
    with span("moe.route"):
        r, topv, probs = _route(at.local(params["router"], None, None), xt,
                                mo, routes)
        # load-balance aux loss (Switch-style):
        # E * sum(frac_tokens * frac_probs)
        frac_probs, frac_tokens = map(at.mean, _balance_fracs(probs, r, mo))
        aux = E * torch.sum(frac_probs * frac_tokens) * mo.aux_loss_alpha

    with span("moe.dispatch"):
        g = torch.arange(xt.shape[0], device=x.device)[:, None, None]
        ein = at.experts(_dispatch(xt, r, g, E, C, at.lo, at.hi),
                         (E, G * C, d))
    eout = mlp_apply(params, ein, "swiglu", lead=("expert", at.lead))
    with span("moe.combine"):
        out = _combine(at.local(eout, at.part, at.lead, None), r, topv, g, C,
                       x.dtype, lo=at.lo if at.part else None)
        out = at.tokens_out(out.reshape(-1, S, d), x.dtype)
    if "shared" in params:
        out = out + mlp_apply(params["shared"], x, "swiglu")
    return out, aux


def router_entropy(params, x, mo: MoEConfig):
    """Mean router entropy — exposed as a beyond-paper AL uncertainty
    signal."""
    logits = x.float() @ params["router"].float()
    p = torch.softmax(logits, dim=-1)
    return -torch.sum(p * torch.log(p + 1e-9), dim=-1)
