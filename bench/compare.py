"""The comparison that decides ``correct``: what the timed path produced
for one sampled batch against the plain reference's float32 forward of
the same tokens over the same weights, and each kernel's output against
plain arithmetic over the inputs the kernel was handed.

Two numbers, each the worst over every row compared:

- ``logits``: for the prompt's last position and every scored step of
  every document, the RMS of the port's logits minus the reference's,
  over the published vocabulary, divided by the RMS of the reference's
  logits about their mean. It covers the whole stack: embedding, norms,
  rope, attention (B3 in the prefill, B6 through the cache at each step),
  the MLP or the MoE, the LM head.
- ``scores``: for every scored step, the four scores of the port's
  scoring kernel (B4) against the plain float64 scores of the logits the
  kernel was handed (the port's, its padded columns included): least
  confidence and margin as a share of the top probability (``|d lc| /
  p1``, ``|d mc| / p1``), ratio and entropy as they are (``|d rc|``,
  ``|d es|`` in nats). The kernel is judged on its own input, so that the
  model's error, which ``logits`` holds, does not swamp it; the two
  together hold the scores a user gets against the reference's.

A MoE configuration adds a third. The reference follows the routes the
port's router chose (its ``RouteTape``), since a near tie between two
experts' probabilities flips one way in bfloat16 and the other in
float32 and would otherwise swamp the arithmetic's error; the routing is
checked by itself:

- ``routes``: the largest share of the reference's own k-th router
  probability by which an expert the port chose falls short of it (0
  where every token took the reference's own experts); infinite where a
  slot of the port's dispatch is not the one the capacity rule gives for
  the port's choices.

Two more hold the attention kernels to plain float32 attention over
the inputs each was handed in the sampled batch, at its scale, at one
layer drawn from the seed (``tape.AttentionTape``), since a tile of keys
dropped among 32,768 barely moves the last logits: ``flash`` (B3, the
prefill's, at a sample of query positions) and ``decode_attn`` (B6,
every step's), each the worst row's RMS error over the RMS of the plain
output, over heads and head dims. An architecture declares which of the
two its path has (``archs/<model_type>.py`` ``KERNEL_CHECKS``).

A cell's limits file names the numbers it compares.
"""
from __future__ import annotations

import torch

from bench.reference.scores import KINDS, scores as plain_scores


def readings(port_logits: torch.Tensor, port_scores: torch.Tensor,
             ref_logits: torch.Tensor, routing=None) -> dict:
    """port_logits (B, 1 + steps, V') fp32 (V' >= V: the port's padded
    vocabulary), port_scores (4, steps, B) in ``KINDS`` order, the scores
    of ``port_logits[:, 1:]``, ref_logits
    (B, 1 + steps, V) fp32; ``routing``: the reference's
    ``transformer.Routing``, where it followed the port's routes ->
    {name: float}."""
    V = ref_logits.shape[-1]
    pl = port_logits[..., :V].double()
    rl = ref_logits.double()
    diff = (pl - rl).square().mean(-1).sqrt()
    spread = (rl - rl.mean(-1, keepdim=True)).square().mean(-1).sqrt()
    logits = (diff / spread).max()

    steps = port_scores.shape[1]
    ref = plain_scores(port_logits[:, 1:].reshape(
        -1, port_logits.shape[-1]))                       # (B * steps,)
    port = {k: port_scores[i].double().T.reshape(-1)      # (B, steps) order
            for i, k in enumerate(KINDS)}
    p1 = 1.0 - ref["lc"]
    errs = [(port["lc"] - ref["lc"]).abs() / p1,
            (port["mc"] - ref["mc"]).abs() / p1,
            (port["rc"] - ref["rc"]).abs(),
            (port["es"] - ref["es"]).abs()]
    score = torch.stack([e.reshape(-1, steps) for e in errs]).max()
    out = {"logits": float(logits), "scores": float(score)}
    if routing is not None and routing.forced is not None:
        out["routes"] = (routing.gap if routing.bad_slots == 0
                         else float("inf"))
    return out


def _row_error(out, ref):
    """(N, R, H, D) -> the worst (N, R) row's RMS error over its RMS."""
    out, ref = out.double(), ref.double()
    err = (out - ref).square().mean((-1, -2)).sqrt()
    return float((err / ref.square().mean((-1, -2)).sqrt()).max())


def kernels(rec, precision: str = "fp32") -> dict:
    """The kernel numbers of a ``tape.Record`` (None: none): each kernel's
    output against plain attention in float32 over the same inputs at
    the call's scale. ``precision="fp8"``: the control's instead, plain
    attention with float8 operands in the kernels' place."""
    from bench.reference import transformer as reference
    if rec is None:
        return {}
    exact = reference.Products()
    low = reference.Products(precision)

    def error(out, q, pos, k, v, scale):
        ref = reference.attend(exact, q, pos, k, v, scale=scale)
        got = (out if precision == "fp32"
               else reference.attend(low, q, pos, k, v, scale=scale))
        return _row_error(got, ref)

    out = {}
    f = rec.flash
    if f is not None:
        out["flash"] = error(f.out, f.q, f.pos, f.k.to(f.q.device),
                             f.v.to(f.q.device), f.scale)
    d = rec.decode
    if d is not None:
        worst = 0.0
        for q, o, valid, scale in d.steps:
            n = int(valid)
            pos = torch.tensor([n - 1], device=q.device)
            worst = max(worst, error(o, q, pos, d.k[:, :n], d.v[:, :n],
                                     scale))
        out["decode_attn"] = worst
    return out


def judge(values: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every number ``limits`` names; one
    that was not read, or is not finite, fails."""
    return {n: {"value": values.get(n, float("nan")), "limit": lim}
            for n, lim in limits.items()}


def passed(checks: dict) -> bool:
    return all(c["value"] == c["value"] and c["value"] <= c["limit"]
               for c in checks.values())
