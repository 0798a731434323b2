"""RWKV6 ("Finch") time-mix and channel-mix blocks with data-dependent
decay (port of repro/models/layers/rwkv.py).

Prefill runs the exact *chunked* WKV (GLA-style): the sequence is split
into chunks of length C; the matrix state S (per head, Dk x Dv) is carried
across chunks with per-channel decay, and the intra-chunk part is a sum
over a (C, C, Dk) exp-of-log-decay-difference tensor. Every exponent is a
difference of a non-increasing cumulative log-decay, masked to -inf above
the diagonal before the exp, hence <= 0: no overflow and no clamping.
Decode is the exact one-step recurrence on the carried state, O(1) in the
context length.

The reference has no Pallas kernel here (its WKV is ``jax.lax.scan`` over
chunks), so neither does the port: plain torch ops, a Python loop over
chunks. The intra-chunk (B, C, C, H, D) fp32 tensor is built once a chunk
and multiplied in place, so only one such tensor is alive at a time
(671 MB at rwkv6-3b's prefill of 16 x 512 tokens).

Every cast is the reference's: projections in the weights' dtype, the
silu of ``g`` and the decay in fp32 (the decay LoRA's product in the
weights' dtype, cast after), the WKV and the group norm in fp32,
``(o * g)`` cast back to ``x.dtype`` before ``w_o``; the channel-mix's
squared ReLU in fp32, cast back before ``w_v``; the state's ``x_prev``
stored in fp32 and cast to ``x.dtype`` when read.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.param import ParamDecl
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import partition


def timemix_decls(cfg: ArchConfig):
    r = cfg.rwkv
    d = cfg.d_model
    H = d // r.head_dim
    return {
        "mu_x": ParamDecl((d,), ("norm",), init="zeros"),
        "mu": ParamDecl((5, d), (None, "norm"), init="zeros"),
        "mix_w1": ParamDecl((d, 5 * r.mix_lora), ("embed", None),
                            scale=0.01),
        "mix_w2": ParamDecl((5, r.mix_lora, d), (None, None, "embed"),
                            scale=0.01),
        "decay_base": ParamDecl((d,), ("norm",), init="uniform", scale=1.0),
        "decay_w1": ParamDecl((d, r.decay_lora), ("embed", "lora"),
                              scale=0.01),
        "decay_w2": ParamDecl((r.decay_lora, d), ("lora", "embed"),
                              scale=0.01),
        "bonus": ParamDecl((H, r.head_dim), ("heads", None), scale=0.1),
        "w_r": ParamDecl((d, d), ("embed", "qkv")),
        "w_k": ParamDecl((d, d), ("embed", "qkv")),
        "w_v": ParamDecl((d, d), ("embed", "qkv")),
        "w_g": ParamDecl((d, d), ("embed", "qkv")),
        "w_o": ParamDecl((d, d), ("qkv", "embed")),
        "gn_scale": ParamDecl((d,), ("norm",), init="ones"),
        "gn_bias": ParamDecl((d,), ("norm",), init="zeros"),
    }


def chanmix_decls(cfg: ArchConfig):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": ParamDecl((d,), ("norm",), init="zeros"),
        "mu_r": ParamDecl((d,), ("norm",), init="zeros"),
        "w_k": ParamDecl((d, f), ("embed", "ff")),
        "w_v": ParamDecl((f, d), ("ff", "embed")),
        "w_r": ParamDecl((d, d), ("embed", "qkv")),
    }


def _token_shift(x, prev):
    """x: (B,S,d); prev: (B,d) last token of the previous segment (zeros at
    t=0)."""
    return torch.cat([prev[:, None, :], x[:, :-1]], dim=1)


def _ddlerp(x, sx, mu_x, mu, w1, w2):
    """RWKV6 data-dependent mixing -> the 5 mixed inputs (w,k,v,r,g)."""
    xx = x + sx * mu_x                                      # (B,S,d)
    lo = torch.tanh(xx @ w1)
    lo = partition.split_heads(lo, 5, w2.shape[1])
    off = torch.einsum("bsml,mld->bsmd", lo, w2)            # (B,S,5,d)
    mixed = x[..., None, :] + sx[..., None, :] * (mu + off)
    return [partition.ac(mixed[..., i, :], "batch", None, None)
            for i in range(5)]


def _group_norm(o, scale, bias, H: int, eps: float = 64e-5):
    B, S, d = o.shape
    x = partition.split_heads(o, H, d // H).float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    x = partition.merge_heads((x - mu) * torch.rsqrt(var + eps))
    return x * scale.float() + bias.float()


def _rkvw(params, x, x_prev):
    """Projections + per-step log decay. Returns (r, k, v, g, log_w, the
    (B,d) last x)."""
    sx = _token_shift(x, x_prev) - x
    xw, xk, xv, xr, xg = _ddlerp(x, sx, params["mu_x"], params["mu"],
                                 params["mix_w1"], params["mix_w2"])
    r = xr @ params["w_r"]
    k = xk @ params["w_k"]
    v = xv @ params["w_v"]
    g = F.silu((xg @ params["w_g"]).float())
    lo = partition.ac(torch.tanh(xw @ params["decay_w1"]), "batch", None,
                      None)
    dec = params["decay_base"].float() + partition.ac(
        lo @ params["decay_w2"], "batch", None, None).float()
    log_w = -torch.exp(dec)                                 # <= 0, per channel
    return r, k, v, g, log_w, x[:, -1]


def wkv_sequential(r, k, v, log_w, bonus, state0):
    """Oracle and decode step: the exact per-step recurrence.
    r/k/v/log_w: (B,S,H,D) fp32; state0: (B,H,D,D). Returns (o (B,S,H,D),
    state)."""
    state, outs = state0, []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], log_w[:, t]
        kv = torch.einsum("bhk,bhv->bhkv", k_t, v_t)
        outs.append(torch.einsum("bhk,bhkv->bhv", r_t,
                                 state + bonus[..., None] * kv))
        state = torch.exp(w_t)[..., None] * state + kv
    return torch.stack(outs, dim=1), state


def wkv_chunked(r, k, v, log_w, bonus, state0, chunk: int):
    """Exact chunked WKV. r/k/v/log_w: (B,S,H,D) fp32; state0: (B,H,D,D).
    Returns (o (B,S,H,D), state)."""
    B, S, H, D = r.shape
    C = min(chunk, S)
    n = -(-S // C)
    pad = n * C - S
    if pad:      # zero k and log w past S: the state takes nothing from them
        r, k, v, log_w = (F.pad(a, (0, 0, 0, 0, 0, pad))
                          for a in (r, k, v, log_w))
    above = ~torch.tril(torch.ones((C, C), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    state, outs = state0, []
    for c in range(n):
        sl = slice(c * C, (c + 1) * C)
        rr, kk, vv, ww = r[:, sl], k[:, sl], v[:, sl], log_w[:, sl]
        b = torch.cumsum(ww, dim=1)                         # inclusive
        b_end = b[:, -1]                                    # (B,H,D)
        # inter-chunk: o_t += (r_t * exp(b_{t-1})) @ S_prev
        b_prev = b - ww                                     # exclusive
        o = torch.einsum("bthk,bhkv->bthv", rr * torch.exp(b_prev), state)
        # intra-chunk: s_tj = sum_d r_td k_jd exp(b_{t-1,d} - b_{j,d}), j<t;
        # -inf above the diagonal BEFORE the exp (b_prev - b > 0 there), and
        # the one (B,C,C,H,D) tensor multiplied in place, but where autograd
        # records the chunk (the same operations out of place)
        e = b_prev[:, :, None] - b[:, None, :]              # (B,C,C,H,D)
        mask = above[None, :, :, None, None]
        if e.requires_grad:
            e = torch.exp(e.masked_fill(mask, float("-inf"))) \
                * rr[:, :, None] * kk[:, None, :]
        else:
            e.masked_fill_(mask, float("-inf"))
            e.exp_()
            e.mul_(rr[:, :, None]).mul_(kk[:, None, :])
        s = e.sum(dim=-1)                                   # (B,C,C,H)
        del e
        o = o + torch.einsum("btjh,bjhv->bthv", s, vv)
        # diagonal bonus term
        diag = (rr * bonus * kk).sum(dim=-1)                # (B,C,H)
        o = o + diag[..., None] * vv
        # S = exp(b_end) * S_prev + sum_j exp(b_end - b_j) k_j v_j
        k_dec = kk * torch.exp(b_end[:, None] - b)
        state = torch.exp(b_end)[..., None] * state + torch.einsum(
            "bjhk,bjhv->bhkv", k_dec, vv)
        outs.append(o)
    return torch.cat(outs, dim=1)[:, :S], state


def timemix_apply(params, x, cfg: ArchConfig, state=None
                  ) -> Tuple[torch.Tensor, dict]:
    """x: (B,S,d). state: None or {"x_prev": (B,d), "S": (B,H,D,D) fp32}.
    Returns (out (B,S,d), {"x_prev": fp32 (B,d), "S": fp32})."""
    r_cfg = cfg.rwkv
    B, S, d = x.shape
    H, D = d // r_cfg.head_dim, r_cfg.head_dim
    x_prev = (torch.zeros((B, d), dtype=x.dtype, device=x.device)
              if state is None else state["x_prev"].to(x.dtype))
    r, k, v, g, log_w, last_x = _rkvw(params, x, x_prev)
    r4, k4, v4 = (partition.split_heads(t, H, D).float() for t in (r, k, v))
    w4 = partition.split_heads(log_w, H, D)
    bonus = params["bonus"].float()

    def scan(r4, k4, v4, w4, bonus, S0):
        if S0 is None:
            S0 = torch.zeros((r4.shape[0], r4.shape[2], D, D),
                             dtype=torch.float32, device=r4.device)
        if S == 1:
            return wkv_sequential(r4, k4, v4, w4, bonus, S0)
        return wkv_chunked(r4, k4, v4, w4, bonus, S0, r_cfg.chunk)

    S0 = None if state is None else state["S"]
    # on DTensors, the scan runs on each rank's (batch, heads) shard
    hl, sl = ("batch", None, "heads", None), ("batch", "heads", None, None)
    o, S1 = partition.local_region(
        scan, (r4, k4, v4, w4, bonus, S0),
        (hl, hl, hl, hl, ("heads", None), sl), ((hl, r4.shape),
                                               (sl, (B, H, D, D))))
    o = _group_norm(partition.merge_heads(o), params["gn_scale"],
                    params["gn_bias"], H)
    o = (o * g).to(x.dtype)
    return o @ params["w_o"], {"x_prev": last_x.float(), "S": S1}


def chanmix_apply(params, x, state=None) -> Tuple[torch.Tensor, dict]:
    """x: (B,S,d). state: None or {"x_prev": (B,d)}."""
    B, S, d = x.shape
    x_prev = (torch.zeros((B, d), dtype=x.dtype, device=x.device)
              if state is None else state["x_prev"].to(x.dtype))
    sx = _token_shift(x, x_prev) - x
    xk = x + sx * params["mu_k"]
    xr = x + sx * params["mu_r"]
    kk = xk @ params["w_k"]
    kk = torch.square(torch.relu(kk.float())).to(x.dtype)
    kv = kk @ params["w_v"]
    rr = torch.sigmoid((xr @ params["w_r"]).float())
    return (rr * kv.float()).to(x.dtype), {"x_prev": x[:, -1].float()}


def rwkv_state_decls(cfg: ArchConfig, batch: int, count: int = 1):
    """The recurrent state of ``count`` stacked layers, fp32 whatever the
    cache dtype, as the reference declares it."""
    r = cfg.rwkv
    d = cfg.d_model
    H, D = d // r.head_dim, r.head_dim
    f32 = torch.float32
    return {
        "att": {"x_prev": ParamDecl((count, batch, d),
                                    ("layer", "batch", None), "zeros", f32),
                "S": ParamDecl((count, batch, H, D, D),
                               ("layer", "batch", "heads", None, None),
                               "zeros", f32)},
        "ffn": {"x_prev": ParamDecl((count, batch, d),
                                    ("layer", "batch", None), "zeros", f32)},
    }
