"""RG-LRU recurrent block (Griffin / RecurrentGemma; port of
repro/models/layers/rglru.py).

Temporal mixing: y = W_out( GeLU(W_gate x) * RGLRU(conv1d_4(W_x x)) ).
The linear recurrence h_t = a_t*h_{t-1} + sqrt(1-a_t^2)*(i_t*u_t) runs
over the sequence as a log-depth (Hillis-Steele) inclusive scan with the
reference's ``combine`` ((a1, b1), (a2, b2)) -> (a1*a2, a2*b1 + b2) for
prefill, and as one step for decode. The reference's
``jax.lax.associative_scan`` has no torch counterpart; the log-depth scan
takes ceil(log2 S) rounds of whole-sequence elementwise ops (9 at a
512-token prompt) where a step loop would take S. Its products associate
in another order than the reference's, so it agrees with the stepwise
recurrence to fp32 rounding (tests/test_torch_rglru.py states the
tolerance). The reference has no Pallas kernel here, so the port has none.

The gates are block-diagonal over ``cfg.n_heads`` blocks and run in fp32;
log a_t = -c * r_t * softplus(-Lambda) with the reference's constant c = 8.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.param import ParamDecl
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import partition

_C_CONST = 8.0


def rglru_decls(cfg: ArchConfig):
    g = cfg.griffin
    d, W = cfg.d_model, g.lru_width
    H = cfg.n_heads
    bw = W // H                      # block width for block-diagonal gates
    return {
        "w_x": ParamDecl((d, W), ("embed", "tp")),
        "w_gate": ParamDecl((d, W), ("embed", "tp")),
        "w_out": ParamDecl((W, d), ("tp", "embed")),
        "conv_w": ParamDecl((g.conv_width, W), ("stack", "tp"), scale=0.1),
        "conv_b": ParamDecl((W,), ("tp",), init="zeros"),
        # block-diagonal input/recurrence gates (H blocks)
        "gate_a_w": ParamDecl((H, bw, bw), ("heads", None, None)),
        "gate_a_b": ParamDecl((H, bw), ("heads", None), init="zeros"),
        "gate_x_w": ParamDecl((H, bw, bw), ("heads", None, None)),
        "gate_x_b": ParamDecl((H, bw), ("heads", None), init="zeros"),
        # Lambda: U(-1, 1)
        "lam": ParamDecl((W,), ("norm",), init="uniform", scale=1.0),
    }


def _gates(params, u, H: int):
    """u: (B,S,W) -> (log_a, gated_in) both (B,S,W) fp32."""
    B, S, W = u.shape
    ub = partition.split_heads(u, H, W // H).float()
    r = torch.sigmoid(
        torch.einsum("bshw,hwv->bshv", ub, params["gate_a_w"].float())
        + params["gate_a_b"].float())
    i = torch.sigmoid(
        torch.einsum("bshw,hwv->bshv", ub, params["gate_x_w"].float())
        + params["gate_x_b"].float())
    r = partition.merge_heads(r)
    i = partition.merge_heads(i)
    lam = params["lam"].float()
    # log a_t = c * r_t * log sigmoid(Lambda)   (<= 0)
    log_a = -_C_CONST * r * F.softplus(-lam)
    return log_a, i * u.float()


def conv1d_causal(params, u, state=None):
    """Depthwise causal conv, width K. u: (B,S,W). state: (B,K-1,W) or None.

    Returns (out, new_state) where new_state holds the last K-1 inputs.
    """
    K = params["conv_w"].shape[0]
    B, S, W = u.shape
    if state is None:
        state = torch.zeros((B, K - 1, W), dtype=u.dtype, device=u.device)
    xs = torch.cat([state.to(u.dtype), u], dim=1)          # (B, S+K-1, W)
    out = torch.zeros((B, S, W), dtype=torch.float32, device=u.device)
    w = params["conv_w"].float()
    for i in range(K):
        out = out + xs[:, i:i + S].float() * w[K - 1 - i]
    out = out + params["conv_b"].float()
    return out.to(u.dtype), xs[:, S:]


def rglru_scan(log_a, gated, h0=None):
    """Linear recurrence h_t = a_t h_{t-1} + b_t as a log-depth inclusive
    scan. All (B,S,W) fp32; h0: (B,W) or None. Returns h (B,S,W)."""
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 0.0)) * gated
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    S, d = a.shape[1], 1
    while d < S:
        # combine((a[t-d], b[t-d]), (a[t], b[t])) for every t >= d
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def rglru_block_apply(params, x, cfg: ArchConfig, state=None
                      ) -> Tuple[torch.Tensor, dict]:
    """Temporal-mix forward. x: (B,S,d). state: None or
    {"h": (B,W), "conv": (B,K-1,W)}. Returns (y, new_state)."""
    u = x @ params["w_x"]
    gate = F.gelu((x @ params["w_gate"]).float(), approximate="tanh")
    u, conv_state = conv1d_causal(
        params, u, None if state is None else state["conv"])
    log_a, gated = _gates(params, u, cfg.n_heads)
    h = rglru_scan(log_a, gated, None if state is None else state["h"])
    y = (gate * h).to(x.dtype)
    return y @ params["w_out"], {"h": h[:, -1].float(), "conv": conv_state}


def rglru_state_decls(cfg: ArchConfig, batch: int, count: int,
                      dtype: torch.dtype):
    """The state of ``count`` stacked layers: ``h`` fp32 whatever the
    cache dtype, ``conv`` (the last K-1 inputs) in the cache dtype, as
    the reference declares them."""
    g = cfg.griffin
    return {
        "h": ParamDecl((count, batch, g.lru_width), ("layer", "batch", "tp"),
                       "zeros", torch.float32),
        "conv": ParamDecl((count, batch, g.conv_width - 1, g.lru_width),
                          ("layer", "batch", None, "tp"), "zeros", dtype),
    }
