"""Dense MLP blocks: SwiGLU / GELU (port of repro/models/layers/mlp.py).

The names follow the reference: SwiGLU is ``silu(x @ w_gate) * (x @ w_in)``,
and GELU is ``jax.nn.gelu``'s default, the tanh approximation."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.common.param import ParamDecl


def mlp_decls(d_model: int, d_ff: int, kind: str, bias: bool = False):
    decls = {"w_in": ParamDecl((d_model, d_ff)),
             "w_out": ParamDecl((d_ff, d_model))}
    if kind == "swiglu":
        decls["w_gate"] = ParamDecl((d_model, d_ff))
    if bias:
        decls["b_in"] = ParamDecl((d_ff,), init="zeros")
        decls["b_out"] = ParamDecl((d_model,), init="zeros")
    return decls


def mlp_apply(params, x, kind: str):
    h = x @ params["w_in"]
    if "b_in" in params:
        h = h + params["b_in"]
    if kind == "swiglu":
        h = F.silu((x @ params["w_gate"]).float()).to(h.dtype) * h
    else:
        h = F.gelu(h.float(), approximate="tanh").to(h.dtype)
    out = h @ params["w_out"]
    if "b_out" in params:
        out = out + params["b_out"]
    return out
