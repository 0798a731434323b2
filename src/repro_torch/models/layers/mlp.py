"""Dense MLP blocks: SwiGLU / GELU (port of repro/models/layers/mlp.py).

The names follow the reference: SwiGLU is ``silu(x @ w_gate) * (x @ w_in)``,
and GELU is ``jax.nn.gelu``'s default, the tanh approximation."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.common.param import ParamDecl
from repro_torch.distributed.partition import ac


def mlp_decls(d_model: int, d_ff: int, kind: str, bias: bool = False):
    decls = {"w_in": ParamDecl((d_model, d_ff), ("embed", "ff")),
             "w_out": ParamDecl((d_ff, d_model), ("ff", "embed"))}
    if kind == "swiglu":
        decls["w_gate"] = ParamDecl((d_model, d_ff), ("embed", "ff"))
    if bias:
        decls["b_in"] = ParamDecl((d_ff,), ("ff",), init="zeros")
        decls["b_out"] = ParamDecl((d_model,), ("norm",), init="zeros")
    return decls


def mlp_apply(params, x, kind: str, lead: tuple = ("batch",)):
    """``lead``: the logical names of x's leading axes (``("expert",
    "batch")`` for the MoE's batched experts), for ``ac``."""
    lg = tuple(lead) + (None,) * (x.dim() - 1 - len(lead)) + ("ff",)
    h = ac(x @ params["w_in"], *lg)
    if "b_in" in params:
        h = h + params["b_in"]
    if kind == "swiglu":
        g = ac(x @ params["w_gate"], *lg)
        h = F.silu(g.float()).to(h.dtype) * h
    else:
        h = F.gelu(h.float(), approximate="tanh").to(h.dtype)
    out = ac(h @ params["w_out"], *lg[:-1], None)
    if "b_out" in params:
        out = out + params["b_out"]
    return out
