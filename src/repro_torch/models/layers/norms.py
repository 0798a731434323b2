"""RMSNorm / LayerNorm in fp32 (port of repro/models/layers/norms.py)."""
from __future__ import annotations

import torch

from repro_torch.common.param import ParamDecl


def rms_decls(dim: int):
    return {"scale": ParamDecl((dim,), ("norm",), init="ones")}


def ln_decls(dim: int):
    return {"scale": ParamDecl((dim,), ("norm",), init="ones"),
            "bias": ParamDecl((dim,), ("norm",), init="zeros")}


def norm_decls(kind: str, dim: int):
    return rms_decls(dim) if kind == "rms" else ln_decls(dim)


def rmsnorm(params, x, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(dtype)


def layernorm(params, x, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * params["scale"].float() + params["bias"].float()).to(dtype)


def apply_norm(kind: str, params, x, eps: float):
    return rmsnorm(params, x, eps) if kind == "rms" else layernorm(params, x, eps)
