# Port of repro/optim/optimizer.py.
"""Optimizers built from scratch: AdamW and a factored Adafactor-style
optimizer (bf16 first moment + rank-1 factored second moment).

The arithmetic is the reference's, in fp32 and in its order, each new
param cast to the param's dtype. ``update`` writes the params and the
state in place (under ``torch.no_grad()``) and returns them with the
metrics ``grad_norm`` and ``lr``.

**Stacked segments.** The reference stacks a segment of ``count > 1``
units on a leading ``layer`` axis; the port keeps a list of units
(``bridge.load_model``). Here a list of two or more dicts stands for that
axis, and a leaf of its units is decided by its stacked shape
``(count, *shape)``, as the reference decides it:

* AdamW decays a stacked vector (a norm scale, a bias: ``ndim`` 2 in the
  reference), and never an unstacked one.
* Adafactor factors a stacked vector across the layers: ``vr`` (count,)
  and ``vc`` (d,), computed over the units stacked; each unit's state
  holds its own entry of ``vr`` (a 0-d tensor) and a copy of ``vc``. A
  stacked leaf of two or more axes factors per unit (the factored axes
  are the last two, and ``denom`` is a mean over ``vr``'s last axis), so
  each unit's state is its row of the reference's.

A list of one unit is unstacked, as in the reference. The clip's scale
multiplies each gradient inside the leaf's update (``g.float() * scale``,
the reference's product), so the fp32 copy of the gradient tree that
``clip_by_global_norm`` returns is never built.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch.common.param import ParamDecl, init_params
from repro_torch.common.tree import tree_leaves


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


def _clip_scale(grads, max_norm: float):
    norm = global_norm(grads)
    return torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0), norm


def clip_by_global_norm(grads, max_norm: float):
    scale, norm = _clip_scale(grads, max_norm)
    return _map_leaves(lambda g, n: g.float() * scale, grads), norm


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = base_lr * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr


# ------------------------------------------------------ stacked segments ----
def _is_units(node) -> bool:
    return (isinstance(node, list) and len(node) > 1
            and all(isinstance(u, dict) for u in node))


def _map_leaves(fn, tree, n: int = 0):
    """``tree``'s structure with each leaf ``x`` -> ``fn(x, n)``, ``n`` the
    units of the stacked segment holding it (0 outside one)."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, n) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        m = len(tree) if n == 0 and _is_units(tree) else n
        out = [_map_leaves(fn, v, m) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, n)


def _groups(params, *others) -> List[tuple]:
    """[(params' leaves, each other tree's matching nodes, n)] in jax's
    leaf order: for a param of a stacked segment of n units, its n units'
    leaves together; else one leaf and n = 0. The other trees have the
    params' structure down to its leaves (a leaf's node there may be a
    state dict)."""
    out = []

    def walk(ps, os_, n):
        head = ps[0]
        if isinstance(head, dict):
            for k in sorted(head):
                walk([p[k] for p in ps], [[o[k] for o in ol] for ol in os_],
                     n)
        elif n == 0 and _is_units(head):
            walk(list(head), [list(ol[0]) for ol in os_], len(head))
        elif isinstance(head, (list, tuple)):
            for i in range(len(head)):
                walk([p[i] for p in ps], [[o[i] for o in ol] for ol in os_],
                     n)
        else:
            out.append((ps, *os_, n))

    walk([params], [[o] for o in others], 0)
    return out


def _decl_of(p, n) -> ParamDecl:
    return ParamDecl(tuple(p.shape), init="zeros", dtype=p.dtype)


def _device_of(params):
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable = cosine_schedule(3e-4, 100, 10000)
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: Any = torch.float32

    def state_decls(self, param_decls):
        def one(d: ParamDecl, n):
            return {"m": ParamDecl(d.shape, d.logical, "zeros",
                                   self.state_dtype),
                    "v": ParamDecl(d.shape, d.logical, "zeros",
                                   self.state_dtype)}
        return {"per_param": _map_leaves(one, param_decls),
                "step": ParamDecl((), (), "zeros", torch.int32)}

    def init(self, params):
        return init_params(self.state_decls(_map_leaves(_decl_of, params)),
                           None, _device_of(params))

    @torch.no_grad()
    def update(self, grads, state, params):
        step = state["step"] + 1
        scale, gnorm = _clip_scale(grads, self.clip_norm)
        lr = self.lr(step)
        bc1 = 1 - self.b1 ** step.float()
        bc2 = 1 - self.b2 ** step.float()
        for ps, gs, ss, n in _groups(params, grads, state["per_param"]):
            for p, g, s in zip(ps, gs, ss):
                g32 = g.float() * scale
                m = s["m"].float().mul_(self.b1).add_((1 - self.b1) * g32)
                v = s["v"].float().mul_(self.b2).add_(
                    (1 - self.b2) * g32.mul_(g32))
                delta = (m / bc1).div_(torch.sqrt(v / bc2).add_(self.eps))
                p32 = p.float()
                if p.dim() + (n > 0) >= 2:
                    # decoupled weight decay, no decay on norms/bias
                    delta.add_(self.weight_decay * p32)
                p.copy_(p32 - lr * delta)
                s["m"].copy_(m)
                s["v"].copy_(v)
        state["step"] = step
        return params, state, {"grad_norm": gnorm, "lr": lr}


def _factor_axes(shape) -> Optional[Tuple[int, int]]:
    """Pick the two largest trailing axes to factor over (None if ndim<2)."""
    if len(shape) < 2:
        return None
    return (len(shape) - 2, len(shape) - 1)


@dataclasses.dataclass(frozen=True)
class Adafactor:
    """Factored second moment (row/col) + bf16 first moment.

    State cost: ~2 bytes/param (m in bf16) + O(rows+cols) for v."""
    lr: Callable = cosine_schedule(1e-4, 100, 10000)
    b1: float = 0.9
    decay: float = 0.99
    eps: float = 1e-30
    clip_norm: float = 1.0
    weight_decay: float = 0.0

    def state_decls(self, param_decls):
        def one(d: ParamDecl, n):
            st = {"m": ParamDecl(d.shape, d.logical, "zeros",
                                 torch.bfloat16)}
            ref = ((n,) if n else ()) + tuple(d.shape)   # the stacked shape
            log = (("layer",) if n else ()) + tuple(d.logical)
            ax = _factor_axes(ref)
            if ax is None:
                st["v"] = ParamDecl(d.shape, d.logical, "zeros",
                                    torch.float32)
                return st
            r, c = ax
            row = tuple(s for i, s in enumerate(ref) if i != c)
            col = tuple(s for i, s in enumerate(ref) if i != r)
            row_log = tuple(a for i, a in enumerate(log) if i != c)
            col_log = tuple(a for i, a in enumerate(log) if i != r)
            if n:         # a unit's row of vr, and of vc but at r == 0
                row, col = row[1:], (col if r == 0 else col[1:])
                row_log = row_log[1:]
                col_log = col_log if r == 0 else col_log[1:]
            st["vr"] = ParamDecl(row, row_log, "zeros", torch.float32)
            st["vc"] = ParamDecl(col, col_log, "zeros", torch.float32)
            return st
        return {"per_param": _map_leaves(one, param_decls),
                "step": ParamDecl((), (), "zeros", torch.int32)}

    def init(self, params):
        return init_params(self.state_decls(_map_leaves(_decl_of, params)),
                           None, _device_of(params))

    @torch.no_grad()
    def update(self, grads, state, params):
        step = state["step"] + 1
        scale, gnorm = _clip_scale(grads, self.clip_norm)
        lr = self.lr(step)
        for ps, gs, ss, n in _groups(params, grads, state["per_param"]):
            if n and ps[0].dim() == 1:
                # the reference's (n, d) leaf, factored over (layer, d)
                g32 = torch.stack([g.float() for g in gs]) * scale
                joint = {"vr": torch.stack([s["vr"] for s in ss]),
                         "vc": ss[0]["vc"].clone()}
                precond = self._precond(g32, joint, (0, 1))
                for i, (p, s) in enumerate(zip(ps, ss)):
                    s["vr"].copy_(joint["vr"][i])
                    s["vc"].copy_(joint["vc"])
                    self._apply(p, precond[i], s, lr, True)
                continue
            for p, g, s in zip(ps, gs, ss):
                precond = self._precond(g.float() * scale, s,
                                        _factor_axes(p.shape))
                self._apply(p, precond, s, lr, p.dim() + (n > 0) >= 2)
        state["step"] = step
        return params, state, {"grad_norm": gnorm, "lr": lr}

    def _precond(self, g32, s, ax):
        """The preconditioned gradient; writes the new ``v`` (or ``vr``
        and ``vc``, factored over ``ax``) into ``s``."""
        g2 = g32 * g32 + self.eps
        if ax is None:
            v = self.decay * s["v"] + (1 - self.decay) * g2
            s["v"].copy_(v)
            return g32 * torch.rsqrt(v + self.eps)
        r, c = ax
        vr = self.decay * s["vr"] + (1 - self.decay) * torch.mean(g2, dim=c)
        vc = self.decay * s["vc"] + (1 - self.decay) * torch.mean(g2, dim=r)
        denom = torch.mean(vr, dim=-1, keepdim=True)
        v = vr.unsqueeze(c) * vc.unsqueeze(r) / torch.clamp_min(
            denom.unsqueeze(c), self.eps)
        s["vr"].copy_(vr)
        s["vc"].copy_(vc)
        return g32 * torch.rsqrt(v + self.eps)

    def _apply(self, p, precond, s, lr, decay: bool):
        m = self.b1 * s["m"].float() + (1 - self.b1) * precond
        delta = m
        p32 = p.float()
        if decay and self.weight_decay:
            delta = delta + self.weight_decay * p32
        p.copy_(p32 - lr * delta)
        s["m"].copy_(m)


OPTIMIZERS = {"adamw": AdamW, "adafactor": Adafactor}


def make_optimizer(name: str, **kw):
    return OPTIMIZERS[name](**kw)
