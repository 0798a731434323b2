"""Random weights made on the device from the run's seed, in the layout and
dtypes that the port declares (``Model.param_decls()``), in a few large
calls: one flat buffer a dtype, filled with N(0, 1) by a generator on the
device in chunks, then each leaf a view of it, scaled in place.

A matrix gets std 1/sqrt(fan_in), fan_in being its second-to-last axis
(a weight maps rows of that size; an expert axis in front does not add to
it); the embedding std 0.02; declarations of ones and zeros (norm scales,
biases) are ones and zeros. The leaves that make the attention's
queries and keys, which each architecture names (``archs/<model_type>.py``
``SPREAD_LEAVES``: ``w_q`` and ``w_k`` for a GQA or MHA stack), get
sqrt(``qk_logit_std``) times that, so that the attention logits
q.k/sqrt(head_dim) spread with that std: at 1 the softmax over thousands
of keys is all but flat (some 12,000 effective keys of 32,768), an
attention output is a near-constant mean of the values, and a check of
the logits cannot see a key dropped or a position shifted; a trained
model's attention is peaked. Too peaked over random keys, the stack turns
chaotic and rounding alone swamps the check, so each cell sets its own
(``bench/limits/<cell>.json``). Rows of the embedding and columns of the
LM head past the published vocabulary (the port's padding) are zero, as a
padded checkpoint holds them.
"""
from __future__ import annotations

import math

import torch

ALIGN = 256             # elements: every leaf starts 512-byte aligned
CHUNK = 1 << 28         # elements a normal_ call


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _rebuild(tree, views, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, views, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, views, path + (i,)) for i, v in enumerate(tree)]
    return views[path]


def _std(path, decl, qk_logit_std: float, spread_leaves) -> float:
    if decl.init == "embed":
        return 0.02
    if decl.init == "normal":
        std = 1.0 / math.sqrt(decl.shape[-2] if len(decl.shape) > 1 else 1)
        if path[-1] in spread_leaves:
            std *= math.sqrt(qk_logit_std)
        return std
    raise ValueError(f"no rule for init {decl.init!r}")


def make(decls, vocab: int, seed: int, device, qk_logit_std: float = 1.0,
         spread_leaves=()) -> dict:
    """The weight tree of ``decls`` on ``device`` from ``seed``; the leaves
    named in ``spread_leaves`` carry sqrt(``qk_logit_std``)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 64)
    leaves = list(_leaves(decls))
    by_dtype = {}
    for path, decl in leaves:
        by_dtype.setdefault(decl.held, []).append((path, decl))
    views = {}
    for dtype, group in by_dtype.items():
        sizes = [-(-math.prod(d.shape) // ALIGN) * ALIGN for _, d in group]
        flat = torch.empty(sum(sizes), dtype=dtype, device=device)
        for c0 in range(0, flat.numel(), CHUNK):
            flat[c0:c0 + CHUNK].normal_(generator=gen)
        at = 0
        for (path, decl), size in zip(group, sizes):
            n = math.prod(decl.shape)
            view = flat[at:at + n].view(decl.shape)
            at += size
            if decl.init == "zeros":
                view.zero_()
            elif decl.init == "ones":
                view.fill_(1.0)
            else:
                view.mul_(_std(path, decl, qk_logit_std, spread_leaves))
            views[path] = view
    params = _rebuild(decls, views)
    params["embed"][vocab:].zero_()
    params["lm_head"][:, vocab:].zero_()
    return params
