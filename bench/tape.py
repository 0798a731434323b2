"""The check's view of the two attention kernels, B3 (the prefill's
``flash_attention_auto``) and B6 (each step's ``decode_attention_auto``).

Installed over the port's kernel entry points for a run, the tape passes
every call on to ``flash`` and ``decode`` (the kernels, or a fault planted
in their place) and, in a batch the check may read, keeps one layer's
calls, the layer drawn from the seed, for the kernel numbers the cell
names (``checks``) and no more: for ``flash``, B3's own call, its inputs
for a sample of documents (the query rows at a sample of positions, the
prompt's last among them, and every key and value, these in pinned host
memory, so that they add nothing to the device's peak) with its output
at those rows and the call's ``scale``; for ``decode_attn``, B6's query,
output, length and scale at every step, and at the batch's end the
layer's cache for those documents, whose keys and values B6 read.
``compare.kernels`` then holds each kernel to plain attention over its
own inputs. The model-level check (``logits``) sees a kernel's fault only
as far as it moves the last logits, which a tile of keys in 32,768 barely
does.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from bench.traffic import seed_entropy

DOCS = 2        # documents of the batch kept
ROWS = 255      # query positions of the prompt kept, besides its last
CHECKS = ("flash", "decode_attn")


@dataclasses.dataclass
class Flash:
    """B3's call at the layer: ``pos`` (R,) the kept query positions;
    ``q``/``out`` (N, R, H, D) at those rows; ``k``/``v`` (N, S, KH, D)
    the call's keys and values (on the host where the call was on a
    card); ``scale`` its softmax scale."""
    pos: torch.Tensor
    q: torch.Tensor
    out: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    scale: float


@dataclasses.dataclass
class Decode:
    """B6's calls at the layer: ``steps``, each step's (q (N, 1, H, D),
    out, valid length, scale); ``k``/``v`` (N, T, KH, D) the layer's cache
    after the last step."""
    steps: List[tuple]
    k: torch.Tensor
    v: torch.Tensor


@dataclasses.dataclass
class Record:
    """One layer's attention in one batch: what the cell's kernel numbers
    need (None where it names no such number)."""
    flash: Optional[Flash]
    decode: Optional[Decode]


def _scale(q, kw) -> float:
    """The softmax scale a kernel call applies: its ``scale``, else the
    kernels' default over ``q``'s head dim."""
    scale = kw.get("scale")
    return float(q.shape[-1] ** -0.5 if scale is None else scale)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A card's ``t`` copied to pinned host memory in its stream's order,
    without waiting for it; a host tensor as it is."""
    if not t.is_cuda:
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t, non_blocking=True)


class AttentionTape:
    def __init__(self, layers: int, batch: int, prompt_len: int, seed: int,
                 device, checks=CHECKS):
        unknown = set(checks) - set(CHECKS)
        if unknown:
            raise ValueError(f"no kernel check {sorted(unknown)}; known: "
                             f"{CHECKS}")
        rng = np.random.default_rng([seed_entropy(seed), 3])
        self.layers = layers
        self.layer = int(rng.integers(layers))
        docs = np.sort(rng.choice(batch, min(batch, DOCS), replace=False))
        rows = rng.choice(prompt_len - 1, min(prompt_len - 1, ROWS),
                          replace=False)
        rows = np.sort(np.append(rows, prompt_len - 1))
        self.docs = torch.from_numpy(docs).to(device)
        self.rows = torch.from_numpy(rows).to(device)
        self.checks = frozenset(checks)
        self.on = False
        self._reset()

    def _reset(self):
        self.calls = self.dcalls = 0
        self.prefill = None
        self.steps = []
        self.cache = None

    def install(self):
        from repro_torch.kernels.decode_attention import ops as dec_ops
        from repro_torch.kernels.flash_attention import ops as fa_ops
        self._mods = (fa_ops, dec_ops)
        self.flash = fa_ops.flash_attention_auto
        self.decode = dec_ops.decode_attention_auto
        self._kernels = (self.flash, self.decode)
        fa_ops.flash_attention_auto = self._flash
        dec_ops.decode_attention_auto = self._decode

    def remove(self):
        """The kernels back in their place (whatever ``flash`` and
        ``decode`` were set to since)."""
        fa_ops, dec_ops = self._mods
        fa_ops.flash_attention_auto, dec_ops.decode_attention_auto = \
            self._kernels

    def start(self, record: bool):
        """A batch begins; ``record``: the check may read it."""
        self._reset()
        self.on = record

    def _flash(self, q, k, v, **kw):
        out = self.flash(q, k, v, **kw)
        if self.on and "flash" in self.checks:
            if self.calls == self.layer:
                if not kw.get("causal", True) or kw.get("window"):
                    raise ValueError("the tape holds causal attention only")
                docs = (lambda t: t.index_select(0, self.docs))
                rows = (lambda t: docs(t).index_select(1, self.rows))
                self.prefill = Flash(self.rows, rows(q), rows(out),
                                     _to_host(docs(k)), _to_host(docs(v)),
                                     _scale(q, kw))
            self.calls += 1
        return out

    def _decode(self, q, k_cache, v_cache, cur_len, **kw):
        out = self.decode(q, k_cache, v_cache, cur_len, **kw)
        if self.on and "decode_attn" in self.checks:
            if self.dcalls % self.layers == self.layer:
                if kw.get("window"):
                    raise ValueError("the tape holds causal attention only")
                self.steps.append((q.index_select(0, self.docs),
                                   out.index_select(0, self.docs),
                                   torch.as_tensor(cur_len).clone(),
                                   _scale(q, kw)))
                self.cache = (k_cache, v_cache)
            self.dcalls += 1
        return out

    def take(self) -> Optional[Record]:
        """The batch's record (None where it kept none); the cache B6 read
        is copied now, before the next batch writes over it."""
        if not self.on or not self.checks:
            return None
        if "flash" in self.checks and self.calls != self.layers:
            raise ValueError(f"{self.calls} prefill attention calls for "
                             f"{self.layers} layers: the tape counts one "
                             f"a layer")
        decode = None
        if "decode_attn" in self.checks:
            if not self.steps or self.dcalls % self.layers:
                raise ValueError(f"{self.dcalls} decode attention calls for "
                                 f"{self.layers} layers: the tape counts "
                                 f"one a layer a step")
            k, v = (t.index_select(0, self.docs) for t in self.cache)
            decode = Decode(self.steps, k, v)
        rec = Record(self.prefill, decode)
        self._reset()
        return rec
