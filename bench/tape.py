"""The check's view of the two attention kernels, B3 (the prefill's
``flash_attention_auto``) and B6 (each step's ``decode_attention_auto``).

Installed over the port's kernel entry points for a run, the tape passes
every call on to ``flash`` and ``decode`` (the kernels, or a fault planted
in their place) and, in a batch the check may read, keeps one layer's
calls, the layer drawn from the seed: B3's query rows and output for a
sample of documents and positions (the prompt's last among them), B6's
query and output at every step, and at the batch's end the layer's cache
for those documents, whose keys and values both kernels read.
``compare.kernels`` then holds each kernel to plain attention over its
own inputs. The model-level
check (``logits``) sees a kernel's fault only as far as it moves the last
logits, which a tile of keys in 32,768 barely does.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from bench.traffic import seed_entropy

DOCS = 2        # documents of the batch kept
ROWS = 255      # query positions of the prompt kept, besides its last


@dataclasses.dataclass
class Record:
    """One layer's attention in one batch. ``pos`` (R,) the kept query
    positions; ``q``/``out`` (N, R, H, D) of the prefill; ``k``/``v``
    (N, T, KH, D) the layer's keys and values after the last step (the
    prompt's first); ``steps``: each step's (q (N, 1, H, D), out, valid)."""
    pos: torch.Tensor
    q: torch.Tensor
    out: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    prompt_len: int
    steps: List[tuple]


class AttentionTape:
    def __init__(self, layers: int, batch: int, prompt_len: int, seed: int,
                 device):
        rng = np.random.default_rng([seed_entropy(seed), 3])
        self.layers = layers
        self.layer = int(rng.integers(layers))
        docs = np.sort(rng.choice(batch, min(batch, DOCS), replace=False))
        rows = rng.choice(prompt_len - 1, min(prompt_len - 1, ROWS),
                          replace=False)
        rows = np.sort(np.append(rows, prompt_len - 1))
        self.docs = torch.from_numpy(docs).to(device)
        self.rows = torch.from_numpy(rows).to(device)
        self.prompt_len = prompt_len
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
        if self.on:
            if self.calls == self.layer:
                if not kw.get("causal", True) or kw.get("window"):
                    raise ValueError("the tape holds causal attention only")
                pick = (lambda t, rows: t.index_select(1, rows)
                        .index_select(0, self.docs))
                self.prefill = (pick(q, self.rows), pick(out, self.rows))
            self.calls += 1
        return out

    def _decode(self, q, k_cache, v_cache, cur_len, **kw):
        out = self.decode(q, k_cache, v_cache, cur_len, **kw)
        if self.on:
            if self.dcalls % self.layers == self.layer:
                if kw.get("window"):
                    raise ValueError("the tape holds causal attention only")
                self.steps.append((q.index_select(0, self.docs),
                                   out.index_select(0, self.docs),
                                   torch.as_tensor(cur_len).clone()))
                self.cache = (k_cache, v_cache)
            self.dcalls += 1
        return out

    def take(self) -> Optional[Record]:
        """The batch's record (None where it kept none); the cache it read
        is copied now, before the next batch writes over it."""
        if not self.on or self.prefill is None:
            return None
        if self.calls != self.layers or self.dcalls % self.layers:
            raise ValueError(f"{self.calls} prefill attention calls for "
                             f"{self.layers} layers: the tape counts one "
                             f"a layer")
        k, v = (t.index_select(0, self.docs) for t in self.cache)
        q, out = self.prefill
        rec = Record(self.rows, q, out, k, v, self.prompt_len, self.steps)
        self._reset()
        return rec
