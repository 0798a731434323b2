# Copied from repro/configs/base.py: ArchConfig, pad_to and the two
# properties the encoder and the dense decode stack use (hd,
# padded_vocab), with the fields the dense stack reads: q_chunk and
# kv_chunk (prefill attention). The LM head is always untied and uncapped:
# tie_embeddings and logits_soft_cap come back with the first config that
# sets them (ROADMAP A12). Dropped: the MoE, MLA, RWKV and Griffin sub-configs, the enc-dec, patch
# and MTP fields, n_params, tp_friendly, active_params and the dry-run
# shapes, which only the TPU dry run and the rest of the LLM stack use
# (ROADMAP A12); and the remat knob, which inference has no use for.
"""Architecture configuration.

One ``ArchConfig`` describes a backbone; each arch file under
``repro_torch/configs`` exports ``CONFIG`` (full size) and
``smoke_config()`` (reduced, runs on the CPU).
"""
from __future__ import annotations

import dataclasses


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense (the only family ported)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    qk_norm: bool = False
    norm: str = "rms"             # rms | ln
    mlp: str = "swiglu"           # swiglu | gelu
    norm_eps: float = 1e-6
    # runtime knobs
    q_chunk: int = 512
    kv_chunk: int = 1024
    attention_impl: str = "chunked"   # chunked | naive | pallas

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab, 256)
