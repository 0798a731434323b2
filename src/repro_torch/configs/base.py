# Copied from repro/configs/base.py: MoEConfig, MLAConfig, RWKVConfig,
# GriffinConfig, ArchConfig, pad_to and the two properties the encoder
# and the decode stack use (hd, padded_vocab), with the fields the ported
# stacks read: q_chunk and kv_chunk (prefill attention), moe, mla, rwkv,
# griffin, logits_soft_cap, the enc-dec fields (enc_dec, n_enc_layers,
# n_enc_frames), n_patches and mtp (the MTP head's declarations; its loss
# waits for ROADMAP A13). The LM head is always untied: no config of the
# registry sets tie_embeddings. Dropped: n_params, tp_friendly,
# active_params, subquadratic and the dry-run shapes, which only the TPU
# dry run uses; and the remat knob, which inference has no use for.
"""Architecture configuration.

One ``ArchConfig`` describes a backbone; each arch file under
``repro_torch/configs`` exports ``CONFIG`` (full size) and
``smoke_config()`` (reduced, runs on the CPU).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    first_dense: int = 0          # leading dense layers (deepseek-v3: 3)
    capacity_factor: float = 1.25
    group_size: int = 2048        # tokens per dispatch group
    aux_loss_alpha: float = 0.001
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64
    mix_lora: int = 32
    chunk: int = 64


@dataclasses.dataclass(frozen=True)
class GriffinConfig:
    """RecurrentGemma block pattern: (rec, rec, attn) repeating."""
    lru_width: int = 2560
    conv_width: int = 4
    pattern: Tuple[str, ...] = ("rec", "rec", "attn")
    window: int = 2048            # local attention window
    c_const: float = 8.0


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | audio | vlm
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
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    rwkv: Optional[RWKVConfig] = None
    griffin: Optional[GriffinConfig] = None
    # enc-dec (whisper): n_layers == decoder layers
    enc_dec: bool = False
    n_enc_layers: int = 0
    n_enc_frames: int = 1500      # stub audio frontend sequence length
    # vlm stub frontend
    n_patches: int = 0            # patch embeddings spliced into prefix
    mtp: bool = False             # deepseek-v3 multi-token prediction head
    logits_soft_cap: Optional[float] = None
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
