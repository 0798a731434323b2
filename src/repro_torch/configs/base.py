# Copied from repro/configs/base.py: MoEConfig, MLAConfig, RWKVConfig,
# GriffinConfig, ArchConfig, pad_to, the two properties the encoder and
# the decode stack use (hd, padded_vocab) and n_params (the training
# path's model FLOPs), with the fields the ported stacks read: q_chunk and
# kv_chunk (prefill attention), remat (the training loss), moe, mla,
# rwkv, griffin, logits_soft_cap, the enc-dec fields (enc_dec,
# n_enc_layers, n_enc_frames), n_patches and mtp. The LM head is always
# untied: no config of the registry sets tie_embeddings. Dropped:
# tp_friendly, active_params, subquadratic and the dry-run shapes, which
# only the TPU dry run uses.
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
    remat: bool = True            # recompute each unit in the backward
    attention_impl: str = "chunked"   # chunked | naive | pallas

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab, 256)

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks), for the training
        path's model FLOPs (6 * n_params a token)."""
        d, L, V = self.d_model, self.n_layers, self.padded_vocab
        total = V * d * 2
        if self.rwkv is not None:
            per = d * d * 5 + 2 * d * self.d_ff + d * self.d_ff  # approx
            return total + L * per
        for i in range(L):
            # attention
            if self.mla is not None:
                m = self.mla
                qk = m.qk_nope_head_dim + m.qk_rope_head_dim
                per_attn = (
                    d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * self.n_heads
                    * (m.qk_nope_head_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d)
            else:
                per_attn = (d * self.hd * (self.n_heads + 2 * self.n_kv_heads)
                            + self.n_heads * self.hd * d)
            # mlp
            if self.moe is not None and i >= self.moe.first_dense:
                mo = self.moe
                per_mlp = ((mo.n_routed + mo.n_shared) * 3 * d
                           * mo.d_ff_expert + d * mo.n_routed)
            else:
                mult = 3 if self.mlp == "swiglu" else 2
                per_mlp = mult * d * self.d_ff
            total += per_attn + per_mlp
        if self.enc_dec:
            # encoder layers + cross attention in decoder
            per_enc = 4 * d * d + 2 * d * self.d_ff
            total += self.n_enc_layers * per_enc + L * 4 * d * d
        return total
