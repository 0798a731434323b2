"""Work counts from a configuration file's published shapes alone, so that
they count the same work whatever implements it: model FLOPs, the causal
attention's FLOPs and bytes (kernel B3), the decode attention's bytes (B6)
and the uncertainty scoring's bytes (B4), and the H100's peaks. This is
the count of the GQA and MHA stacks, with or without a MoE; an
architecture names its count in ``archs/<model_type>.py``.

Model FLOPs are 2 per active matmul parameter and token, where the active
parameters leave out the embedding rows and count the LM head only where
logits are made (the prompt's last position and each scored step), plus
the causal attention's 4 * head_dim FLOPs a (query head, key) pair a
layer. A MoE layer counts its router, its ``num_experts_per_tok`` routed
experts and its shared experts: the work the model needs, not the
capacity padding of a dispatch.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core FLOP/s, HBM3 bytes/s
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

BF16 = 2
FP32 = 4


@dataclasses.dataclass(frozen=True)
class Shapes:
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    dense_layers: int          # leading dense layers of a MoE config
    experts: int               # 0: no MoE
    experts_per_token: int
    expert_ff: int
    shared_experts: int

    @classmethod
    def from_config(cls, conf: dict) -> "Shapes":
        d, heads = conf["hidden_size"], conf["num_attention_heads"]
        moe = "n_routed_experts" in conf
        return cls(
            layers=conf["num_hidden_layers"], d=d, heads=heads,
            kv_heads=conf.get("num_key_value_heads", heads),
            head_dim=conf.get("head_dim") or d // heads,
            d_ff=conf["intermediate_size"], vocab=conf["vocab_size"],
            dense_layers=(conf.get("first_k_dense_replace", 0) if moe
                          else conf["num_hidden_layers"]),
            experts=conf["n_routed_experts"] if moe else 0,
            experts_per_token=conf.get("num_experts_per_tok", 0),
            expert_ff=conf.get("moe_intermediate_size", 0),
            shared_experts=conf.get("n_shared_experts", 0))

    def attn_params(self) -> int:
        """q, k, v and o of one layer."""
        hd = self.head_dim
        return (self.d * hd * (self.heads + 2 * self.kv_heads)
                + self.heads * hd * self.d)

    def mlp_params(self, dense: bool) -> int:
        """The MLP of one layer that a token uses: SwiGLU's three matrices,
        or the router, its routed experts and the shared experts."""
        if dense:
            return 3 * self.d * self.d_ff
        active = self.experts_per_token + self.shared_experts
        return self.d * self.experts + active * 3 * self.d * self.expert_ff

    def active_params(self) -> int:
        """Matmul parameters a token uses, without embedding and LM head."""
        moe_layers = self.layers - self.dense_layers
        return (self.layers * self.attn_params()
                + self.dense_layers * self.mlp_params(True)
                + moe_layers * self.mlp_params(False))

    def head_params(self) -> int:
        return self.d * self.vocab


def causal_pairs(n: int) -> int:
    """(query, key) pairs of a causal sequence of ``n`` positions."""
    return n * (n + 1) // 2


@dataclasses.dataclass(frozen=True)
class BatchWork:
    """The work of one batch of ``batch`` documents: a prefill of
    ``prompt_len`` positions, then ``steps`` decode steps, each scored."""
    shapes: Shapes
    batch: int
    prompt_len: int
    steps: int

    @property
    def tokens(self) -> int:
        return self.batch * (self.prompt_len + self.steps)

    def model_flops(self) -> float:
        s = self.shapes
        logit_rows = self.batch * (1 + self.steps)
        attn = (4 * s.head_dim * s.heads * s.layers * self.batch
                * causal_pairs(self.prompt_len + self.steps))
        return float(2 * s.active_params() * self.tokens
                     + 2 * s.head_params() * logit_rows + attn)

    def flash_bound_s(self) -> float:
        """B3's least time over the batch's prefill: a layer's causal
        attention FLOPs over the bf16 peak, or its q, k, v and o bytes over
        the HBM peak, whichever is larger, summed over layers."""
        s = self.shapes
        flops = (4 * s.head_dim * s.heads * self.batch
                 * causal_pairs(self.prompt_len))
        nbytes = (self.batch * self.prompt_len * s.head_dim * BF16
                  * (2 * s.heads + 2 * s.kv_heads))
        return s.layers * max(flops / PEAK_BF16_FLOPS,
                              nbytes / PEAK_HBM_BYTES)

    def decode_attn_bound_s(self) -> float:
        """B6's least time over the batch's decode steps: the live K and V
        rows, q and the output, over the HBM peak, every layer."""
        s = self.shapes
        kv_row = 2 * s.kv_heads * s.head_dim * BF16
        qo = 2 * s.heads * s.head_dim * BF16
        live = sum(self.prompt_len + t + 1 for t in range(self.steps))
        nbytes = self.batch * (live * kv_row + self.steps * qo)
        return s.layers * nbytes / PEAK_HBM_BYTES

    def unc_bound_s(self) -> float:
        """B4's least time over the batch's scored steps: the (B, V) fp32
        logits read once and the four fp32 scores a row written, every
        step, over the HBM peak."""
        s = self.shapes
        nbytes = self.steps * self.batch * (s.vocab + 4) * FP32
        return nbytes / PEAK_HBM_BYTES


def batch_work(conf: dict, traffic) -> BatchWork:
    """The work of one batch of a ``traffic.ScoreSweep`` on ``conf``."""
    return BatchWork(Shapes.from_config(conf), traffic.batch,
                     traffic.prompt_len, traffic.scored_steps)
