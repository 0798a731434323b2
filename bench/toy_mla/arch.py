"""A toy architecture for the benchmark's CPU tests, which add it to a copy
of the layout as new files only (``testing.add_toy_arch``): this module
as ``bench/archs/toy_mla.py``, ``reference.py`` beside it as
``bench/reference/toy_mla.py``, ``config.json`` and ``limits.json``. A
dense stack of multi-head latent attention (the port's ``mla`` mixer,
deepseek-v3's attention) with SwiGLU MLPs. Its prefill runs the port's
chunked attention and each step the absorbed form over the latent cache,
so its path calls neither B3 nor B6 and it has no kernel numbers."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, MLAConfig

from bench.archs import decoder_fields

REFERENCE = "toy_mla"
SPREAD_LEAVES = ("w_uq", "w_uk")
KERNEL_CHECKS = ()


def port_config(conf: dict) -> ArchConfig:
    mla = MLAConfig(q_lora_rank=conf["q_lora_rank"],
                    kv_lora_rank=conf["kv_lora_rank"],
                    qk_nope_head_dim=conf["qk_nope_head_dim"],
                    qk_rope_head_dim=conf["qk_rope_head_dim"],
                    v_head_dim=conf["v_head_dim"])
    return ArchConfig(family="dense", mla=mla, **decoder_fields(conf))


class Work:
    """One batch's tokens and model FLOPs: 2 per matmul parameter and
    token (the LM head where logits are made), plus the causal
    attention's 2 * (qk + v) a (query head, key) pair a layer."""

    def __init__(self, tokens: int, flops: float):
        self.tokens = tokens
        self._flops = flops

    def model_flops(self) -> float:
        return self._flops


def batch_work(conf: dict, traffic) -> Work:
    d, H, L = (conf["hidden_size"], conf["num_attention_heads"],
               conf["num_hidden_layers"])
    nope, rope, dv = (conf["qk_nope_head_dim"], conf["qk_rope_head_dim"],
                      conf["v_head_dim"])
    rq, rkv = conf["q_lora_rank"], conf["kv_lora_rank"]
    attn = (d * rq + rq * H * (nope + rope) + d * (rkv + rope)
            + rkv * H * (nope + dv) + H * dv * d)
    mlp = 3 * d * conf["intermediate_size"]
    B, T = traffic.batch, traffic.positions
    pairs = T * (T + 1) // 2
    flops = (2 * L * (attn + mlp) * B * T
             + 2 * d * conf["vocab_size"] * B * (1 + traffic.scored_steps)
             + 2 * (nope + rope + dv) * H * L * B * pairs)
    return Work(B * T, float(flops))
