"""DeepSeekMoE: leading dense layers, then fine-grained MoE layers (a
softmax router over the routed experts, top-k, plus shared experts) with
MHA, rope, RMSNorm and SwiGLU."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, MoEConfig

from bench.archs import decoder_fields
from bench.work import batch_work  # noqa: F401  (the GQA / MHA count)

REFERENCE = "transformer"
SPREAD_LEAVES = ("w_q", "w_k")
KERNEL_CHECKS = ("flash", "decode_attn")


def port_config(conf: dict) -> ArchConfig:
    name = conf["name"]
    if conf.get("scoring_func", "softmax") != "softmax":
        raise ValueError(f"{name}: the port's router is a softmax")
    if conf.get("moe_layer_freq", 1) != 1 or conf.get("attention_bias"):
        raise ValueError(f"{name}: the port puts a MoE in every layer after "
                         f"the dense ones, and no attention bias")
    if not conf.get("norm_topk_prob", False):
        raise ValueError(f"{name}: the port always normalises the top-k "
                         f"weights by their sum")
    assumed = conf["assumed"]
    moe = MoEConfig(n_routed=conf["n_routed_experts"],
                    top_k=conf["num_experts_per_tok"],
                    d_ff_expert=conf["moe_intermediate_size"],
                    n_shared=conf.get("n_shared_experts", 0),
                    first_dense=conf.get("first_k_dense_replace", 0),
                    capacity_factor=float(assumed["capacity_factor"]),
                    group_size=int(assumed["group_size"]))
    return ArchConfig(family="moe", moe=moe, **decoder_fields(conf))
