# Copied from repro/configs/deepseek_moe_16b.py; imports renamed.
"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed top-6.
[arXiv:2401.06066; hf]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,               # dense-layer FFN (layer 0)
    vocab=102400,
    moe=MoEConfig(
        n_routed=64,
        top_k=6,
        d_ff_expert=1408,
        n_shared=2,
        first_dense=1,
        capacity_factor=1.25,
    ),
)


def smoke_config() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="dsmoe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256, q_chunk=16, kv_chunk=16,
        moe=dataclasses.replace(CONFIG.moe, n_routed=8, top_k=2, d_ff_expert=32,
                                n_shared=1, first_dense=1, group_size=64),
    )
