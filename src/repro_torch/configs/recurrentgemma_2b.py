# Copied from repro/configs/recurrentgemma_2b.py; imports renamed.
"""recurrentgemma-2b — Griffin: RG-LRU + local attention, 1 attn : 2 rec.
[arXiv:2402.19427; hf]

Sub-quadratic: RG-LRU state + 2048-token local window => runs long_500k.
"""
from repro_torch.configs.base import ArchConfig, GriffinConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256000,
    head_dim=256,
    griffin=GriffinConfig(
        lru_width=2560,
        conv_width=4,
        pattern=("rec", "rec", "attn"),
        window=2048,
    ),
    logits_soft_cap=30.0,
    subquadratic=True,
)


def smoke_config() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="rgemma-smoke", n_layers=6, d_model=64, n_heads=4,
        n_kv_heads=1, d_ff=128, vocab=256, head_dim=16, q_chunk=16, kv_chunk=16,
        griffin=GriffinConfig(lru_width=64, conv_width=4,
                              pattern=("rec", "rec", "attn"), window=16),
    )
