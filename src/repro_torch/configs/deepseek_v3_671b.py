# Copied from repro/configs/deepseek_v3_671b.py; imports renamed.
"""deepseek-v3-671b — MLA + 1 shared + 256 routed top-8 + MTP.
[arXiv:2412.19437; hf]
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,               # dense-layer FFN (first 3 layers)
    vocab=129280,
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_routed=256,
        top_k=8,
        d_ff_expert=2048,
        n_shared=1,
        first_dense=3,
        capacity_factor=1.25,
    ),
    mtp=True,
)


def smoke_config() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="dsv3-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256, q_chunk=16, kv_chunk=16,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        moe=dataclasses.replace(CONFIG.moe, n_routed=8, top_k=2, d_ff_expert=32,
                                n_shared=1, first_dense=1, group_size=64),
    )
