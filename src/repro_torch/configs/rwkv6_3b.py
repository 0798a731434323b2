# Copied from repro/configs/rwkv6_3b.py; imports renamed.
"""rwkv6-3b (Finch) — attention-free, data-dependent decay.
[arXiv:2404.05892; hf]

Pure recurrent state => O(1) decode, runs long_500k.
"""
from repro_torch.configs.base import ArchConfig, RWKVConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,               # d_model / rwkv.head_dim
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    norm="ln",
    norm_eps=1e-5,
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32, chunk=64),
    subquadratic=True,
)


def smoke_config() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="rwkv6-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256,
        rwkv=RWKVConfig(head_dim=16, decay_lora=16, mix_lora=8, chunk=16),
    )
