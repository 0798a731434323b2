# Copied from repro/configs/phi3_medium_14b.py; imports renamed.
"""phi3-medium-14b — dense, RoPE+SwiGLU+GQA. [arXiv:2404.14219; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab=100352,
    rope_theta=10000.0,
)


def smoke_config() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="phi3-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256, q_chunk=16, kv_chunk=16,
    )
