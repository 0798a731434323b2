# Copied from repro/configs/llava_next_34b.py; imports renamed.
"""llava-next-34b — VLM backbone; anyres patch frontend stubbed.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

``input_specs`` supplies precomputed patch embeddings (B, n_patches, d)
spliced over the sequence prefix (anyres tiling stub).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    rope_theta=5000000.0,
    n_patches=2880,           # anyres: base + 4 tiles x 576
)


def smoke_config() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="llava-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256, n_patches=8, q_chunk=16, kv_chunk=16,
    )
