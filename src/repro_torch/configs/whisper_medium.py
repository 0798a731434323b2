# Copied from repro/configs/whisper_medium.py; imports renamed.
"""whisper-medium — enc-dec audio; conv frontend stubbed. [arXiv:2212.04356]

``input_specs`` supplies precomputed frame embeddings (B, 1500, d); the
transformer backbone (24 enc + 24 dec layers, d=1024, 16H, LN+GELU) is what
this repo exercises.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    norm="ln",
    mlp="gelu",
    norm_eps=1e-5,
    enc_dec=True,
    n_enc_layers=24,
    n_enc_frames=1500,
    rope_theta=10000.0,   # backbone uses RoPE in this repro (see DESIGN.md)
)


def smoke_config() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="whisper-smoke", n_layers=2, n_enc_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, n_enc_frames=24,
        q_chunk=16, kv_chunk=16,
    )
