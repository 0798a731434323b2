"""One module a ``model_type`` of the configuration files: ``port_config
(conf)`` turns a file into the port's ``ArchConfig`` as the file states
it, with the kernels on (``attention_impl="pallas"``), and refuses what
the port cannot run as stated. ``decoder_fields`` holds what the
decoder-only stacks share."""
from __future__ import annotations


def decoder_fields(conf: dict) -> dict:
    """ArchConfig fields of a decoder-only rms/SwiGLU stack with rope."""
    if conf.get("hidden_act", "silu") != "silu":
        raise ValueError(f"{conf['name']}: the port's SwiGLU is silu-gated, "
                         f"not {conf['hidden_act']!r}")
    if conf.get("tie_word_embeddings", False):
        raise ValueError(f"{conf['name']}: the port's LM head is untied")
    heads = conf["num_attention_heads"]
    return dict(name=conf["name"], n_layers=conf["num_hidden_layers"],
                d_model=conf["hidden_size"], n_heads=heads,
                n_kv_heads=conf.get("num_key_value_heads", heads),
                head_dim=conf.get("head_dim") or 0,
                d_ff=conf["intermediate_size"], vocab=conf["vocab_size"],
                rope_theta=float(conf["rope_theta"]),
                norm_eps=float(conf["rms_norm_eps"]),
                attention_impl="pallas")
