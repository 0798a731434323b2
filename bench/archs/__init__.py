"""One module a ``model_type`` of the configuration files, the one place
that holds what is particular to an architecture. The harness finds it
by the configuration's ``model_type`` (``harness.Layout.arch``), so a new
architecture comes as new files: this module, and where no reference
here computes it, its plain reference under ``bench/reference/``. It
declares:

- ``port_config(conf)``: the configuration file as the port's
  ``ArchConfig``, as the file states it, with the kernels on
  (``attention_impl="pallas"``); it refuses what the port cannot run as
  stated;
- ``REFERENCE``: the name of its plain float32 reference,
  ``bench/reference/<REFERENCE>.py``, which has ``forward(conf, params,
  tokens, prompt_len, *, precision, routing)`` and ``Routing`` (for a
  MoE, ``capacity`` and ``slots`` too, which the route faults use), and
  imports nothing of the port;
- ``batch_work(conf, traffic)``: the work of one batch, counted from the
  file's published shapes whatever implements them: ``tokens``,
  ``model_flops()`` and the least time of each kernel the cell's path
  runs (``flash_bound_s()``, ``decode_attn_bound_s()``,
  ``unc_bound_s()``), which the metric readers take;
- ``SPREAD_LEAVES``: the names of the weights that make the attention's
  queries and keys, which carry sqrt(``qk_logit_std``) (``weights.make``);
- ``KERNEL_CHECKS``: the kernel numbers its path can give
  (``compare.kernels``: ``flash`` where the prefill calls B3,
  ``decode_attn`` where each step calls B6); a cell's limits file names
  them with the numbers every cell has, and the attention tape keeps
  what those need.

``decoder_fields`` holds what the decoder-only stacks share."""
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
