"""Serving entry point: batched decode with first-class AL scoring (port of
repro/launch/serve.py).

Runs prefill + N decode steps for a batch of synthetic prompts and computes
fused uncertainty scores from every step's logits (the paper's technique,
uncertainty scoring, in the serving path itself), so an AL sweep over a
pool is just "serve the pool, keep the scores".

``--arch`` names a ported config by module name or canonical id:
``rwkv6_3b`` (RWKV6, the default, as the reference's), ``qwen3_8b``,
``internlm2_20b``, ``phi3_medium_14b``, ``qwen15_4b`` (the dense stack),
``deepseek_moe_16b`` (token-choice MoE), ``deepseek_v3_671b`` (MLA with
a 256-expert MoE; at full size one card holds it only with its depth
cut, which ``run_serving`` takes as a config), ``recurrentgemma_2b`` (RG-LRU
with local attention and the logit soft cap), ``whisper_medium``
(encoder-decoder over stub frame embeddings) or ``llava_next_34b`` (stub
patch embeddings spliced over the prompt's prefix); ``--full`` serves its
full-size config, else its smoke config. As the reference's, the
frontends are fed zeros: ``n_enc_frames`` zero frames, and
min(n_patches, prompt_len) zero patch embeddings, in bf16.

On the card every kernel of the path runs: flash attention in the
prefill of every attention layer (global or local), of every encoder
layer and of every cross-attention layer, decode attention in every
global attention layer and every cross-attention layer of every step, and
the uncertainty-stats pass over every step's logits (rwkv6-3b has no
attention, and deepseek-v3's MLA runs no attention kernel, so both run
the last alone; recurrentgemma-2b's local decode is plain torch, as the
reference's). Scores and tokens stay on the device
until the loop ends; the only host syncs are the timers'.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen15_4b \\
      --batch 4 --prompt-len 32 --decode-steps 16 [--device cpu] [--full]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Union

import torch

from repro_torch.configs import ArchConfig, get_config, get_smoke_config
from repro_torch.data.synthetic import lm_pool
from repro_torch.kernels.uncertainty import ops as unc_ops
from repro_torch.models.transformer import Model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def serve_steps(model: Model, params, cache, logits, steps: int, feed=None):
    """``steps`` decode steps after a prefill whose last logits are
    ``logits``. Each step's token is the greedy argmax of the previous
    logits, or, with ``feed`` ((steps, B) ints: teacher forcing, a replay),
    ``feed[t]``. Returns (scores (4, steps, B) fp32 = lc/mc/rc/es of every
    step's logits, fed tokens (steps, B) int32), both on the device; the
    cache is updated in place."""
    hist, fed = [], []
    for t in range(steps):
        tok = (torch.argmax(logits, -1).to(torch.int32) if feed is None
               else feed[t].to(device=logits.device, dtype=torch.int32))
        fed.append(tok)
        logits, cache = model.decode_step(params, cache, tok[:, None])
        # the paper's technique in the serving path: fused scores per step
        hist.append(unc_ops.uncertainty_stats(logits))
    scores = torch.stack([torch.stack([s[k] for k in unc_ops.KINDS])
                          for s in hist], 1)
    return scores, torch.stack(fed)


def run_serving(arch: Union[str, ArchConfig] = "rwkv6-3b", *,
                smoke: bool = True,
                batch: int = 4, prompt_len: int = 32, decode_steps: int = 16,
                max_len: int = 128, seed: int = 0, log: bool = True,
                device="cuda", params=None, tokens=None) -> dict:
    """Serve ``batch`` synthetic prompts (``lm_pool`` at ``seed``) for
    ``decode_steps`` steps with ``cfg.attention_impl = "pallas"`` (the
    kernels on a CUDA device, their plain versions on the CPU).

    ``arch``: a registry name (``smoke`` picks its smoke or full config)
    or an ``ArchConfig``, served as given (``smoke`` is then unused): the
    seam for a depth cut, e.g. ``dataclasses.replace(get_config(
    "deepseek_v3_671b"), n_layers=5)``. ``params``: a parameter tree to
    serve (e.g. ``bridge.load_model`` of the reference's weights) instead
    of random weights seeded ``seed``.
    ``tokens``: (decode_steps, batch) tokens to feed instead of the greedy
    argmax (see ``serve_steps``). Returns the reference's dict: ``arch``,
    ``prefill_s``, ``decode_s_per_step``, ``tokens_per_s``, ``mean_lc``,
    ``mean_es``, ``final_len``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; serve on the CPU with "
                           "device='cpu'")
    if prompt_len + decode_steps > max_len:
        raise ValueError(f"prompt_len {prompt_len} + decode_steps "
                         f"{decode_steps} exceed max_len {max_len}")
    if isinstance(arch, ArchConfig):
        cfg = arch
    else:
        cfg = get_smoke_config(arch) if smoke else get_config(arch)
    cfg = dataclasses.replace(cfg, attention_impl="pallas")
    model = Model(cfg)
    if params is None:
        params = model.init(seed, device)
    toks, _ = lm_pool(batch, prompt_len, cfg.vocab, seed=seed)
    batch_in = {"tokens": torch.from_numpy(toks).to(device)}
    if cfg.enc_dec:
        batch_in["frames"] = torch.zeros(
            (batch, cfg.n_enc_frames, cfg.d_model), dtype=torch.bfloat16,
            device=device)
    if cfg.n_patches:
        batch_in["patch_embeds"] = torch.zeros(
            (batch, min(cfg.n_patches, prompt_len), cfg.d_model),
            dtype=torch.bfloat16, device=device)
    cache = model.init_cache(batch, max_len, device)

    _sync(device)
    t0 = time.perf_counter()
    cache, logits = model.prefill(params, batch_in, cache)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    t0 = time.perf_counter()
    scores, _ = serve_steps(model, params, cache, logits, decode_steps,
                            feed=tokens)
    _sync(device)
    t_decode = time.perf_counter() - t0

    out = {
        "arch": cfg.name,
        "prefill_s": t_prefill,
        "decode_s_per_step": t_decode / decode_steps,
        "tokens_per_s": batch * decode_steps / t_decode,
        "mean_lc": float(scores[0].mean()),
        "mean_es": float(scores[3].mean()),
        "final_len": int(cache["len"]),
    }
    if log:
        print({k: (round(v, 5) if isinstance(v, float) else v)
               for k, v in out.items()})
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-3b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run_serving(args.arch, smoke=not args.full, batch=args.batch,
                prompt_len=args.prompt_len, decode_steps=args.decode_steps,
                max_len=args.max_len, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
