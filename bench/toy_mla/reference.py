"""The plain float32 reference of the toy MLA stack (``arch.py``), for the
benchmark's CPU tests: per layer RMSNorm; multi-head latent attention,
``c_q = rmsnorm(x @ w_dq)``, ``q = c_q @ w_uq`` a head, its last
``qk_rope_head_dim`` dims rotated; ``c_kv = rmsnorm((x @ w_dkv)[:,
:kv_lora_rank])`` and the rest of ``x @ w_dkv`` one rotated key shared by
every head; ``k = [c_kv @ w_uk | that key]``, ``v = c_kv @ w_uv`` a
head; causal softmax at ``(qk_nope_head_dim + qk_rope_head_dim) **
-0.5``; ``@ w_o``; residual; RMSNorm, SwiGLU, residual; then the final
RMSNorm and the LM head over the published vocabulary. The expanded form,
whatever form the program decodes in."""
from __future__ import annotations

import torch

from bench.reference.transformer import (Products, Routing,  # noqa: F401
                                         attention, exact_fp32, layers,
                                         rmsnorm, rope, swiglu)


@torch.no_grad()
def forward(conf: dict, params, tokens: torch.Tensor, prompt_len: int, *,
            precision: str = "fp32", routing: Routing = None,
            q_block: int = 512, row_block: int = 8192) -> torch.Tensor:
    """tokens (B, T) -> float32 logits (B, T - prompt_len + 1, V) at
    positions prompt_len - 1 .. T - 1."""
    pr = Products(precision)
    B, T = tokens.shape
    V, d = conf["vocab_size"], conf["hidden_size"]
    H, R = conf["num_attention_heads"], conf["kv_lora_rank"]
    nope, rp, dv = (conf["qk_nope_head_dim"], conf["qk_rope_head_dim"],
                    conf["v_head_dim"])
    eps, theta = conf["rms_norm_eps"], float(conf["rope_theta"])
    with exact_fp32():
        x = params["embed"][tokens.long()].float()           # (B, T, d)
        for lp in layers(params):
            a = lp["mixer"]
            h = rmsnorm(x, lp["norm1"]["scale"], eps)
            cq = rmsnorm(pr.mm(h, a["w_dq"]), a["q_norm"]["scale"], eps)
            q = pr.mm(cq, a["w_uq"]).view(B, T, H, nope + rp)
            q = torch.cat([q[..., :nope], rope(q[..., nope:], theta)], -1)
            dkv = pr.mm(h, a["w_dkv"])
            ckv = rmsnorm(dkv[..., :R], a["kv_norm"]["scale"], eps)
            kr = rope(dkv[..., R:].reshape(B, T, 1, rp), theta)
            k = torch.cat([pr.mm(ckv, a["w_uk"]).view(B, T, H, nope),
                           kr.expand(B, T, H, rp)], -1)
            v = pr.mm(ckv, a["w_uv"]).view(B, T, H, dv)
            o = attention(pr, q, k, v, q_block, scale=(nope + rp) ** -0.5)
            x += pr.mm(o, a["w_o"])
            m = lp["mlp"]
            h = rmsnorm(x, lp["norm2"]["scale"], eps).view(B * T, d)
            x += swiglu(pr, h, m["w_in"], m["w_gate"], m["w_out"],
                        row_block).view(B, T, d)
        h = rmsnorm(x[:, prompt_len - 1:], params["final_norm"]["scale"],
                    eps)
        return pr.mm(h, params["lm_head"][:, :V])
