"""Multi-head Latent Attention, deepseek-v3 (port of
repro/models/layers/mla.py).

Train and prefill expand the compressed latents into full per-head K/V
(QK head dim ``qk_nope + qk_rope``, 192 at full size) and run the generic
attention, V padded up to the QK head dim and the output cut back to
``v_head_dim``. Decode is the *absorbed* form: ``W_UK`` is folded into
the query, and scores and outputs are computed against the (B, S,
kv_lora_rank) latent cache and the (B, S, qk_rope) rope cache, which
hold no head axis; that is the KV-cache compression that makes MLA
serving cheap. The rope key is one shared ``qk_rope``-wide vector a
position, rotated before it is broadcast over the heads.

Products accumulate as the reference's: its plain ``jnp.einsum`` is a
product in the operands' dtype here (``@``), and its ``einsum_f32`` casts
the operands to fp32 first (bf16 x bf16 products are exact in fp32, so
that computes the same sums, with TF32 off). Decode rounds where the
reference rounds: the absorbed query to the cache dtype before the
score product, the probabilities to the cache dtype before the latent
product, ``w_uv`` taken in fp32 and the result cast to ``x.dtype``
before ``w_o``. No Pallas kernel runs here in the reference, and no
kernel runs here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common.dots import einsum_f32
from repro_torch.common.param import ParamDecl
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import partition
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers.norms import rms_decls, rmsnorm
from repro_torch.models.layers.rope import apply_rope


def mla_decls(cfg: ArchConfig):
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "w_dq": ParamDecl((d, m.q_lora_rank), ("embed", "lora")),
        "q_norm": rms_decls(m.q_lora_rank),
        "w_uq": ParamDecl((m.q_lora_rank, H * qk), ("lora", "qkv")),
        "w_dkv": ParamDecl((d, m.kv_lora_rank + m.qk_rope_head_dim),
                           ("embed", "lora")),
        "kv_norm": rms_decls(m.kv_lora_rank),
        "w_uk": ParamDecl((m.kv_lora_rank, H * m.qk_nope_head_dim),
                          ("lora", "qkv")),
        "w_uv": ParamDecl((m.kv_lora_rank, H * m.v_head_dim),
                          ("lora", "qkv")),
        "w_o": ParamDecl((H * m.v_head_dim, d), ("qkv", "embed")),
    }


def latents(params, x, cfg: ArchConfig, positions):
    """x: (B,S,d) -> q_nope (B,S,H,nope), q_rope (B,S,H,rope) rotated,
    c_kv (B,S,R) after its RMSNorm, k_rope (B,S,rope) rotated (no head
    axis: rope's 3-D branch)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    cq = rmsnorm(params["q_norm"],
                 partition.ac(x @ params["w_dq"], "batch", None, None),
                 cfg.norm_eps)
    q = partition.split_heads(cq @ params["w_uq"], H, qk)
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    dkv = partition.ac(x @ params["w_dkv"], "batch", None, None)
    c_kv = rmsnorm(params["kv_norm"], dkv[..., :m.kv_lora_rank],
                   cfg.norm_eps)
    k_rope = apply_rope(dkv[..., m.kv_lora_rank:], positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def mla_prefill(params, x, cfg: ArchConfig, positions, impl: str = "chunked"):
    """Causal MLA over the whole sequence, ``impl`` "chunked" or "naive".
    Returns (out (B,S,d), (c_kv, k_rope)): the latter is the compressed
    cache of these positions."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope, c_kv, k_rope = latents(params, x, cfg, positions)
    k_nope = partition.split_heads(c_kv @ params["w_uk"], H,
                                   m.qk_nope_head_dim)
    v = partition.split_heads(c_kv @ params["w_uv"], H, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.qk_rope_head_dim)], dim=-1)
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    # V padded up to the QK head dim so that the generic attention applies
    v_p = F.pad(v, (0, qk - m.v_head_dim)) if m.v_head_dim != qk else v
    kw = dict(causal=True, scale=qk ** -0.5)
    if impl == "chunked":
        kw.update(q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    o = partition.heads_local(
        lambda q, k, v: attn_lib.attention(q, k, v, impl=impl, **kw),
        q, k, v_p)[..., :m.v_head_dim]
    return o.reshape(B, S, -1) @ params["w_o"], (c_kv, k_rope)


def mla_decode(params, x, cfg: ArchConfig, c_kv_cache, k_rope_cache, cur_len,
               positions, lat=None):
    """Absorbed decode. x: (B,1,d); c_kv_cache: (B,Smax,R); k_rope_cache:
    (B,Smax,rope), both already holding the current token at position
    cur_len - 1. ``cur_len``: an int or a 0-d int tensor on the caches'
    device (the mask is built there: no host sync). ``lat``: this token's
    ``latents``, where the caller has them."""
    m = cfg.mla
    B = x.shape[0]
    H, R = cfg.n_heads, m.kv_lora_rank
    cdt = c_kv_cache.dtype
    if lat is None:
        lat = latents(params, x, cfg, positions)
    q_nope, q_rope = lat[:2]
    # absorb W_UK into the query: q_lat = q_nope @ W_UK^T  (B,1,H,R)
    w_uk = params["w_uk"].reshape(R, H, m.qk_nope_head_dim)
    q_lat = einsum_f32("bqhd,rhd->bqhr", q_nope, w_uk)
    ckv = c_kv_cache.float()
    s = torch.einsum("bqhr,bsr->bhqs", q_lat.to(cdt).float(), ckv)
    s = s + einsum_f32("bqhd,bsd->bhqs", q_rope, k_rope_cache)
    s = s * ((m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5)
    ok = torch.arange(c_kv_cache.shape[1], device=s.device) < cur_len
    s = torch.where(ok[None, None, None, :], s, attn_lib.NEG_INF)
    p = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhqs,bsr->bqhr", p.to(cdt).float(), ckv)
    w_uv = params["w_uv"].reshape(R, H, m.v_head_dim)
    o = torch.einsum("bqhr,rhd->bqhd", o_lat, w_uv.float())
    return o.reshape(B, 1, H * m.v_head_dim).to(x.dtype) @ params["w_o"]
