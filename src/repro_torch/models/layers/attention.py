"""GQA attention: naive, chunked (online softmax in plain PyTorch), the
dispatcher, single-token decode over a KV cache, and single-token decode
over local attention's ring buffer (``decode_attention_pos``) (port of
repro/models/layers/attention.py).

Layouts are the reference's: q (B, Sq, H, D), k and v (B, Skv, KH, D);
query head h reads KV head h // G, G = H / KH. Weights stay 2-D
(d_model, n * head_dim). Every function returns ``q.dtype``. Products
accumulate in fp32 over operands in their storage dtype, as the
reference's ``einsum_f32`` does (bf16 x bf16 products are exact in fp32,
so casting the operands to fp32 first computes the same sums).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.param import ParamDecl
from repro_torch.models.layers.norms import rms_decls, rmsnorm

NEG_INF = -1e30


def attn_decls(d_model: int, n_heads: int, n_kv: int, head_dim: int,
               qkv_bias: bool = False, qk_norm: bool = False,
               out_bias: bool = False):
    decls = {
        "w_q": ParamDecl((d_model, n_heads * head_dim)),
        "w_k": ParamDecl((d_model, n_kv * head_dim)),
        "w_v": ParamDecl((d_model, n_kv * head_dim)),
        "w_o": ParamDecl((n_heads * head_dim, d_model)),
    }
    if qkv_bias:
        decls["b_q"] = ParamDecl((n_heads * head_dim,), init="zeros")
        decls["b_k"] = ParamDecl((n_kv * head_dim,), init="zeros")
        decls["b_v"] = ParamDecl((n_kv * head_dim,), init="zeros")
    if out_bias:
        decls["b_o"] = ParamDecl((d_model,), init="zeros")
    if qk_norm:
        decls["q_norm"] = rms_decls(head_dim)
        decls["k_norm"] = rms_decls(head_dim)
    return decls


def project_qkv(params, x, n_heads: int, n_kv: int, head_dim: int,
                qk_norm: bool, norm_eps: float = 1e-6):
    """x: (B,S,d) -> q (B,S,H,D), k,v (B,S,KH,D). No rope here; qk_norm is
    an RMSNorm over head_dim after the reshape."""
    B, S, _ = x.shape
    q, k, v = x @ params["w_q"], x @ params["w_k"], x @ params["w_v"]
    if "b_q" in params:
        q, k, v = q + params["b_q"], k + params["b_k"], v + params["b_v"]
    q = q.reshape(B, S, n_heads, head_dim)
    k = k.reshape(B, S, n_kv, head_dim)
    v = v.reshape(B, S, n_kv, head_dim)
    if qk_norm:
        q = rmsnorm(params["q_norm"], q, norm_eps)
        k = rmsnorm(params["k_norm"], k, norm_eps)
    return q, k, v


def _mask(q_pos, k_pos, *, causal: bool, window: Optional[int], kv_valid):
    """(qc, kc) boolean mask of *allowed* positions."""
    qp = q_pos[:, None]
    kp = k_pos[None, :]
    m = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= kp <= qp
    if window is not None:
        m &= kp > qp - window
    if kv_valid is not None:
        m &= kp < kv_valid
    return m


def naive_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0,
                    kv_valid=None, scale: Optional[float] = None):
    """Oracle path: the full (Sq, Skv) score matrix."""
    B, Sq, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Sq, KH, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    m = _mask(q_pos, k_pos, causal=causal, window=window, kv_valid=kv_valid)
    s = torch.where(m, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None, q_offset: int = 0,
                      kv_valid=None, q_chunk: int = 512, kv_chunk: int = 1024,
                      scale: Optional[float] = None):
    """Flash-style attention in plain PyTorch: a loop over query chunks,
    an inner loop over KV chunks with the online-softmax carry (m, l, acc).
    Peak memory per step: the (B, KH, G, qc, kc) fp32 score tile."""
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = scale if scale is not None else D ** -0.5
    qc = min(q_chunk, Sq)
    kc = min(kv_chunk, Skv)
    nq, nk = -(-Sq // qc), -(-Skv // kc)
    pad_q, pad_k = nq * qc - Sq, nk * kc - Skv
    qg = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q)).reshape(
        B, nq, qc, KH, G, D)
    kb = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k)).reshape(
        B, nk, kc, KH, D)
    vb = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k)).reshape(
        B, nk, kc, KH, D)
    valid = Skv if kv_valid is None else kv_valid
    dev = q.device
    outs = []
    for qi in range(nq):
        qch = qg[:, qi]                                  # (B,qc,KH,G,D)
        q_pos = q_offset + qi * qc + torch.arange(qc, device=dev)
        m = torch.full((B, KH, G, qc), NEG_INF, device=dev)
        l = torch.zeros((B, KH, G, qc), device=dev)
        acc = torch.zeros((B, KH, G, qc, D), device=dev)
        for ki in range(nk):
            k_pos = ki * kc + torch.arange(kc, device=dev)
            s = torch.einsum("bqkgd,bskd->bkgqs", qch.float(),
                             kb[:, ki].float()) * scale
            s = torch.where(_mask(q_pos, k_pos, causal=causal, window=window,
                                  kv_valid=valid), s, NEG_INF)
            m_cur = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_cur[..., None])
            corr = torch.exp(m - m_cur)
            l = l * corr + torch.sum(p, dim=-1)
            # p rounded to the V dtype before its product, as the reference
            pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(vb.dtype).float(),
                              vb[:, ki].float())
            acc = acc * corr[..., None] + pv
            m = m_cur
        out = acc / torch.clamp_min(l, 1e-30)[..., None]    # (B,KH,G,qc,D)
        outs.append(out.permute(0, 3, 1, 2, 4))             # (B,qc,KH,G,D)
    out = torch.cat(outs, dim=1).reshape(B, nq * qc, H, D)[:, :Sq]
    return out.to(q.dtype)


def decode_attention(q, k_cache, v_cache, cur_len, *,
                     window: Optional[int] = None,
                     scale: Optional[float] = None):
    """Single-step decode. q: (B,1,H,D); caches: (B,Smax,KH,D).

    cur_len: int or 0-d int tensor (on the caches' device: no host sync)
    -- the number of valid cache entries *including* the current token
    (already written into the cache). q is rounded to the cache dtype and
    the probabilities to the V dtype before their products, as in the
    reference.
    """
    B, _, H, D = q.shape
    KH = k_cache.shape[2]
    G = H // KH
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, KH, G, D).to(k_cache.dtype)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) * scale
    k_pos = torch.arange(k_cache.shape[1], device=q.device)
    ok = k_pos < cur_len
    if window is not None:
        ok &= k_pos > cur_len - 1 - window
    s = torch.where(ok[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, H, D).to(q.dtype)


def decode_attention_pos(q, k_cache, v_cache, k_pos, cur_pos,
                         window: Optional[int] = None,
                         scale: Optional[float] = None):
    """Decode over a ring buffer with explicit key positions.

    q: (B,1,H,D); caches: (B,W,KH,D); k_pos: (W,) int32, -1 = empty slot;
    cur_pos: 0-d int tensor (the current token's position, on the caches'
    device: no host sync). Plain torch, as the reference computes it (its
    local decode is jnp, not a kernel): q rounded to the cache dtype and the
    probabilities to the V dtype before their products.
    """
    B, _, H, D = q.shape
    KH = k_cache.shape[2]
    G = H // KH
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, KH, G, D).to(k_cache.dtype)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) * scale
    ok = (k_pos >= 0) & (k_pos <= cur_pos)
    if window is not None:
        ok &= k_pos > cur_pos - window
    s = torch.where(ok[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, H, D).to(q.dtype)


def attention(q, k, v, *, impl: str = "chunked", **kw):
    """``impl``: "naive", "chunked", or "pallas" (the configs' name for the
    flash kernel: the CUDA kernel on a CUDA tensor, the chunked path on a
    CPU tensor; ``kernels/flash_attention/ops.py``). The kernel has no
    backward: "pallas" on a CUDA tensor that requires grad raises."""
    if impl == "naive":
        kw.pop("q_chunk", None)
        kw.pop("kv_chunk", None)
        return naive_attention(q, k, v, **kw)
    if impl == "pallas":
        if q.is_cuda and torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            raise RuntimeError(
                "attention_impl='pallas' on a CUDA tensor that requires "
                "grad: the flash-attention kernel has no backward (the "
                "reference trains through 'chunked' attention)")
        from repro_torch.kernels.flash_attention import ops as fa_ops
        return fa_ops.flash_attention_auto(q, k, v, **kw)
    if impl != "chunked":
        raise ValueError(f"unknown attention impl {impl!r}")
    kw.setdefault("q_chunk", 512)
    kw.setdefault("kv_chunk", 1024)
    return chunked_attention(q, k, v, **kw)
