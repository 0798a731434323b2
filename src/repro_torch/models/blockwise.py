"""Blockwise-chunked transformer encoder for ingest embedding (port of
repro/models/blockwise.py; its layers are the dense (norm1, attn, norm2,
mlp) unit of ``models/transformer.py``).

Per layer, attention runs in tiles of query rows: on a CPU tensor the
chunked online-softmax loop, in tiles of ``block`` rows; on a CUDA tensor
the flash kernel (``kernels/flash_attention``), whose query tile is its
own fixed 64 rows, so there ``block`` has no effect. The forward runs under
``torch.inference_mode()``; ``jax.checkpoint`` has no counterpart in
inference.

Bitwise chunking contract: the block size is invisible in the output
bytes. Inside attention a query row's online-softmax trajectory depends
only on the KV chunk grid, pinned by ``kv_chunk``, never on how query
rows are grouped. Outside attention every op (norms, rope, projections,
the FFN) runs on the whole ``(B, S, d)`` tensor of real rows, whose shape
does not depend on the block: unlike the reference, the port never pads
``S`` up to a multiple of the block nor reshapes rows into blocks, so
cuBLAS and MKL see the same matrix shapes at every block size. Dropping
the padding is exact: pad rows would come after every real row, and
causal masking makes them no-ops for real rows. The FFN alone runs in
chunks of ``ROW_CHUNK`` flattened rows, a fixed count, to bound its
``(rows, d_ff)`` intermediates.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.common.param import ParamDecl, init_params
from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers.mlp import mlp_apply
from repro_torch.models.layers.norms import apply_norm, norm_decls
from repro_torch.models.layers.rope import apply_rope
from repro_torch.models.transformer import layer_decls

# flattened (batch x sequence) rows per FFN matrix product: bounds the
# (rows, d_ff) intermediates; a fixed count, so the shapes never follow
# the block
ROW_CHUNK = 8192


def tiny_encoder_config(vocab: int = 512) -> ArchConfig:
    """CPU-sized GQA encoder used by the service's transformer backend."""
    return ArchConfig(
        name="tiny_blockwise_encoder", family="dense",
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
        vocab=vocab, norm="rms", mlp="swiglu",
        attention_impl="pallas")   # the kernel on the card, chunked on CPU


def encoder_decls(cfg: ArchConfig, input_dim: Optional[int] = None):
    """Token embed (or audio frame projection), ``n_layers`` units and the
    final norm. Layers are a list here, not a stacked axis."""
    decls = {"final_norm": norm_decls(cfg.norm, cfg.d_model),
             "layers": [layer_decls(cfg) for _ in range(cfg.n_layers)]}
    if input_dim:
        decls["frame_proj"] = ParamDecl((input_dim, cfg.d_model),
                                        ("embed", None))
    else:
        decls["embed"] = ParamDecl((cfg.padded_vocab, cfg.d_model),
                                   ("vocab", "embed"), init="embed")
    return decls


def init_encoder(cfg: ArchConfig, seed: int = 11,
                 input_dim: Optional[int] = None, device="cuda"):
    """fp32 parameter tree drawn from a generator on ``device``."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    return init_params(encoder_decls(cfg, input_dim), g, device)


def embed_tokens(cfg: ArchConfig, params, tokens):
    """tokens (B,S) int, -1 = right-padding -> (B,S,d) f32. Row-local."""
    safe = torch.clamp(tokens.long(), 0, cfg.padded_vocab - 1)
    return params["embed"][safe].float()


def embed_frames(params, frames):
    """frames (B,S,F) f32 -> (B,S,d) f32 linear frontend. Row-local."""
    return frames.float() @ params["frame_proj"]


def _rows(fn, x):
    """``fn`` over the flattened rows of x (..., d) in chunks of
    ROW_CHUNK rows."""
    flat = x.reshape(-1, x.shape[-1])
    out = torch.cat([fn(flat[s:s + ROW_CHUNK])
                     for s in range(0, flat.shape[0], ROW_CHUNK)])
    return out.reshape(*x.shape[:-1], out.shape[-1])


def blockwise_encode(cfg: ArchConfig, params, x, *, block: int,
                     kv_chunk: int, impl: Optional[str] = None):
    """x: (B,S,d) embedded inputs -> (B,S,d) final-norm hidden states.

    ``block`` chunks the query axis of the chunked attention path (the
    reference's activation knob; the CUDA kernel keeps its own query
    tile); ``kv_chunk`` pins the online-softmax KV grid and
    must stay fixed across block sizes for the bitwise contract (the
    backend clamps it to the canonical sequence length)."""
    B, S, d = x.shape
    block = max(1, min(block, S))
    positions = torch.arange(S, device=x.device)[None, :]
    impl = impl or cfg.attention_impl
    h = x
    for lp in params["layers"]:
        n1 = apply_norm(cfg.norm, lp["norm1"], h, cfg.norm_eps)
        q, k, v = attn_lib.project_qkv(lp["mixer"], n1, cfg.n_heads,
                                       cfg.n_kv_heads, cfg.hd, cfg.qk_norm,
                                       cfg.norm_eps)
        del n1
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        o = attn_lib.attention(q, k, v, impl=impl, causal=True,
                               q_chunk=block, kv_chunk=kv_chunk)
        del q, k, v
        o = o.reshape(B, S, -1) @ lp["mixer"]["w_o"]
        if "b_o" in lp["mixer"]:
            o = o + lp["mixer"]["b_o"]
        h = h + o
        del o
        h = h + _rows(lambda r: mlp_apply(
            lp["mlp"], apply_norm(cfg.norm, lp["norm2"], r, cfg.norm_eps),
            cfg.mlp), h)
    return apply_norm(cfg.norm, params["final_norm"], h, cfg.norm_eps)


def pool_hidden(h, mask, pooling: str):
    """h (B,S,d), mask (B,S) bool -> (B,d) f32 features. Sample-local."""
    mask = mask.float()
    if pooling == "last":
        idx = torch.clamp_min(mask.sum(-1).long() - 1, 0)
        return torch.gather(
            h, 1, idx[:, None, None].expand(-1, 1, h.shape[-1]))[:, 0].float()
    denom = torch.clamp_min(mask.sum(-1, keepdim=True), 1.0)
    return (torch.sum(h * mask[..., None], dim=1) / denom).float()


def activation_accounting(cfg: ArchConfig, batch: int, seq_len: int,
                          block: int, kv_chunk: int,
                          itemsize: int = 4) -> dict:
    """Analytic per-forward memory split (bytes), the reference's
    arithmetic unchanged: ``peak_activation_bytes`` is the largest
    per-block working set (attention score tile + softmax carry vs. the
    MLP intermediate), flat in ``seq_len`` at a fixed block size;
    ``state_bytes`` the O(S) residual stream + per-layer K/V;
    ``unchunked_peak_bytes`` the same at block = kv_chunk = the padded
    sequence."""
    B = batch
    nb = -(-seq_len // max(block, 1))
    Sp = nb * max(block, 1)
    qc = min(block, Sp)
    kc = min(kv_chunk, Sp)
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // KH
    ff_mult = 2 if cfg.mlp == "swiglu" else 1

    def _peak(qc_, kc_):
        scores = B * KH * G * qc_ * kc_          # (B,KH,G,qc,kc) f32 tile
        carry = B * KH * G * qc_ * (2 + D)       # online-softmax m,l,acc
        q_tile = B * qc_ * H * D
        attn_tile = scores + carry + q_tile
        mlp_tile = B * qc_ * (ff_mult * cfg.d_ff + 2 * cfg.d_model)
        return max(attn_tile, mlp_tile) * itemsize

    residual = B * Sp * cfg.d_model * itemsize
    kv_state = 2 * B * Sp * KH * D * itemsize
    return {
        "peak_activation_bytes": _peak(qc, kc),
        "state_bytes": residual + kv_state,
        "unchunked_peak_bytes": _peak(Sp, Sp),
        "blocks": nb,
        "block": qc,
        "kv_chunk": kc,
    }


def _freeze(tree, module: nn.Module, prefix: str):
    """Register every tensor of ``tree`` on ``module`` as a frozen
    parameter, in place (the tree then holds the parameters)."""
    items = enumerate(tree) if isinstance(tree, list) else list(tree.items())
    for key, val in items:
        name = f"{prefix}_{key}" if prefix else str(key)
        if isinstance(val, torch.Tensor):
            p = nn.Parameter(val, requires_grad=False)
            module.register_parameter(name, p)
            tree[key] = p
        else:
            _freeze(val, module, name)


class BlockwiseEncoder(nn.Module):
    """The frozen encoder: embed (tokens) or frame projection (audio),
    ``blockwise_encode`` and pooling. ``params`` is the reference's tree
    with the layer axis unstacked into a list (what ``bridge.load_encoder``
    writes into)."""

    def __init__(self, cfg: ArchConfig, seed: int = 11,
                 input_dim: Optional[int] = None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.params = init_encoder(cfg, seed, input_dim, device)
        _freeze(self.params, self, "")

    @torch.inference_mode()
    def forward(self, batch, *, block: int, kv_chunk: int, impl: str,
                pooling: str):
        """batch: (B,S) int tokens (-1 = pad) or (B,S,F) f32 frames ->
        (B,d) f32 features."""
        if "embed" in self.params:
            x = embed_tokens(self.cfg, self.params, batch)
            mask = batch >= 0
        else:
            x = embed_frames(self.params, batch)
            mask = torch.ones(batch.shape[:2], dtype=torch.bool,
                              device=batch.device)
        h = blockwise_encode(self.cfg, self.params, x, block=block,
                             kv_chunk=kv_chunk, impl=impl)
        return pool_hidden(h, mask, pooling)
