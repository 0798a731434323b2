"""Causal LM: prefill, single-token decode over a KV cache, and the
stateless forward (port of repro/models/transformer.py, its dense and MoE
stacks).

A model is a list of *segments*; each segment is ``count`` repetitions of a
*unit* (a short list of LayerSpecs). A dense config is one segment of
``n_layers`` units of one ``(attn, dense)`` layer: norm1, GQA attention
with rope (and qk_norm, qkv bias), norm2, a SwiGLU or GELU MLP. A MoE
config (``cfg.moe``) is ``first_dense`` ``(attn, dense)`` layers, if any,
then ``n_layers - first_dense`` ``(attn, moe)`` layers, whose MLP is the
token-choice MoE of ``layers/moe.py``. The MLA, RWKV and RG-LRU mixers,
local attention's ring buffer, the encoder-decoder and patch frontends and
the MTP head wait for ROADMAP A12; a config that needs them raises
``NotImplementedError``. ``loss`` and its chunked cross-entropy wait for
A13.

Modes, as in the reference:
  train    full sequence, no cache (``last_logits``, ``embed_pool``)
  oracle   train with naive attention
  prefill  full sequence, fills the KV cache
  decode   one token against the cache

Every mode runs the layers as a Python loop, so there is no scan to
unroll: the decode path is the reference's unrolled, in-place one
(``_decode_layer_inplace``). Weights are a list of units per segment (the
reference's stacked ``layer`` axis unstacked, as ``bridge.load_model``
writes them); the KV cache stays stacked per segment, ``(L, B, S, KH*hd)``
in the cache dtype, and each step writes the new token's K/V in place at
``cur_len``. A segment of one unit keeps its layer axis too, ``(1, B, S,
KH*hd)``, where the reference's has none (``(B, S, KH*hd)``): the two
caches compare only through the outputs. ``cache["len"]`` is a 0-d int32
tensor on the device, so a decode step never syncs with the host.

Attention follows ``cfg.attention_impl``. ``"pallas"``, the configs' name
for the kernel path, sends prefill to the flash-attention kernel and each
decode step to the decode-attention kernel on a CUDA tensor
(``kernels/decode_attention``: the only caller of that kernel); on a CPU
tensor both take their plain versions, the chunked path (``q_chunk``,
``kv_chunk``) and the plain ``decode_attention``, bit for bit the
reference's ``"chunked"`` arithmetic. Any other value sends decode to the
plain ``decode_attention``, as the reference's decode layer does on every
backend.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.common.param import ParamDecl, init_params, with_dtype
from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers import moe as moe_lib
from repro_torch.models.layers.mlp import mlp_apply, mlp_decls
from repro_torch.models.layers.norms import apply_norm, norm_decls
from repro_torch.models.layers.rope import apply_rope

PARAM_DTYPE = torch.bfloat16        # the reference's ParamDecl default


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str          # attn (the only mixer ported)
    mlp: str            # dense | moe


@dataclasses.dataclass(frozen=True)
class Segment:
    count: int
    unit: Tuple[LayerSpec, ...]


def require_ported(cfg: ArchConfig) -> None:
    """Admit the dense and MoE stacks; refuse every other family."""
    if cfg.family == "dense" or (cfg.family == "moe" and cfg.moe is not None):
        return
    raise NotImplementedError(
        f"{cfg.name}: the {cfg.family!r} family (MLA, RWKV, RG-LRU, enc-dec "
        f"or patch frontends, MTP) waits for ROADMAP A12; the port has the "
        f"dense and MoE decode stacks only")


def build_segments(cfg: ArchConfig) -> List[Segment]:
    require_ported(cfg)
    if cfg.moe is not None:
        fd = cfg.moe.first_dense
        segs = [Segment(fd, (LayerSpec("attn", "dense"),))] if fd else []
        return segs + [Segment(cfg.n_layers - fd,
                               (LayerSpec("attn", "moe"),))]
    return [Segment(cfg.n_layers, (LayerSpec("attn", "dense"),))]


# ---------------------------------------------------------------- decls ----

def layer_decls(cfg: ArchConfig, spec: LayerSpec = LayerSpec("attn",
                                                              "dense")):
    """The ``(attn, dense)`` or ``(attn, moe)`` layer of ``_layer_decls``."""
    if spec.mlp == "moe":
        mlp = moe_lib.moe_decls(cfg.d_model, cfg.moe)
    else:
        mlp = mlp_decls(cfg.d_model, cfg.d_ff, cfg.mlp,
                        bias=(cfg.norm == "ln"))
    return {
        "norm1": norm_decls(cfg.norm, cfg.d_model),
        "norm2": norm_decls(cfg.norm, cfg.d_model),
        "mixer": attn_lib.attn_decls(cfg.d_model, cfg.n_heads,
                                     cfg.n_kv_heads, cfg.hd, cfg.qkv_bias,
                                     cfg.qk_norm, out_bias=(cfg.norm == "ln")),
        "mlp": mlp,
    }


def model_decls(cfg: ArchConfig):
    """Embedding, segments (a list of ``count`` units each, a unit being
    ``{"0": layer}``), final norm and the untied LM head; bf16 but for
    the declarations that name their dtype (the MoE router: fp32)."""
    V, d = cfg.padded_vocab, cfg.d_model
    decls: Dict[str, Any] = {
        "embed": ParamDecl((V, d), init="embed"),
        "final_norm": norm_decls(cfg.norm, d),
        "segments": [[{str(i): layer_decls(cfg, spec)
                       for i, spec in enumerate(s.unit)}
                      for _ in range(s.count)]
                     for s in build_segments(cfg)],
        "lm_head": ParamDecl((d, V)),
    }
    return with_dtype(decls, PARAM_DTYPE)


def cache_decls(cfg: ArchConfig, B: int, S: int,
                dtype: torch.dtype = PARAM_DTYPE):
    """``len`` (an int32 scalar) and, per segment and unit position, the
    stacked K and V caches ``(count, B, S, KH*hd)``."""
    F = cfg.n_kv_heads * cfg.hd
    return {"len": ParamDecl((), init="zeros", dtype=torch.int32),
            "segments": [{str(i): {"k": ParamDecl((s.count, B, S, F), "zeros",
                                                  dtype),
                                   "v": ParamDecl((s.count, B, S, F), "zeros",
                                                  dtype)}
                          for i in range(len(s.unit))}
                         for s in build_segments(cfg)]}


# --------------------------------------------------------------- layers ----

def _decode_attend(cfg: ArchConfig, q, k_cache, v_cache, valid):
    if cfg.attention_impl == "pallas":
        from repro_torch.kernels.decode_attention import ops
        return ops.decode_attention_auto(q, k_cache, v_cache, valid)
    return attn_lib.decode_attention(q, k_cache, v_cache, valid)


def _apply_attn(cfg: ArchConfig, params, x, positions, mode, lc=None,
                li: int = 0, cur_len=None, valid=None):
    """The ``attn`` mixer. ``lc`` is the segment's stacked cache
    ``{"k", "v"}``, written in place at layer ``li``: the prompt's K/V in
    prefill (the rest zeroed), the new token's at ``cur_len`` in decode,
    where attention then covers ``valid = cur_len + 1`` entries."""
    B, S, _ = x.shape
    KH, hd = cfg.n_kv_heads, cfg.hd
    q, k, v = attn_lib.project_qkv(params, x, cfg.n_heads, KH, hd,
                                   cfg.qk_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if mode == "decode":
        kc, vc = lc["k"][li], lc["v"][li]               # (B, Sc, KH*hd)
        at = cur_len.reshape(1).long()
        kc.index_copy_(1, at, k.reshape(B, 1, KH * hd).to(kc.dtype))
        vc.index_copy_(1, at, v.reshape(B, 1, KH * hd).to(vc.dtype))
        Sc = kc.shape[1]
        o = _decode_attend(cfg, q, kc.view(B, Sc, KH, hd),
                           vc.view(B, Sc, KH, hd), valid)
    else:
        impl = cfg.attention_impl if mode != "oracle" else "naive"
        o = attn_lib.attention(q, k, v, impl=impl, causal=True, window=None,
                               q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
        if mode == "prefill":
            for buf, t in ((lc["k"][li], k), (lc["v"][li], v)):
                buf[:, :S] = t.reshape(B, S, KH * hd)
                buf[:, S:].zero_()
    out = o.reshape(B, S, -1) @ params["w_o"]
    if "b_o" in params:
        out = out + params["b_o"]
    return out


def _apply_layer(cfg: ArchConfig, spec: LayerSpec, params, x, positions,
                 mode, lc=None, li: int = 0, cur_len=None, valid=None,
                 routes=None):
    if spec.mixer != "attn" or spec.mlp not in ("dense", "moe"):
        raise NotImplementedError(f"layer {spec} waits for ROADMAP A12")
    h = apply_norm(cfg.norm, params["norm1"], x, cfg.norm_eps)
    x = x + _apply_attn(cfg, params["mixer"], h, positions, mode, lc, li,
                        cur_len, valid)
    h2 = apply_norm(cfg.norm, params["norm2"], x, cfg.norm_eps)
    if spec.mlp == "moe":      # serving drops the aux loss, as the reference
        return x + moe_lib.moe_apply(params["mlp"], h2, cfg.moe,
                                     cfg.norm_eps, routes=routes)[0]
    return x + mlp_apply(params["mlp"], h2, cfg.mlp)


def apply_backbone(cfg: ArchConfig, params, x, positions, mode, cache=None,
                   cur_len=None, routes=None):
    """x: (B,S,d) embedded inputs -> (B,S,d) final-norm hidden states.
    In prefill and decode, ``cache`` is written in place. ``routes``: a
    ``moe.RouteTape`` every MoE layer records into or is forced from."""
    valid = cur_len + 1 if mode == "decode" else None
    for si, seg in enumerate(build_segments(cfg)):
        seg_cache = None if cache is None else cache["segments"][si]
        for li, unit in enumerate(params["segments"][si]):
            for i, spec in enumerate(seg.unit):
                lc = None if seg_cache is None else seg_cache[str(i)]
                x = _apply_layer(cfg, spec, unit[str(i)], x, positions, mode,
                                 lc, li, cur_len, valid, routes)
    return apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)


# ----------------------------------------------------------------- model ---

class Model:
    """Functional model facade over a parameter tree (nested dicts and
    lists of tensors). Every method runs under ``torch.inference_mode()``;
    ``prefill`` and ``decode_step`` update the cache in place and return
    it. ``routes``: a ``moe.RouteTape`` that every MoE layer of every
    call records its routes into, or is forced from (tests and the
    card's agreement check only)."""

    def __init__(self, cfg: ArchConfig, *, routes=None):
        require_ported(cfg)
        self.cfg = cfg
        self.routes = routes

    # -- declarations --------------------------------------------------
    def param_decls(self):
        return model_decls(self.cfg)

    def init(self, seed: int = 0, device="cuda"):
        """Random weights from a generator on ``device`` seeded ``seed``,
        each in its declared dtype (bf16, the router fp32)."""
        device = torch.device(device)
        g = torch.Generator(device=device).manual_seed(seed)
        return init_params(self.param_decls(), g, device)

    def cache_decls(self, batch: int, max_len: int,
                    dtype: torch.dtype = PARAM_DTYPE):
        return cache_decls(self.cfg, batch, max_len, dtype)

    def init_cache(self, batch: int, max_len: int, device="cuda",
                   dtype: torch.dtype = PARAM_DTYPE):
        """The zeroed cache of ``cache_decls`` on ``device``."""
        return init_params(self.cache_decls(batch, max_len, dtype), None,
                           torch.device(device))

    # -- embedding / head -----------------------------------------------
    @staticmethod
    def _embed(params, tokens):
        return params["embed"][tokens.long()]

    def _logits(self, params, h):
        """(B,d) hidden -> (B,V) fp32 logits (the product in the weights'
        dtype, then cast, as the reference)."""
        return (h @ params["lm_head"]).float()

    def _forward(self, params, tokens, mode):
        x = self._embed(params, tokens)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        return apply_backbone(self.cfg, params, x, positions, mode,
                              routes=self.routes)

    # -- serving ----------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, params, batch, cache):
        """Fill the cache from a prompt ``batch["tokens"]`` (B,S); returns
        (cache, last-position fp32 logits (B,V))."""
        x = self._embed(params, batch["tokens"])
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        h = apply_backbone(self.cfg, params, x, positions, "prefill",
                           cache=cache, routes=self.routes)
        cache["len"] = torch.full((), S, dtype=torch.int32, device=x.device)
        return cache, self._logits(params, h[:, -1])

    @torch.inference_mode()
    def decode_step(self, params, cache, token):
        """One serving step. token: (B,1) int. Returns (fp32 logits (B,V),
        cache)."""
        cur_len = cache["len"]
        x = self._embed(params, token)
        B = x.shape[0]
        positions = cur_len.reshape(1, 1).expand(B, 1)
        h = apply_backbone(self.cfg, params, x, positions, "decode",
                           cache=cache, cur_len=cur_len, routes=self.routes)
        cache["len"] = cur_len + 1
        return self._logits(params, h[:, 0]), cache

    # -- AL hooks ----------------------------------------------------------
    @torch.inference_mode()
    def embed_pool(self, params, batch):
        """Mean-pooled final hidden state (B,d) over tokens >= 0."""
        tokens = batch["tokens"]
        h = self._forward(params, tokens, "train")
        mask = (tokens >= 0).to(h.dtype)[..., None]
        return torch.sum(h * mask, dim=1) / torch.clamp_min(
            torch.sum(mask, dim=1), 1)

    @torch.inference_mode()
    def last_logits(self, params, batch):
        """Last-position fp32 logits (B,V) of the stateless forward."""
        h = self._forward(params, batch["tokens"], "train")
        return self._logits(params, h[:, -1])
