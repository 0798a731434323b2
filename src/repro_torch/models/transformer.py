"""Causal LM: prefill, single-token decode over a cache, and the
stateless forward (port of repro/models/transformer.py, its dense, MoE,
RWKV and Griffin stacks).

A model is a list of *segments*; each segment is ``count`` repetitions of a
*unit* (a short list of LayerSpecs). A dense config is one segment of
``n_layers`` units of one ``(attn, dense)`` layer: norm1, GQA attention
with rope (and qk_norm, qkv bias), norm2, a SwiGLU or GELU MLP. A MoE
config (``cfg.moe``) is ``first_dense`` ``(attn, dense)`` layers, if any,
then ``n_layers - first_dense`` ``(attn, moe)`` layers, whose MLP is the
token-choice MoE of ``layers/moe.py``. An RWKV config (``cfg.rwkv``) is
``n_layers`` units of one ``(rwkv_att, rwkv_ffn)`` layer: RWKV6 time-mix
and channel-mix (``layers/rwkv.py``). A Griffin config (``cfg.griffin``)
repeats its pattern, ``(rec, rec, attn_local)`` for recurrentgemma, and
ends in a one-unit segment of the remainder (``(rec, rec)`` at 26
layers): the RG-LRU block (``layers/rglru.py``) and local attention over
a ring buffer of ``min(window, max_len)`` slots. ``cfg.logits_soft_cap``
caps the fp32 logits as ``tanh(x / cap) * cap``. The MLA mixer, the
encoder-decoder and patch frontends and the MTP head wait for ROADMAP
A12; a config that needs them raises ``NotImplementedError``. ``loss``
and its chunked cross-entropy wait for A13.

Modes, as in the reference:
  train    full sequence, no cache (``last_logits``, ``embed_pool``)
  oracle   train with naive attention
  prefill  full sequence, fills the cache from a zero state
  decode   one token against the cache

Every mode runs the layers as a Python loop, so there is no scan to
unroll: the decode path is the reference's unrolled, in-place one
(``_decode_layer_inplace``). Weights are a list of units per segment (the
reference's stacked ``layer`` axis unstacked, as ``bridge.load_model``
writes them); the cache stays stacked per segment and unit position, a
leading layer axis on every leaf, and each step writes its layer's slice
in place: the new token's K/V at ``cur_len`` (``(L, B, S, KH*hd)``), the
ring's slot ``cur_len % W`` and its position (``pos`` holds position + 1,
0 for an empty slot), the recurrent states. A segment of one unit keeps
its layer axis too, ``(1, ...)``, where the reference's has none: the two
caches compare only through the outputs. K/V, the ring and the conv state
are in the cache dtype; the RWKV state (``x_prev``, ``S``) and the RG-LRU
``h`` are fp32 whatever the cache dtype, ``pos`` int32, as the reference
declares them. ``cache["len"]`` is a 0-d int32 tensor on the device, and
the slot and position writes are device ops (``index_copy_``), so a
decode step never syncs with the host.

Attention follows ``cfg.attention_impl``. ``"pallas"``, the configs' name
for the kernel path, sends prefill (global, or local with the window) to
the flash-attention kernel and each global decode step to the
decode-attention kernel on a CUDA tensor (``kernels/decode_attention``:
the only caller of that kernel); on a CPU tensor both take their plain
versions, the chunked path (``q_chunk``, ``kv_chunk``) and the plain
``decode_attention``, bit for bit the reference's ``"chunked"``
arithmetic. Any other value sends decode to the plain
``decode_attention``, as the reference's decode layer does on every
backend. The local decode over the ring is plain torch
(``decode_attention_pos``) on every device, as the reference's is jnp.
The RWKV and RG-LRU layers have no kernel in the reference and none here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.common.param import ParamDecl, init_params, with_dtype
from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers import moe as moe_lib
from repro_torch.models.layers import rglru as rglru_lib
from repro_torch.models.layers import rwkv as rwkv_lib
from repro_torch.models.layers.mlp import mlp_apply, mlp_decls
from repro_torch.models.layers.norms import apply_norm, norm_decls
from repro_torch.models.layers.rope import apply_rope

PARAM_DTYPE = torch.bfloat16        # the reference's ParamDecl default


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str          # attn | attn_local | rec | rwkv_att
    mlp: str            # dense | moe | rwkv_ffn


@dataclasses.dataclass(frozen=True)
class Segment:
    count: int
    unit: Tuple[LayerSpec, ...]


def require_ported(cfg: ArchConfig) -> None:
    """Admit the dense and MoE stacks, RWKV (``ssm`` with ``cfg.rwkv``) and
    Griffin (``hybrid`` with ``cfg.griffin``); refuse every other family."""
    if (cfg.family == "dense"
            or (cfg.family == "moe" and cfg.moe is not None)
            or (cfg.family == "ssm" and cfg.rwkv is not None)
            or (cfg.family == "hybrid" and cfg.griffin is not None)):
        return
    raise NotImplementedError(
        f"{cfg.name}: the {cfg.family!r} family (MLA, enc-dec or patch "
        f"frontends, MTP, or a family without its sub-config) waits for "
        f"ROADMAP A12; the port has the dense, MoE, RWKV and Griffin stacks")


def build_segments(cfg: ArchConfig) -> List[Segment]:
    require_ported(cfg)
    if cfg.rwkv is not None:
        return [Segment(cfg.n_layers, (LayerSpec("rwkv_att", "rwkv_ffn"),))]
    if cfg.griffin is not None:
        pat = cfg.griffin.pattern
        unit = tuple(LayerSpec("rec" if p == "rec" else "attn_local",
                               "dense") for p in pat)
        full, rem = divmod(cfg.n_layers, len(pat))
        segs = [Segment(full, unit)] if full else []
        if rem:
            segs.append(Segment(1, unit[:rem]))
        return segs
    if cfg.moe is not None:
        fd = cfg.moe.first_dense
        segs = [Segment(fd, (LayerSpec("attn", "dense"),))] if fd else []
        return segs + [Segment(cfg.n_layers - fd,
                               (LayerSpec("attn", "moe"),))]
    return [Segment(cfg.n_layers, (LayerSpec("attn", "dense"),))]


# ---------------------------------------------------------------- decls ----

def _mixer_decls(cfg: ArchConfig, spec: LayerSpec):
    if spec.mixer in ("attn", "attn_local"):
        return attn_lib.attn_decls(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.hd, cfg.qkv_bias, cfg.qk_norm,
                                   out_bias=(cfg.norm == "ln"))
    if spec.mixer == "rec":
        return rglru_lib.rglru_decls(cfg)
    if spec.mixer == "rwkv_att":
        return rwkv_lib.timemix_decls(cfg)
    raise NotImplementedError(f"mixer {spec.mixer!r} waits for ROADMAP A12")


def _mlp_decls(cfg: ArchConfig, spec: LayerSpec):
    if spec.mlp == "dense":
        return mlp_decls(cfg.d_model, cfg.d_ff, cfg.mlp,
                         bias=(cfg.norm == "ln"))
    if spec.mlp == "moe":
        return moe_lib.moe_decls(cfg.d_model, cfg.moe)
    if spec.mlp == "rwkv_ffn":
        return rwkv_lib.chanmix_decls(cfg)
    raise NotImplementedError(f"mlp {spec.mlp!r} waits for ROADMAP A12")


def layer_decls(cfg: ArchConfig, spec: LayerSpec = LayerSpec("attn",
                                                              "dense")):
    """One layer of ``_layer_decls``: two norms, the mixer, the MLP."""
    return {
        "norm1": norm_decls(cfg.norm, cfg.d_model),
        "norm2": norm_decls(cfg.norm, cfg.d_model),
        "mixer": _mixer_decls(cfg, spec),
        "mlp": _mlp_decls(cfg, spec),
    }


def model_decls(cfg: ArchConfig):
    """Embedding, segments (a list of ``count`` units each, a unit being
    ``{"0": layer, ...}``), final norm and the untied LM head; bf16 but for
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


def _layer_cache_decls(cfg: ArchConfig, spec: LayerSpec, count: int, B: int,
                       S: int, dtype: torch.dtype):
    F = cfg.n_kv_heads * cfg.hd
    if spec.mixer == "attn":
        return {"k": ParamDecl((count, B, S, F), "zeros", dtype),
                "v": ParamDecl((count, B, S, F), "zeros", dtype)}
    if spec.mixer == "attn_local":
        W = min(cfg.griffin.window, S)
        return {"k": ParamDecl((count, B, W, F), "zeros", dtype),
                "v": ParamDecl((count, B, W, F), "zeros", dtype),
                "pos": ParamDecl((count, W), "zeros", torch.int32)}
    if spec.mixer == "rec":
        return rglru_lib.rglru_state_decls(cfg, B, count, dtype)
    if spec.mixer == "rwkv_att":
        return rwkv_lib.rwkv_state_decls(cfg, B, count)
    raise NotImplementedError(f"mixer {spec.mixer!r} waits for ROADMAP A12")


def cache_decls(cfg: ArchConfig, B: int, S: int,
                dtype: torch.dtype = PARAM_DTYPE):
    """``len`` (an int32 scalar) and, per segment and unit position, the
    layer's cache with a leading ``count`` axis: K and V ``(count, B, S,
    KH*hd)`` for global attention, the ring for local attention, the
    recurrent state for RG-LRU and RWKV. ``dtype`` is the cache dtype;
    the declarations that name theirs (the fp32 states, int32 ``pos``)
    keep it."""
    return {"len": ParamDecl((), init="zeros", dtype=torch.int32),
            "segments": [{str(i): _layer_cache_decls(cfg, spec, s.count, B,
                                                     S, dtype)
                          for i, spec in enumerate(s.unit)}
                         for s in build_segments(cfg)]}


# --------------------------------------------------------------- layers ----

def _decode_attend(cfg: ArchConfig, q, k_cache, v_cache, valid):
    if cfg.attention_impl == "pallas":
        from repro_torch.kernels.decode_attention import ops
        return ops.decode_attention_auto(q, k_cache, v_cache, valid)
    return attn_lib.decode_attention(q, k_cache, v_cache, valid)


def _apply_attn(cfg: ArchConfig, params, x, positions, mode, lc=None,
                li: int = 0, cur_len=None, valid=None, *, local=False):
    """The ``attn`` and ``attn_local`` mixers. ``lc`` is the segment's
    stacked cache, written in place at layer ``li``. Global attention: the
    prompt's K/V in prefill (the rest zeroed), the new token's at
    ``cur_len`` in decode, where attention then covers ``valid = cur_len
    + 1`` entries. Local attention (window ``cfg.griffin.window``): the
    prompt's last W positions folded into the ring in prefill, the new
    token into slot ``cur_len % W`` with its position in decode."""
    B, S, _ = x.shape
    KH, hd = cfg.n_kv_heads, cfg.hd
    window = cfg.griffin.window if local else None
    q, k, v = attn_lib.project_qkv(params, x, cfg.n_heads, KH, hd,
                                   cfg.qk_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if mode == "decode":
        kc, vc = lc["k"][li], lc["v"][li]               # (B, Sc, KH*hd)
        Sc = kc.shape[1]
        at = (torch.remainder(cur_len, Sc) if local else cur_len)
        at = at.reshape(1).long()
        kc.index_copy_(1, at, k.reshape(B, 1, KH * hd).to(kc.dtype))
        vc.index_copy_(1, at, v.reshape(B, 1, KH * hd).to(vc.dtype))
        if local:
            pos = lc["pos"][li]                         # position + 1
            pos.index_copy_(0, at, (cur_len + 1).reshape(1).to(pos.dtype))
            o = attn_lib.decode_attention_pos(
                q, kc.view(B, Sc, KH, hd), vc.view(B, Sc, KH, hd), pos - 1,
                cur_len, window)
        else:
            o = _decode_attend(cfg, q, kc.view(B, Sc, KH, hd),
                               vc.view(B, Sc, KH, hd), valid)
    else:
        impl = cfg.attention_impl if mode != "oracle" else "naive"
        o = attn_lib.attention(q, k, v, impl=impl, causal=True,
                               window=window, q_chunk=cfg.q_chunk,
                               kv_chunk=cfg.kv_chunk)
        if mode == "prefill":
            kf, vf = k.reshape(B, S, KH * hd), v.reshape(B, S, KH * hd)
            if local:
                (kr, vr), ringpos = _ring_from_seq(kf, vf,
                                                   lc["k"].shape[2])
                lc["k"][li].copy_(kr)
                lc["v"][li].copy_(vr)
                lc["pos"][li].copy_(ringpos)
            else:
                for buf, t in ((lc["k"][li], kf), (lc["v"][li], vf)):
                    buf[:, :S] = t
                    buf[:, S:].zero_()
    out = o.reshape(B, S, -1) @ params["w_o"]
    if "b_o" in params:
        out = out + params["b_o"]
    return out


def _ring_from_seq(kf, vf, W: int):
    """Fold the last W positions of (B,S,F) k/v into ring-buffer layout:
    slot i holds the largest position p <= S-1 with p = i (mod W), or
    nothing (zeros, ``pos`` 0) when S < W leaves it empty. Returns ((k, v)
    (B,W,F), pos (W,) int32 = position + 1)."""
    B, S, F = kf.shape
    i = torch.arange(W, device=kf.device)
    p = i + torch.div(S - 1 - i, W, rounding_mode="floor") * W
    valid = p >= 0
    pc = torch.clamp(p, 0, S - 1)
    kr = torch.where(valid[None, :, None], kf[:, pc], 0)
    vr = torch.where(valid[None, :, None], vf[:, pc], 0)
    pos = torch.where(valid, p + 1, 0).to(torch.int32)
    return (kr, vr), pos


def _stateful(apply, x, mode, lc, li: int):
    """A recurrent block ``apply(x, state) -> (out, new_state)``: in decode
    from layer ``li``'s slice of the stacked state ``lc``, else from a zero
    state (the reference's prefill and train); in prefill and decode the
    new state is written back into that slice in place."""
    state = ({k: t[li] for k, t in lc.items()} if mode == "decode"
             else None)
    out, new = apply(x, state)
    if mode in ("prefill", "decode"):
        for k, t in new.items():
            lc[k][li].copy_(t)
    return out


def _apply_layer(cfg: ArchConfig, spec: LayerSpec, params, x, positions,
                 mode, lc=None, li: int = 0, cur_len=None, valid=None,
                 routes=None):
    h = apply_norm(cfg.norm, params["norm1"], x, cfg.norm_eps)
    mp = params["mixer"]
    if spec.mixer in ("attn", "attn_local"):
        mo = _apply_attn(cfg, mp, h, positions, mode, lc, li, cur_len, valid,
                         local=spec.mixer == "attn_local")
    elif spec.mixer == "rec":
        mo = _stateful(lambda t, st: rglru_lib.rglru_block_apply(
            mp, t, cfg, st), h, mode, lc, li)
    elif spec.mixer == "rwkv_att":
        mo = _stateful(lambda t, st: rwkv_lib.timemix_apply(mp, t, cfg, st),
                       h, mode, None if lc is None else lc["att"], li)
    else:
        raise NotImplementedError(f"layer {spec} waits for ROADMAP A12")
    x = x + mo
    h2 = apply_norm(cfg.norm, params["norm2"], x, cfg.norm_eps)
    if spec.mlp == "moe":      # serving drops the aux loss, as the reference
        return x + moe_lib.moe_apply(params["mlp"], h2, cfg.moe,
                                     cfg.norm_eps, routes=routes)[0]
    if spec.mlp == "rwkv_ffn":
        return x + _stateful(
            lambda t, st: rwkv_lib.chanmix_apply(params["mlp"], t, st), h2,
            mode, None if lc is None else lc["ffn"], li)
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


def _soft_cap(x, cap: Optional[float]):
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


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
        each in its declared dtype (bf16, the MoE router fp32)."""
        device = torch.device(device)
        g = torch.Generator(device=device).manual_seed(seed)
        return init_params(self.param_decls(), g, device)

    def cache_decls(self, batch: int, max_len: int,
                    dtype: torch.dtype = PARAM_DTYPE):
        return cache_decls(self.cfg, batch, max_len, dtype)

    def init_cache(self, batch: int, max_len: int, device="cuda",
                   dtype: torch.dtype = PARAM_DTYPE):
        """The zeroed cache of ``cache_decls`` on ``device`` (``dtype`` for
        the leaves that name none)."""
        return init_params(self.cache_decls(batch, max_len, dtype), None,
                           torch.device(device))

    # -- embedding / head -----------------------------------------------
    @staticmethod
    def _embed(params, tokens):
        return params["embed"][tokens.long()]

    def _logits(self, params, h):
        """(B,d) hidden -> (B,V) fp32 logits (the product in the weights'
        dtype, then cast, then ``cfg.logits_soft_cap``, as the
        reference)."""
        return _soft_cap((h @ params["lm_head"]).float(),
                         self.cfg.logits_soft_cap)

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
