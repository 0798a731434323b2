"""Causal LM: prefill, single-token decode over a cache, and the
stateless forward (port of repro/models/transformer.py, its dense, MoE,
RWKV, Griffin, encoder-decoder and patch-prefix stacks).

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
caps the fp32 logits as ``tanh(x / cap) * cap``. An enc-dec config
(``cfg.enc_dec``, whisper) adds an encoder of ``n_enc_layers`` ``(attn,
dense)`` layers over frame embeddings ``batch["frames"]`` (B, T, d), T
at most ``n_enc_frames``: rope over frame positions, non-causal
attention, a final norm (``apply_encoder``); each decoder layer adds
cross-attention (``norm_x``, ``cross``: no rope, all T frames) after its
self-attention, whose K/V the prefill writes into the cache's ``xk`` and
``xv`` once. A patch-prefix config (``cfg.n_patches``, llava) splices
``batch["patch_embeds"][:, :P]`` over the first P = min(n_patches, S)
token embeddings. An MLA config (``cfg.mla``, deepseek-v3) takes the
``mla`` mixer in place of attention in both of its MoE config's
segments (``layers/mla.py``): prefill expands the latents to per-head
K/V through the chunked path, as the reference names it, and writes the
compressed latents into the cache's ``ckv`` (L, B, S, kv_lora_rank) and
``kr`` (L, B, S, qk_rope); decode writes the token's latents at
``cur_len`` and attends in latent space (absorbed). ``cfg.mtp`` declares
the MTP head (``mtp``: ``proj``, ``norm_h``, ``norm_e``, one dense MLA
``layer`` and ``final_norm``); only the training loss reads it.

``Model.loss`` is the training objective, the reference's: the
cross-entropy of the next token (labels of -1 are padding) over the
sequence in chunks of ``loss_chunk`` positions, so no (B, S, V) logits
exist at once, plus the z-loss (1e-4 * mean lse²), plus the MoE layers'
load-balance aux losses summed in layer order (``apply_backbone``), plus,
for ``cfg.mtp``, 0.3 times the MTP head's cross-entropy of the token two
ahead. Where ``cfg.remat``, each unit of every segment and of the encoder,
and each CE chunk, runs under ``torch.utils.checkpoint`` (non-reentrant):
the backward recomputes it, as the reference's ``jax.checkpoint`` does,
and a MoE layer's recomputation takes the routes of its first run
(``moe.RecomputeRoutes``). Every arch of the registry trains through
this one path.

Modes, as in the reference:
  train    full sequence, no cache (``loss``, ``last_logits``,
           ``embed_pool``)
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
caches compare only through the outputs. K/V, the cross K/V, the ring and
the conv state are in the cache dtype; the RWKV state (``x_prev``, ``S``)
and the RG-LRU ``h`` are fp32 whatever the cache dtype, ``pos`` int32, as
the reference declares them. ``cache["len"]`` is a 0-d int32 tensor on the
device, and so is an enc-dec cache's ``enc_len`` (the T frames the
prefill wrote, the cross-attention's valid entries), and the slot and
position writes are device ops (``index_copy_``), so a decode step never
syncs with the host.

Attention follows ``cfg.attention_impl``. ``"pallas"``, the configs' name
for the kernel path, sends prefill (global, or local with the window),
the encoder's attention and the cross-attention's prefill (both
non-causal) to the flash-attention kernel, and each global decode step
and each cross-attention decode step to the decode-attention kernel on a
CUDA tensor (``kernels/decode_attention``: the only caller of that
kernel); on a CPU tensor both take their plain versions, the chunked
path (``q_chunk``, ``kv_chunk``) and the plain ``decode_attention``, bit
for bit the reference's ``"chunked"`` arithmetic. Any other value sends
decode to the plain ``decode_attention``, as the reference's decode layer
does on every backend, and the encoder and cross-attention prefill to the
chunked path, which the reference names for them whatever the config
says (``"oracle"`` mode: naive attention there too). The local
decode over the ring is plain torch (``decode_attention_pos``) on every
device, as the reference's is jnp. MLA takes the chunked path in prefill
whatever ``attention_impl`` says but ``"naive"`` (and in ``"oracle"``
mode), as the reference's MLA branch does, and its decode is plain
torch: no kernel. The RWKV and RG-LRU layers have no kernel in the
reference and none here.

On DTensors (the dry run's trace of a production mesh,
``launch/steps.py``) the same code runs sharded: ``partition.ac``
constrains activations where the reference's ``ac`` does, attention and
the recurrent scans run on each rank's (batch, heads) shards
(``partition.heads_local``, as a shard_map would), and the cache writes
at a position write each rank's shard (``partition.write_local``). On
plain tensors each of these is the plain call.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.common.param import ParamDecl, init_params, with_dtype
from repro_torch.common.spans import span
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import partition
from repro_torch.distributed.partition import ac
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers import mla as mla_lib
from repro_torch.models.layers import moe as moe_lib
from repro_torch.models.layers import rglru as rglru_lib
from repro_torch.models.layers import rwkv as rwkv_lib
from repro_torch.models.layers.mlp import mlp_apply, mlp_decls
from repro_torch.models.layers.norms import apply_norm, norm_decls
from repro_torch.models.layers.rope import apply_rope

PARAM_DTYPE = torch.bfloat16        # the reference's ParamDecl default


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str          # attn | attn_local | mla | rec | rwkv_att
    mlp: str            # dense | moe | rwkv_ffn
    cross_attn: bool = False   # whisper decoder


@dataclasses.dataclass(frozen=True)
class Segment:
    count: int
    unit: Tuple[LayerSpec, ...]


def require_ported(cfg: ArchConfig) -> None:
    """Admit the dense and MoE stacks (``moe`` with ``cfg.moe``, with
    ``cfg.mla`` or without), RWKV (``ssm`` with ``cfg.rwkv``), Griffin
    (``hybrid`` with ``cfg.griffin``), the encoder-decoder (``audio``
    with ``cfg.enc_dec``) and the patch prefix (``vlm`` with
    ``cfg.n_patches``); refuse a family without its sub-config or
    frontend, and any other family."""
    if (cfg.family == "dense"
            or (cfg.family == "moe" and cfg.moe is not None)
            or (cfg.family == "ssm" and cfg.rwkv is not None)
            or (cfg.family == "hybrid" and cfg.griffin is not None)
            or (cfg.family == "audio" and cfg.enc_dec)
            or (cfg.family == "vlm" and cfg.n_patches > 0)):
        return
    raise NotImplementedError(
        f"{cfg.name}: the {cfg.family!r} family without its sub-config or "
        f"frontend; the port has the dense, MoE (with or without MLA), "
        f"RWKV, Griffin, enc-dec and patch-prefix stacks")


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
    mixer = "mla" if cfg.mla is not None else "attn"
    if cfg.moe is not None:
        fd = cfg.moe.first_dense
        segs = [Segment(fd, (LayerSpec(mixer, "dense"),))] if fd else []
        return segs + [Segment(cfg.n_layers - fd,
                               (LayerSpec(mixer, "moe"),))]
    return [Segment(cfg.n_layers, (LayerSpec(mixer, "dense",
                                             cross_attn=cfg.enc_dec),))]


# ---------------------------------------------------------------- decls ----

def _mixer_decls(cfg: ArchConfig, spec: LayerSpec):
    if spec.mixer in ("attn", "attn_local"):
        return attn_lib.attn_decls(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.hd, cfg.qkv_bias, cfg.qk_norm,
                                   out_bias=(cfg.norm == "ln"))
    if spec.mixer == "mla":
        return mla_lib.mla_decls(cfg)
    if spec.mixer == "rec":
        return rglru_lib.rglru_decls(cfg)
    if spec.mixer == "rwkv_att":
        return rwkv_lib.timemix_decls(cfg)
    raise ValueError(f"unknown mixer {spec.mixer!r}")


def _mlp_decls(cfg: ArchConfig, spec: LayerSpec):
    if spec.mlp == "dense":
        return mlp_decls(cfg.d_model, cfg.d_ff, cfg.mlp,
                         bias=(cfg.norm == "ln"))
    if spec.mlp == "moe":
        return moe_lib.moe_decls(cfg.d_model, cfg.moe)
    if spec.mlp == "rwkv_ffn":
        return rwkv_lib.chanmix_decls(cfg)
    raise ValueError(f"unknown mlp {spec.mlp!r}")


def layer_decls(cfg: ArchConfig, spec: LayerSpec = LayerSpec("attn",
                                                              "dense")):
    """One layer of ``_layer_decls``: two norms, the mixer, the MLP, and
    for a cross layer ``norm_x`` and the cross-attention ``cross``."""
    d = {
        "norm1": norm_decls(cfg.norm, cfg.d_model),
        "norm2": norm_decls(cfg.norm, cfg.d_model),
        "mixer": _mixer_decls(cfg, spec),
        "mlp": _mlp_decls(cfg, spec),
    }
    if spec.cross_attn:
        d["norm_x"] = norm_decls(cfg.norm, cfg.d_model)
        d["cross"] = attn_lib.attn_decls(
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            out_bias=(cfg.norm == "ln"))
    return d


def model_decls(cfg: ArchConfig):
    """Embedding, segments (a list of ``count`` units each, a unit being
    ``{"0": layer, ...}``), final norm and the untied LM head; for an
    enc-dec config the ``encoder`` (``segment``: ``n_enc_layers`` units of
    one ``(attn, dense)`` layer, and its ``final_norm``); for ``cfg.mtp``
    the MTP head (``mtp``: ``proj`` (2d, d), ``norm_h``, ``norm_e``, one
    dense layer of the config's mixer, ``final_norm``), declared only;
    bf16 but for the declarations that name their dtype (the MoE router:
    fp32)."""
    V, d = cfg.padded_vocab, cfg.d_model
    decls: Dict[str, Any] = {
        "embed": ParamDecl((V, d), ("vocab", "embed"), init="embed"),
        "final_norm": norm_decls(cfg.norm, d),
        "segments": [[{str(i): layer_decls(cfg, spec)
                       for i, spec in enumerate(s.unit)}
                      for _ in range(s.count)]
                     for s in build_segments(cfg)],
        "lm_head": ParamDecl((d, V), ("embed", "vocab")),
    }
    if cfg.enc_dec:
        decls["encoder"] = {
            "segment": [{"0": layer_decls(cfg)}
                        for _ in range(cfg.n_enc_layers)],
            "final_norm": norm_decls(cfg.norm, d)}
    if cfg.mtp:
        decls["mtp"] = {
            "proj": ParamDecl((2 * d, d), ("embed", None)),
            "norm_h": norm_decls(cfg.norm, d),
            "norm_e": norm_decls(cfg.norm, d),
            "layer": layer_decls(cfg, LayerSpec(
                "mla" if cfg.mla is not None else "attn", "dense")),
            "final_norm": norm_decls(cfg.norm, d)}
    return with_dtype(decls, PARAM_DTYPE)


def _layer_cache_decls(cfg: ArchConfig, spec: LayerSpec, count: int, B: int,
                       S: int, dtype: torch.dtype):
    F = cfg.n_kv_heads * cfg.hd
    kv = ("layer", "batch", "kv_seq", "qkv")
    if spec.mixer == "attn":
        c = {"k": ParamDecl((count, B, S, F), kv, "zeros", dtype),
             "v": ParamDecl((count, B, S, F), kv, "zeros", dtype)}
        if spec.cross_attn:
            Se = cfg.n_enc_frames
            x = ("layer", "batch", None, "qkv")
            c["xk"] = ParamDecl((count, B, Se, F), x, "zeros", dtype)
            c["xv"] = ParamDecl((count, B, Se, F), x, "zeros", dtype)
        return c
    if spec.mixer == "attn_local":
        W = min(cfg.griffin.window, S)
        ring = ("layer", "batch", None, "qkv")
        return {"k": ParamDecl((count, B, W, F), ring, "zeros", dtype),
                "v": ParamDecl((count, B, W, F), ring, "zeros", dtype),
                "pos": ParamDecl((count, W), ("layer", None), "zeros",
                                 torch.int32)}
    if spec.mixer == "mla":
        m = cfg.mla
        lat = ("layer", "batch", "kv_seq", None)
        return {"ckv": ParamDecl((count, B, S, m.kv_lora_rank), lat,
                                 "zeros", dtype),
                "kr": ParamDecl((count, B, S, m.qk_rope_head_dim), lat,
                                "zeros", dtype)}
    if spec.mixer == "rec":
        return rglru_lib.rglru_state_decls(cfg, B, count, dtype)
    if spec.mixer == "rwkv_att":
        return rwkv_lib.rwkv_state_decls(cfg, B, count)
    raise ValueError(f"unknown mixer {spec.mixer!r}")


def cache_decls(cfg: ArchConfig, B: int, S: int,
                dtype: torch.dtype = PARAM_DTYPE):
    """``len`` (an int32 scalar) and, per segment and unit position, the
    layer's cache with a leading ``count`` axis: K and V ``(count, B, S,
    KH*hd)`` for global attention (and a cross layer's ``xk``, ``xv``
    ``(count, B, n_enc_frames, KH*hd)``), the ring for local attention,
    the latents ``ckv`` ``(count, B, S, kv_lora_rank)`` and ``kr``
    ``(count, B, S, qk_rope)`` for MLA, the recurrent state for RG-LRU
    and RWKV; an enc-dec cache also holds
    ``enc_len`` (an int32 scalar: the frames the prefill wrote).
    ``dtype`` is the cache dtype; the declarations that name theirs (the
    fp32 states, int32 ``pos``) keep it."""
    decls = {"len": ParamDecl((), (), init="zeros", dtype=torch.int32),
             "segments": [{str(i): _layer_cache_decls(cfg, spec, s.count,
                                                      B, S, dtype)
                           for i, spec in enumerate(s.unit)}
                          for s in build_segments(cfg)]}
    if cfg.enc_dec:
        decls["enc_len"] = ParamDecl((), (), init="zeros",
                                     dtype=torch.int32)
    return decls


# --------------------------------------------------------------- layers ----

def _decode_attend(cfg: ArchConfig, q, k_cache, v_cache, valid):
    """q (B, 1, H, hd) against a cache layer's first ``valid`` entries;
    the layer (B, Sc, KH*hd) as stored, on each rank's heads."""
    def attend(q, kc, vc, valid):
        if cfg.attention_impl == "pallas":
            from repro_torch.kernels.decode_attention import ops
            return ops.decode_attention_auto(q, kc, vc, valid)
        return attn_lib.decode_attention(q, kc, vc, valid)
    return partition.heads_local(attend, q, k_cache, v_cache, valid)


def _qkv(cfg: ArchConfig, params, x, positions):
    """q (B,S,H,hd), k, v (B,S,KH,hd) of x, rope on q and k."""
    q, k, v = attn_lib.project_qkv(params, x, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.hd, cfg.qk_norm, cfg.norm_eps)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _write_step(cfg: ArchConfig, lc, li: int, k, v, cur_len, local=False):
    """A decode step's K/V (B,1,KH,hd) written in place at ``cur_len``
    into layer ``li`` of the stacked cache ``lc`` (local attention: ring
    slot ``cur_len % W``, with the position + 1 in ``pos``). Returns the
    layer's (B, Sc, KH*hd) K and V."""
    B = k.shape[0]
    kc, vc = lc["k"][li], lc["v"][li]
    at = (torch.remainder(cur_len, kc.shape[1]) if local else cur_len)
    at = partition.to_local(at.reshape(1).long())
    for buf, new in ((kc, k), (vc, v)):
        partition.write_local(
            lambda b, s: b.index_copy_(1, at, s.to(b.dtype)), buf,
            new.reshape(B, 1, cfg.n_kv_heads * cfg.hd), "batch", None, "qkv")
    if local:
        partition.write_local(
            lambda b, s: b.index_copy_(0, at, s.to(b.dtype)), lc["pos"][li],
            (cur_len + 1).reshape(1), None)
    return kc, vc


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
    q, k, v = _qkv(cfg, params, x, positions)
    if mode == "decode":
        kc, vc = _write_step(cfg, lc, li, k, v, cur_len, local)
        if local:
            pos = lc["pos"][li]                         # position + 1
            o = partition.heads_local(
                lambda q, kc, vc, pos, cur: attn_lib.decode_attention_pos(
                    q, kc, vc, pos - 1, cur, window),
                q, kc, vc, pos, cur_len)
        else:
            o = _decode_attend(cfg, q, kc, vc, valid)
    else:
        impl = cfg.attention_impl if mode != "oracle" else "naive"
        o = partition.heads_local(
            lambda q, k, v: attn_lib.attention(
                q, k, v, impl=impl, causal=True, window=window,
                q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk), q, k, v)
        if mode == "prefill":
            kf, vf = k.reshape(B, S, KH * hd), v.reshape(B, S, KH * hd)
            if local:
                W = lc["k"].shape[2]
                for name, t in (("k", kf), ("v", vf)):
                    partition.write_local(
                        lambda b, s: b.copy_(_ring_fold(s, W)),
                        lc[name][li], t, "batch", None, "qkv")
                partition.write_local(
                    lambda b, s: b.copy_(s), lc["pos"][li],
                    _ring_pos(S, W, x.device))
            else:
                for name, t in (("k", kf), ("v", vf)):
                    partition.write_local(_fill_prefix, lc[name][li], t,
                                          "batch", None, "qkv")
    return _out_proj(params, o)


def _apply_mla(cfg: ArchConfig, params, x, positions, mode, lc=None,
               li: int = 0, cur_len=None, valid=None):
    """The ``mla`` mixer. ``lc`` is the segment's stacked cache, written in
    place at layer ``li``: the prompt's latents in prefill (the rest
    zeroed), the new token's at ``cur_len`` in decode, which then attends
    over ``valid = cur_len + 1`` entries."""
    if mode == "decode":
        ckv, kr = lc["ckv"][li], lc["kr"][li]           # (B, Sc, R|rope)
        lat = mla_lib.latents(params, x, cfg, positions)
        at = partition.to_local(cur_len.reshape(1).long())
        for buf, new in ((ckv, lat[2]), (kr, lat[3])):
            partition.write_local(
                lambda b, s: b.index_copy_(1, at, s.to(b.dtype)), buf, new,
                "batch", None, None)
        return mla_lib.mla_decode(params, x, cfg, ckv, kr, valid, positions,
                                  lat)
    impl = ("naive" if mode == "oracle" or cfg.attention_impl == "naive"
            else "chunked")
    out, (c_kv, k_rope) = mla_lib.mla_prefill(params, x, cfg, positions,
                                              impl)
    if mode == "prefill":
        for name, t in (("ckv", c_kv), ("kr", k_rope)):
            partition.write_local(_fill_prefix, lc[name][li], t, "batch",
                                  None, None)
    return out


def _fill_prefix(buf, t):
    """Write (B, n, F) ``t`` over the first n entries of the (B, S, F)
    cache slice ``buf`` in place and zero the rest."""
    n = t.shape[1]
    buf[:, :n] = t
    buf[:, n:].zero_()


def _out_proj(params, o):
    """(B, S, H, D) attention output -> (B, S, d): ``w_o`` and, where
    declared, ``b_o``."""
    B, S = o.shape[:2]
    out = ac(o.reshape(B, S, -1) @ params["w_o"], "batch", None, None)
    if "b_o" in params:
        out = out + params["b_o"]
    return out


def _bidir_attend(cfg: ArchConfig, q, k, v, mode):
    """Non-causal attention over every key: the encoder's, and the
    cross-attention's in prefill and train. The reference names the
    chunked path for both whatever ``cfg.attention_impl`` says; the kernel
    path (``"pallas"``) takes the flash kernel on a CUDA tensor and that
    same chunked path on a CPU tensor; ``"oracle"`` mode takes naive
    attention."""
    impl = ("naive" if mode == "oracle"
            else "pallas" if cfg.attention_impl == "pallas" else "chunked")
    return partition.heads_local(
        lambda q, k, v: attn_lib.attention(
            q, k, v, impl=impl, causal=False, q_chunk=cfg.q_chunk,
            kv_chunk=cfg.kv_chunk), q, k, v)


def _apply_cross_attn(cfg: ArchConfig, params, x, mode, lc=None,
                      li: int = 0, enc_out=None, enc_len=None):
    """Whisper's decoder cross-attention: no rope, every frame allowed.
    In prefill and train K and V come from the encoder output ``enc_out``
    (B, T, d), and prefill writes them over layer ``li``'s ``xk``/``xv``
    slice in place; in decode the query attends over the ``enc_len``
    (a 0-d int32 tensor on the device) frames cached there."""
    B, S, _ = x.shape
    KH, hd = cfg.n_kv_heads, cfg.hd
    q = partition.split_heads(ac(x @ params["w_q"], "batch", None, "qkv"),
                              cfg.n_heads, hd)
    if mode == "decode":
        o = _decode_attend(cfg, q, lc["xk"][li], lc["xv"][li], enc_len)
    else:
        T = enc_out.shape[1]
        k, v = (partition.split_heads(
            ac(enc_out @ params[w], "batch", None, "qkv"), KH, hd)
            for w in ("w_k", "w_v"))
        o = _bidir_attend(cfg, q, k, v, mode)
        if mode == "prefill":
            for name, t in (("xk", k), ("xv", v)):
                partition.write_local(_fill_prefix, lc[name][li],
                                      t.reshape(B, T, KH * hd), "batch",
                                      None, "qkv")
    return _out_proj(params, o)


def _ring_slots(S: int, W: int, device):
    """Slot i of a W-slot ring after S positions holds the largest
    position p <= S-1 with p = i (mod W), or nothing when S < W leaves it
    empty: (p clamped into [0, S-1], whether the slot holds one)."""
    i = torch.arange(W, device=device)
    p = i + torch.div(S - 1 - i, W, rounding_mode="floor") * W
    return torch.clamp(p, 0, S - 1), p >= 0


def _ring_fold(t, W: int):
    """(B,S,F) -> the ring's (B,W,F), zeros in an empty slot."""
    pc, valid = _ring_slots(t.shape[1], W, t.device)
    return torch.where(valid[None, :, None], t[:, pc], 0)


def _ring_pos(S: int, W: int, device):
    """The ring's (W,) int32 ``pos``: position + 1, 0 for an empty
    slot."""
    pc, valid = _ring_slots(S, W, device)
    return torch.where(valid, pc + 1, 0).to(torch.int32)


def _ring_from_seq(kf, vf, W: int):
    """Fold the last W positions of (B,S,F) k/v into ring-buffer layout.
    Returns ((k, v) (B,W,F), pos (W,) int32 = position + 1)."""
    return ((_ring_fold(kf, W), _ring_fold(vf, W)),
            _ring_pos(kf.shape[1], W, kf.device))


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
                 routes=None, enc_out=None, enc_len=None):
    """One layer -> (x, the MoE's aux loss, or None for another MLP)."""
    x = ac(x, "batch", None, None)
    with span("layer.mixer"):
        h = apply_norm(cfg.norm, params["norm1"], x, cfg.norm_eps)
        mp = params["mixer"]
        if spec.mixer in ("attn", "attn_local"):
            mo = _apply_attn(cfg, mp, h, positions, mode, lc, li, cur_len,
                             valid, local=spec.mixer == "attn_local")
        elif spec.mixer == "mla":
            mo = _apply_mla(cfg, mp, h, positions, mode, lc, li, cur_len,
                            valid)
        elif spec.mixer == "rec":
            mo = _stateful(lambda t, st: rglru_lib.rglru_block_apply(
                mp, t, cfg, st), h, mode, lc, li)
        elif spec.mixer == "rwkv_att":
            mo = _stateful(
                lambda t, st: rwkv_lib.timemix_apply(mp, t, cfg, st), h,
                mode, None if lc is None else lc["att"], li)
        else:
            raise ValueError(f"unknown mixer {spec.mixer!r}")
        x = ac(x + mo, "batch", None, None)
        if spec.cross_attn:
            hx = apply_norm(cfg.norm, params["norm_x"], x, cfg.norm_eps)
            x = x + _apply_cross_attn(cfg, params["cross"], hx, mode, lc, li,
                                      enc_out, enc_len)
    with span("layer.ffn"):
        h2 = apply_norm(cfg.norm, params["norm2"], x, cfg.norm_eps)
        if spec.mlp == "moe":
            out, aux = moe_lib.moe_apply(params["mlp"], h2, cfg.moe,
                                         cfg.norm_eps, routes=routes)
            return ac(x + out, "batch", None, None), aux
        if spec.mlp == "rwkv_ffn":
            out = _stateful(
                lambda t, st: rwkv_lib.chanmix_apply(params["mlp"], t, st),
                h2, mode, None if lc is None else lc["ffn"], li)
            return ac(x + out, "batch", None, None), None
        return ac(x + mlp_apply(params["mlp"], h2, cfg.mlp),
                  "batch", None, None), None


def _remat(cfg: ArchConfig, mode: str) -> bool:
    """Recompute in the backward: the training forward under autograd
    with ``cfg.remat``."""
    return cfg.remat and mode == "train" and torch.is_grad_enabled()


def _checkpoint(fn, *args):
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def apply_backbone(cfg: ArchConfig, params, x, positions, mode, cache=None,
                   cur_len=None, routes=None, enc_out=None):
    """x: (B,S,d) embedded inputs -> ((B,S,d) final-norm hidden states, the
    MoE layers' aux losses summed in layer order: a 0-d fp32, or 0.0
    without MoE). In prefill and decode, ``cache`` is written in place.
    ``routes``: a ``moe.RouteTape`` every MoE layer records into or is
    forced from. ``enc_out``: the encoder's output (B, T, d) that an
    enc-dec config's cross-attention reads in prefill and train (decode
    reads the cache). Under ``_remat`` each unit is checkpointed."""
    valid = cur_len + 1 if mode == "decode" else None
    enc_len = cache.get("enc_len") if mode == "decode" else None
    aux = 0.0
    remat = _remat(cfg, mode)
    for si, seg in enumerate(build_segments(cfg)):
        seg_cache = None if cache is None else cache["segments"][si]
        for li, unit in enumerate(params["segments"][si]):
            def run(x, aux, tape, seg=seg, seg_cache=seg_cache, li=li,
                    unit=unit):
                for i, spec in enumerate(seg.unit):
                    lc = None if seg_cache is None else seg_cache[str(i)]
                    x, a = _apply_layer(cfg, spec, unit[str(i)], x,
                                        positions, mode, lc, li, cur_len,
                                        valid, tape, enc_out, enc_len)
                    if a is not None:
                        aux = aux + a
                return x, aux
            if remat:
                tape = moe_lib.RecomputeRoutes(routes)
                x, aux = _checkpoint(
                    lambda x, aux, tape=tape, run=run: run(x, aux,
                                                           tape.begin()),
                    x, aux)
            else:
                x, aux = run(x, aux, routes)
    return apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps), aux


def apply_encoder(cfg: ArchConfig, params, frames, mode="train"):
    """Whisper's encoder over stub frame embeddings (B, T, d) -> (B, T, d):
    per layer norm1, attention (rope over frame positions, non-causal,
    ``_bidir_attend``), ``w_o`` and ``b_o``, norm2 and the MLP, each
    added to the residual; then the encoder's final norm. The frames are
    cast to the weights' dtype (the reference promotes bf16 frames to
    fp32 weights inside its first products instead)."""
    enc = params["encoder"]
    x = frames.to(enc["final_norm"]["scale"].dtype)
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device)[None].expand(B, T)

    def run(x, lp):
        h = apply_norm(cfg.norm, lp["norm1"], x, cfg.norm_eps)
        q, k, v = attn_lib.project_qkv(lp["mixer"], h, cfg.n_heads,
                                       cfg.n_kv_heads, cfg.hd, cfg.qk_norm,
                                       cfg.norm_eps)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        x = x + _out_proj(lp["mixer"], _bidir_attend(cfg, q, k, v, mode))
        h2 = apply_norm(cfg.norm, lp["norm2"], x, cfg.norm_eps)
        return x + mlp_apply(lp["mlp"], h2, cfg.mlp)

    remat = _remat(cfg, mode)
    for unit in enc["segment"]:
        x = (_checkpoint(lambda x, lp=unit["0"]: run(x, lp), x) if remat
             else run(x, unit["0"]))
    return apply_norm(cfg.norm, enc["final_norm"], x, cfg.norm_eps)


def _soft_cap(x, cap: Optional[float]):
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


# ----------------------------------------------------------------- model ---

class Model:
    """Functional model facade over a parameter tree (nested dicts and
    lists of tensors). The serving and AL methods run under
    ``torch.inference_mode()``; ``loss`` does not, so that autograd can
    differentiate it (the params must then come from ``init`` or
    ``bridge.load_model`` outside inference mode). ``prefill`` and
    ``decode_step`` update the cache in place and return it. ``routes``:
    a ``moe.RouteTape`` that every MoE layer of every call records its
    routes into, or is forced from (tests and the card's agreement check
    only)."""

    def __init__(self, cfg: ArchConfig, *, routes=None):
        from repro_torch.models import decode_graphs   # imports this
        require_ported(cfg)
        self.cfg = cfg
        self.routes = routes
        self._graphs = (decode_graphs.DecodeGraphs()
                        if decode_graphs.graphable(cfg) else None)

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

    # -- embedding / frontends / head -------------------------------------
    @staticmethod
    def _embed(params, tokens):
        return ac(params["embed"][tokens.long()], "batch", None, None)

    def _embed_inputs(self, params, batch):
        """Token embeddings (B,S,d); a patch-prefix config splices
        ``batch["patch_embeds"][:, :P]`` (cast to the embeddings' dtype)
        over the first P = min(n_patches, S) positions when the batch
        has them."""
        x = self._embed(params, batch["tokens"])
        if self.cfg.n_patches and "patch_embeds" in batch:
            P = min(self.cfg.n_patches, x.shape[1])
            x = torch.cat([batch["patch_embeds"][:, :P].to(x.dtype),
                           x[:, P:]], dim=1)
        return x

    def _encode(self, params, batch, mode="train"):
        """The encoder's output over ``batch["frames"]`` for an enc-dec
        config, else None."""
        if not self.cfg.enc_dec:
            return None
        return apply_encoder(self.cfg, params, batch["frames"], mode)

    def _logits(self, params, h):
        """(..., d) hidden -> (..., V) fp32 logits (the product in the
        weights' dtype, then cast, then ``cfg.logits_soft_cap``, as the
        reference)."""
        lg = ("batch",) + (None,) * (h.dim() - 2) + ("vocab",)
        return _soft_cap(ac(h @ params["lm_head"], *lg).float(),
                         self.cfg.logits_soft_cap)

    def _forward(self, params, batch, mode):
        """-> (final-norm hidden states (B,S,d), MoE aux loss)."""
        x = self._embed_inputs(params, batch)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        return apply_backbone(self.cfg, params, x, positions, mode,
                              routes=self.routes,
                              enc_out=self._encode(params, batch, mode))

    # -- training --------------------------------------------------------
    def loss(self, params, batch, *, loss_chunk: int = 512):
        """batch: tokens (B,S) int, labels (B,S) int (-1 = pad), and
        ``frames`` / ``patch_embeds`` where the config takes them. Returns
        (loss, metrics): 0-d fp32 tensors, metrics ``ce``, ``z_loss``,
        ``aux_loss`` and, for ``cfg.mtp``, ``mtp``."""
        h, aux = self._forward(params, batch, "train")
        ce, z = self._chunked_ce(params, h, batch["labels"], loss_chunk)
        aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
        loss = ce + z + aux
        metrics = {"ce": ce, "z_loss": z, "aux_loss": aux}
        if self.cfg.mtp:
            mtp_loss = self._mtp_loss(params, h, batch)
            loss = loss + 0.3 * mtp_loss
            metrics["mtp"] = mtp_loss
        return loss, metrics

    def _chunked_ce(self, params, h, labels, chunk: int):
        """Mean CE and z-loss over the positions whose label is >= 0, the
        sequence taken ``chunk`` positions at a time (padded with -1
        labels to a whole number of chunks): each chunk's fp32 logits
        (``_logits``) live only inside it. Returns (ce, 1e-4 * mean
        lse²)."""
        B, S, d = h.shape
        c = min(chunk, S)
        n = -(-S // c)
        if n * c != S:
            h = torch.nn.functional.pad(h, (0, 0, 0, n * c - S))
            labels = torch.nn.functional.pad(labels, (0, n * c - S),
                                             value=-1)

        def step(hh, ll):
            logits = self._logits(params, hh)              # (B, c, V) fp32
            lse = torch.logsumexp(logits, dim=-1)
            lbl = torch.clamp_min(ll, 0).long()
            if partition.is_dtensor(logits):
                # vocab-parallel: the label's logit as a masked sum over
                # each rank's vocab shard (gather has no such strategy)
                V = logits.shape[-1]
                hit = torch.arange(V, device=lbl.device) == lbl[..., None]
                lbl_logit = torch.where(hit, logits, 0.0).sum(-1)
            else:
                lbl_logit = torch.gather(logits, -1, lbl[..., None])[..., 0]
            w = (ll >= 0).float()
            return (torch.sum((lse - lbl_logit) * w),
                    torch.sum(torch.square(lse) * w), torch.sum(w))

        remat = _remat(self.cfg, "train")
        ce_sum = z_sum = n_tok = 0.0
        for i in range(n):
            hh, ll = h[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
            a, b, cnt = _checkpoint(step, hh, ll) if remat else step(hh, ll)
            ce_sum, z_sum, n_tok = ce_sum + a, z_sum + b, n_tok + cnt
        n_tok = torch.clamp_min(n_tok, 1.0)
        return ce_sum / n_tok, 1e-4 * z_sum / n_tok

    def _mtp_loss(self, params, h, batch):
        """deepseek-v3's MTP (depth 1): predict token t+2 from
        [norm_h(h_t); norm_e(emb_{t+1})] through ``proj``, one dense layer
        of the config's mixer and ``final_norm``; the CE of the labels
        rolled by one, the last two masked."""
        cfg = self.cfg
        mp = params["mtp"]
        tokens, labels = batch["tokens"], batch["labels"]
        B, S = tokens.shape
        positions = torch.arange(S, device=h.device)[None].expand(B, S)
        emb_next = self._embed(params, torch.roll(tokens, -1, dims=1))
        hh = apply_norm(cfg.norm, mp["norm_h"], h, cfg.norm_eps)
        ee = apply_norm(cfg.norm, mp["norm_e"], emb_next, cfg.norm_eps)
        z = torch.cat([hh, ee], -1) @ mp["proj"]
        spec = LayerSpec("mla" if cfg.mla is not None else "attn", "dense")
        z, _ = _apply_layer(cfg, spec, mp["layer"], z, positions, "train")
        z = apply_norm(cfg.norm, mp["final_norm"], z, cfg.norm_eps)
        labels2 = torch.roll(labels, -1, dims=1)
        labels2 = torch.where(torch.arange(S, device=labels.device) >= S - 2,
                              -1, labels2)
        return self._chunked_ce(params, z, labels2, 512)[0]

    # -- serving ----------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, params, batch, cache):
        """Fill the cache from a prompt ``batch["tokens"]`` (B,S), with
        ``batch["frames"]`` (B, T, d), T <= n_enc_frames, for an enc-dec
        config and optionally ``batch["patch_embeds"]`` for a patch-prefix
        one; returns (cache, last-position fp32 logits (B,V))."""
        with span("model.prefill"):
            x = self._embed_inputs(params, batch)
            B, S, _ = x.shape
            positions = torch.arange(S, device=x.device)[None].expand(B, S)
            enc_out = self._encode(params, batch)
            if enc_out is not None:
                T = enc_out.shape[1]
                if T > self.cfg.n_enc_frames:
                    raise ValueError(f"{T} frames exceed the cache's "
                                     f"n_enc_frames {self.cfg.n_enc_frames}")
                cache["enc_len"] = torch.full((), T, dtype=torch.int32,
                                              device=x.device)
            h, _ = apply_backbone(self.cfg, params, x, positions, "prefill",
                                  cache=cache, routes=self.routes,
                                  enc_out=enc_out)
            cache["len"] = torch.full((), S, dtype=torch.int32,
                                      device=x.device)
            return cache, self._logits(params, h[:, -1])

    @torch.inference_mode()
    def decode_step(self, params, cache, token):
        """One serving step. token: (B,1) int. Returns (fp32 logits (B,V),
        cache). With the token on a CUDA device, a stack of global
        attention and MLP or MoE layers replays the step from CUDA graphs
        (``models/decode_graphs.py``), bit for bit this eager step."""
        if self._graphs is not None and type(token) is torch.Tensor and \
                token.is_cuda:
            return self._graphs.step(self, params, cache, token)
        return self._decode_eager(params, cache, token)

    def _decode_eager(self, params, cache, token):
        cur_len = cache["len"]
        x = self._embed(params, token)
        B = x.shape[0]
        positions = cur_len.reshape(1, 1).expand(B, 1)
        h, _ = apply_backbone(self.cfg, params, x, positions, "decode",
                              cache=cache, cur_len=cur_len,
                              routes=self.routes)
        cache["len"] = cur_len + 1
        return self._logits(params, h[:, 0]), cache

    # -- AL hooks ----------------------------------------------------------
    @torch.inference_mode()
    def embed_pool(self, params, batch):
        """Mean-pooled final hidden state (B,d) over tokens >= 0."""
        h, _ = self._forward(params, batch, "train")
        mask = (batch["tokens"] >= 0).to(h.dtype)[..., None]
        return torch.sum(h * mask, dim=1) / torch.clamp_min(
            torch.sum(mask, dim=1), 1)

    @torch.inference_mode()
    def last_logits(self, params, batch):
        """Last-position fp32 logits (B,V) of the stateless forward."""
        h, _ = self._forward(params, batch, "train")
        return self._logits(params, h[:, -1])
