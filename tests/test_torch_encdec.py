"""Port parity: the encoder-decoder (whisper-medium) and patch-prefix
(llava-next-34b) frontends of ``repro_torch.models.transformer`` against
repro's, piece by piece, on the smoke configs (whisper: d 64, 4/4 heads,
2 encoder layers over 24 frames, 2 decoder layers; llava: 8 patches).

The reference's weights come over through ``bridge.load_model`` with the
terms it initialises to zero (LayerNorm ``bias``, ``b_o``, ``b_in``,
``b_out``) drawn from N(0, 0.5), so that a port that drops or misplaces a
bias fails; frames and patch embeddings are seeded N(0, 1), as the
reference's own tests draw them (zero frames leave the encoder's output
at its final norm's bias). fp32 throughout, where both sides compute the
same sums in other orders: held within 1e-5 (the largest difference seen
is below 2e-6). The reference's encoder, cross-attention and decode layer
are jnp (no Pallas), so nothing runs in interpret mode.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import bridge, configs
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.uncertainty import ops as unc_ops
from repro_torch.models import transformer
from repro_torch.models.transformer import LayerSpec, Model

jax = pytest.importorskip("jax")
jnp = jax.numpy

B, S, SC = 2, 12, 20          # batch, prompt, cache length
ATOL = 1e-5
DRAWN = ("bias", "b_o", "b_in", "b_out")


def _ref_params(arch, seed=0):
    from repro.configs import get_smoke_config
    from repro.models.transformer import Model as RefModel
    cfg = get_smoke_config(arch)
    params = RefModel(cfg).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(2)

    def draw(path, a):
        if getattr(path[-1], "key", None) in DRAWN:
            a = jnp.asarray(rng.normal(0.0, 0.5, a.shape), a.dtype)
        return a.astype(jnp.float32)
    params = jax.tree_util.tree_map_with_path(draw, params)
    return cfg, params


@pytest.fixture(scope="module")
def whisper():
    cfg, rp = _ref_params("whisper-medium")
    pcfg = configs.get_smoke_config("whisper-medium")
    pp = bridge.load_model(jax.tree.map(np.asarray, rp), pcfg)
    return {"cfg": cfg, "pcfg": pcfg, "rp": rp, "pp": pp}


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("frames", [24, 17])
def test_encoder_matches_reference(whisper, frames):
    """``apply_encoder`` over T frames (the config's 24, and a T that is
    not a multiple of the 16-row chunks) against the reference's."""
    from repro.models.transformer import apply_encoder
    x = _normal((B, frames, 64), frames)
    want = apply_encoder(whisper["cfg"], whisper["rp"], jnp.asarray(x))
    with torch.inference_mode():
        got = transformer.apply_encoder(whisper["pcfg"], whisper["pp"],
                                        _t(x))
    assert got.shape == (B, frames, 64) and got.dtype == torch.float32
    _close(got, want)


def test_encoder_oracle_mode_is_naive_attention(whisper):
    """``"oracle"`` mode takes naive attention in the encoder, the
    chunked path's result within fp32 rounding."""
    x = _t(_normal((B, 24, 64), 3))
    with torch.inference_mode():
        plain = transformer.apply_encoder(whisper["pcfg"], whisper["pp"], x)
        oracle = transformer.apply_encoder(whisper["pcfg"], whisper["pp"],
                                           x, "oracle")
    assert not torch.equal(plain, oracle)
    _close(oracle, plain)


def _cross_params(whisper, layer=0):
    """The reference's and the port's ``cross`` params of decoder layer
    ``layer`` (the reference's stacked on a leading layer axis)."""
    rp = jax.tree.map(lambda a: a[layer],
                      whisper["rp"]["segments"][0]["0"]["cross"])
    return rp, whisper["pp"]["segments"][0][layer]["0"]["cross"]


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
def test_cross_attention_prefill_and_its_cache(whisper, impl):
    """Cross-attention in prefill: the output, and the ``xk``/``xv`` it
    writes (the encoder output's K/V, in place, at layer 1 of the stacked
    cache, layer 0 untouched), against the reference's."""
    from repro.models.transformer import _apply_cross_attn
    rp, pp = _cross_params(whisper, 1)
    x, enc = _normal((B, S, 64), 5), _normal((B, 24, 64), 6)
    want, wcache = _apply_cross_attn(
        whisper["cfg"], rp, jnp.asarray(x), jnp.asarray(enc), "prefill",
        {"xk": jnp.zeros((B, 24, 64)), "xv": jnp.zeros((B, 24, 64))})
    cfg = dataclasses.replace(whisper["pcfg"], attention_impl=impl)
    lc = {"xk": torch.full((2, B, 24, 64), 7.0),
          "xv": torch.full((2, B, 24, 64), 7.0)}
    with torch.inference_mode():
        got = transformer._apply_cross_attn(cfg, pp, _t(x), "prefill", lc,
                                            1, enc_out=_t(enc))
    _close(got, want)
    _close(lc["xk"][1], wcache["xk"])
    _close(lc["xv"][1], wcache["xv"])
    assert bool((lc["xk"][0] == 7.0).all() and (lc["xv"][0] == 7.0).all())


def test_cross_attention_train_mode(whisper):
    """Cross-attention without a cache (train: ``last_logits``,
    ``embed_pool``) against the reference's."""
    from repro.models.transformer import _apply_cross_attn
    rp, pp = _cross_params(whisper)
    x, enc = _normal((B, S, 64), 8), _normal((B, 24, 64), 9)
    want, _ = _apply_cross_attn(whisper["cfg"], rp, jnp.asarray(x),
                                jnp.asarray(enc), "train", None)
    with torch.inference_mode():
        got = transformer._apply_cross_attn(whisper["pcfg"], pp, _t(x),
                                            "train", enc_out=_t(enc))
    _close(got, want)


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
@pytest.mark.parametrize("li", [0, 1])
def test_decode_layer_matches_reference_step(whisper, li, impl):
    """One decoder layer's decode step (self-attention over the cache,
    cross-attention over the cached frames, the MLP) against the
    reference's ``_decode_layer_inplace`` at layer ``li`` of a stacked
    cache: the layer's output and the K/V it writes at ``cur_len``."""
    from repro.models.transformer import LayerSpec as RefSpec
    from repro.models.transformer import _decode_layer_inplace
    rcfg, cur = whisper["cfg"], 9
    lc = {k: _normal((2, B, n, 64), i) for i, (k, n) in enumerate(
        (("k", SC), ("v", SC), ("xk", 24), ("xv", 24)))}
    for k in ("k", "v"):
        lc[k][:, :, cur:] = 0.0
    x = _normal((B, 1, 64), 4)
    rlayer = jax.tree.map(lambda a: a[li], whisper["rp"]["segments"][0]["0"])
    pos = jnp.full((B, 1), cur, jnp.int32)
    want, wlc = _decode_layer_inplace(
        rcfg, RefSpec("attn", "dense", cross_attn=True), rlayer,
        jnp.asarray(x), pos, {k: jnp.asarray(v) for k, v in lc.items()},
        li, jnp.int32(cur), None)
    cfg = dataclasses.replace(whisper["pcfg"], attention_impl=impl)
    plc = {k: _t(v) for k, v in lc.items()}
    cur_t = torch.tensor(cur, dtype=torch.int32)
    with torch.inference_mode():
        got, _ = transformer._apply_layer(
            cfg, LayerSpec("attn", "dense", cross_attn=True),
            whisper["pp"]["segments"][0][li]["0"], _t(x),
            cur_t.reshape(1, 1).expand(B, 1), "decode", plc, li, cur_t,
            cur_t + 1, enc_len=torch.tensor(24, dtype=torch.int32))
    _close(got, want)
    for k in ("k", "v", "xk", "xv"):
        _close(plc[k], wlc[k])


def test_cross_decode_reads_enc_len_entries(whisper):
    """Cross-attention decode attends over the ``enc_len`` cached frames:
    at enc_len = T < n_enc_frames it equals the reference's decode over
    a cache of T frames (what the reference's prefill leaves), whatever
    the entries past T hold."""
    from repro.models.transformer import _apply_cross_attn
    rp, pp = _cross_params(whisper)
    T = 13
    xk, xv = _normal((B, 24, 64), 11), _normal((B, 24, 64), 12)
    q = _normal((B, 1, 64), 10)
    want, _ = _apply_cross_attn(
        whisper["cfg"], rp, jnp.asarray(q), None, "decode",
        {"xk": jnp.asarray(xk[:, :T]), "xv": jnp.asarray(xv[:, :T])})
    lc = {"xk": _t(xk)[None], "xv": _t(xv)[None]}
    with torch.inference_mode():
        got = transformer._apply_cross_attn(
            whisper["pcfg"], pp, _t(q), "decode", lc, 0,
            enc_len=torch.tensor(T, dtype=torch.int32))
    _close(got, want)


def test_prefill_with_fewer_frames_matches_reference(whisper):
    """A prefill over T < n_enc_frames frames (the reference's cross cache
    then holds T entries; the port's holds n_enc_frames, ``enc_len`` T)
    and 3 decode steps, against the reference's; more frames than the
    cache holds raise."""
    from repro.common.param import init_params
    from repro.models.transformer import Model as RefModel
    rm, T = RefModel(whisper["cfg"]), 15
    toks = np.random.default_rng(1).integers(0, 256, (B, S + 3)).astype(
        np.int32)
    frames = _normal((B, T, 64), 13)
    rcache = jax.tree.map(lambda a: a.astype(jnp.float32),
                          init_params(rm.cache_decls(B, SC),
                                      jax.random.PRNGKey(1)))
    rcache, want = rm.prefill(whisper["rp"], {
        "tokens": jnp.asarray(toks[:, :S]), "frames": jnp.asarray(frames)},
        rcache)
    model = Model(whisper["pcfg"])
    cache = model.init_cache(B, SC, "cpu", torch.float32)
    cache, got = model.prefill(whisper["pp"], {
        "tokens": torch.from_numpy(toks[:, :S]), "frames": _t(frames)},
        cache)
    assert cache["enc_len"].dtype == torch.int32 and int(cache["enc_len"]) \
        == T
    _close(got, want)
    for t in range(3):
        tok = toks[:, S + t:S + t + 1]
        want, rcache = rm.decode_step(whisper["rp"], rcache,
                                      jnp.asarray(tok))
        got, cache = model.decode_step(whisper["pp"], cache,
                                       torch.from_numpy(tok))
        _close(got, want)
    with pytest.raises(ValueError, match="n_enc_frames"):
        model.prefill(whisper["pp"], {
            "tokens": torch.from_numpy(toks[:, :S]),
            "frames": _t(_normal((B, 25, 64), 14))},
            model.init_cache(B, SC, "cpu", torch.float32))


def test_enc_dec_cache_declarations(whisper):
    """A cross layer's cache adds ``xk``/``xv`` (count, B, n_enc_frames,
    KH*hd) in the cache dtype, and the cache an int32 ``enc_len``."""
    cache = Model(whisper["pcfg"]).init_cache(3, 10, "cpu")
    lc = cache["segments"][0]["0"]
    assert set(lc) == {"k", "v", "xk", "xv"}
    for k in ("xk", "xv"):
        assert lc[k].shape == (2, 3, 24, 64) and lc[k].dtype == \
            torch.bfloat16
    assert lc["k"].shape == (2, 3, 10, 64)
    assert cache["enc_len"].shape == () and cache["enc_len"].dtype == \
        torch.int32
    assert "enc_len" not in Model(configs.get_smoke_config(
        "llava-next-34b")).init_cache(3, 10, "cpu")


@pytest.mark.parametrize("seq", [5, 8, 12])
def test_patch_splice_matches_reference(seq):
    """``_embed_inputs`` splices the patch embeddings over the first
    min(n_patches, S) positions (n_patches 8: S below, at and above it),
    cast to the embeddings' dtype, against the reference's."""
    from repro.models.transformer import Model as RefModel
    cfg, rp = _ref_params("llava-next-34b")
    pcfg = configs.get_smoke_config("llava-next-34b")
    pp = bridge.load_model(jax.tree.map(np.asarray, rp), pcfg)
    toks = np.random.default_rng(seq).integers(0, 256, (B, seq)).astype(
        np.int32)
    patches = _normal((B, 8, 64), seq)
    want = RefModel(cfg)._embed_inputs(rp, {
        "tokens": jnp.asarray(toks),
        "patch_embeds": jnp.asarray(patches, jnp.bfloat16)})
    model = Model(pcfg)
    got = model._embed_inputs(pp, {
        "tokens": torch.from_numpy(toks),
        "patch_embeds": _t(patches).bfloat16()})
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    P = min(8, seq)
    assert torch.equal(got[:, :P], _t(patches).bfloat16().float()[:, :P])
    assert torch.equal(got[:, P:], pp["embed"][torch.from_numpy(
        toks[:, P:]).long()])
    # without patch embeddings the tokens' embeddings stay
    plain = model._embed_inputs(pp, {"tokens": torch.from_numpy(toks)})
    assert torch.equal(plain, pp["embed"][torch.from_numpy(toks).long()])


def test_bridge_carries_the_encoder_tree(whisper):
    """``load_model`` unstacks the reference's encoder segment into the
    port's list of units, leaf for leaf and dtype for dtype (bf16 kept),
    carries each cross layer's ``norm_x`` and ``cross``, and raises when
    a key is missing on either side."""
    from repro.models.transformer import Model as RefModel
    rp = RefModel(whisper["cfg"]).init(jax.random.PRNGKey(4))
    tree = jax.tree.map(np.asarray, rp)
    pp = bridge.load_model(tree, whisper["pcfg"])
    enc = pp["encoder"]
    assert set(enc) == {"segment", "final_norm"} and len(enc["segment"]) == 2
    stacked = tree["encoder"]["segment"]["0"]
    for i, unit in enumerate(enc["segment"]):
        assert set(unit) == {"0"}
        for path, t in _leaves(unit["0"]):
            a = _at(stacked, path)[i]
            assert t.dtype == torch.bfloat16 and t.shape == a.shape, path
            assert torch.equal(t.float(), _t(a.astype(np.float32))), path
    layer = pp["segments"][0][1]["0"]
    assert {"norm_x", "cross"} <= set(layer)
    assert torch.equal(layer["cross"]["w_q"].float(), _t(np.asarray(
        tree["segments"][0]["0"]["cross"]["w_q"][1], np.float32)))
    assert torch.equal(enc["final_norm"]["bias"].float(), _t(np.asarray(
        tree["encoder"]["final_norm"]["bias"], np.float32)))
    lacking = jax.tree.map(lambda a: a, tree)
    del lacking["encoder"]["segment"]["0"]["mixer"]["b_o"]
    with pytest.raises(ValueError, match="lacks.*encoder/segment"):
        bridge.load_model(lacking, whisper["pcfg"])
    extra = jax.tree.map(lambda a: a, tree)
    extra["segments"][0]["0"]["cross"]["b_q"] = np.zeros((2, 64))
    with pytest.raises(ValueError, match="does not declare.*cross/b_q"):
        bridge.load_model(extra, whisper["pcfg"])


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def _at(tree, path):
    for k in path.strip("/").split("/"):
        tree = tree[k]
    return np.asarray(tree)


@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-34b"])
def test_kernel_path_on_the_cpu_launches_nothing(arch):
    """``attention_impl="pallas"`` on CPU tensors serves through the plain
    versions (the chunked path, the plain decode, the plain scores) and
    launches no kernel; its logits equal the chunked path's bit for bit."""
    cfg = configs.get_smoke_config(arch)
    model = Model(dataclasses.replace(cfg, attention_impl="pallas"))
    plain = Model(dataclasses.replace(cfg, attention_impl="chunked"))
    params = model.init(0, "cpu")
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (B, S)).astype(np.int32))}
    if cfg.enc_dec:
        batch["frames"] = _t(_normal((B, 24, 64), 1)).bfloat16()
    else:
        batch["patch_embeds"] = _t(_normal((B, 8, 64), 1)).bfloat16()
    for ops in (fa_ops, da_ops, unc_ops):
        ops.reset_launches()
    outs = []
    for m in (model, plain):
        cache = m.init_cache(B, SC, "cpu")
        cache, logits = m.prefill(params, batch, cache)
        steps = [logits]
        for _ in range(3):
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
            logits, cache = m.decode_step(params, cache, tok)
            unc_ops.uncertainty_stats(logits)
            steps.append(logits)
        outs.append(torch.stack(steps))
    assert torch.equal(outs[0], outs[1])
    for counts in (fa_ops.LAUNCHES, da_ops.LAUNCHES, unc_ops.LAUNCHES):
        assert set(counts.values()) == {0}


@pytest.mark.parametrize("family,field", [("audio", "enc_dec"),
                                          ("vlm", "n_patches")])
def test_frontend_families_need_their_frontend(family, field):
    """The gate admits ``audio`` only with ``enc_dec`` and ``vlm`` only
    with ``n_patches``: the config without it raises, naming the missing
    sub-config or frontend, with it builds its segments (a cross layer per decoder layer for
    ``audio``)."""
    cfg = configs.get_smoke_config("qwen3-8b")
    off = dataclasses.replace(cfg, family=family)
    with pytest.raises(NotImplementedError, match="sub-config or frontend"):
        Model(off)
    on = dataclasses.replace(off, **{field: 8 if field == "n_patches"
                                     else True},
                             n_enc_layers=1 if field == "enc_dec" else 0)
    segs = transformer.build_segments(on)
    assert [s.count for s in segs] == [2]
    assert segs[0].unit == (LayerSpec("attn", "dense",
                                      cross_attn=field == "enc_dec"),)
