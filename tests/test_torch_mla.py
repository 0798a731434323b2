"""Port parity: repro_torch's MLA (``models/layers/mla.py``) and its place
in the LM (``models/transformer.py``: the ``ckv``/``kr`` cache) against
repro's, at deepseek-v3's smoke size (d 64, 4 heads, q/kv LoRA ranks
32/16, QK head dim 16 + 8 rope, V 16).

Inputs come from a numpy seed: every weight N(0, 1/fan_in), the two
RMSNorm scales (``q_norm``, ``kv_norm``: all ones in the reference) drawn
from N(1, 0.5) so that swapping or dropping one fails, x N(0, 1), the
same arrays fed to both packages. Tolerances, each stated at its test:
fp32 pieces within 1e-5 of the reference (the two sum in other orders;
outputs are O(1)); the absorbed decode against the last row of the
prefill's expansion within the reference's own 2e-4
(tests/test_models.py); the bf16 decode against the reference's bf16
run on the CPU, where its ``einsum_f32`` upcasts, within ``BF16_TOL``.

The ``cuda`` twins of the expansion oracle run at deepseek-v3's full
widths (d 7,168, 128 heads, kv rank 512, rope 64) and skip where there
is no GPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.models.layers import mla
from repro_torch.models.transformer import Model

ARCH = "deepseek-v3-671b"
B, S, SMAX = 2, 12, 20
# bf16 decode, port against the reference's bf16 run: both round q_lat
# and p to bf16, keep o_lat in fp32 and round the output to bf16 before
# w_o. On this input the two agree bit for bit (outputs up to 1.5, mean
# 0.37); allclose(rtol=0, atol=BF16_TOL) allows a bf16 step at 0.25-0.5
# and not one at the largest outputs, and rounding q_lat, p or o_lat in
# another place than the reference's fails it.
BF16_TOL = 2.0 ** -8
# the expansion oracle in bf16 at full width: outputs up to ~0.8 (a bf16
# step 2**-8 = 0.0039 at 0.5-1, the largest difference seen on the CPU
# at B 2, S 65); allclose(rtol=atol=EXPANSION_BF16_TOL), ~5 steps
EXPANSION_BF16_TOL = 2e-2


def _cfg():
    return configs.get_smoke_config(ARCH)


def _draw(cfg, seed=0):
    """The MLA's weights as float32 numpy arrays (N(0, 1/fan_in); the
    norm scales N(1, 0.5))."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, decl in mla.mla_decls(cfg).items():
        if isinstance(decl, dict):
            shape = decl["scale"].shape
            out[name] = {"scale": rng.normal(1.0, 0.5, shape)}
        else:
            std = decl.shape[0] ** -0.5
            out[name] = rng.normal(0.0, std, decl.shape)
    return _tree(out, lambda a: a.astype(np.float32))


def _tree(t, f):
    return {k: _tree(v, f) if isinstance(v, dict) else f(v)
            for k, v in t.items()}


def _port(np_params, dtype=torch.float32):
    return _tree(np_params, lambda a: torch.from_numpy(a).to(dtype))


def _ref(np_params, dtype=None):
    import jax.numpy as jnp
    return _tree(np_params, lambda a: jnp.asarray(a, dtype or jnp.float32))


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _positions(s, start=0):
    return np.broadcast_to(np.arange(start, start + s)[None], (B, s)).copy()


@pytest.fixture(scope="module")
def rmla():
    pytest.importorskip("jax")
    from repro.models.layers import mla as ref_mla
    return ref_mla


def test_latents_match_reference(rmla):
    """q_nope, q_rope (rotated per head), c_kv (after its norm) and the
    shared k_rope (B, S, rope: no head axis) within 1e-5."""
    cfg, p = _cfg(), _draw(_cfg())
    x, pos = _x((B, S, cfg.d_model)), _positions(S)
    want = rmla._latents(_ref(p), x, cfg, pos)
    got = mla.latents(_port(p), torch.from_numpy(x), cfg,
                      torch.from_numpy(pos))
    shapes = [(B, S, 4, 16), (B, S, 4, 8), (B, S, 16), (B, S, 8)]
    for w, g, shape in zip(want, got, shapes):
        assert tuple(g.shape) == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("impl", ["chunked", "naive"])
def test_prefill_matches_reference(rmla, impl):
    """The expansion (V padded 16 -> 24 and cut back, scale 24**-0.5),
    through the chunked path (q_chunk = kv_chunk = 16 over 20 positions:
    two chunks each way) and the naive one: output and the compressed
    cache within 1e-5."""
    cfg, p = _cfg(), _draw(_cfg())
    s = 20
    x, pos = _x((B, s, cfg.d_model)), _positions(s)
    want, (wc, wk) = rmla.mla_prefill(_ref(p), x, cfg, pos, impl=impl)
    got, (gc, gk) = mla.mla_prefill(_port(p), torch.from_numpy(x), cfg,
                                    torch.from_numpy(pos), impl=impl)
    assert tuple(got.shape) == (B, s, cfg.d_model)
    for w, g in ((want, got), (wc, gc), (wk, gk)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("cur", [1, 7, S])
def test_decode_matches_reference(rmla, cur):
    """The absorbed decode at fp32 against the reference's over the same
    caches (filled past ``cur`` too, so that the mask must hide them),
    with ``cur`` an int (the reference's) and a 0-d tensor (the port's
    serve path): within 1e-5."""
    cfg, p = _cfg(), _draw(_cfg())
    ckv, kr = _x((B, SMAX, 16), 2), _x((B, SMAX, 8), 3)
    x, pos = _x((B, 1, cfg.d_model), 4), _positions(1, cur - 1)
    want = np.asarray(rmla.mla_decode(_ref(p), x, cfg, ckv, kr, cur, pos))
    for c in (cur, torch.tensor(cur, dtype=torch.int32)):
        got = mla.mla_decode(_port(p), torch.from_numpy(x), cfg,
                             torch.from_numpy(ckv), torch.from_numpy(kr), c,
                             torch.from_numpy(pos))
        assert tuple(got.shape) == (B, 1, cfg.d_model)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_bf16_decode_matches_reference(rmla):
    """bf16 weights, input and caches: the port's decode against the
    reference's bf16 run, within BF16_TOL; both round the absorbed query
    and the probabilities to the cache dtype and keep o_lat in fp32."""
    import jax.numpy as jnp
    cfg, p = _cfg(), _draw(_cfg())
    _, (ckv, kr) = mla.mla_prefill(
        _port(p, torch.bfloat16),
        torch.from_numpy(_x((B, SMAX, cfg.d_model), 5)).bfloat16(), cfg,
        torch.from_numpy(_positions(SMAX)))
    x = torch.from_numpy(_x((B, 1, cfg.d_model), 6)).bfloat16()
    pos = _positions(1, S - 1)
    got = mla.mla_decode(_port(p, torch.bfloat16), x, cfg, ckv, kr, S,
                         torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16

    def j(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    want = rmla.mla_decode(_ref(p, jnp.bfloat16), j(x), cfg, j(ckv), j(kr),
                           S, pos)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=BF16_TOL)


def _expansion_oracle(cfg, p, x, impl="naive"):
    """(absorbed decode of the last token against the compressed cache of
    all S, the prefill's last row): the reference's
    ``test_mla_decode_matches_prefill_expansion``."""
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)[None].expand(b, s)
    out, (ckv, kr) = mla.mla_prefill(p, x, cfg, pos, impl=impl)
    dec = mla.mla_decode(p, x[:, s - 1:s], cfg, ckv, kr, s,
                         torch.full((b, 1), s - 1, device=x.device))
    return dec[:, 0], out[:, -1]


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_decode_matches_prefill_expansion(impl):
    """Twin of the reference's oracle (B 2, S 12, fp32): the absorbed
    decode equals the expanded attention's last row within 2e-4."""
    cfg = _cfg()
    p = _port(_draw(cfg))
    dec, full = _expansion_oracle(cfg, p, torch.from_numpy(
        _x((B, S, cfg.d_model), 7)), impl)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=2e-4,
                               atol=2e-4)


def _ref_cache(ref_model, jax, batch, max_len):
    from repro.common.param import init_params
    return init_params(ref_model.cache_decls(batch, max_len),
                       jax.random.PRNGKey(1))


@pytest.fixture(scope="module")
def lm():
    """The smoke LM in fp32 on the reference's weights (norm scales
    drawn), both models, and a prompt of S tokens plus one more."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.models.transformer import Model as RefModel
    from repro_torch import bridge
    rcfg = get_smoke_config(ARCH)
    rmodel = RefModel(rcfg)
    rng = np.random.default_rng(8)

    def draw(path, a):
        a = a.astype(jnp.float32)
        if len(path) > 1 and getattr(path[-2], "key", None) in (
                "q_norm", "kv_norm"):
            return jnp.asarray(rng.normal(1.0, 0.5, a.shape), jnp.float32)
        return a
    rp = jax.tree_util.tree_map_with_path(
        draw, rmodel.init(jax.random.PRNGKey(0)))
    cfg = dataclasses.replace(_cfg(), attention_impl="pallas")
    pp = bridge.load_model(jax.tree.map(np.asarray, rp), cfg)
    toks = np.random.default_rng(9).integers(0, 256, (B, S + 1)).astype(
        np.int32)
    return dict(jax=jax, jnp=jnp, rmodel=rmodel, rp=rp, cfg=cfg, pp=pp,
                toks=toks)


def _ref_prefill(lm):
    jnp = lm["jnp"]
    cache = _ref_cache(lm["rmodel"], lm["jax"], B, SMAX)
    cache = lm["jax"].tree.map(lambda a: a.astype(jnp.float32)
                               if a.dtype == jnp.bfloat16 else a, cache)
    return lm["jax"].jit(lm["rmodel"].prefill)(
        lm["rp"], {"tokens": jnp.asarray(lm["toks"][:, :S])}, cache)


def _port_prefill(lm, fill=1.0):
    """The port's prefill into a cache first filled with ``fill`` (so
    that rows the prefill must zero are seen to be zeroed)."""
    model = Model(lm["cfg"])
    cache = model.init_cache(B, SMAX, "cpu", torch.float32)
    for seg in cache["segments"]:
        for t in seg["0"].values():
            t.fill_(fill)
    return model, model.prefill(
        lm["pp"], {"tokens": torch.from_numpy(lm["toks"][:, :S])}, cache)


def _layers(cache, seg_counts=(1, 3)):
    """(ckv, kr) of every layer of a port cache, in layer order."""
    out = []
    for si, n in enumerate(seg_counts):
        c = cache["segments"][si]["0"]
        out += [(c["ckv"][i], c["kr"][i]) for i in range(n)]
    return out


def _ref_layers(cache, seg_counts=(1, 3)):
    out = []
    for si, n in enumerate(seg_counts):
        c = cache["segments"][si]["0"]
        ckv, kr = np.asarray(c["ckv"]), np.asarray(c["kr"])
        if n == 1:
            ckv, kr = ckv[None], kr[None]
        out += [(ckv[i], kr[i]) for i in range(n)]
    return out


def test_prefill_writes_latent_prefix(lm):
    """Prefill writes each layer's latents over the first S rows of its
    ``ckv`` (L, B, SMAX, 16) and ``kr`` (L, B, SMAX, 8), equal to the
    reference's cache within 1e-5, and zeroes the rest, whatever the
    cache held; the logits too within 1e-5."""
    rcache, rlogits = _ref_prefill(lm)
    _, (cache, logits) = _port_prefill(lm)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), rtol=0,
                               atol=1e-5)
    assert cache["segments"][1]["0"]["ckv"].shape == (3, B, SMAX, 16)
    assert cache["segments"][1]["0"]["kr"].shape == (3, B, SMAX, 8)
    for (ckv, kr), (rckv, rkr) in zip(_layers(cache), _ref_layers(rcache)):
        for got, want in ((ckv, rckv), (kr, rkr)):
            np.testing.assert_allclose(got[:, :S].numpy(), want[:, :S],
                                       rtol=0, atol=1e-5)
            assert got[:, :S].abs().amax() > 0
            assert not got[:, S:].any()


def test_decode_writes_row_cur_len_only(lm):
    """One decode step writes row ``cur_len`` (= S) of every layer's
    ``ckv``/``kr`` in place, equal to the reference's decode cache within
    1e-5, and leaves every other row's bytes as they were; the logits
    within 1e-5 of the reference's step."""
    jnp = lm["jnp"]
    rcache, _ = _ref_prefill(lm)
    tok = lm["toks"][:, S:S + 1]
    rlogits, rcache = lm["jax"].jit(lm["rmodel"].decode_step)(
        lm["rp"], rcache, jnp.asarray(tok))
    model, (cache, _) = _port_prefill(lm, fill=0.0)
    before = [(c.clone(), k.clone()) for c, k in _layers(cache)]
    logits, cache = model.decode_step(lm["pp"], cache, torch.from_numpy(tok))
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), rtol=0,
                               atol=1e-5)
    assert int(cache["len"]) == S + 1
    keep = [r for r in range(SMAX) if r != S]
    for (ckv, kr), (c0, k0), (rckv, rkr) in zip(
            _layers(cache), before, _ref_layers(rcache)):
        for got, old, want in ((ckv, c0, rckv), (kr, k0, rkr)):
            assert torch.equal(got[:, keep], old[:, keep])
            assert not torch.equal(got[:, S], old[:, S])
            np.testing.assert_allclose(got[:, S].numpy(), want[:, S],
                                       rtol=0, atol=1e-5)


@pytest.mark.parametrize("init,scale", [("normal", None), ("normal", 0.3),
                                        ("embed", None), ("uniform", None),
                                        ("uniform", 0.7)])
def test_init_in_place_draws_old_bits(init, scale):
    """``init_one`` scales its draw in place (a deepseek-v3 expert tensor
    is 15 GB in fp32: an out-of-place product held a second copy). The
    result equals the out-of-place recipe bit for bit, from one
    generator seed, in bf16 and held in fp32."""
    import math
    from repro_torch.common.param import ParamDecl, fan_in, init_one
    shape = (3, 40, 24)
    for held in (torch.bfloat16, None):
        decl = ParamDecl(shape, init=init, dtype=held, scale=scale)
        got = init_one(decl, torch.Generator().manual_seed(5), "cpu")
        g = torch.Generator().manual_seed(5)
        if init == "uniform":
            lim = scale if scale is not None else math.sqrt(
                1.0 / fan_in(shape))
            x = (torch.rand(shape, generator=g) * 2.0 - 1.0) * lim
        else:
            std = scale if scale is not None else (
                0.02 if init == "embed" else 1.0 / math.sqrt(fan_in(shape)))
            x = torch.randn(shape, generator=g) * std
        want = x.to(torch.bfloat16).to(decl.held)
        assert got.dtype == want.dtype == decl.held
        assert torch.equal(got.view(torch.int16 if held else torch.int32),
                           want.view(torch.int16 if held else torch.int32))


# ------------------------------------------------------------- on the card --
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_decode_matches_prefill_expansion_full_width(dtype):
    """The expansion oracle on the card at deepseek-v3's full widths (d
    7,168, 128 heads, q/kv ranks 1,536/512, QK 128 + 64, V 128), B 2,
    S 96, through the chunked prefill the serve path runs: fp32 within
    the reference's 2e-4 (TF32 off), bf16 within EXPANSION_BF16_TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert not torch.backends.cuda.matmul.allow_tf32
    dev = torch.device("cuda")
    cfg = configs.get_config(ARCH)
    dt = getattr(torch, dtype)
    p = _tree(_draw(cfg, seed=10),
              lambda a: torch.from_numpy(a).to(dev, dt))
    x = torch.from_numpy(_x((B, 96, cfg.d_model), 11)).to(dev, dt)
    dec, full = _expansion_oracle(cfg, p, x, impl="chunked")
    tol = 2e-4 if dt == torch.float32 else EXPANSION_BF16_TOL
    torch.testing.assert_close(dec.float(), full.float(), rtol=tol, atol=tol)
