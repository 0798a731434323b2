"""Port parity: RWKV6 (``repro_torch.models.layers.rwkv``) against repro's
``repro.models.layers.rwkv`` on numpy inputs from a seed, and the port's
own oracles, twins of tests/test_models.py's RWKV cases.

Tolerances:
- chunked WKV against the sequential recurrence: 2e-4, the reference's
  own (tests/test_models.py), at its shapes and decays;
- port against reference, the same function on the same fp32 inputs:
  1e-5 (they sum in other orders); the chunked WKV against the
  reference's chunked WKV at 2e-4, its own tolerance, since its
  cumulative log-decays reach ~10^3 under strong decay and their fp32
  cumsums round differently on each side (1.3e-4 seen there, 1.4e-5 at
  the realistic decays);
- decode against the full forward in bf16: the reference's bar, argmax
  agreement >= 0.99 and rtol = atol = 0.08.

The reference initialises ``mu_x``, ``mu``, ``mu_k``, ``mu_r`` and
``gn_bias`` to zero; the layer tests draw them from N(0, 0.5) in both, so
the token shift, the data-dependent mix and the group norm's bias are
tested.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import bridge, configs
from repro_torch.models.layers import rwkv
from repro_torch.models.transformer import Model

jax = pytest.importorskip("jax")
jnp = jax.numpy

ARCH = "rwkv6-3b"
SEQ_TOL = 2e-4
PORT_TOL = 1e-5
ZERO_INIT = ("mu_x", "mu", "mu_k", "mu_r", "gn_bias")


def _rng(seed=3):
    return np.random.default_rng(seed)


def _arr(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _wkv_inputs(rng, B, S, H, D, decay_scale, decay_shift, state_scale):
    r, k, v = (_arr(rng, (B, S, H, D)) for _ in range(3))
    log_w = -np.exp(_arr(rng, (B, S, H, D), decay_scale) + decay_shift)
    bonus = _arr(rng, (H, D), 0.2)
    s0 = (_arr(rng, (B, H, D, D), state_scale) if state_scale
          else np.zeros((B, H, D, D), np.float32))
    return r, k, v, log_w.astype(np.float32), bonus, s0


@pytest.mark.parametrize("case", ["realistic", "strong_decay"])
def test_wkv_chunked_matches_sequential_and_reference(case):
    """Twins of test_rwkv_chunked_vs_sequential (B 2, S 50, H 3, D 8,
    chunk 16, a carried state) and test_rwkv_strong_decay_stability (decay
    e^2..e^4, which overflows a chunked path that exponentiates before
    masking): the port's chunked WKV equals its sequential recurrence
    within 2e-4 and stays finite, and both equal the reference's."""
    from repro.models.layers import rwkv as rrwkv
    if case == "realistic":
        args = _wkv_inputs(_rng(3), 2, 50, 3, 8, 0.5, 0.0, 0.3)
    else:
        args = _wkv_inputs(_rng(4), 1, 64, 2, 8, 1.0, 2.0, 0.0)
    ta = [_t(a) for a in args]
    o1, s1 = rwkv.wkv_sequential(*ta)
    o2, s2 = rwkv.wkv_chunked(*ta, chunk=16)
    assert torch.isfinite(o2).all() and torch.isfinite(s2).all()
    np.testing.assert_allclose(o2, o1, rtol=SEQ_TOL, atol=SEQ_TOL)
    np.testing.assert_allclose(s2, s1, rtol=SEQ_TOL, atol=SEQ_TOL)
    ja = [jnp.asarray(a) for a in args]
    ro, rs = rrwkv.wkv_chunked(*ja, chunk=16)
    qo, qs = rrwkv.wkv_sequential(*ja)
    # the chunked paths cancel large cumulative log-decays (|b| ~ 10^3
    # under strong decay) whose fp32 cumsums round in another order on
    # each side: held at the reference's own chunked tolerance
    np.testing.assert_allclose(o2, np.asarray(ro), rtol=SEQ_TOL, atol=SEQ_TOL)
    np.testing.assert_allclose(s2, np.asarray(rs), rtol=SEQ_TOL, atol=SEQ_TOL)
    np.testing.assert_allclose(o1, np.asarray(qo), rtol=0, atol=PORT_TOL)
    np.testing.assert_allclose(s1, np.asarray(qs), rtol=0, atol=PORT_TOL)


@pytest.mark.parametrize("S", [1, 16, 37])
def test_wkv_chunked_ragged_and_single_step(S):
    """A sequence shorter than, equal to, and not a multiple of the chunk
    (the zero padding past S must leave the state alone)."""
    args = [_t(a) for a in _wkv_inputs(_rng(5), 2, S, 2, 8, 0.5, 0.0, 0.3)]
    o1, s1 = rwkv.wkv_sequential(*args)
    o2, s2 = rwkv.wkv_chunked(*args, chunk=16)
    assert o2.shape == o1.shape == (2, S, 2, 8)
    np.testing.assert_allclose(o2, o1, rtol=SEQ_TOL, atol=SEQ_TOL)
    np.testing.assert_allclose(s2, s1, rtol=SEQ_TOL, atol=SEQ_TOL)


def _layer_params(seed=7):
    """One reference RWKV layer (the smoke config's first), fp32, with the
    zero-initialised terms drawn from N(0, 0.5); and its port twin."""
    from repro.configs import get_smoke_config
    from repro.models.transformer import Model as RefModel
    cfg = get_smoke_config(ARCH)
    tree = RefModel(cfg).init(jax.random.PRNGKey(seed))
    rng = _rng(seed)

    def draw(path, a):
        a = a.astype(jnp.float32)
        if getattr(path[-1], "key", None) in ZERO_INIT:
            return jnp.asarray(rng.normal(0.0, 0.5, a.shape), jnp.float32)
        return a
    tree = jax.tree_util.tree_map_with_path(draw, tree)
    layer = jax.tree.map(lambda a: a[0], tree["segments"][0]["0"])
    port = bridge.load_model(jax.tree.map(np.asarray, tree), cfg)
    return cfg, layer, port["segments"][0][0]["0"]


@pytest.mark.parametrize("S,carried", [(20, False), (20, True), (1, True)])
def test_timemix_and_chanmix_match_reference(S, carried):
    """``timemix_apply`` and ``chanmix_apply`` on the same fp32 weights and
    inputs: outputs and new states within 1e-5, from a zero state and from
    a carried one (the decode step at S 1)."""
    from repro.models.layers import rwkv as rrwkv
    cfg, ref_layer, port_layer = _layer_params()
    rng = _rng(11)
    B, d = 2, cfg.d_model
    H, D = d // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    x = _arr(rng, (B, S, d))
    state = None
    if carried:
        state = {"x_prev": _arr(rng, (B, d)),
                 "S": _arr(rng, (B, H, D, D), 0.3)}
    ro, rs = rrwkv.timemix_apply(
        ref_layer["mixer"], jnp.asarray(x), cfg,
        None if state is None else jax.tree.map(jnp.asarray, state))
    po, ps = rwkv.timemix_apply(port_layer["mixer"], _t(x), cfg,
                                None if state is None else
                                {k: _t(v) for k, v in state.items()})
    np.testing.assert_allclose(po, np.asarray(ro), rtol=0, atol=PORT_TOL)
    for key in ("x_prev", "S"):
        assert ps[key].dtype == torch.float32
        np.testing.assert_allclose(ps[key], np.asarray(rs[key]), rtol=0,
                                   atol=PORT_TOL)
    ffn_state = None if state is None else {"x_prev": state["x_prev"]}
    ro, rs = rrwkv.chanmix_apply(
        ref_layer["mlp"], jnp.asarray(x),
        None if ffn_state is None else jax.tree.map(jnp.asarray, ffn_state))
    po, ps = rwkv.chanmix_apply(port_layer["mlp"], _t(x),
                                None if ffn_state is None else
                                {"x_prev": _t(ffn_state["x_prev"])})
    np.testing.assert_allclose(po, np.asarray(ro), rtol=0, atol=PORT_TOL)
    np.testing.assert_allclose(ps["x_prev"], np.asarray(rs["x_prev"]),
                               rtol=0, atol=PORT_TOL)


def test_bf16_casts_follow_the_reference():
    """In bf16 the layer returns bf16 and its state fp32, as the
    reference's casts give (the WKV and group norm in fp32)."""
    cfg = configs.get_smoke_config(ARCH)
    layer = Model(cfg).init(0, "cpu")["segments"][0][0]["0"]
    x = torch.randn((2, 5, cfg.d_model)).bfloat16()
    out, st = rwkv.timemix_apply(layer["mixer"], x, cfg)
    assert out.dtype == torch.bfloat16
    assert st["x_prev"].dtype == st["S"].dtype == torch.float32
    out2, st2 = rwkv.timemix_apply(layer["mixer"], x[:, :1], cfg, st)
    assert out2.dtype == torch.bfloat16 and st2["S"].dtype == torch.float32
    out, st = rwkv.chanmix_apply(layer["mlp"], x)
    assert out.dtype == torch.bfloat16 and st["x_prev"].dtype == \
        torch.float32


def test_decode_matches_full_forward():
    """Twin of test_decode_matches_full_forward[rwkv6-3b]: random bf16
    weights (the port's init), B 2, S 24; prefill(S) + decode(token S)
    equals last_logits over S + 1 tokens on the reference's bar."""
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH),
                              attention_impl="pallas")
    model = Model(cfg)
    params = model.init(0, "cpu")
    B, S = 2, 24
    toks = torch.from_numpy(_rng(3).integers(0, cfg.vocab, (B, S + 1)))
    full = model.last_logits(params, {"tokens": toks}).numpy()
    cache = model.init_cache(B, S + 4, "cpu")
    cache, _ = model.prefill(params, {"tokens": toks[:, :S]}, cache)
    dec, cache = model.decode_step(params, cache, toks[:, S:S + 1])
    assert int(cache["len"]) == S + 1
    assert np.mean(np.argmax(full, -1) == np.argmax(dec.numpy(), -1)) >= 0.99
    np.testing.assert_allclose(dec.numpy(), full, rtol=0.08, atol=0.08)


def test_state_cache_declared_fp32():
    """The RWKV state is fp32 whatever the cache dtype, stacked on a layer
    axis, as the reference declares it."""
    cfg = configs.get_smoke_config(ARCH)
    cache = Model(cfg).init_cache(3, 16, "cpu", torch.bfloat16)
    c = cache["segments"][0]["0"]
    H, D = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    assert c["att"]["S"].shape == (cfg.n_layers, 3, H, D, D)
    assert c["att"]["x_prev"].shape == c["ffn"]["x_prev"].shape == \
        (cfg.n_layers, 3, cfg.d_model)
    assert {c["att"]["S"].dtype, c["att"]["x_prev"].dtype,
            c["ffn"]["x_prev"].dtype} == {torch.float32}


def test_init_moments_match_reference():
    """The port's ``scale`` and ``"uniform"`` init, drawn at the full
    config's widths (one layer's declarations), against the reference's
    recipe drawn at the same shapes: ``decay_base`` U(-1, 1) (mean 0,
    var 1/3, inside the limit), ``mix_w1``/``mix_w2``/``decay_w*`` std
    0.01, ``bonus`` std 0.1, ``w_r`` std 1/sqrt(2,560). The moments agree
    within 5 % (the draws are 10^3-10^6 values)."""
    from repro.common.param import init_params as ref_init
    from repro.configs import get_config
    from repro.models.layers import rwkv as rrwkv
    from repro_torch.common.param import init_params
    ref = ref_init(rrwkv.timemix_decls(get_config(ARCH)),
                   jax.random.PRNGKey(0))
    port = init_params(rwkv.timemix_decls(configs.get_config(ARCH)),
                       torch.Generator().manual_seed(0), "cpu")
    for key, std in (("mix_w1", 0.01), ("mix_w2", 0.01), ("decay_w1", 0.01),
                     ("decay_w2", 0.01), ("bonus", 0.1),
                     ("w_r", 2560 ** -0.5)):
        want = float(np.std(np.asarray(ref[key], np.float32)))
        got = float(port[key].float().std())
        assert abs(want - std) <= 0.05 * std, (key, want)
        assert abs(got - std) <= 0.05 * std, (key, got)
    base_ref = np.asarray(ref["decay_base"], np.float32)
    base = port["decay_base"].float().numpy()
    for a in (base_ref, base):
        assert a.min() >= -1.0 and a.max() <= 1.0
        assert abs(a.mean()) < 0.05 and abs(a.var() - 1 / 3) < 0.05 / 3
