"""Port parity: the RG-LRU block (``repro_torch.models.layers.rglru``),
local attention's ring buffer (``transformer._ring_from_seq``,
``attention.decode_attention_pos``) and the logit soft cap against
repro's, on numpy inputs from a seed, and the port's own oracles, twins of
tests/test_models.py's RG-LRU and recurrentgemma cases.

Tolerances:
- the log-depth scan against a float64 stepwise loop: 1e-4, the
  reference's own (tests/test_models.py), and against the reference's
  ``associative_scan``: 1e-5 (both associate the products in their own
  order);
- port against reference, the same function on the same fp32 inputs:
  1e-5; the whole model in fp32 (prefill, 8 decode steps, last_logits)
  1e-4, as tests/test_torch_serve.py holds the other archs;
- decode against the full forward in bf16: the reference's bar, argmax
  agreement >= 0.99 and rtol = atol = 0.08.

The reference initialises ``conv_b``, ``gate_a_b`` and ``gate_x_b`` to
zero; the layer tests draw them from N(0, 0.5) in both.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import bridge, configs
from repro_torch.models import transformer
from repro_torch.models.layers import attention, rglru
from repro_torch.models.transformer import Model

jax = pytest.importorskip("jax")
jnp = jax.numpy

ARCH = "recurrentgemma-2b"
STEP_TOL = 1e-4
PORT_TOL = 1e-5
MODEL_TOL = 1e-4
ZERO_INIT = ("conv_b", "gate_a_b", "gate_x_b")


def _rng(seed=3):
    return np.random.default_rng(seed)


def _arr(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("B,S,W,h0", [(2, 33, 16, True), (2, 1, 16, True),
                                      (3, 64, 8, False)])
def test_rglru_scan_matches_stepwise_and_reference(B, S, W, h0):
    """Twin of test_rglru_scan_vs_stepwise (B 2, S 33, W 16, a carried h0):
    the port's log-depth scan against a float64 stepwise loop at every
    position, and against the reference's associative scan; also the
    decode step (S 1) and a power-of-two length without h0."""
    from repro.models.layers import rglru as rrglru
    rng = _rng(3)
    log_a = -np.exp(_arr(rng, (B, S, W), 0.5))
    gated = _arr(rng, (B, S, W))
    h_init = _arr(rng, (B, W)) if h0 else None
    got = rglru.rglru_scan(_t(log_a), _t(gated),
                           None if h_init is None else _t(h_init))
    a = np.exp(log_a.astype(np.float64))
    b = np.sqrt(np.maximum(1 - a * a, 0)) * gated.astype(np.float64)
    h = np.zeros((B, W)) if h_init is None else h_init.astype(np.float64)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        np.testing.assert_allclose(got[:, t], h, rtol=STEP_TOL,
                                   atol=STEP_TOL)
    want = rrglru.rglru_scan(jnp.asarray(log_a), jnp.asarray(gated),
                             None if h_init is None else jnp.asarray(h_init))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=PORT_TOL)


def _layer(seed=7):
    """The smoke config's first rec layer, fp32, with the zero-initialised
    terms drawn; the reference's and the port's."""
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
    return cfg, layer["mixer"], port["segments"][0][0]["0"]["mixer"]


@pytest.mark.parametrize("S,carried", [(20, False), (20, True), (1, True),
                                       (2, True)])
def test_rglru_block_and_conv_match_reference(S, carried):
    """``conv1d_causal`` (with a carried (B, K-1, W) state, including S
    shorter than K-1) and ``rglru_block_apply`` on the same fp32 weights
    and inputs: outputs and new states within 1e-5."""
    from repro.models.layers import rglru as rrglru
    cfg, ref_p, port_p = _layer()
    rng = _rng(11)
    B, W, K = 2, cfg.griffin.lru_width, cfg.griffin.conv_width
    x = _arr(rng, (B, S, cfg.d_model))
    u = _arr(rng, (B, S, W))
    state = None
    if carried:
        state = {"h": _arr(rng, (B, W)), "conv": _arr(rng, (B, K - 1, W))}
    ro, rs = rrglru.conv1d_causal(
        ref_p, jnp.asarray(u), None if state is None
        else jnp.asarray(state["conv"]))
    po, ps = rglru.conv1d_causal(port_p, _t(u), None if state is None
                                 else _t(state["conv"]))
    assert ps.shape == (B, K - 1, W)
    np.testing.assert_allclose(po, np.asarray(ro), rtol=0, atol=PORT_TOL)
    np.testing.assert_array_equal(ps, np.asarray(rs))
    ro, rs = rrglru.rglru_block_apply(
        ref_p, jnp.asarray(x), cfg,
        None if state is None else jax.tree.map(jnp.asarray, state))
    po, ps = rglru.rglru_block_apply(
        port_p, _t(x), cfg,
        None if state is None else {k: _t(v) for k, v in state.items()})
    np.testing.assert_allclose(po, np.asarray(ro), rtol=0, atol=PORT_TOL)
    assert ps["h"].dtype == torch.float32
    for key in ("h", "conv"):
        np.testing.assert_allclose(ps[key], np.asarray(rs[key]), rtol=0,
                                   atol=PORT_TOL)


@pytest.mark.parametrize("S,W", [(5, 16), (16, 16), (23, 16), (40, 7)])
def test_ring_from_seq_matches_reference(S, W):
    """The ring fold of the last W positions: slots, zeros where empty
    (S < W) and positions + 1, equal to the reference's bit for bit."""
    from repro.models.transformer import _ring_from_seq as ref_ring
    rng = _rng(S)
    k, v = _arr(rng, (2, S, 12)), _arr(rng, (2, S, 12))
    (rk, rv), rpos = ref_ring(jnp.asarray(k), jnp.asarray(v), W)
    (pk, pv), ppos = transformer._ring_from_seq(_t(k), _t(v), W)
    assert ppos.dtype == torch.int32
    np.testing.assert_array_equal(ppos, np.asarray(rpos))
    np.testing.assert_array_equal(pk, np.asarray(rk))
    np.testing.assert_array_equal(pv, np.asarray(rv))


@pytest.mark.parametrize("cur,window", [(5, None), (5, 4), (30, 16),
                                        (30, None)])
def test_decode_attention_pos_matches_reference(cur, window):
    """Decode over a 16-slot ring with empty slots (position -1), slots
    past the current position and the window's edge; fp32 within 1e-5 and
    bf16 within the bf16 bar of the reference's bf16 (3e-2)."""
    from repro.models.layers import attention as rattn
    rng = _rng(cur)
    B, W, H, KH, D = 2, 16, 4, 1, 16
    q = _arr(rng, (B, 1, H, D))
    k, v = _arr(rng, (B, W, KH, D)), _arr(rng, (B, W, KH, D))
    pos = np.full(W, -1, np.int32)
    filled = min(cur + 1, W)
    for p in range(cur + 1 - filled, cur + 1):
        pos[p % W] = p
    if cur < W:
        pos[cur + 2:cur + 4] = [cur + 1, cur + 2]    # beyond cur: masked
    for dtype, jdt, tol in ((torch.float32, jnp.float32, PORT_TOL),
                            (torch.bfloat16, jnp.bfloat16, 3e-2)):
        want = rattn.decode_attention_pos(
            *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(pos),
            jnp.int32(cur), window)
        got = attention.decode_attention_pos(
            *(_t(a).to(dtype) for a in (q, k, v)), torch.from_numpy(pos),
            torch.tensor(cur, dtype=torch.int32), window)
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float(), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def _ref_model(cfg, seed=0):
    """The reference's model and fp32 weights for ``cfg`` (the zero terms
    drawn), and the port's twin tree."""
    from repro.models.transformer import Model as RefModel
    model = RefModel(cfg)
    rng = _rng(seed + 1)

    def draw(path, a):
        a = a.astype(jnp.float32)
        if getattr(path[-1], "key", None) in ZERO_INIT:
            return jnp.asarray(rng.normal(0.0, 0.5, a.shape), jnp.float32)
        return a
    params = jax.tree_util.tree_map_with_path(
        draw, model.init(jax.random.PRNGKey(seed)))
    return model, params, bridge.load_model(jax.tree.map(np.asarray,
                                                         params), cfg)


def _fp32_runs(cfg, pcfg, B=2, S=20, T=8, max_len=32):
    """Reference and port, fp32 weights and cache: prefill(S), T
    teacher-forced decode steps and last_logits over S + T tokens."""
    from repro.common.param import init_params
    model, rp, pp = _ref_model(cfg)
    toks = _rng(1).integers(0, cfg.vocab, (B, S + T)).astype(np.int32)
    cache = init_params(model.cache_decls(B, max_len), jax.random.PRNGKey(1))
    cache = jax.tree.map(lambda a: a.astype(jnp.float32)
                         if a.dtype == jnp.bfloat16 else a, cache)
    cache, lg = jax.jit(model.prefill)(rp, {"tokens": jnp.asarray(
        toks[:, :S])}, cache)
    want = [np.asarray(lg)]
    step = jax.jit(model.decode_step)
    for t in range(T):
        lg, cache = step(rp, cache, jnp.asarray(toks[:, S + t:S + t + 1]))
        want.append(np.asarray(lg))
    want.append(np.asarray(model.last_logits(rp, {"tokens": jnp.asarray(
        toks)})))
    port = Model(pcfg)
    pc = port.init_cache(B, max_len, "cpu", torch.float32)
    pc, lg = port.prefill(pp, {"tokens": torch.from_numpy(toks[:, :S])}, pc)
    got = [lg.numpy()]
    for t in range(T):
        lg, pc = port.decode_step(pp, pc, torch.from_numpy(
            toks[:, S + t:S + t + 1]))
        got.append(lg.numpy())
    got.append(port.last_logits(pp, {"tokens": torch.from_numpy(
        toks)}).numpy())
    assert int(pc["len"]) == S + T
    return want, got


@pytest.mark.parametrize("n_layers,cap", [(6, 1.0), (8, 30.0), (5, 30.0)])
def test_model_with_soft_cap_and_remainder_matches_reference(n_layers, cap):
    """The model in fp32 against the reference's, the ring wrapping (S 20
    and 8 steps over a 16-slot window): ``prefill``, ``decode_step`` and
    ``last_logits`` with the soft cap on (at cap 1.0 it bends every logit,
    |logits| < 1), and at 8 and 5 layers the one-unit remainder segment
    ``(rec, rec)`` after 2 and 1 units (``bridge.load_model``: a stacked
    and an unstacked segment, or two unstacked), within 1e-4."""
    from repro.configs import get_smoke_config
    cfg = dataclasses.replace(get_smoke_config(ARCH), n_layers=n_layers,
                              logits_soft_cap=cap)
    pcfg = dataclasses.replace(configs.get_smoke_config(ARCH),
                               n_layers=n_layers, logits_soft_cap=cap,
                               attention_impl="pallas")
    segs = transformer.build_segments(pcfg)
    assert [s.count for s in segs] == {6: [2], 8: [2, 1], 5: [1, 1]}[
        n_layers]
    want, got = _fp32_runs(cfg, pcfg)
    for w, g in zip(want, got):
        assert np.abs(g).max() < cap
        np.testing.assert_allclose(g, w, rtol=0, atol=MODEL_TOL)
    uncapped = dataclasses.replace(pcfg, logits_soft_cap=None)
    _, plain = _fp32_runs(dataclasses.replace(cfg, logits_soft_cap=None),
                          uncapped)
    np.testing.assert_allclose(np.tanh(plain[0] / cap) * cap, got[0],
                               rtol=0, atol=MODEL_TOL)


def test_decode_matches_full_forward():
    """Twin of test_decode_matches_full_forward[recurrentgemma-2b]: random
    bf16 weights (the port's init), B 2, S 24 over the 16-slot ring (it
    wraps); prefill(S) + decode(token S) equals last_logits over S + 1
    tokens on the reference's bar."""
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH),
                              attention_impl="pallas")
    model = Model(cfg)
    params = model.init(0, "cpu")
    B, S = 2, 24
    toks = torch.from_numpy(_rng(3).integers(0, cfg.vocab, (B, S + 1)))
    full = model.last_logits(params, {"tokens": toks}).numpy()
    cache = model.init_cache(B, S + 4, "cpu")
    assert cache["segments"][0]["2"]["k"].shape[2] == cfg.griffin.window
    cache, _ = model.prefill(params, {"tokens": toks[:, :S]}, cache)
    dec, cache = model.decode_step(params, cache, toks[:, S:S + 1])
    assert int(cache["len"]) == S + 1
    assert np.mean(np.argmax(full, -1) == np.argmax(dec.numpy(), -1)) >= 0.99
    np.testing.assert_allclose(dec.numpy(), full, rtol=0.08, atol=0.08)


def test_cache_dtypes_follow_the_reference():
    """``h`` fp32, ``conv`` and the ring's K/V in the cache dtype, ``pos``
    int32, every leaf stacked on a layer axis; the ring has
    min(window, max_len) slots."""
    cfg = configs.get_config(ARCH)
    decls = Model(cfg).cache_decls(16, 1024)
    segs = decls["segments"]
    assert len(segs) == 2
    rec, local = segs[0]["0"], segs[0]["2"]
    assert rec["h"].shape == (8, 16, 2560) and rec["h"].dtype == \
        torch.float32
    assert rec["conv"].shape == (8, 16, 3, 2560) and rec["conv"].dtype == \
        torch.bfloat16
    assert local["k"].shape == (8, 16, 1024, 256)
    assert local["k"].dtype == torch.bfloat16
    assert local["pos"].shape == (8, 1024) and local["pos"].dtype == \
        torch.int32
    assert set(segs[1]) == {"0", "1"} and segs[1]["1"]["h"].shape[0] == 1


def test_init_moments_match_reference():
    """``conv_w`` std 0.1 and ``lam`` U(-1, 1), the port's ``scale`` and
    ``"uniform"`` recipe against the reference's at the full widths
    (moments within 5 %), and the gates' std 1/sqrt(H * bw)."""
    from repro.common.param import init_params as ref_init
    from repro.configs import get_config
    from repro.models.layers import rglru as rrglru
    from repro_torch.common.param import init_params
    ref = ref_init(rrglru.rglru_decls(get_config(ARCH)),
                   jax.random.PRNGKey(0))
    port = init_params(rglru.rglru_decls(configs.get_config(ARCH)),
                       torch.Generator().manual_seed(0), "cpu")
    for key, std in (("conv_w", 0.1), ("gate_a_w", 2560 ** -0.5),
                     ("w_x", 2560 ** -0.5)):
        for a in (np.asarray(ref[key], np.float32), port[key].float()):
            assert abs(float(a.std()) - std) <= 0.05 * std, key
    for a in (np.asarray(ref["lam"], np.float32), port["lam"].float()
              .numpy()):
        assert a.min() >= -1.0 and a.max() <= 1.0
        assert abs(a.mean()) < 0.05 and abs(a.var() - 1 / 3) < 0.05 / 3
