"""Port parity: repro_torch's token-choice MoE (``models/layers/moe.py``)
against repro's (``repro.models.layers.moe``).

Setups: the reference's own two (tests/test_models.py: 8 experts top-2
with a shared expert, group 32, capacity factor 1.5; 4 experts top-2,
group 16, capacity 5 for the dispatch) and one that overflows capacity
at every top-k rank (4 experts top-3, capacity factor 0.3). Weights are
the reference's ``init_params`` cast to fp32 and carried over as numpy;
inputs come from numpy seeds.

- ``out`` and ``aux`` within 1e-5 in fp32: the port gathers rows where the
  reference multiplies by a one-hot, so the expert inputs are equal; the
  products and the combine sum in other orders (differences seen ~1e-6 at
  outputs of O(1)).
- The port's (G, E, C) slot table equals the argmax over tokens of the
  reference's dispatch one-hot, slot for slot, empty slots included,
  over the same router probabilities: exact, with drops and planted ties.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import moe

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.common.param import init_params  # noqa: E402
from repro.configs.base import MoEConfig as RefMoEConfig  # noqa: E402
from repro.models.layers import moe as ref_moe  # noqa: E402

TOL = 1e-5
D = 24

# (MoEConfig fields, (B, S))
SETUPS = {
    "shared_top2": (dict(n_routed=8, top_k=2, d_ff_expert=16, n_shared=1,
                         group_size=32, capacity_factor=1.5), (2, 32)),
    "e4_top2": (dict(n_routed=4, top_k=2, d_ff_expert=8, group_size=16),
                (2, 16)),
    "overflow_every_k": (dict(n_routed=4, top_k=3, d_ff_expert=8,
                              n_shared=2, group_size=16,
                              capacity_factor=0.3), (2, 16)),
}


def _setup(name, seed=0):
    fields, (B, S) = SETUPS[name]
    rm, mo = RefMoEConfig(**fields), MoEConfig(**fields)
    rp = init_params(ref_moe.moe_decls(D, rm), jax.random.PRNGKey(seed))
    rp = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), rp)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), rp)
    x = np.random.default_rng(seed).standard_normal((B, S, D)).astype(
        np.float32)
    return rm, mo, rp, tp, x


def _port_table(probs, mo, C):
    topi = moe.top_k(torch.from_numpy(probs), mo.top_k)[1]
    return moe.slot_table(moe.Routes(topi, moe.route(topi, mo.n_routed, C)),
                          mo.n_routed, C)


def _ref_table(dispatch):
    """(G, S, E, C) one-hot -> (G, E, C) token index, EMPTY where none."""
    d = np.asarray(dispatch)
    assert d.sum(axis=1).max() <= 1
    return np.where(d.any(axis=1), d.argmax(axis=1), moe.EMPTY)


def _ref_probs(rp, x, rm):
    B, S, _ = x.shape
    gs = min(rm.group_size, B * S)
    logits = jnp.einsum("gsd,de->gse", jnp.asarray(x).reshape(-1, gs, D),
                        jnp.asarray(rp["router"]))
    return np.array(jax.nn.softmax(logits, axis=-1)), gs


@pytest.mark.parametrize("name", list(SETUPS))
def test_moe_apply_matches_reference(name):
    rm, mo, rp, tp, x = _setup(name)
    want, want_aux = ref_moe.moe_apply(rp, jnp.asarray(x), rm)
    got, aux = moe.moe_apply(tp, torch.from_numpy(x), mo)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=0, atol=TOL)


@pytest.mark.parametrize("name", list(SETUPS))
def test_slot_table_equals_reference_dispatch(name):
    rm, mo, rp, _, x = _setup(name)
    probs, gs = _ref_probs(rp, x, rm)
    C = 5 if name == "e4_top2" else ref_moe.capacity(rm, gs)
    dispatch, combine, _, topv = ref_moe._dispatch_combine(
        jnp.asarray(probs), rm, C)
    table = _port_table(probs, mo, C)
    np.testing.assert_array_equal(table.numpy(), _ref_table(dispatch))
    # the combine weight of every filled slot is the normalised top-k value
    # of the token in it
    topi = moe.top_k(torch.from_numpy(probs), mo.top_k)[1]
    slot = moe.route(topi, mo.n_routed, C)
    np.testing.assert_allclose(
        np.asarray(combine).sum(axis=(2, 3)),
        np.where(slot.numpy() < C, np.asarray(topv), 0).sum(-1), rtol=0,
        atol=1e-7)
    if name == "overflow_every_k":
        kept = (slot < C).numpy()
        assert all((~kept[..., k]).any() for k in range(mo.top_k)), \
            "the setup must drop a choice at every rank"


@pytest.mark.parametrize("seed,E,K,S,C", [(0, 4, 2, 16, 3), (1, 8, 3, 24, 2),
                                          (2, 16, 6, 40, 5), (3, 64, 6, 96, 6),
                                          (4, 6, 4, 13, 1), (5, 8, 2, 64, 40)])
def test_slot_table_random_routes(seed, E, K, S, C):
    """Random router probabilities (two groups; a coarse grid, so ties
    occur) at capacities from 1 to past every demand: the port's slot
    table equals the reference's dispatch."""
    rng = np.random.default_rng(seed)
    probs = np.round(rng.random((2, S, E)) * 8).astype(np.float32) / 8
    fields = dict(n_routed=E, top_k=K, d_ff_expert=8, group_size=S)
    dispatch = ref_moe._dispatch_combine(jnp.asarray(probs),
                                         RefMoEConfig(**fields), C)[0]
    np.testing.assert_array_equal(
        _port_table(probs, MoEConfig(**fields), C).numpy(),
        _ref_table(dispatch))


def test_capacity_equals_reference():
    for e, k, cf in ((8, 2, 1.5), (64, 6, 1.25), (4, 3, 0.3), (16, 4, 1.0)):
        fields = dict(n_routed=e, top_k=k, d_ff_expert=8, capacity_factor=cf)
        for gs in (1, 2, 16, 24, 33, 2048):
            assert moe.capacity(MoEConfig(**fields), gs) == \
                ref_moe.capacity(RefMoEConfig(**fields), gs), (fields, gs)


def test_planted_ties_route_to_the_lowest_index():
    """Rows whose probabilities tie exactly (two, three or all experts)
    pick and queue experts as jax.lax.top_k does: the lower index first."""
    mo = MoEConfig(n_routed=4, top_k=2, d_ff_expert=8, group_size=8)
    rm = RefMoEConfig(n_routed=4, top_k=2, d_ff_expert=8, group_size=8)
    probs = np.full((1, 8, 4), 0.1, np.float32)
    probs[0, 0] = [0.2, 0.3, 0.3, 0.2]
    probs[0, 1] = [0.25, 0.25, 0.25, 0.25]
    probs[0, 2] = [0.4, 0.1, 0.4, 0.1]
    probs[0, 3] = [0.1, 0.1, 0.1, 0.7]
    probs[0, 4:] = [0.3, 0.2, 0.2, 0.3]
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 2)
    got_v, got_i = moe.top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    for C in (1, 2, 3):
        dispatch = ref_moe._dispatch_combine(jnp.asarray(probs), rm, C)[0]
        np.testing.assert_array_equal(_port_table(probs, mo, C).numpy(),
                                      _ref_table(dispatch))


def test_indivisible_tokens_raise():
    _, mo, _, tp, _ = _setup("shared_top2")
    x = torch.zeros((2, 40, D))               # 80 tokens, groups of 32
    with pytest.raises(ValueError, match="not divisible"):
        moe.moe_apply(tp, x, mo)


@pytest.mark.parametrize("name", list(SETUPS))
def test_forced_own_routes_are_bitwise_unforced(name):
    _, mo, _, tp, x = _setup(name)
    xt = torch.from_numpy(x)
    plain, plain_aux = moe.moe_apply(tp, xt, mo)
    tape = moe.RouteTape()
    rec, rec_aux = moe.moe_apply(tp, xt, mo, routes=tape)
    assert len(tape.recorded) == 1
    forced = moe.RouteTape(force=tape.recorded)
    got, got_aux = moe.moe_apply(tp, xt, mo, routes=forced)
    for a in (rec, got):
        assert torch.equal(a, plain)
    assert torch.equal(got_aux, plain_aux) and torch.equal(rec_aux, plain_aux)
    with pytest.raises(IndexError):          # one call recorded, one forced
        moe.moe_apply(tp, xt, mo, routes=forced)


def test_forced_routes_override_the_router():
    """Forcing another input's routes sends this input's tokens where the
    other's went, kept and dropped alike, weighted by this input's own
    router probabilities at those experts: equal, within TOL, to a token
    by token loop over the recorded routes."""
    _, mo, _, tp, x = _setup("overflow_every_k")
    tape = moe.RouteTape()
    moe.moe_apply(tp, torch.from_numpy(x), mo, routes=tape)
    (r,) = tape.recorded
    other = torch.from_numpy(x[::-1].copy())
    got, _ = moe.moe_apply(tp, other, mo,
                           routes=moe.RouteTape(force=tape.recorded))
    own, _ = moe.moe_apply(tp, other, mo)
    assert not torch.equal(got, own)

    def ffn(p, v, e=None):
        w = {k: p[k] if e is None else p[k][e] for k in
             ("w_in", "w_gate", "w_out")}
        return (torch.nn.functional.silu(v @ w["w_gate"]) * (v @ w["w_in"])
                ) @ w["w_out"]
    G, gs, K = r.topi.shape
    C = moe.capacity(mo, gs)
    xt = other.reshape(G, gs, D)
    probs = torch.softmax(xt @ tp["router"], -1)
    want = torch.zeros_like(xt)
    for g in range(G):
        for s in range(gs):
            w = probs[g, s, r.topi[g, s]]
            w = w / w.sum()
            for k in range(K):
                if r.slot[g, s, k] < C:
                    e = int(r.topi[g, s, k])
                    want[g, s] += w[k] * ffn(tp, xt[g, s], e)
            want[g, s] += ffn(tp["shared"], xt[g, s])
    np.testing.assert_allclose(got.numpy(), want.reshape(got.shape).numpy(),
                               rtol=0, atol=TOL)


def test_router_entropy_matches_reference():
    rm, mo, rp, tp, x = _setup("shared_top2")
    want = np.asarray(ref_moe.router_entropy(rp, jnp.asarray(x), rm))
    got = moe.router_entropy(tp, torch.from_numpy(x), mo)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
