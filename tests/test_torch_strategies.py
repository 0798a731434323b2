"""Port parity: every zoo strategy's ``select`` in repro_torch against
repro's, on the same features and probs (numpy seeds) and the same random
draws (the draw seam, fed by ``jax.random`` here). Indices must be
identical: the tolerance is zero.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.strategies import zoo as ref_zoo  # noqa: E402
from repro_torch.common import rng as rnglib  # noqa: E402
from repro_torch.core.strategies import base, zoo  # noqa: E402


class JaxDraws:
    """The draw seam backed by ``jax.random``: the reference's own calls."""

    def key(self, seed):
        return jax.random.PRNGKey(seed)

    def split(self, key, n):
        return list(jax.random.split(key, n))

    def randint(self, key, low, high):
        return int(jax.random.randint(key, (), low, high))

    def categorical(self, key, logits):
        return int(jax.random.categorical(key, jnp.asarray(
            logits.detach().cpu().numpy())))

    def gumbel(self, key, n, device):
        return torch.from_numpy(np.array(
            jax.random.gumbel(key, (n,), jnp.float32))).to(device)

    def choice(self, key, n, size):
        return torch.from_numpy(np.asarray(jax.random.choice(
            key, n, (size,), replace=False)).astype(np.int64))

    def permutation(self, key, n):
        return torch.from_numpy(
            np.asarray(jax.random.permutation(key, n)).astype(np.int64))


def _artifacts(seed, n=300, c=10, d=16, n_lab=9):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n, c)) * 2
    probs = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(
        np.float32)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    lab = rng.normal(size=(n_lab, d)).astype(np.float32)
    return probs, emb, lab


def _select_both(name, seed, budget, probs, emb, lab):
    ref = np.asarray(ref_zoo.get_strategy(name).select(
        jax.random.PRNGKey(seed), budget, probs=jnp.asarray(probs),
        embeddings=jnp.asarray(emb),
        labeled_embeddings=None if lab is None else jnp.asarray(lab)))
    port = zoo.get_strategy(name).select(
        rnglib.key(seed, JaxDraws()), budget, probs=torch.from_numpy(probs),
        embeddings=torch.from_numpy(emb),
        labeled_embeddings=None if lab is None else torch.from_numpy(lab))
    return ref, port.numpy()


@pytest.mark.parametrize("name", sorted(ref_zoo.ZOO))
@pytest.mark.parametrize("seed", [0, 3])
def test_select_matches_reference(name, seed):
    probs, emb, lab = _artifacts(seed)
    ref, port = _select_both(name, seed, 10, probs, emb, lab)
    np.testing.assert_array_equal(port, ref)
    assert len(set(port.tolist())) == 10


def test_zoo_names_match_reference():
    assert sorted(zoo.ZOO) == sorted(ref_zoo.ZOO)
    assert zoo.PAPER_SEVEN == ref_zoo.PAPER_SEVEN
    assert zoo.HYBRIDS == ref_zoo.HYBRIDS


@pytest.mark.parametrize("name", ["coreset", "weighted_kcenter"])
def test_warm_start_with_one_center_tail_matches_reference(name):
    """513 labeled centers at r_block 512: the last chunk holds one center
    and takes the difference form, in both packages."""
    probs, emb, _ = _artifacts(4, n=200)
    lab = np.random.default_rng(5).normal(size=(513, 16)).astype(np.float32)
    ref, port = _select_both(name, 2, 8, probs, emb, lab)
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("name", ["lc", "mc", "rc", "es"])
def test_uncertainty_ties_break_to_lower_index(name):
    """Rows with identical probs tie exactly; lax.top_k's rule (higher
    value first, lower index on ties) must hold in the port."""
    probs, _, _ = _artifacts(6, n=120)
    probs[40:80] = probs[3]            # 40 exact ties with row 3
    ref = np.asarray(ref_zoo.get_strategy(name).select(
        jax.random.PRNGKey(0), 10, probs=jnp.asarray(probs)))
    port = zoo.get_strategy(name).select(
        rnglib.key(0), 10, probs=torch.from_numpy(probs)).numpy()
    np.testing.assert_array_equal(port, ref)


def test_top_k_select_is_stable():
    s = torch.tensor([0.5, 0.9, 0.5, 0.9, 0.1])
    assert base.top_k_select(s, 4).tolist() == [1, 3, 0, 2]


def test_unit_weights_match_reference():
    from repro.core.strategies import base as ref_base
    s = np.random.default_rng(8).normal(size=50).astype(np.float32)
    np.testing.assert_allclose(
        base.unit_weights(torch.from_numpy(s)).numpy(),
        np.asarray(ref_base.unit_weights(jnp.asarray(s))), rtol=0, atol=1e-6)


def test_select_sharded_is_not_ported():
    with pytest.raises(NotImplementedError, match="A5"):
        zoo.get_strategy("kcg").select_sharded(rnglib.key(0), 3, [])


def test_torch_draws_are_deterministic_and_device_free():
    d = rnglib.DEFAULT_DRAWS
    k = rnglib.key(11)
    a, b = rnglib.split(k, 2)
    assert a != b and rnglib.split(k, 2) == [a, b]
    assert rnglib.randint(a, 0, 100) == rnglib.randint(a, 0, 100)
    g = rnglib.gumbel(b, 64, "cpu")
    assert g.dtype == torch.float32 and torch.isfinite(g).all()
    assert torch.equal(g, rnglib.gumbel(b, 64, "cpu"))
    c = rnglib.choice(a, 50, 20)
    assert len(set(c.tolist())) == 20 and int(c.max()) < 50
    assert sorted(rnglib.permutation(a, 30).tolist()) == list(range(30))
    logits = torch.full((5,), -1e9)
    logits[2] = 0.0
    assert rnglib.categorical(a, logits) == 2
    assert k.draws is d
