"""Replica sharding on the port (``replicas: N``).

Every zoo strategy's sharded selection must equal the port's own
single-pool ``select`` bit for bit across shard counts, ragged pools and
empty shards (the reference's internal oracle, held inside the port), and
must select the same indices as repro's ``select_sharded`` on the same
numpy features and probs with the reference's draws injected. Servers at
``replicas: 3`` select the same keys as servers at ``replicas: 1``, and as
a repro server at ``replicas: 3`` fed the same pushes (weights through the
bridge). Tolerance: none — indices and keys are compared exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch.common import rng as rnglib
from repro_torch.core.selection import (ShardView, gather_rows, locate_row,
                                        replica_of, replica_top_k)
from repro_torch.core.strategies.zoo import SHARDED_COMPLETE, ZOO
from repro_torch.data.synthetic import image_pool
from repro_torch.service.backends import MLPBackend
from repro_torch.service.config import ALServiceConfig
from repro_torch.service.server import ALServer

REPLICAS = (1, 2, 3, 7)
STRATEGIES = sorted(ZOO)


def _mlp_server(replicas, backend=None, draws=None, **cfg):
    be = backend or MLPBackend(in_dim=192, feat_dim=32, device="cpu")
    return ALServer(ALServiceConfig(device="cpu", batch_size=16,
                                    replicas=replicas, **cfg),
                    backend=be, draws=draws)


def _make_shards(feats, probs, keys, replicas, view=ShardView):
    """Hash-partition a pool the way the session does: shard-local rows
    keep global order."""
    shards = []
    for s in range(replicas):
        g = np.asarray([i for i, k in enumerate(keys)
                        if replica_of(k, replicas) == s], np.int64)
        shards.append(view(feats=feats[g] if g.size else feats[:0],
                           probs=probs[g] if g.size else probs[:0], gidx=g))
    return shards


@pytest.fixture(scope="module")
def pool_artifacts():
    """A ragged-size pool with probs/embeddings + labeled rows."""
    rng = np.random.default_rng(7)
    N, d, C = 61, 16, 10
    feats = rng.standard_normal((N, d)).astype(np.float32)
    logits = rng.standard_normal((N, C))
    probs = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(
        np.float32)
    labeled = rng.standard_normal((7, d)).astype(np.float32)
    keys = [f"pool-{i}" for i in range(N)]
    return feats, probs, labeled, keys


def _single(strategy, seed, budget, feats, probs, labeled, draws=None):
    strat = ZOO[strategy]
    return np.asarray(strat.select(
        rnglib.key(seed, draws), budget,
        probs=torch.from_numpy(probs) if "probs" in strat.needs else None,
        embeddings=(torch.from_numpy(feats) if "embeddings" in strat.needs
                    else None),
        labeled_embeddings=(torch.from_numpy(labeled) if labeled is not None
                            and "embeddings" in strat.needs else None)))


# ----------------------------------------------------- merge primitives --
def test_replica_top_k_matches_a_stable_sort_with_ties():
    rng = np.random.default_rng(0)
    scores = (rng.integers(0, 5, size=97) / 4.0).astype(np.float32)
    keys = [f"t{i}" for i in range(97)]
    feats = rng.standard_normal((97, 4)).astype(np.float32)
    order = torch.sort(torch.from_numpy(scores), descending=True,
                       stable=True)
    for r in REPLICAS:
        shards = _make_shards(feats, feats, keys, r)
        sc = [torch.from_numpy(scores[s.gidx]) for s in shards]
        gidx, vals = replica_top_k(shards, sc, 10)
        assert gidx.tolist() == order.indices[:10].tolist(), r
        assert vals.tolist() == order.values[:10].tolist(), r


def test_locate_and_gather_rows():
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((31, 8)).astype(np.float32)
    keys = [f"g{i}" for i in range(31)]
    shards = _make_shards(feats, feats, keys, 4)
    rows = [0, 30, 17, 17, 5]
    np.testing.assert_array_equal(gather_rows(shards, rows), feats[rows])
    for g in rows:
        si, li = locate_row(shards, g)
        assert int(shards[si].gidx[li]) == g
    with pytest.raises(IndexError):
        locate_row(shards, 31)
    assert gather_rows(shards, []).shape == (0, 8)


def test_every_zoo_strategy_has_a_sharded_path():
    assert SHARDED_COMPLETE
    assert all(ZOO[s].sharded_fn is not None for s in ZOO)


# ------------------------------------------- strategy-level equivalence --
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sharded_strategy_bit_identical(strategy, pool_artifacts):
    feats, probs, labeled, keys = pool_artifacts
    single = _single(strategy, 3, 6, feats, probs, labeled)
    lab = torch.from_numpy(labeled) \
        if "embeddings" in ZOO[strategy].needs else None
    for r in REPLICAS:
        sharded = np.asarray(ZOO[strategy].select_sharded(
            rnglib.key(3), 6, _make_shards(feats, probs, keys, r),
            labeled_embeddings=lab))
        assert sharded.tolist() == single.tolist(), \
            f"{strategy} diverged at replicas={r}"


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sharded_strategy_empty_shard_edge(strategy):
    """Pool smaller than the shard count: some shards are empty and must
    neither crash nor perturb the merge."""
    rng = np.random.default_rng(11)
    N, d, C = 5, 16, 10
    feats = rng.standard_normal((N, d)).astype(np.float32)
    logits = rng.standard_normal((N, C))
    probs = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(
        np.float32)
    keys = [f"tiny-{i}" for i in range(N)]
    shards = _make_shards(feats, probs, keys, 7)
    assert any(s.n == 0 for s in shards), "edge requires an empty shard"
    single = _single(strategy, 9, 3, feats, probs, None)
    sharded = np.asarray(ZOO[strategy].select_sharded(rnglib.key(9), 3,
                                                      shards))
    assert sharded.tolist() == single.tolist()


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sharded_strategy_matches_reference(strategy, pool_artifacts):
    """repro's ``select_sharded`` at replicas 3 on the same numpy inputs,
    the reference's draws injected into the port: the same indices."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.selection import ShardView as RefShardView
    from repro.core.strategies.zoo import ZOO as REF_ZOO
    from test_torch_strategies import JaxDraws
    feats, probs, labeled, keys = pool_artifacts
    warm = "embeddings" in ZOO[strategy].needs
    want = np.asarray(REF_ZOO[strategy].select_sharded(
        jax.random.PRNGKey(5), 6,
        _make_shards(feats, probs, keys, 3, view=RefShardView),
        labeled_embeddings=jnp.asarray(labeled) if warm else None))
    got = np.asarray(ZOO[strategy].select_sharded(
        rnglib.key(5, JaxDraws()), 6, _make_shards(feats, probs, keys, 3),
        labeled_embeddings=torch.from_numpy(labeled) if warm else None))
    assert got.tolist() == want.tolist()


# --------------------------------------------- server-level equivalence --
@pytest.fixture(scope="module")
def servers():
    """One port server per shard count, identically populated (same
    pushes, labels and head training)."""
    X, Y = image_pool(53, seed=5)
    out = {}
    for r in REPLICAS:
        srv = _mlp_server(r)
        keys = srv.push_data(list(X))
        srv.label(keys[:11], Y[:11])
        srv.train_and_eval()
        out[r] = srv
    yield out
    for srv in out.values():
        srv.close()


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_server_query_bit_identical_across_replicas(strategy, servers):
    ref = servers[1].query(budget=5, strategy=strategy, rng_seed=4)
    for r in REPLICAS[1:]:
        res = servers[r].query(budget=5, strategy=strategy, rng_seed=4)
        assert res["keys"] == ref["keys"], f"replicas={r}"
        assert res["indices"] == ref["indices"], f"replicas={r}"
    st = servers[3].stats()
    assert st["replicas"] == 3 and st["workers"]["backend"] == "thread"
    assert st["workers"]["lanes"] == 3 and st["workers"]["tasks"] > 0


def test_server_budget_exceeding_pool_across_replicas(servers):
    ref = servers[1].query(budget=500, strategy="lc", rng_seed=0)
    assert len(ref["keys"]) == 53 - 11
    for r in REPLICAS[1:]:
        assert servers[r].query(budget=500, strategy="lc",
                                rng_seed=0)["keys"] == ref["keys"]


def test_server_replicas_3_matches_reference_server():
    """repro and repro_torch servers at replicas 3 (the reference's MLP
    weights and initial head through the bridge, its draws injected), fed
    the same pushes, labels and training: the same keys."""
    pytest.importorskip("jax")
    from repro.service.backends import MLPBackend as RefMLP
    from repro.service.config import ALServiceConfig as RefConfig
    from repro.service.server import ALServer as RefServer
    from repro_torch import bridge
    from test_torch_strategies import JaxDraws
    ref_be = RefMLP(in_dim=192, feat_dim=32)
    be = MLPBackend(in_dim=192, feat_dim=32, device="cpu")
    bridge.load_mlp(be, np.asarray(ref_be.w1), np.asarray(ref_be.w2))
    h0 = ref_be.init_head()
    bridge.set_initial_head(be, np.asarray(h0.w), np.asarray(h0.b))
    ref = RefServer(RefConfig(batch_size=16, replicas=3), backend=ref_be)
    port = _mlp_server(3, backend=be, draws=JaxDraws())
    X, Y = image_pool(64, seed=12)
    keys = ref.push_data(list(X))
    assert port.push_data(list(X)) == keys
    for srv in (ref, port):
        srv.label(keys[:12], Y[:12])
        srv.train_and_eval()
    try:
        for strategy in ("lc", "es", "kcg", "coreset", "dbal", "badge"):
            assert port.query(budget=6, strategy=strategy,
                              rng_seed=2)["keys"] == \
                ref.query(budget=6, strategy=strategy,
                          rng_seed=2)["keys"], strategy
    finally:
        port.close()


def test_sharded_artifact_cache_hits_and_invalidation():
    X, Y = image_pool(30, seed=6)
    srv = _mlp_server(3)
    keys = srv.push_data(list(X))
    sess = srv.session()
    srv.query(budget=4, strategy="lc")
    srv.query(budget=4, strategy="kcg")
    assert sess.artifact_builds == 1          # per-shard set built once
    srv.label(keys[:6], Y[:6])                # label: NO shard invalidated
    srv.query(budget=4, strategy="lc")
    assert sess.artifact_builds == 1
    X2, _ = image_pool(6, seed=16)
    new_keys = srv.push_data(list(X2))        # delta: only touched shards
    touched = {replica_of(k, 3) for k in new_keys}
    before = [c.builds for c in sess._columns]
    srv.query(budget=4, strategy="lc")
    assert sess.artifact_builds == 2
    after = [c.builds for c in sess._columns]
    assert {si for si in range(3) if after[si] > before[si]} == touched
    srv.close()


def test_sharded_async_ingest_and_tiny_cache():
    """Async pushes drain per shard on the worker lanes; with a cache too
    small to hold the pool, per-shard builds re-embed evicted rows from
    the raw copies and still select like a roomy server."""
    X, Y = image_pool(60, seed=8)
    roomy = _mlp_server(3)
    tiny = _mlp_server(3, cache_bytes=10 * 32 * 4)   # ~10 of 60 feats fit
    tickets = [tiny.push_data(list(X[i:i + 7]), asynchronous=True)
               for i in range(0, 60, 7)]
    tiny.flush()
    keys = [k for t in tickets for k in t.keys]
    assert roomy.push_data(list(X)) == keys
    assert tiny.stats()["pool"] == 60 and tiny.cache.stats()["entries"] < 60
    for strategy in ("lc", "kcg"):
        assert tiny.query(budget=6, strategy=strategy)["keys"] == \
            roomy.query(budget=6, strategy=strategy)["keys"]
    for srv in (roomy, tiny):
        srv.close()


@pytest.mark.parametrize("replicas", [1, 2])
def test_shard_executor_is_the_shard_runtime(replicas):
    """``shard_executor`` is the back-compat alias of ``shard_runtime``:
    the same pool at ``replicas: 2``, None at ``replicas: 1`` as the
    reference's."""
    srv = _mlp_server(replicas)
    try:
        assert srv.shard_executor() is srv.shard_runtime()
        if replicas == 1:
            pytest.importorskip("jax")
            from repro.service.config import ALServiceConfig as RefConfig
            from repro.service.server import ALServer as RefServer
            ref = RefServer(RefConfig(replicas=1))
            assert srv.shard_executor() is None
            assert ref.shard_executor() is None
        else:
            assert srv.shard_executor() is not None
    finally:
        srv.close()
