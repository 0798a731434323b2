"""Persisted k-center state on the port (``KCenterStateCache``): warm
selections with the session's persisted min-dist vectors equal the
``strategy_state_cache: false`` from-scratch oracle across pushes, labels
and retrains (exactly: same keys), and the cache's counters follow the
reference's invalidation matrix — the same counts as repro's server on
the same script.
"""
import numpy as np
import pytest

from repro_torch.core.selection import KCenterStateCache, replica_of
from repro_torch.data.synthetic import image_pool
from repro_torch.service.backends import MLPBackend
from repro_torch.service.config import ALServiceConfig
from repro_torch.service.server import ALServer


def _mlp_server(replicas=1, **cfg):
    return ALServer(ALServiceConfig(device="cpu", batch_size=16,
                                    replicas=replicas, **cfg),
                    backend=MLPBackend(in_dim=192, feat_dim=32,
                                       device="cpu"))


@pytest.mark.parametrize("replicas", (1, 3))
@pytest.mark.parametrize("strategy", ("coreset", "weighted_kcenter"))
def test_persisted_state_bit_identical_to_cold(replicas, strategy):
    X, Y = image_pool(56, seed=14)
    warm = _mlp_server(replicas)
    cold = _mlp_server(replicas, strategy_state_cache=False)
    for srv in (warm, cold):
        keys = srv.push_data(list(X[:40]))
        srv.label(keys[:10], Y[:10])
        srv.train_and_eval()
    for seed in (0, 1):
        assert warm.query(budget=6, strategy=strategy,
                          rng_seed=seed)["keys"] == \
            cold.query(budget=6, strategy=strategy, rng_seed=seed)["keys"]
    st = warm.stats()["strategy_state"]
    assert st["enabled"] and st["rebuilds"] >= 1 and st["hits"] >= 1
    assert cold.stats()["strategy_state"]["rebuilds"] == 0
    for srv in (warm, cold):
        srv.push_data(list(X[40:]))
    assert warm.query(budget=6, strategy=strategy, rng_seed=2)["keys"] == \
        cold.query(budget=6, strategy=strategy, rng_seed=2)["keys"]
    st2 = warm.stats()["strategy_state"]
    assert st2["extends"] >= 1 and st2["rebuilds"] == st["rebuilds"]
    assert st2["rows_extended"] >= 16
    for srv in (warm, cold):
        srv.label(keys[10:16], Y[10:16])
        srv.train_and_eval()
    assert warm.query(budget=6, strategy=strategy, rng_seed=3)["keys"] == \
        cold.query(budget=6, strategy=strategy, rng_seed=3)["keys"]
    for srv in (warm, cold):
        srv.close()


def _matrix_script(srv):
    """push -> label -> train -> query; push; train; label: the counters
    after each step."""
    X, Y = image_pool(48, seed=15)
    keys = srv.push_data(list(X[:36]))
    srv.label(keys[:8], Y[:8])
    srv.train_and_eval()
    srv.query(budget=4, strategy="coreset")
    steps = [dict(srv.stats()["strategy_state"])]
    e0 = srv.embed_rows
    new_keys = srv.push_data(list(X[36:]))
    srv.query(budget=4, strategy="coreset")
    steps.append(dict(srv.stats()["strategy_state"]))
    pushed = srv.embed_rows - e0
    e1 = srv.embed_rows
    srv.train_and_eval()
    srv.query(budget=4, strategy="coreset")
    steps.append(dict(srv.stats()["strategy_state"]))
    srv.label(new_keys[:4], Y[36:40])
    srv.query(budget=4, strategy="coreset")
    steps.append(dict(srv.stats()["strategy_state"]))
    for s in steps:
        s.pop("enabled", None)
    return steps, new_keys, pushed, srv.embed_rows - e1


def test_state_invalidation_matrix():
    """push extends only the touched shards; train drops every shard's
    vector and re-embeds nothing; label drops nothing (center extends)."""
    srv = _mlp_server(3)
    steps, new_keys, pushed, after_train = _matrix_script(srv)
    s0, s1, s2, s3 = steps
    assert s0["rebuilds"] == 3
    touched = {replica_of(k, 3) for k in new_keys}
    assert pushed == 12
    assert s1["rebuilds"] == s0["rebuilds"]
    assert s1["invalidations"] == s0["invalidations"]
    assert s1["extends"] - s0["extends"] == len(touched)
    assert s1["rows_extended"] - s0["rows_extended"] == 12
    assert after_train == 0
    assert s2["invalidations"] > s1["invalidations"]
    assert s2["rebuilds"] == s1["rebuilds"] + 3
    assert s3["invalidations"] == s2["invalidations"]
    assert s3["rebuilds"] == s2["rebuilds"]
    assert s3["center_extends"] - s2["center_extends"] == 3
    srv.close()


def test_state_counters_match_reference():
    pytest.importorskip("jax")
    from repro.service.backends import MLPBackend as RefMLP
    from repro.service.config import ALServiceConfig as RefConfig
    from repro.service.server import ALServer as RefServer
    ref = RefServer(RefConfig(batch_size=16, replicas=3),
                    backend=RefMLP(in_dim=192, feat_dim=32))
    port = _mlp_server(3)
    assert _matrix_script(port)[0] == _matrix_script(ref)[0]
    port.close()


def test_prepare_folds_deltas_exactly():
    """Function level: extend by rows, extend by centers, and reorder
    (rebuild) each equal a from-scratch fold bit for bit."""
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(50, 12)).astype(np.float32)
    cache = KCenterStateCache()
    locs = [(0, i) for i in range(5)]

    def prep(rows, k, order=None):
        ls = [locs[i] for i in (order or range(k))]
        return cache.prepare(feats_l=[feats], rows_l=[rows], lineages=[0],
                             head_version=0, locs=ls,
                             centers=feats[[li for _, li in ls]])

    def scratch(rows, k, order=None):
        return KCenterStateCache().prepare(
            feats_l=[feats], rows_l=[rows], lineages=[0], head_version=0,
            locs=[locs[i] for i in (order or range(k))],
            centers=feats[[li for _, li in (locs[i] for i in
                                             (order or range(k)))]])

    for rows, k in ((30, 3), (50, 3), (50, 5)):
        np.testing.assert_array_equal(prep(rows, k).minds[0],
                                      scratch(rows, k).minds[0])
    c = cache.stats()
    assert c["rebuilds"] == 1 and c["extends"] == 1 and \
        c["center_extends"] == 1
    assert prep(50, 5, order=[1, 0, 2, 3, 4]).minds[0].shape == (50,)
    assert cache.stats()["rebuilds"] == 2          # non-prefix: rebuilt
    assert prep(50, 0) is None
