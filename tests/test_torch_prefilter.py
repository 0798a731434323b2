"""The centroid-gated prefilter on the port (``prefilter: true``).

Summary construction and maintenance invariants; gated top-k and gated
greedy against the ``prefilter: false`` full-scan oracle inside the port
(bit for bit at a loose slack, and through a realistic script at the
default slack, as the reference's own tests hold it); and the port's
``pool_rows`` on a redundancy-heavy pool against repro's, which must
agree within 5 % (same MLP weights through the bridge, the reference's
draws injected, so both build their summaries from the same k-means
seeds; features and distances differ by fp32 ulps, which may move a row
across a cluster boundary or a bound).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import prefilter as pf
from repro_torch.core.selection import ShardView, replica_of
from repro_torch.core.strategies.uncertainty import SCORE_FNS
from repro_torch.kernels.pairwise import ops
from repro_torch.service.backends import MLPBackend
from repro_torch.service.config import ALServiceConfig
from repro_torch.service.server import ALServer

GATED = ("lc", "mc", "rc", "es", "kcg", "coreset")


def _mlp_server(replicas=1, backend=None, draws=None, **cfg):
    be = backend or MLPBackend(in_dim=192, feat_dim=32, device="cpu")
    return ALServer(ALServiceConfig(device="cpu", batch_size=16,
                                    replicas=replicas, **cfg),
                    backend=be, draws=draws)


def _vec_pool(n, seed=0, d=192):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _pair(replicas, n=96, seed=1, **pf_cfg):
    """(oracle, gated) servers fed the identical pool."""
    X = _vec_pool(n, seed)
    cfg = dict(prefilter=True, prefilter_min_rows=8, prefilter_clusters=6)
    cfg.update(pf_cfg)
    off = _mlp_server(replicas)
    on = _mlp_server(replicas, **cfg)
    keys = off.push_data(list(X))
    assert on.push_data(list(X)) == keys
    return off, on, keys, X


# ------------------------------------------------------ summary building --
def test_build_summary_partitions_rows_and_bounds_radii():
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(57, 16)).astype(np.float32)
    s = pf.build_summary(feats, k=5, salt="t")
    assert s.covered == 57 and s.starts[0] == 0 and s.starts[-1] == 57
    assert sorted(s.rowid.tolist()) == list(range(57))   # a permutation
    np.testing.assert_array_equal(s.xperm, feats[s.rowid])
    np.testing.assert_array_equal(s.xperm_dev.numpy(), feats[s.rowid])
    for j in range(s.k):
        seg = s.rowid[int(s.starts[j]):int(s.starts[j + 1])]
        assert np.all(np.diff(seg) > 0) or seg.size <= 1
        if seg.size:
            d2 = ((feats[seg].astype(np.float64) - s.cents[j]) ** 2).sum(-1)
            assert np.sqrt(d2).max() <= s.radii[j] + 1e-9
    s2 = pf.build_summary(feats, k=5, salt="t")           # deterministic
    np.testing.assert_array_equal(s.rowid, s2.rowid)


def test_summary_matches_reference_layout():
    """With the reference's draws the port lays the pool out in the same
    clusters as repro's ``build_summary``."""
    pytest.importorskip("jax")
    from repro.core import prefilter as ref_pf
    from test_torch_strategies import JaxDraws
    rng = np.random.default_rng(8)
    centers = rng.normal(size=(6, 24)) * 5
    feats = (centers[rng.integers(0, 6, 300)]
             + 0.1 * rng.normal(size=(300, 24))).astype(np.float32)
    want = ref_pf.build_summary(feats, k=6, salt="s/0")
    got = pf.build_summary(feats, k=6, salt="s/0", draws=JaxDraws())
    np.testing.assert_array_equal(got.starts, want.starts)
    np.testing.assert_array_equal(got.rowid, want.rowid)
    np.testing.assert_allclose(got.cents, want.cents, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.radii, want.radii, rtol=0, atol=1e-5)


def test_maintain_summary_epochs_and_caps_cow():
    cfg = pf.PrefilterConfig(clusters=4, min_rows=16)
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(40, 8)).astype(np.float32)
    probs = rng.dirichlet(np.ones(4), size=40).astype(np.float32)
    assert pf.maintain_summary(None, feats[:10], probs[:10], 0, cfg) is None
    s = pf.maintain_summary(None, feats[:24], probs[:24], 0, cfg)
    assert s is not None and s.covered == 24 and s.builds == 1
    assert s.caps is not None and s.caps_head_epoch == 0
    assert pf.maintain_summary(s, feats[:30], probs[:30], 0, cfg) is s
    s2 = pf.maintain_summary(s, feats[:30], probs[:30], 1, cfg)
    assert s2 is not s and s2.xperm is s.xperm and s2.builds == s.builds
    assert s2.xperm_dev is s.xperm_dev          # no second device copy
    assert s.caps_head_epoch == 0 and s2.caps_head_epoch == 1
    small = pf.maintain_summary(None, feats[:17], probs[:17], 0, cfg)
    big = pf.maintain_summary(small, feats, probs, 0, cfg)
    assert big.covered == 40 and big.builds == 2
    for kind, fn in SCORE_FNS.items():
        sc = fn(torch.from_numpy(probs[:s.covered])).numpy()
        for j in range(s.k):
            seg = s.rowid[int(s.starts[j]):int(s.starts[j + 1])]
            if seg.size:
                assert s.caps[kind][j] == sc[seg].max(), (kind, j)


def test_auto_k_clamps():
    assert pf.PrefilterConfig().auto_k(100_000) == 64
    assert pf.PrefilterConfig().auto_k(300) == 4
    assert pf.PrefilterConfig(clusters=9).auto_k(5) == 5
    assert pf.PrefilterConfig().auto_k(1) == 1


# ------------------------------------------- bit-identity vs the oracle --
def test_gated_top_k_equals_the_full_scan():
    """Function level, ties included: the cap-ordered scan returns the
    full scan's (indices, values) exactly."""
    rng = np.random.default_rng(5)
    n, d = 240, 8
    feats = rng.normal(size=(n, d)).astype(np.float32)
    probs = rng.dirichlet(np.ones(4), size=n).astype(np.float32)
    probs[100] = probs[7]                         # an exact score tie
    keys = [f"k{i}" for i in range(n)]
    shards = []
    for si in range(3):
        g = np.asarray([i for i, k in enumerate(keys)
                        if replica_of(k, 3) == si], np.int64)
        summ = pf.build_summary(feats[g], k=6, salt=f"x/{si}")
        summ = summ.with_caps(probs[g], head_epoch=0)
        shards.append(ShardView(feats=feats[g], probs=probs[g], gidx=g,
                                summary=summ, pool_rows=np.arange(g.size),
                                pool_feats=feats[g], probs_epoch=0))
    for kind in SCORE_FNS:
        full = torch.sort(SCORE_FNS[kind](torch.from_numpy(probs)),
                          descending=True, stable=True)
        with ops.track_ops() as st:
            idx, vals = pf.gated_top_k(shards, kind, 12)
        assert idx.tolist() == full.indices[:12].tolist(), kind
        assert vals.tolist() == full.values[:12].tolist(), kind
        assert dict(st)["pool_rows"] <= n


@pytest.mark.parametrize("replicas", (1, 3))
def test_gated_selections_bit_identical(replicas):
    off, on, keys, X = _pair(replicas, n=96)
    for srv in (off, on):
        srv.label(keys[:20], [i % 4 for i in range(20)])
        srv.train_and_eval()
    for s in GATED:
        assert on.query(budget=7, strategy=s, rng_seed=5)["keys"] == \
            off.query(budget=7, strategy=s, rng_seed=5)["keys"], s
    X2 = _vec_pool(24, seed=9)          # tail rows after the summary build
    for srv in (off, on):
        srv.push_data(list(X2))
    for s in GATED:
        assert on.query(budget=7, strategy=s, rng_seed=8)["keys"] == \
            off.query(budget=7, strategy=s, rng_seed=8)["keys"], s
    assert max(on.stats()["artifacts"]["summary_builds"]) >= 1
    on.close(), off.close()


def test_loose_slack_is_the_full_scan():
    off, on, keys, _ = _pair(3, n=80, prefilter_slack=1e9)
    for srv in (off, on):
        srv.label(keys[:16], [i % 4 for i in range(16)])
        srv.train_and_eval()
    for s in GATED:
        assert on.query(budget=9, strategy=s, rng_seed=2)["keys"] == \
            off.query(budget=9, strategy=s, rng_seed=2)["keys"], s
    on.close(), off.close()


def test_prefilter_ignored_by_weighted_strategies():
    off, on, keys, _ = _pair(3, n=72)
    for srv in (off, on):
        srv.label(keys[:16], [i % 4 for i in range(16)])
        srv.train_and_eval()
    for s in ("badge", "margin_density", "weighted_kcenter"):
        assert on.query(budget=5, strategy=s, rng_seed=4)["keys"] == \
            off.query(budget=5, strategy=s, rng_seed=4)["keys"], s
    on.close(), off.close()


@pytest.mark.parametrize("n,cfg,strategies", [
    (2, dict(prefilter_min_rows=1, prefilter_clusters=2), ("lc", "kcg")),
    (10, dict(prefilter_min_rows=1, prefilter_clusters=64), GATED),
])
def test_degenerate_shards(n, cfg, strategies):
    """Empty shards (pool smaller than the replica count) and shards
    smaller than one centroid per row still agree with the oracle."""
    off, on, keys, _ = _pair(3, n=n, **cfg)
    for s in strategies:
        b = min(4, n)
        assert on.query(budget=b, strategy=s, rng_seed=3)["keys"] == \
            off.query(budget=b, strategy=s, rng_seed=3)["keys"], s
    on.close(), off.close()


def test_all_rows_labeled_and_below_min_rows():
    off, on, keys, _ = _pair(1, n=24, prefilter_min_rows=1)
    for srv in (off, on):
        srv.label(keys, [i % 4 for i in range(len(keys))])
        srv.train_and_eval()
    assert on.query(budget=4, strategy="lc")["keys"] == \
        off.query(budget=4, strategy="lc")["keys"] == []
    off2, on2, _, _ = _pair(1, n=40, prefilter_min_rows=4096)
    assert on2.stats()["artifacts"]["summary_builds"] == [0]
    for s in ("lc", "kcg"):
        assert on2.query(budget=5, strategy=s, rng_seed=6)["keys"] == \
            off2.query(budget=5, strategy=s, rng_seed=6)["keys"], s
    for srv in (off, on, off2, on2):
        srv.close()


# ------------------------------------------- pool_rows vs the reference --
def _dupe_pool(n, clumps, d, seed=11):
    """Redundancy-heavy vector pool (the reference benchmark's recipe):
    97 % near-duplicates in ``clumps`` tight clusters, 3 % spread wide,
    shuffled."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(clumps, d)) * 6.0
    n_dupe = int(n * 0.97)
    assign = rng.integers(0, clumps, size=n_dupe)
    dup = centers[assign] + 0.03 * rng.normal(size=(n_dupe, d))
    spread = 8.0 * rng.normal(size=(n - n_dupe, d))
    x = np.concatenate([dup, spread]).astype(np.float32)
    clump_of = np.concatenate([assign, np.full(n - n_dupe, -1)])
    perm = rng.permutation(n)
    return x[perm], clump_of[perm]


def test_pool_rows_match_reference_on_a_redundant_pool():
    pytest.importorskip("jax")
    from repro.kernels.pairwise import ops as ref_ops
    from repro.service.backends import MLPBackend as RefMLP
    from repro.service.config import ALServiceConfig as RefConfig
    from repro.service.server import ALServer as RefServer
    from repro_torch import bridge
    from test_torch_strategies import JaxDraws
    n, clumps, d = 1536, 16, 192
    X, clump_of = _dupe_pool(n, clumps, d)
    lab = [int(m) for c in range(clumps)
           for m in np.nonzero(clump_of == c)[0][:4]]
    cfg = dict(batch_size=64, replicas=3, prefilter=True,
               prefilter_clusters=32, prefilter_min_rows=64)
    ref_be = RefMLP(in_dim=d, feat_dim=32)
    be = MLPBackend(in_dim=d, feat_dim=32, device="cpu")
    bridge.load_mlp(be, np.asarray(ref_be.w1), np.asarray(ref_be.w2))
    h0 = ref_be.init_head()
    bridge.set_initial_head(be, np.asarray(h0.w), np.asarray(h0.b))
    servers = {"ref": (RefServer(RefConfig(**cfg), backend=ref_be), ref_ops),
               "port": (ALServer(ALServiceConfig(device="cpu", **cfg),
                                 backend=be, draws=JaxDraws()), ops)}
    rows, picks = {}, {}
    for name, (srv, o) in servers.items():
        keys = srv.push_data(list(X))
        srv.label([keys[i] for i in lab], [i % 4 for i in range(len(lab))])
        srv.train_and_eval()
        srv.query(budget=1, strategy="lc")          # warm: summaries, state
        srv.query(budget=1, strategy="coreset")
        for strat, budget in (("lc", 16), ("es", 16), ("coreset", 24),
                              ("kcg", 24)):
            with o.track_ops() as st:
                picks[name, strat] = srv.query(budget=budget, strategy=strat,
                                               rng_seed=7)["keys"]
            rows[name, strat] = dict(st)["pool_rows"]
    servers["port"][0].close()
    for strat in ("lc", "es", "coreset", "kcg"):
        r, p = rows["ref", strat], rows["port", strat]
        assert abs(p - r) <= 0.05 * r, (strat, p, r)
    assert picks["port", "lc"] == picks["ref", "lc"]
    # the gated lc scan scores a fraction of the unlabeled rows, where the
    # full scan scores every one of them
    assert rows["port", "lc"] * 5 < n - len(lab), rows["port", "lc"]
