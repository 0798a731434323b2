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
from repro_torch.kernels.pairwise import autotune, ops
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
    # the device layout: each segment padded with zero rows to gate blocks
    lay = s.xgate_dev.numpy()
    np.testing.assert_array_equal(lay[s.gpos], feats[s.rowid])
    assert lay.shape[0] == s.gstarts[-1] and s.gstarts[-1] % pf.GATE_ROWS == 0
    assert not np.delete(lay, s.gpos, axis=0).any()
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
    assert s2.xgate_dev is s.xgate_dev          # no second device copy
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


# ------------------------------------ the engine against its per-segment oracle --
class SegmentOracle:
    """The per-segment gated k-center engine the wave engine replaces:
    one fused round per pending entry per folded slice, padded to
    ``pf._bucket`` rows (the reference's loop, ``repro/core/prefilter.py``),
    with the segments it folds recorded in order."""

    def __init__(self, shard, slack):
        self.slack = float(slack)
        self.summary = shard.summary
        feats = shard.pool_feats
        self.pool_feats = feats
        n_pool = int(feats.shape[0])
        pool_rows = np.asarray(shard.pool_rows)
        self.gpos = np.full(n_pool, -1, np.int64)
        self.gpos[pool_rows] = np.asarray(shard.gidx)
        in_view = np.zeros(n_pool, bool)
        in_view[pool_rows] = True
        self.entries = []
        summ = self.summary
        self.covered = 0 if summ is None else min(summ.covered, n_pool)
        if summ is not None:
            k = summ.k
            self.starts = np.asarray(summ.starts)
            self.rowid = np.asarray(summ.rowid)
            self.xperm = torch.from_numpy(np.asarray(summ.xperm))
            self.inv_perm = np.empty(self.covered, np.int64)
            self.inv_perm[self.rowid] = np.arange(self.covered)
            view_perm = in_view[self.rowid]
            self.mind_x = torch.from_numpy(
                np.where(view_perm, pf.BIG, -1.0).astype(np.float32))
            self.seg_alive = np.array(
                [int(view_perm[int(self.starts[j]):
                               int(self.starts[j + 1])].sum())
                 for j in range(k)])
            self.seg_pending = np.zeros(k, np.int64)
            self.T_sqrt = np.full(k, np.inf, np.float64)
            self.M = np.full(k, np.inf, np.float64)
        self.tail_mind = torch.from_numpy(np.where(
            in_view[self.covered:], pf.BIG, -1.0).astype(np.float32))
        self.tail_x = torch.from_numpy(
            np.asarray(feats[self.covered:], np.float32))
        self.tail_alive = int(in_view[self.covered:].sum())
        self.tail_pending = 0
        self.last_folded = []

    def row_vec(self, pool_row):
        return np.asarray(self.pool_feats[pool_row], np.float32)

    def _queue(self, batch):
        self.entries.append(torch.from_numpy(np.ascontiguousarray(batch)))
        if self.summary is None:
            return
        c = np.asarray(batch, np.float64)
        diff = self.summary.cents[:, None, :] - c[None, :, :]
        d2 = np.einsum("krd,krd->kr", diff, diff)
        t = np.sqrt(d2) + self.summary.radii[:, None]
        self.T_sqrt = np.minimum(self.T_sqrt, t.min(axis=1))

    def add_center(self, vec):
        self._queue(np.asarray(vec, np.float32)[None, :])

    def add_warm_start(self, centers, r_block):
        c = np.asarray(centers, np.float32)
        for s in range(0, c.shape[0], r_block):
            self._queue(c[s:s + r_block])

    def mask_pool_row(self, pool_row):
        if pool_row >= self.covered:
            self.tail_mind[pool_row - self.covered] = -1.0
            self.tail_alive -= 1
            return
        xp = int(self.inv_perm[pool_row])
        self.mind_x[xp] = -1.0
        j = int(np.searchsorted(self.starts, xp, side="right")) - 1
        self.seg_alive[j] -= 1

    def _fold_slice(self, x_slice, mind_slice, pending_from):
        m = int(x_slice.shape[0])
        p = pf._bucket(m)
        xp = torch.zeros((p, x_slice.shape[1]), dtype=torch.float32)
        xp[:m] = x_slice
        nm = torch.full((p,), -1.0, dtype=torch.float32)
        nm[:m] = mind_slice
        li, lv = 0, -pf.BIG
        for entry in self.entries[pending_from:]:
            nm, li, lv = ops.greedy_round(
                xp, nm, entry, torch.full((entry.shape[0],), -1,
                                          dtype=torch.int32))
        if pending_from >= len(self.entries):
            sc = ops.masked_weighted_score(nm)
            li = torch.argmax(sc)
            lv = sc[li]
        return nm[:m], float(lv), int(li)

    def _fold_seg(self, j):
        s, e = int(self.starts[j]), int(self.starts[j + 1])
        nm, lv, li = self._fold_slice(self.xperm[s:e], self.mind_x[s:e],
                                      int(self.seg_pending[j]))
        self.mind_x[s:e] = nm
        self.seg_pending[j] = len(self.entries)
        self.M[j] = lv
        self.last_folded.append(j)
        if li >= e - s:
            return None
        return (lv, int(self.rowid[s + li]))

    def _fold_tail(self):
        n_tail = self.tail_mind.shape[0]
        if n_tail == 0 or self.tail_alive <= 0:
            return None
        nm, lv, li = self._fold_slice(self.tail_x, self.tail_mind,
                                      self.tail_pending)
        self.tail_mind = nm
        self.tail_pending = len(self.entries)
        if li >= n_tail:
            return None
        return (lv, self.covered + li)

    def propose(self):
        self.last_folded = []
        best = self._fold_tail()
        if self.summary is not None:
            ub = np.minimum(self.M, np.square(self.T_sqrt))
            order = sorted((j for j in range(self.summary.k)
                            if self.seg_alive[j] > 0),
                           key=lambda j: (-ub[j], j))
            for j in order:
                if best is not None and ub[j] * (1.0 + self.slack) < best[0]:
                    break
                cand = self._fold_seg(j)
                if cand is not None and (best is None or cand[0] > best[0]
                                         or (cand[0] == best[0]
                                             and cand[1] < best[1])):
                    best = cand
        if best is None:
            return None
        val, pool_row = best
        return (val, int(self.gpos[pool_row]), pool_row)


def _oracle_shards(X, replicas, tail, labeled, k, salt="o", device="cpu"):
    """ShardViews over ``X`` (row i on shard i % replicas): summaries over
    each shard's first rows, the last ``tail`` rows of each shard past
    them, ``labeled`` global rows out of the views."""
    n, d = X.shape
    shards = []
    for si in range(replicas):
        g = np.arange(si, n, replicas, dtype=np.int64)
        feats = X[g]
        covered = g.size - tail
        summ = pf.build_summary(feats[:covered], k=k, salt=f"{salt}/{si}",
                                device=device)
        keep = ~np.isin(g, labeled)
        shards.append(ShardView(feats=feats[keep], probs=None, gidx=g[keep],
                                summary=summ,
                                pool_rows=np.nonzero(keep)[0],
                                pool_feats=feats, device=device))
    return shards


def _same_state(e, o):
    """The wave engine's state equals the oracle's, bit for bit."""
    if o.summary is not None:
        got = e.mind.numpy()[e.lay]
        assert np.array_equal(got.view(np.int32),
                              o.mind_x.numpy().view(np.int32))
        assert np.array_equal(e.M, o.M)
        assert np.array_equal(e.seg_pending, o.seg_pending)
        assert np.array_equal(e.seg_alive, o.seg_alive)
    t = (e.mind_t.numpy()[:e.n_tail] if e.n_tail
         else np.zeros(0, np.float32))
    assert np.array_equal(t.view(np.int32),
                          o.tail_mind.numpy().view(np.int32))
    assert e.tail_pending == o.tail_pending


def _drive(shards, engines, budget, init=None, trackers=None):
    """gated_greedy_select's slot loop over several engine sets at once
    (each a list, one engine a shard; the first set's proposals pick the
    winners). Yields per slot (slot, proposals, pool_rows, folded
    segments), each a list by set of lists by shard; ``trackers`` are
    the sets' op-accounting modules (default the port's ``ops``)."""
    trackers = trackers or [ops] * len(engines)
    d = shards[0].feats.shape[1]
    if init is not None:
        for si, s in enumerate(shards):
            rb = autotune.model_blocks(s.n, d).r_block
            for es in engines:
                es[si].add_warm_start(init, rb)
        start = 0
    else:
        first = int(shards[0].gidx[3])
        seed = np.asarray(shards[0].feats[3], np.float32)
        for es in engines:
            for e in es:
                e.add_center(seed)
            es[0].mask_pool_row(int(shards[0].pool_rows[3]))
        start = 1
    history = []
    for slot in range(start, budget):
        props, rows, folded = [], [], []
        for es, tr in zip(engines, trackers):
            p, r, f = [], [], []
            for e in es:
                with tr.track_ops() as st:
                    p.append(e.propose())
                r.append(st["pool_rows"])
                f.append(list(e.last_folded))
            props.append(p)
            rows.append(r)
            folded.append(f)
        history.append((slot, props, rows, folded))
        best = None
        for si, p in enumerate(props[0]):
            if p is not None and (best is None or p[0] > best[0]
                                  or (p[0] == best[0] and p[1] < best[1])):
                best = (p[0], p[1], si, p[2])
        if best is None:
            break
        _, _, wi, pool_row = best
        center = engines[0][wi].row_vec(pool_row)
        for es in engines:
            es[wi].mask_pool_row(pool_row)
            if slot + 1 < budget:
                for e in es:
                    e.add_center(center)
        yield history[-1]


def _oracle_pool(kind, n, d, seed):
    if kind == "clumped":
        return _dupe_pool(n, 12, d, seed=seed)[0]
    return _vec_pool(n, seed=seed, d=d)


@pytest.mark.parametrize("replicas", (1, 3))
@pytest.mark.parametrize("kind", ("random", "clumped"))
@pytest.mark.parametrize("slack", (1e9, 0.05))
@pytest.mark.parametrize("warm", (False, True))
def test_wave_engine_matches_the_per_segment_oracle(replicas, kind, slack,
                                                    warm):
    """After every slot: the same proposals, the same segments folded in
    the same order, min-dists bit for bit, M, the pending cursors (in
    entries) and pool_rows — with tail rows, labeled rows out of the view,
    and (warm) a warm start without persisted state whose M centers leave
    a one-center last chunk (M % r_block == 1)."""
    d = 24
    X = _oracle_pool(kind, 180 * replicas, d, seed=replicas + len(kind))
    labeled = np.arange(0, X.shape[0], 17)
    shards = _oracle_shards(X, replicas, tail=9, labeled=labeled, k=7)
    init = None
    if warm:
        rb = autotune.model_blocks(shards[0].n, d).r_block
        assert all(autotune.model_blocks(s.n, d).r_block == rb
                   for s in shards)
        init = np.concatenate([X[labeled]] * (-(-(rb + 1) //
                                                 labeled.size)))[:rb + 1]
        init = init + np.float32(0.01) * np.arange(
            init.shape[0], dtype=np.float32)[:, None]
        assert init.shape[0] % rb == 1
    new = [pf._ShardEngine(s, slack) for s in shards]
    old = [SegmentOracle(s, slack) for s in shards]
    slots, pruned = 0, False
    for slot, props, rows, folded in _drive(shards, [new, old], 14, init):
        assert props[0] == props[1], slot
        assert folded[0] == folded[1], slot
        assert rows[0] == rows[1], slot
        for e, o in zip(new, old):
            _same_state(e, o)
            pruned |= len(o.last_folded) < int((o.seg_alive > 0).sum())
        slots += 1
    assert slots == 14 - (0 if warm else 1)
    if slack == 0.05 and kind == "clumped":
        assert pruned          # the stop rule cut some slot's scan short


def test_wave_engine_folds_in_few_waves():
    """``gated_greedy_select``: a loose slack folds every segment of a
    slot in one round, and so does the default slack on a clumped pool
    (wave 1 reaches the stop); the host waits once a wave, plus each
    engine's two blocking uploads (its min-dists, the seed center)."""
    from repro_torch.common import rng as rnglib
    X = _dupe_pool(600, 12, 24, seed=3)[0]
    for slack in (1e9, 0.05):
        shards = _oracle_shards(X, 3, tail=0, labeled=np.arange(0, 600, 31),
                                k=16)
        pf.reset_engine_stats()
        sel = pf.gated_greedy_select(rnglib.key(4), 20, shards, slack=slack)
        st = dict(pf.ENGINE_STATS)
        assert len(set(sel.tolist())) == 20
        assert st["proposals"] == 3 * 19
        assert st["waves"] == st["proposals"], st
        assert st["syncs"] == st["waves"] + 2 * 3, st


def test_wave_engine_matches_the_reference_engine():
    """repro's per-segment engine on the same pool and the same summaries
    (the port's geometry handed over, so the bounds are the same f64
    numbers): the same segments folded in the same order, the same
    pool_rows and the same picks every slot, at the default slack on a
    clumped pool with tail rows and a warm start of M = r_block + 1."""
    pytest.importorskip("jax")
    from repro.core import prefilter as ref_pf
    from repro.core.selection import ShardView as RefShardView
    from repro.kernels.pairwise import ops as ref_ops

    class RefEngine(ref_pf._ShardEngine):
        def propose(self):
            self.last_folded = []
            return super().propose()

        def _fold_seg(self, j):
            self.last_folded.append(j)
            return super()._fold_seg(j)

    d = 24
    X = _dupe_pool(540, 12, d, seed=5)[0]
    labeled = np.arange(0, 540, 23)
    shards = _oracle_shards(X, 3, tail=7, labeled=labeled, k=9)
    ref_shards = []
    for s in shards:
        m = s.summary
        rs = ref_pf.CentroidSummary(m.k, m.cents, m.radii, m.starts,
                                    m.rowid, m.xperm, m.covered)
        ref_shards.append(RefShardView(
            feats=s.feats, probs=None, gidx=s.gidx, summary=rs,
            pool_rows=s.pool_rows, pool_feats=s.pool_feats))
    rb = autotune.model_blocks(shards[0].n, d).r_block
    init = X[np.resize(labeled, rb + 1)] + np.float32(0.02) * np.arange(
        rb + 1, dtype=np.float32)[:, None]
    for warm in (None, init):
        new = [pf._ShardEngine(s, 0.05) for s in shards]
        ref = [RefEngine(s, 0.05) for s in ref_shards]
        slots = 0
        for slot, props, rows, folded in _drive(
                shards, [new, ref], 12, warm, trackers=[ops, ref_ops]):
            assert [p and p[1] for p in props[0]] == \
                [p and p[1] for p in props[1]], slot
            assert folded[0] == folded[1], slot
            assert rows[0] == rows[1], slot
            slots += 1
        assert slots >= 11


@pytest.mark.cuda
@pytest.mark.parametrize("slack", (1e9, 0.05))
def test_cuda_wave_engine_with_a_tail_equals_the_full_scan(slack):
    """On the card, with each shard's last rows past its summary (the
    tail, folded in buffers and a launch of its own): the gated picks
    equal a k-center loop of ``greedy_round`` launches over the whole
    pool; the engine launches no ``greedy_round`` and one gated round a
    wave, plus one for the tail a proposal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.common import rng as rnglib
    dev = torch.device("cuda")
    budget = 40
    X = _dupe_pool(3_000, 12, 64, seed=7)[0]
    shards = _oracle_shards(X, 3, tail=150, labeled=np.zeros(0, np.int64),
                            k=16, device=dev)
    pf.reset_engine_stats()
    ops.reset_launches()
    got = pf.gated_greedy_select(rnglib.key(4), budget, shards, slack=slack)
    torch.cuda.synchronize()
    st, launches = dict(pf.ENGINE_STATS), dict(ops.LAUNCHES)
    x = torch.from_numpy(X).to(dev)
    mind = torch.full((X.shape[0],), pf.BIG, device=dev)
    want = [rnglib.randint(rnglib.key(4), 0, X.shape[0])]
    for _ in range(budget - 1):
        last = want[-1]
        mind, idx, _ = ops.greedy_round(
            x, mind, x[last:last + 1],
            torch.tensor([last], dtype=torch.int32, device=dev))
        want.append(int(idx))
    assert got.tolist() == want
    assert launches.get("greedy_round", 0) == 0, launches
    assert launches["gated_greedy_round"] == st["waves"] + st["proposals"]
