"""Standing queries on the port (``ALSession.standing_*``): twins of
tests/test_standing_queries.py's standing cases, plus a cross-package
check against repro's server and the replay's one-readback decision
against the reference's per-slot loop.

The contracts, each against its knob-as-oracle twin:

- every emit is the EXACT selection a one-shot ``query()`` returns over
  the pool at that moment, so the final emit equals a one-shot over the
  final pool on a fresh server with every incremental engine off;
- near-duplicate deltas take the O(delta) replay (mode ``replay``), and
  the keys still equal ``standing_replay: false``'s full emits;
- the feature path is batch-insensitive (any chunking, bitwise);
- close / a dead ingest worker / a failed emit surface at the next poll.

The CPU runs ``ops.greedy_round``'s plain version (dispatch follows the
tensor), so the replay's decisions are the reference's bit for bit.
"""
import time

import numpy as np
import pytest
import torch

from repro_torch.data.synthetic import image_pool
from repro_torch.kernels.pairwise import ops
from repro_torch.service.backends import MLPBackend
from repro_torch.service.client import ALClient, serve_tcp
from repro_torch.service.config import ALServiceConfig
from repro_torch.service.server import ALServer, replay_holds


def _mlp_server(replicas=1, backend=None, **cfg):
    return ALServer(ALServiceConfig(device="cpu", batch_size=16,
                                    replicas=replicas, **cfg),
                    backend=backend or MLPBackend(in_dim=192, feat_dim=32,
                                                  device="cpu"))


def _near_dups(X, n, scale=1e-4, seed=0):
    """Tiny perturbations of existing rows: new content keys, but their
    min-dist to the already-labeled centers is ~0, so they can never
    displace a recorded per-slot winner (the replay-eligible delta)."""
    rng = np.random.default_rng(seed)
    return [np.asarray(X[i % len(X)], np.float32)
            + rng.normal(scale=scale, size=np.shape(X[0])).astype(np.float32)
            for i in range(n)]


# ------------------------------------------------ streamed == one-shot --
@pytest.mark.parametrize("replicas", (1, 3))
def test_standing_stream_matches_one_shot(replicas):
    X, Y = image_pool(60, seed=11)
    srv = _mlp_server(replicas)
    keys = srv.push_data(list(X[:24]))
    srv.label(keys[:6], Y[:6])
    srv.train_and_eval()
    reg = srv.standing_register(budget=5, strategy="coreset", rng_seed=3)
    assert reg["keys"] == srv.query(budget=5, strategy="coreset",
                                    rng_seed=3)["keys"]
    seen = reg["seq"]
    cumulative = list(reg["keys"])
    for lo, hi in ((24, 36), (36, 48), (48, 60)):
        srv.push_data(list(X[lo:hi]), asynchronous=True).result()
        r = srv.standing_poll(reg["query_id"], since=seen)
        # the emit log replays to the cumulative selection via added/removed
        for e in r["emits"]:
            cumulative = [k for k in cumulative
                          if k not in set(e["removed"])] + list(e["added"])
            assert sorted(cumulative) == sorted(e["keys"])
        seen = r["seq"]
        assert r["keys"] == srv.query(budget=5, strategy="coreset",
                                      rng_seed=3)["keys"]
    # sync mutations emit lazily at the next poll
    srv.label(keys[6:12], Y[6:12])
    srv.train_and_eval()
    final = srv.standing_poll(reg["query_id"], since=seen)
    assert final["seq"] > seen
    ref = _mlp_server(replicas, artifact_cache=False,
                      strategy_state_cache=False, standing_replay=False)
    assert ref.push_data(list(X)) == srv.session()._keys
    ref.label(keys[:12], Y[:12])
    ref.train_and_eval()
    assert final["keys"] == ref.query(budget=5, strategy="coreset",
                                      rng_seed=3)["keys"]
    for s in (srv, ref):
        s.close()


@pytest.mark.parametrize("replicas", (1, 3))
def test_standing_replay_fires_and_matches_oracle(replicas):
    X, Y = image_pool(40, seed=12)
    dups = _near_dups(X[:8], 10, seed=12)
    on = _mlp_server(replicas)
    off = _mlp_server(replicas, standing_replay=False)
    regs = {}
    for srv in (on, off):
        keys = srv.push_data(list(X))
        srv.label(keys[:8], Y[:8])
        srv.train_and_eval()
        regs[srv] = srv.standing_register(budget=5, strategy="coreset")
    for srv in (on, off):
        srv.push_data(dups[:5], asynchronous=True).result()
        srv.push_data(dups[5:], asynchronous=True).result()
    a = on.standing_poll(regs[on]["query_id"])
    b = off.standing_poll(regs[off]["query_id"])
    assert a["keys"] == b["keys"]
    assert any(e["mode"] == "replay" for e in a["emits"])
    assert all(e["mode"] == "full" for e in b["emits"])
    sa, sb = (s.stats()["standing_queries"] for s in (on, off))
    assert sa["replay_emits"] >= 1
    # one readback an emit that replayed over delta rows, budget - 1 rounds
    assert sa["replay_readbacks"] >= 1
    assert sa["replay_rounds"] == 4 * sa["replay_readbacks"]
    assert sb["replay_emits"] == 0 and sb["full_emits"] == sb["emits"]
    assert sb["replay_readbacks"] == 0
    for s in (on, off):
        s.close()


def test_standing_replay_diverges_to_full_emit():
    X, Y = image_pool(30, seed=13)
    srv = _mlp_server()
    keys = srv.push_data(list(X))
    srv.label(keys[:6], Y[:6])
    srv.train_and_eval()
    reg = srv.standing_register(budget=4, strategy="coreset")
    # far-out rows: guaranteed to beat every recorded winner score
    far = [np.full_like(np.asarray(X[0], np.float32), 40.0 + i)
           for i in range(3)]
    srv.push_data(far, asynchronous=True).result()
    r = srv.standing_poll(reg["query_id"], since=reg["seq"])
    assert [e["mode"] for e in r["emits"]] == ["full"]
    assert set(e for em in r["emits"] for e in em["added"]) & set(
        srv.session()._keys[-3:])          # the new rows actually won
    assert r["keys"] == srv.query(budget=4, strategy="coreset")["keys"]
    # the replay ran (and bowed out) before the full emit
    assert srv.stats()["standing_queries"]["replay_readbacks"] == 1
    srv.close()


def test_standing_register_validation():
    srv = _mlp_server()
    srv.push_data(list(image_pool(8, seed=1)[0]))
    with pytest.raises(ValueError, match="concrete strategy"):
        srv.standing_register(budget=2, strategy="auto")
    with pytest.raises(KeyError):
        srv.standing_register(budget=2, strategy="nope")
    with pytest.raises(ValueError, match="budget"):
        srv.standing_register(budget=0, strategy="lc")
    with pytest.raises(KeyError, match="unknown standing query"):
        srv.standing_poll("deadbeef")
    with pytest.raises(KeyError, match="unknown standing query"):
        srv.standing_cancel("deadbeef")
    assert srv.stats()["standing_queries"]["registered"] == 0
    srv.close()


def test_standing_emit_cost_is_o_delta():
    """Replay emits are op-accounted O(new rows): pool_rows touched by a
    near-duplicate delta emit stay a small multiple of the delta size,
    far below the full re-selection's."""
    X, Y = image_pool(48, seed=16)
    srv = _mlp_server()
    keys = srv.push_data(list(X))
    srv.label(keys[:8], Y[:8])
    srv.train_and_eval()
    reg = srv.standing_register(budget=6, strategy="coreset")
    delta = _near_dups(X[:8], 4, seed=16)
    # SYNC push: no worker-thread emit (track_ops is process-global), the
    # next poll emits on THIS thread inside the tracked window
    srv.push_data(delta)
    with ops.track_ops() as stats:
        r = srv.standing_poll(reg["query_id"], since=reg["seq"])
    stats = dict(stats)          # track_ops yields the live global dict
    assert [e["mode"] for e in r["emits"]] == ["replay"]
    n_pool, n_delta, budget = 48 + 4, len(delta), 6
    assert stats["pool_rows"] <= 3 * n_delta * (budget + 1)
    assert stats["pool_rows"] < n_pool * budget // 2
    srv2 = _mlp_server(standing_replay=False)
    k2 = srv2.push_data(list(X))
    srv2.label(k2[:8], Y[:8])
    srv2.train_and_eval()
    reg2 = srv2.standing_register(budget=6, strategy="coreset")
    srv2.push_data(delta)
    with ops.track_ops() as full_stats:
        r2 = srv2.standing_poll(reg2["query_id"], since=reg2["seq"])
    full_stats = dict(full_stats)
    assert r2["keys"] == r["keys"]
    assert full_stats["pool_rows"] >= (n_pool - 8) * (budget - 1)
    assert full_stats["pool_rows"] > 4 * stats["pool_rows"]
    for s in (srv, srv2):
        s.close()


# ------------------------------------------------- batch-insensitivity --
@pytest.mark.parametrize("replicas", (1, 3))
def test_feature_path_batch_insensitive(replicas):
    X, Y = image_pool(34, seed=17)
    n = len(X)
    servers, snaps = [], []
    for chunk in (1, 3, 17, n):
        srv = _mlp_server(replicas, cache_bytes=1 << 10)
        for lo in range(0, n, chunk):
            srv.push_data(list(X[lo:lo + chunk]))
        keys = srv.session()._keys
        srv.label(keys[:7], Y[:7])
        srv.train_and_eval()
        servers.append(srv)
        feats_l, _, rows_l, _ = srv.session()._artifact_snapshot()
        snaps.append([np.asarray(f[:r]) for f, r in zip(feats_l, rows_l)])
    for snap in snaps[1:]:
        for a, b in zip(snaps[0], snap):
            np.testing.assert_array_equal(a, b)      # bitwise, per shard
    sels = [srv.query(budget=5, strategy="coreset", rng_seed=4)["keys"]
            for srv in servers]
    assert all(s == sels[0] for s in sels)
    sels_lc = [srv.query(budget=5, strategy="lc", rng_seed=4)["keys"]
               for srv in servers]
    assert all(s == sels_lc[0] for s in sels_lc)
    for s in servers:
        s.close()


# ------------------------------------------- cancellation / fault paths --
def test_close_session_cancels_standing_queries():
    X, Y = image_pool(24, seed=18)
    srv = _mlp_server()
    sid = srv.create_session()
    sess = srv.session(sid)
    keys = srv.push_data(list(X[:16]), session=sid)
    srv.label(keys[:4], Y[:4], session=sid)
    reg = srv.standing_register(budget=3, strategy="coreset", session=sid)
    emits_before = sess.standing_emits
    srv.close_session(sid)
    with pytest.raises(RuntimeError, match="session closed"):
        sess.standing_poll(reg["query_id"])
    with pytest.raises(KeyError):                    # session itself gone
        srv.standing_poll(reg["query_id"], session=sid)
    assert sess.standing_emits == emits_before       # no orphaned emits
    assert sess._standing[reg["query_id"]].cancelled == "session closed"
    srv.close()


def test_dead_ingest_worker_fails_polls_ticket_style():
    X, Y = image_pool(20, seed=19)
    srv = _mlp_server()
    sess = srv.session()
    keys = srv.push_data(list(X[:16]))
    srv.label(keys[:4], Y[:4])
    reg = srv.standing_register(budget=3, strategy="coreset")
    sess._ingest_loop = lambda: None       # worker thread exits immediately
    sess.push_data(list(X[16:]), asynchronous=True)
    deadline = time.time() + 10
    while sess._ingest_thread.is_alive() and time.time() < deadline:
        time.sleep(0.01)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="worker died"):
        srv.standing_poll(reg["query_id"])
    assert time.perf_counter() - t0 < 5.0


def test_failed_emit_parks_on_query_not_worker(monkeypatch):
    X, Y = image_pool(24, seed=20)
    srv = _mlp_server()
    sess = srv.session()
    keys = srv.push_data(list(X[:16]))
    srv.label(keys[:4], Y[:4])
    reg = srv.standing_register(budget=3, strategy="coreset")
    boom = RuntimeError("emit exploded")
    monkeypatch.setattr(sess, "_standing_emit_locked",
                        lambda sq: (_ for _ in ()).throw(boom))
    sess.push_data(list(X[16:]), asynchronous=True).result()
    srv.flush()                                      # worker survived
    with pytest.raises(RuntimeError, match="emit failed"):
        srv.standing_poll(reg["query_id"])
    monkeypatch.undo()
    r = srv.standing_poll(reg["query_id"])           # error cleared on success
    assert r["keys"] == srv.query(budget=3, strategy="coreset")["keys"]
    assert srv.stats()["pool"] == 24                 # no rows lost
    srv.close()


class _Interrupt(BaseException):
    """A BaseException that is not an Exception (as KeyboardInterrupt)."""


def test_emit_raising_base_exception_parks_on_query(monkeypatch):
    """A standing emit whose strategy raises a BaseException that is not an
    Exception parks on the query, as the reference's ``except
    BaseException`` does: the ingest worker lives on, ``flush(timeout=)``
    returns, the poll surfaces the error, and a later push drains."""
    from repro_torch.service import server as server_mod
    X, Y = image_pool(32, seed=21)
    srv = _mlp_server()
    sess = srv.session()
    keys = srv.push_data(list(X[:16]))
    srv.label(keys[:4], Y[:4])
    srv.train_and_eval()
    reg = srv.standing_register(budget=3, strategy="lc")
    real = server_mod.get_strategy

    class Exploding:
        needs = ("probs",)

        def select(self, *a, **kw):
            raise _Interrupt("strategy interrupted")
    monkeypatch.setattr(server_mod, "get_strategy",
                        lambda name: Exploding())
    sess.push_data(list(X[16:24]), asynchronous=True)
    srv.flush(timeout=10.0)                          # the drain ended
    assert sess._ingest_thread.is_alive() and not sess._ingest_busy
    with pytest.raises(RuntimeError, match="emit failed") as info:
        srv.standing_poll(reg["query_id"])
    assert isinstance(info.value.__cause__, _Interrupt)
    monkeypatch.setattr(server_mod, "get_strategy", real)
    sess.push_data(list(X[24:]), asynchronous=True).result(timeout=10.0)
    srv.flush(timeout=10.0)                          # a later push drains
    r = srv.standing_poll(reg["query_id"])           # error cleared
    assert r["keys"] == srv.query(budget=3, strategy="lc")["keys"]
    assert srv.stats()["pool"] == 32
    srv.close()


def test_standing_ops_over_tcp():
    """register / poll / cancel through ALClient over the TCP transport:
    the emits equal one-shot queries, and a cancelled query's poll
    raises."""
    X, Y = image_pool(40, seed=22)
    srv = _mlp_server(3)
    rpc = serve_tcp(srv, "127.0.0.1", 0)
    cli = ALClient(url=f"127.0.0.1:{rpc.port}")
    try:
        keys = cli.push_data(list(X[:30]))
        cli.label(keys[:6], [int(y) for y in Y[:6]])
        cli.train_eval()
        reg = cli.standing_register(budget=4, strategy="coreset",
                                    rng_seed=1)
        assert reg["keys"] == cli.query(budget=4, strategy="coreset",
                                        rng_seed=1)["keys"]
        cli.push_data(_near_dups(X[:6], 5, seed=22))
        r = cli.standing_poll(reg["query_id"], since=reg["seq"])
        assert [e["mode"] for e in r["emits"]] == ["replay"]
        cli.push_data(list(X[30:]))
        r = cli.standing_poll(reg["query_id"], since=r["seq"])
        assert len(r["emits"]) == 1
        assert r["keys"] == cli.query(budget=4, strategy="coreset",
                                      rng_seed=1)["keys"]
        assert cli.stats()["standing_queries"]["live"] == 1
        cli.standing_cancel(reg["query_id"])
        with pytest.raises(Exception, match="cancelled"):
            cli.standing_poll(reg["query_id"])
    finally:
        cli.close()
        rpc.stop()
        srv.close()


# ----------------------------------- the replay's one-readback decision --
def _per_slot_decision(x, mind, centers, values):
    """The reference's loop (src/repro/service/server.py
    ``_standing_replay``): one round a slot, each max read back."""
    no_mask = torch.full((1,), -1, dtype=torch.int32)
    best = float(torch.max(ops.masked_weighted_score(mind)))
    for j in range(len(values)):
        if best > values[j]:
            return False
        if j + 1 < len(values):
            mind, _, lv = ops.greedy_round(x, mind, centers[j:j + 1],
                                           no_mask)
            best = float(lv)
    return True


def _tie_case(seed, n=24, d=8, budget=6):
    """Integer features: every squared distance is an exact integer in
    fp32, so the planted ties are exact in any summation order."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
    centers = rng.integers(-4, 5, size=(budget - 1, d)).astype(np.float32)
    mind = rng.integers(20, 200, size=n).astype(np.float32)
    # the per-slot maxima the delta rows reach
    m, maxima = mind.copy(), [float(mind.max())]
    for c in centers:
        m = np.minimum(m, ((x - c) ** 2).sum(-1))
        maxima.append(float(m.max()))
    return x, centers, mind, maxima


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("plant", ["ties", "one_below", "one_above"])
def test_replay_decision_equals_per_slot_loop(seed, plant):
    """Planted exact ties at ``values[j]`` (a tie keeps the stored pick),
    a value one ulp below at one slot (displaced there), one ulp above
    everywhere: the one-readback decision equals the per-slot loop's, and
    the reference's own loop (repro's ops) where JAX is installed."""
    x, centers, mind, maxima = _tie_case(seed)
    values = list(maxima)
    j = seed % len(values)
    if plant == "one_below":
        values[j] = float(np.nextafter(np.float32(values[j]),
                                       np.float32(-np.inf)))
    elif plant == "one_above":
        values = [float(np.nextafter(np.float32(v), np.float32(np.inf)))
                  for v in values]
    xt, mt, ct = (torch.from_numpy(a) for a in (x, mind, centers))
    got = replay_holds(xt, mt, ct, values)
    assert got == _per_slot_decision(xt, mt, ct, values)
    assert got == (plant != "one_below")
    try:
        import jax.numpy as jnp
        from repro.kernels.pairwise import ops as ref_ops
    except ImportError:
        return
    mj, ej = jnp.asarray(mind), jnp.asarray(x)
    no_mask = jnp.full((1,), -1, jnp.int32)
    best, want = float(jnp.max(ref_ops.masked_weighted_score(mj))), True
    for k in range(len(values)):
        if best > values[k]:
            want = False
            break
        if k + 1 < len(values):
            mj, _, lv = ref_ops.greedy_round(
                ej, mj, jnp.asarray(centers[k])[None, :], no_mask)
            best = float(lv)
    assert got == want


# ------------------------------------------------ against the reference --
@pytest.mark.parametrize("replicas", (1, 3))
def test_standing_emits_match_reference_server(replicas):
    """repro and repro_torch servers (the reference's MLP weights and
    initial head through the bridge) fed the same pushes, labels and
    deltas: every emit's keys and mode are equal."""
    pytest.importorskip("jax")
    from repro.service.backends import MLPBackend as RefMLP
    from repro.service.config import ALServiceConfig as RefConfig
    from repro.service.server import ALServer as RefServer
    from repro_torch import bridge
    ref_be = RefMLP(in_dim=192, feat_dim=32)
    be = MLPBackend(in_dim=192, feat_dim=32, device="cpu")
    bridge.load_mlp(be, np.asarray(ref_be.w1), np.asarray(ref_be.w2))
    h0 = ref_be.init_head()
    bridge.set_initial_head(be, np.asarray(h0.w), np.asarray(h0.b))
    ref = RefServer(RefConfig(batch_size=16, replicas=replicas),
                    backend=ref_be)
    port = _mlp_server(replicas, backend=be)
    X, Y = image_pool(48, seed=23)
    far = [np.full_like(np.asarray(X[0], np.float32), 30.0 + i)
           for i in range(2)]
    steps = [("sync", _near_dups(X[:10], 6, seed=23)),
             ("async", _near_dups(X[:10], 4, seed=24)),
             ("sync", list(X[36:])),
             ("async", far),
             ("sync", _near_dups(X[:10], 3, seed=25))]
    logs = []
    try:
        for srv in (ref, port):
            keys = srv.push_data(list(X[:36]))
            srv.label(keys[:8], Y[:8])
            srv.train_and_eval()
            reg = srv.standing_register(budget=5, strategy="coreset",
                                        rng_seed=2)
            log = [(reg["keys"], "register")]
            seq = reg["seq"]
            for how, rows in steps:
                if how == "sync":
                    srv.push_data(rows)
                else:
                    srv.push_data(rows, asynchronous=True).result()
                r = srv.standing_poll(reg["query_id"], since=seq)
                seq = r["seq"]
                log += [(e["keys"], e["mode"]) for e in r["emits"]]
            logs.append(log)
        assert logs[0] == logs[1]
        modes = [m for _, m in logs[1]]
        assert "replay" in modes and "full" in modes
    finally:
        port.close()


# ------------------------------------------- random interleavings --------
def test_random_streams_standing_equals_one_shot():
    """Hypothesis: under ANY interleaving of push (sync and async), label,
    train and poll, at replicas in {1, 3}, every emit equals the one-shot
    selection at that moment (and a cold mirror server's), and the final
    selection equals a fresh all-oracles-off server's one-shot."""
    pytest.importorskip("hypothesis")
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st

    X, _ = image_pool(66, seed=21)
    chunks = [list(X[i * 6:(i + 1) * 6]) for i in range(11)]
    ops_st = st.lists(
        st.one_of(
            st.tuples(st.just("push"), st.integers(0, 10)),
            st.tuples(st.just("push_async"), st.integers(0, 10)),
            st.tuples(st.just("label"), st.integers(1, 5)),
            st.tuples(st.just("train"), st.just(0)),
            st.tuples(st.just("poll"), st.just(0)),
        ), min_size=4, max_size=12)

    @settings(max_examples=6, deadline=None, database=None,
              suppress_health_check=list(HealthCheck))
    @given(ops=ops_st, replicas=st.sampled_from([1, 3]),
           seed=st.integers(0, 99))
    def run(ops, replicas, seed):
        srv = _mlp_server(replicas)
        cold = _mlp_server(replicas, strategy_state_cache=False,
                           standing_replay=False)
        sess = srv.session()
        keys0 = srv.push_data(chunks[0])
        cold.push_data(chunks[0])
        for s in (srv, cold):
            s.label(keys0[:3], [hash(k) % 10 for k in keys0[:3]])
            s.train_and_eval()
        reg = srv.standing_register(budget=4, strategy="coreset",
                                    rng_seed=seed)
        labeled_log = [(k, hash(k) % 10) for k in keys0[:3]]
        for op, arg in ops:
            if op == "push":
                srv.push_data(chunks[arg])
                cold.push_data(chunks[arg])
            elif op == "push_async":
                srv.push_data(chunks[arg], asynchronous=True)
                cold.push_data(chunks[arg], asynchronous=True)
            elif op == "label":
                srv.flush()
                todo = [k for k in sess._keys
                        if k not in sess._labels][:arg]
                ys = [hash(k) % 10 for k in todo]
                srv.label(todo, ys)
                cold.label(todo, ys)
                labeled_log += list(zip(todo, ys))
            elif op == "train":
                srv.train_and_eval()
                cold.train_and_eval()
            else:
                r = srv.standing_poll(reg["query_id"])
                assert r["keys"] == srv.query(
                    budget=4, strategy="coreset", rng_seed=seed)["keys"]
                assert r["keys"] == cold.query(
                    budget=4, strategy="coreset", rng_seed=seed)["keys"]
        final = srv.standing_poll(reg["query_id"])
        cold.flush()
        assert cold.session()._keys == sess._keys
        assert final["keys"] == cold.query(
            budget=4, strategy="coreset", rng_seed=seed)["keys"]
        ref = _mlp_server(replicas, artifact_cache=False,
                          strategy_state_cache=False, standing_replay=False)
        for lo in range(0, len(sess._keys), 16):
            ref.push_data([sess._raw[k] for k in sess._keys[lo:lo + 16]])
        assert ref.session()._keys == sess._keys
        ref.label(*zip(*labeled_log))
        ref.train_and_eval()
        assert final["keys"] == ref.query(
            budget=4, strategy="coreset", rng_seed=seed)["keys"]
        for s in (srv, cold, ref):
            s.close()

    run()
