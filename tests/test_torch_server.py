"""Port parity, end to end over TCP: a repro server and a repro_torch server
(device cpu, the reference's weights through the bridge, the reference's
random draws through the draw seam) are fed the same pushes and must
select equal keys, and give equal PSHEA outcomes.

Features and probs differ between the packages by a few fp32 ulps
(different sum orders), so equal keys are only a fair demand where the
reference's winners are separated. Before each comparison the test
asserts that every winning score beats its runner-up by more than SEP
times the largest difference between the two packages' scores on that
pool. A mismatch then means a bug, not a near-tie.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.service import client as ref_client  # noqa: E402
from repro.service.config import ALServiceConfig as RefConfig  # noqa: E402
from repro.service.server import ALServer as RefServer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.data.synthetic import image_pool  # noqa: E402
from repro_torch.service import backends  # noqa: E402
from repro_torch.service.client import ALClient, serve_tcp  # noqa: E402
from repro_torch.service.config import ALServiceConfig  # noqa: E402
from repro_torch.service.server import ALServer  # noqa: E402

SEP = 10.0
BUDGET = 10


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


def _port_server(ref_srv, yml):
    be = backends.ResNetBackend(device="cpu")
    bridge.load_resnet(be.model, jax.tree.map(np.asarray,
                                              ref_srv.backend.params))
    h0 = ref_srv.backend.init_head()
    bridge.set_initial_head(be, np.asarray(h0.w), np.asarray(h0.b))
    cfg = ALServiceConfig.from_yaml(yml)
    assert cfg.device == "CPU"
    return ALServer(cfg, backend=be, draws=JaxDraws())


YML = """
name: "IMG_CLASSIFICATION"
active_learning:
  strategy:
    type: "lc"
  model:
    name: "synthetic_cnn"
    batch_size: 16
  device: CPU
al_worker:
  protocol: "tcp"
  host: "127.0.0.1"
  port: 0
  replicas: 1
"""


@pytest.fixture(scope="module")
def pair():
    ref_srv = RefServer(RefConfig.from_yaml(YML))
    port_srv = _port_server(ref_srv, YML)
    ref_rpc = ref_client.serve_tcp(ref_srv, "127.0.0.1", 0)
    port_rpc = serve_tcp(port_srv, "127.0.0.1", 0)
    ref_cli = ref_client.ALClient(url=f"127.0.0.1:{ref_rpc.port}")
    port_cli = ALClient(url=f"127.0.0.1:{port_rpc.port}")
    xs, ys = image_pool(240, seed=3)
    keys = ref_cli.push_data(list(xs))
    assert port_cli.push_data(list(xs)) == keys
    key2y = dict(zip(keys, (int(y) for y in ys)))
    ex, ey = image_pool(120, seed=11)
    for srv in (ref_srv, port_srv):
        srv.attach_oracle(lambda ks: [key2y[k] for k in ks], ex, ey)
    # a trained head spreads the probs: an untrained one leaves them near
    # uniform, where uncertainty scores sit closer than the ulps apart
    seed_keys = keys[::8]
    for cli in (ref_cli, port_cli):
        cli.label(seed_keys, [key2y[k] for k in seed_keys])
    assert port_cli.train_eval() == ref_cli.train_eval()
    yield ref_srv, port_srv, ref_cli, port_cli, key2y, port_rpc.port
    for c in (ref_cli, port_cli):
        c.close()
    ref_rpc.stop()
    port_rpc.stop()


def _artifacts(srv):
    """(feats, probs, labeled feats) over a server's unlabeled pool, in
    pool order, as float64."""
    sess = srv.session()
    feats, probs, _, index = sess._artifact_snapshot()
    if isinstance(feats, list):              # the reference: per shard
        feats, probs = feats[0], probs[0]
        index = {k: v[1] for k, v in index.items()}
    unl = [index[k] for k in sess._keys if k not in sess._labels]
    lab = [index[k] for k in sess._labeled_keys]
    f = np.asarray(feats, np.float64)
    return f[unl], np.asarray(probs, np.float64)[unl], \
        (f[lab] if lab else None)


def _assert_top_k_separated(ref_scores, port_scores, k):
    s = np.sort(ref_scores)[::-1][:k + 1]
    tol = np.abs(ref_scores - port_scores).max()
    assert (s[:-1] - s[1:]).min() > SEP * tol, ((s[:-1] - s[1:]).min(), tol)


def _greedy_minds(feats, sel, init_centers):
    """The k-center min-dist vector before each pick of ``sel``."""
    def d2(c):
        return ((feats - c) ** 2).sum(-1)

    if init_centers is None:
        mind, rest = d2(feats[sel[0]]), sel[1:]
        mind[sel[0]] = -1
    else:
        mind = np.min([d2(c) for c in init_centers], 0)
        rest = sel
    out = []
    for s in rest:
        out.append(mind.copy())
        mind = np.minimum(mind, d2(feats[s]))
        mind[s] = -1
    return rest, out


def _assert_greedy_separated(ref_art, port_art, sel, warm):
    """Replay the reference's k-center picks on both packages' features:
    every pick after a seed must beat its runner-up by more than SEP
    times the largest min-dist difference between the packages."""
    rest, ref_minds = _greedy_minds(ref_art[0], sel, ref_art[2] if warm
                                    else None)
    _, port_minds = _greedy_minds(port_art[0], sel, port_art[2] if warm
                                  else None)
    for s, mr, mp in zip(rest, ref_minds, port_minds):
        order = np.argsort(-mr, kind="stable")
        assert order[0] == s
        tol = np.abs(mr - mp).max()
        assert mr[order[0]] - mr[order[1]] > SEP * tol, (s, tol)


def _lc(p):
    return 1 - p.max(-1)


def _mc(p):
    t = np.sort(p, -1)
    return -(t[:, -1] - t[:, -2])


def _rc(p):
    t = np.sort(p, -1)
    return t[:, -2] / np.maximum(t[:, -1], 1e-12)


def _es(p):
    q = np.clip(p, 1e-12, 1)
    return -(q * np.log(q)).sum(-1)


SCORES = {"lc": _lc, "mc": _mc, "rc": _rc, "es": _es}


@pytest.mark.parametrize("strategy", ["lc", "mc", "rc", "es", "kcg", "dbal"])
def test_query_selects_equal_keys(pair, strategy):
    ref_srv, port_srv, ref_cli, port_cli, _, _ = pair
    want = ref_cli.query(budget=BUDGET, strategy=strategy, rng_seed=1)
    ref_art, port_art = _artifacts(ref_srv), _artifacts(port_srv)
    if strategy in SCORES:
        score = SCORES[strategy]
        _assert_top_k_separated(score(ref_art[1]), score(port_art[1]),
                                BUDGET)
    elif strategy == "kcg":
        _assert_greedy_separated(ref_art, port_art, want["indices"], False)
    else:   # dbal: its LC prefilter boundary (beta * budget rows)
        _assert_top_k_separated(_lc(ref_art[1]), _lc(port_art[1]),
                                10 * BUDGET)
    got = port_cli.query(budget=BUDGET, strategy=strategy, rng_seed=1)
    assert got["keys"] == want["keys"]
    assert got["strategy"] == strategy


def test_quickstart_flow_then_warm_coreset(pair):
    """Default strategy (lc) -> label -> train_eval -> coreset warm-started
    from the labels; then PSHEA over the remaining pool."""
    ref_srv, port_srv, ref_cli, port_cli, key2y, _ = pair
    sel = ref_cli.query(budget=BUDGET)
    _assert_top_k_separated(_lc(_artifacts(ref_srv)[1]),
                            _lc(_artifacts(port_srv)[1]), BUDGET)
    assert port_cli.query(budget=BUDGET)["keys"] == sel["keys"]
    for c in (ref_cli, port_cli):
        c.label(sel["keys"], [key2y[k] for k in sel["keys"]])
    acc_ref, acc_port = ref_cli.train_eval(), port_cli.train_eval()
    assert acc_port == acc_ref
    want = ref_cli.query(budget=BUDGET, strategy="coreset", rng_seed=2)
    _assert_greedy_separated(_artifacts(ref_srv), _artifacts(port_srv),
                             want["indices"], True)
    got = port_cli.query(budget=BUDGET, strategy="coreset", rng_seed=2)
    assert got["keys"] == want["keys"]
    st = port_cli.stats()
    assert st["labeled"] == 30 + BUDGET and st["device"] == "cpu"
    assert st["strategy_state"] == {"enabled": True, "active": False}

    want = ref_cli.query(budget=70, strategy="auto")
    got = port_cli.query(budget=70, strategy="auto")
    for field in ("strategy", "eliminated", "rounds", "budget_spent",
                  "stop_reason"):
        assert got[field] == want[field], field
    np.testing.assert_allclose(got["accuracy"], want["accuracy"], atol=0)


def test_async_push_flush_and_sessions(pair):
    """Async ingest and sessions behave as in the reference: keys known at
    enqueue, rows visible after flush, sessions isolated."""
    _, port_srv, _, _, _, port = pair
    extra, _ = image_pool(20, seed=21)
    sess = ALClient(url=f"127.0.0.1:{port}", session="new")
    t = sess.push_data(list(extra), asynchronous=True)
    sess.flush()
    assert t.result(timeout=30) == t.keys
    assert sess.stats()["pool"] == 20
    got = sess.query(budget=5, strategy="kcg")
    assert len(set(got["keys"])) == 5 and set(got["keys"]) <= set(t.keys)
    sess.close()
    assert port_srv.session_ids() == ["default"]


def test_unported_paths_raise_naming_their_queue(pair):
    port_srv = pair[1]
    with pytest.raises(NotImplementedError, match="A5"):
        port_srv.standing_register(budget=3, strategy="coreset")
    for cfg, item in [(ALServiceConfig(device="cpu", replicas=2), "A5"),
                      (ALServiceConfig(device="cpu", prefilter=True), "A6"),
                      (ALServiceConfig(device="cpu",
                                       worker_backend="process"), "A7")]:
        with pytest.raises(NotImplementedError, match=item):
            ALServer(cfg, backend=port_srv.backend)


@pytest.mark.parametrize("knob", ["artifact_cache", "incremental_artifacts"])
def test_artifact_oracles_select_identically(knob):
    """The from-scratch artifact paths are the oracles of the incremental
    column: a server with either turned off selects the same keys."""
    xs, _ = image_pool(120, seed=5)
    fast = ALServer(ALServiceConfig(device="cpu", batch_size=8))
    oracle = ALServer(ALServiceConfig(device="cpu", batch_size=8,
                                      **{knob: False}))
    for srv in (fast, oracle):
        srv.push_data(list(xs[:60]))
        srv.query(budget=4, strategy="kcg")
        srv.push_data(list(xs[60:]))
    for strategy in ("lc", "kcg", "dbal"):
        assert fast.query(budget=6, strategy=strategy, rng_seed=3)["keys"] \
            == oracle.query(budget=6, strategy=strategy, rng_seed=3)["keys"]
    arts = fast.stats()["artifacts"]
    assert arts["full_builds"] == 1 and arts["delta_builds"] == 1
    assert fast.embed_rows == 120
