"""The port's twins of ``examples/quickstart.py`` and
``examples/al_image_service.py`` against the reference's flows, rebuilt
here at the reference examples' own sizes (400 images, budget 10; pools
of 1,200 and 600, budgets 120 and 600, target accuracy 0.97).

Each twin runs with ``device="cpu"``, the reference's ResNet weights and
initial head through the bridge, and the reference's random draws through
the draw seam. Features and probs differ between the packages by a few
fp32 ulps, so a row's rank is only a fair demand where the reference's
scores around it are separated by more than SEP times the largest
difference between the two packages' scores on the pool
(``tests/test_torch_server.py``'s rule). The quickstart's ten lc picks
are separated, and the test asserts that before it demands equal keys.
The image service queries an untrained head, whose probs are near
uniform: at budget 120 its lc, mc and es scores sit closer than that
around the 120th row. There every row the reference ranks above the
band (the 120th score ± SEP times the difference) must be picked, no row
below it may be, and only rows inside it may differ; where the scores
are separated that is equality. Its cold coreset must pick the
reference's rows while each pick beats its runner-up by more than the
band, and at the first pick that does not, a row inside the band.

A band drawn from the packages' own difference must not widen with a
fault, so each is capped before it is used: the scores' and the
min-dists' largest difference is at most REL_CAP of the reference's
largest value (measured: at most 4e-6 of it), the score band holds at
most half the budget's rows (measured: lc 1, mc 1, es 38 of 120), and
the cold coreset's picks agree, separated, for at least half the budget
(measured: 93 of 120).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.service.config import ALServiceConfig as RefConfig  # noqa: E402
from repro.service.server import ALServer as RefServer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.data.synthetic import image_pool  # noqa: E402
from repro_torch.examples import al_image_service, quickstart  # noqa: E402
from repro_torch.service import backends  # noqa: E402
from repro_torch.service.config import ALServiceConfig  # noqa: E402
from repro_torch.service.server import ALServer  # noqa: E402

SEP = 10.0
REL_CAP = 1e-5


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


def _bridged_backend(ref_srv):
    """A port ResNet backend on the CPU holding the reference server's
    weights and initial head."""
    be = backends.ResNetBackend(device="cpu")
    bridge.load_resnet(be.model, jax.tree.map(np.asarray,
                                              ref_srv.backend.params))
    h0 = ref_srv.backend.init_head()
    bridge.set_initial_head(be, np.asarray(h0.w), np.asarray(h0.b))
    return be


def _artifacts(srv):
    """(feats, probs) over a server's unlabeled pool, in pool order, as
    float64."""
    sess = srv.session()
    feats, probs, _, index = sess._artifact_snapshot()
    if isinstance(feats, list):              # the reference: per shard
        feats, probs = feats[0], probs[0]
        index = {k: v[1] for k, v in index.items()}
    unl = [index[k] for k in sess._keys if k not in sess._labels]
    return (np.asarray(feats, np.float64)[unl],
            np.asarray(probs, np.float64)[unl])


def _pool_artifacts(ref_cfg, port_cfg, be, xs):
    """Both packages' (feats, probs) over ``xs`` pushed into a fresh
    server built as the example builds it."""
    ref_srv = RefServer(ref_cfg)
    port_srv = ALServer(port_cfg, backend=be, draws=JaxDraws())
    try:
        for srv in (ref_srv, port_srv):
            srv.push_data(list(xs))
        return _artifacts(ref_srv), _artifacts(port_srv)
    finally:
        port_srv.close()


def _assert_top_k_separated(ref_scores, port_scores, k):
    s = np.sort(ref_scores)[::-1][:k + 1]
    tol = np.abs(ref_scores - port_scores).max()
    assert (s[:-1] - s[1:]).min() > SEP * tol, ((s[:-1] - s[1:]).min(), tol)


def _assert_top_k_within_band(ref_scores, port_scores, got_rows, k):
    """``got_rows`` (k distinct pool rows) holds every row whose reference
    score lies above the band around the reference's k-th score and none
    below it; the band is SEP times the largest difference between the
    two packages' scores."""
    diff = np.abs(ref_scores - port_scores).max()
    assert diff <= REL_CAP * np.abs(ref_scores).max(), diff
    band = SEP * diff
    kth = np.sort(ref_scores)[::-1][k - 1]
    inside = np.abs(ref_scores - kth) <= band
    assert inside.sum() <= k // 2, int(inside.sum())
    got = set(got_rows)
    assert len(got) == k
    above = set(np.nonzero(ref_scores > kth + band)[0].tolist())
    below = set(np.nonzero(ref_scores < kth - band)[0].tolist())
    assert above <= got, sorted(above - got)
    assert not got & below, sorted(got & below)


def _assert_greedy_prefix(ref_feats, port_feats, want, got):
    """The port's cold k-center picks ``got`` equal the reference's
    ``want`` while each reference pick beats its runner-up by more than
    SEP times the largest min-dist difference between the packages (at
    most REL_CAP of the largest min-dist); at the first pick that does
    not, the port's pick lies within that band of the best (the paths
    may part there), and that comes no sooner than half the picks."""
    assert got[0] == want[0]                 # the seed: one draw

    def d2(feats, s):
        return ((feats - feats[s]) ** 2).sum(-1)

    mr, mp = d2(ref_feats, want[0]), d2(port_feats, want[0])
    mr[want[0]] = mp[want[0]] = -1
    for j in range(1, len(want)):
        diff = np.abs(mr - mp).max()
        assert diff <= REL_CAP * mr.max(), (j, diff)
        band = SEP * diff
        top2 = np.sort(mr)[::-1][:2]
        if top2[0] - top2[1] <= band:
            assert j >= len(want) // 2, j
            assert mr[got[j]] >= top2[0] - band, (j, got[j])
            return
        assert got[j] == want[j] == int(np.argmax(mr)), j
        s = want[j]
        mr, mp = np.minimum(mr, d2(ref_feats, s)), np.minimum(mp, d2(
            port_feats, s))
        mr[s] = mp[s] = -1


def _lc(p):
    return 1 - p.max(-1)


def _mc(p):
    t = np.sort(p, -1)
    return -(t[:, -1] - t[:, -2])


def _es(p):
    q = np.clip(p, 1e-12, 1)
    return -(q * np.log(q)).sum(-1)


SCORES = {"lc": _lc, "mc": _mc, "es": _es}
REF_YML = quickstart.EXAMPLE_YML.format(device="CPU")


def test_quickstart_selects_the_reference_keys():
    """The quickstart flow: lc over the untrained head's probs, then
    label and train_eval; indices, keys and accuracy equal."""
    ref_srv = RefServer(RefConfig.from_yaml(REF_YML))
    be = _bridged_backend(ref_srv)
    xs, ys = image_pool(quickstart.POOL, seed=3)
    keys = ref_srv.push_data(list(xs))
    want = ref_srv.query(budget=quickstart.BUDGET)
    key2y = dict(zip(keys, (int(y) for y in ys)))
    ref_srv.label(want["keys"], [key2y[k] for k in want["keys"]])
    want_acc = ref_srv.train_and_eval()

    ref_art, port_art = _pool_artifacts(
        RefConfig.from_yaml(REF_YML),
        ALServiceConfig.from_yaml(quickstart.EXAMPLE_YML.format(
            device="cpu")), be, xs)
    _assert_top_k_separated(_lc(ref_art[1]), _lc(port_art[1]),
                            quickstart.BUDGET)
    got = quickstart.run(device="cpu", backend=be, draws=JaxDraws(),
                         log=False)
    assert got["strategy"] == want["strategy"] == "lc"
    assert got["indices"] == list(want["indices"])
    assert got["keys"] == list(want["keys"])
    assert got["accuracy"] == want_acc
    assert got["device"] == "cpu"


@pytest.fixture(scope="module")
def image_service():
    """The reference's al_image_service flow and the twin's run, on the
    same weights and draws, plus both packages' pool artifacts."""
    X, Y = image_pool(al_image_service.POOL, seed=0)
    EX, EY = image_pool(al_image_service.EVAL_POOL, seed=1)

    def ref_server():
        srv = RefServer(RefConfig(batch_size=32))
        keys = srv.push_data(list(X))
        key2y = dict(zip(keys, (int(y) for y in Y)))
        srv.attach_oracle(lambda ks: [key2y[k] for k in ks], EX, EY)
        return srv, key2y

    want = {}
    be = keys = None
    for strategy in al_image_service.STRATEGIES:
        srv, key2y = ref_server()
        keys = keys or list(key2y)
        if be is None:
            be = _bridged_backend(srv)
        res = srv.query(budget=al_image_service.BUDGET, strategy=strategy)
        srv.label(res["keys"], [key2y[k] for k in res["keys"]])
        want[strategy] = {"keys": list(res["keys"]),
                          "indices": list(res["indices"]),
                          "accuracy": srv.train_and_eval()}
    srv, _ = ref_server()
    want_auto = srv.query(budget=al_image_service.AUTO_BUDGET,
                          strategy="auto",
                          target_accuracy=al_image_service.TARGET_ACCURACY)
    arts = _pool_artifacts(RefConfig(batch_size=32),
                           ALServiceConfig(batch_size=32, device="cpu"),
                           be, X)
    got = al_image_service.run(device="cpu", backend=be, draws=JaxDraws(),
                               log=False)
    return want, want_auto, arts, got, keys


@pytest.mark.parametrize("strategy", al_image_service.STRATEGIES)
def test_image_service_selects_the_reference_keys(image_service, strategy):
    want, _, (ref_art, port_art), got, keys = image_service
    budget = al_image_service.BUDGET
    res = got["results"][strategy]
    assert len(set(res["keys"])) == budget
    assert got["device"] == "cpu"
    row = {k: i for i, k in enumerate(keys)}
    got_rows = [row[k] for k in res["keys"]]
    if strategy in SCORES:
        score = SCORES[strategy]
        _assert_top_k_within_band(score(ref_art[1]), score(port_art[1]),
                                  got_rows, budget)
        return
    if strategy == "coreset":       # no labels: a cold k-center
        _assert_greedy_prefix(ref_art[0], port_art[0],
                              want[strategy]["indices"], got_rows)
        return
    # random: the reference's draws; dbal: at the example's sizes its LC
    # prefilter (beta * budget rows) keeps the whole pool, so there is no
    # boundary to separate
    assert 10 * budget >= len(keys)
    assert res["keys"] == want[strategy]["keys"]
    assert res["accuracy"] == want[strategy]["accuracy"]


def test_image_service_pshea_matches_the_reference(image_service):
    _, want, _, got, _ = image_service
    auto = got["auto"]
    assert auto["strategy"] == want["strategy"]
    assert auto["eliminated"] == list(want["eliminated"])
    assert auto["stop_reason"] == want["stop_reason"]
    assert auto["accuracy"] == want["accuracy"]
    assert auto["strategy"] in auto["candidates"]
    assert sorted(auto["candidates"]) == sorted(want["history"])
    best = max(got["results"], key=lambda s: got["results"][s]["accuracy"])
    assert got["best_fixed"] == best
