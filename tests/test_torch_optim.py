"""Port parity: ``optim/optimizer.py`` and ``optim/compression.py``
against repro's, and twins of every test of ``tests/test_train.py`` that
has no slow marker.

The optimizers are held on smoke model trees whose segments repeat their
unit (count >= 2), where the reference stacks a ``layer`` axis and the
port keeps a list of units: qwen1.5-4b (one segment of 2 units: norm
scales and qkv biases are stacked vectors) and recurrentgemma-2b (2
units of (rec, rec, attn): the RG-LRU's vectors stacked) here, and
deepseek-v3-671b (a dense unit, then a segment of 3 MoE units: stacked
(E, d, F) experts, the MTP head unstacked) in
``tests/test_torch_optim_moe.py``. The params are the reference's, cast to fp32
and carried over by ``bridge.load_model``; each of 5 updates takes the
same seeded N(0, 1) gradients in both (their global norm is far above
1, so the clip scales them). After the 5 updates every param and every
state leaf (AdamW m, v; Adafactor m, v or vr, vc), the port's units
stacked back into the reference's layout, is within 1e-6 of the
reference's relative to the leaf's largest magnitude.

Two views of the 5 updates: each update started from the reference's
params and state before it (both optimizers), and, for AdamW, the 5
updates chained with the port carrying its own state. The gradients are
multiples of 1/16 in [-1/2, 1/2], so that every sum of squares in the
global norm is exact in any order and the clip's scale is the same bits
in both (a fp32 norm summed in another order moves the scale by up to
~1e-6 here, and AdamW's v with its square). The bars reached are 1.9e-7
(AdamW) and 3.7e-7 (Adafactor: the means of its factored moments sum in
other orders); ``BARS`` holds both at 4e-7. Adafactor's m is bf16 in
both: a bf16 rounding of two fp32 values an ulp apart can fall on either
side, so a bf16 leaf's elements are equal, or one bf16 step apart, or
(where ``b1 * m + (1 - b1) * precond`` cancels to near zero) within 1e-6
of the leaf's largest magnitude, and at most ``BF16_APART`` of them
differ; that is why Adafactor is held step by step (one flip moves its
param by ``lr`` times a bf16 step in every later update).
"""
import numpy as np
import pytest
import torch

from repro_torch import bridge, configs
from repro_torch.common.tree import leaves_with_paths, tree_leaves, tree_map
from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     SimulatedFailure,
                                                     StragglerMonitor,
                                                     supervise)
from repro_torch.models.transformer import Model
from repro_torch.optim.compression import (int8_dequantize, int8_quantize,
                                           make_compressed_grad_fn,
                                           topk_sparsify)
from repro_torch.optim.optimizer import (Adafactor, AdamW,
                                         clip_by_global_norm,
                                         cosine_schedule, make_optimizer)

# deepseek-v3-671b's tree is held in tests/test_torch_optim_moe.py: the
# reference's jitted updates of the three trees split over two workers
TREES = ["qwen1.5-4b", "recurrentgemma-2b"]
STEPS = 5
REL = 1e-6
# the largest relative difference of an fp32 leaf allowed, per optimizer,
# over the three trees (reached: 1.9e-7 and 3.7e-7)
BARS = {"adamw": 4e-7, "adafactor": 4e-7}
# the share of a bf16 leaf's elements whose two fp32 values round to
# neighbouring bf16 values
BF16_APART = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's small CPU ops run faster on one thread, and the test
    workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _restack(tree):
    """The port's tree in the reference's layout: a list of units becomes
    one unit, its leaves stacked on a leading axis when there are two or
    more."""
    if isinstance(tree, list) and tree and all(isinstance(u, dict)
                                               for u in tree):
        if len(tree) == 1:
            return _restack(tree[0])
        units = [_restack(u) for u in tree]
        return tree_map(lambda *xs: torch.stack(xs), *units)
    if isinstance(tree, dict):
        return {k: _restack(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_restack(v) for v in tree]
    return tree


def _compare(port, ref, what):
    """Every leaf of ``port`` (restacked) within REL of ``ref``'s, by
    path; a bf16 leaf where the fp32 values round apart within one bf16
    step. Returns the largest relative difference of the fp32 leaves."""
    got = dict(leaves_with_paths(_restack(port)))
    want = dict(leaves_with_paths(ref))
    assert set(got) == set(want), (what, set(got) ^ set(want))
    worst = 0.0
    for path, w in want.items():
        g = got[path]
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16, path
            gw = g.float().numpy()
            wf = w.astype(np.float32)
            # one bf16 step at wf: 2**(exponent - 7)
            step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(wf),
                                                        2.0 ** -126))) - 7)
            apart = gw != wf
            bar = np.maximum(step, REL * float(np.abs(wf).max()))
            assert np.all(np.abs(gw - wf) <= bar), (what, path)
            assert apart.mean() <= BF16_APART, (what, path, apart.mean())
            continue
        if g.shape != w.shape:       # Adafactor's shared vc: one a unit
            assert g.shape[1:] == w.shape and bool(
                (g == g[0]).all()), path
            g = g[0]
        g = g.double().numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        d = float(np.abs(g - w).max()) / scale
        assert d <= REL, (what, path, d)
        worst = max(worst, d)
    return worst


@pytest.fixture(scope="module", params=TREES)
def model_tree(request):
    return _model_tree(request.param)


def _model_tree(arch):
    """The reference's fp32 params of ``arch``'s smoke config and STEPS
    seeded gradient trees, as numpy."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.models.transformer import Model as RefModel
    cfg = get_smoke_config(arch)
    params = RefModel(cfg).init(jax.random.PRNGKey(0))
    params = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                          params)
    rng = np.random.default_rng(5)
    grads = [jax.tree.map(lambda a: (rng.integers(-8, 9, a.shape) / 16.0
                                     ).astype(np.float32), params)
             for _ in range(STEPS)]
    return {"jax": jax, "arch": arch, "params": params,
            "grads": grads}


def _fill(port, ref, unit=None):
    """Copy the reference-layout tree ``ref`` into the port-layout tree
    ``port`` in place: unit ``i`` of a segment of two or more units takes
    row ``i`` of a stacked leaf, and the whole leaf where it has no layer
    axis (Adafactor's vc of a stacked vector)."""
    if isinstance(port, dict):
        for k in port:
            _fill(port[k], ref[k], unit)
    elif isinstance(port, list) and unit is None and port and all(
            isinstance(u, dict) for u in port):
        for i, u in enumerate(port):
            _fill(u, ref, i if len(port) > 1 else None)
    elif isinstance(port, list):
        for i, v in enumerate(port):
            _fill(v, ref[i], unit)
    else:
        a = np.array(ref)
        t = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
             if a.dtype.name == "bfloat16" else torch.from_numpy(a))
        if unit is not None and t.dim() == port.dim() + 1:
            t = t[unit]
        port.copy_(t)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_reference_on_model_tree(model_tree, name):
    _check_optimizer(model_tree, name)


def _check_optimizer(model_tree, name):
    jax = model_tree["jax"]
    import jax.numpy as jnp
    from repro.optim.optimizer import cosine_schedule as ref_cos
    from repro.optim.optimizer import make_optimizer as ref_make
    np_ = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    ropt = ref_make(name, lr=ref_cos(1e-2, 2, 10))
    rp = jax.tree.map(jnp.asarray, model_tree["params"])
    rs = ropt.init(rp)
    update = jax.jit(ropt.update)
    ref_steps = []
    for g in model_tree["grads"]:
        before = (np_(rp), np_(rs))
        rp, rs, rm = update(jax.tree.map(jnp.asarray, g), rs, rp)
        ref_steps.append((before, (np_(rp), np_(rs)), rm))

    cfg = configs.get_smoke_config(model_tree["arch"])
    opt = make_optimizer(name, lr=cosine_schedule(1e-2, 2, 10))
    worst = 0.0
    # each update from the reference's params and state before it
    pp = bridge.load_model(model_tree["params"], cfg)
    ps = opt.init(pp)
    for k, (g, ((p0, s0), (p1, s1), rm)) in enumerate(
            zip(model_tree["grads"], ref_steps)):
        _fill(pp, p0)
        _fill(ps["per_param"], s0["per_param"])
        ps["step"] = torch.tensor(k, dtype=torch.int32)
        pp, ps, pm = opt.update(bridge.load_model(g, cfg), ps, pp)
        assert int(ps["step"]) == int(s1["step"]) == k + 1
        assert float(pm["lr"]) == float(rm["lr"])
        assert float(pm["grad_norm"]) == float(rm["grad_norm"])
        worst = max(worst, _compare(pp, p1, "params"),
                    _compare(ps["per_param"], s1["per_param"], "state"))
    if name == "adamw":
        # and the 5 updates chained, the port carrying its own state
        pp = bridge.load_model(model_tree["params"], cfg)
        ps = opt.init(pp)
        for g in model_tree["grads"]:
            pp, ps, pm = opt.update(bridge.load_model(g, cfg), ps, pp)
        worst = max(worst, _compare(pp, np_(rp), "params"),
                    _compare(ps["per_param"], np_(rs["per_param"]), "state"))
    assert worst <= BARS[name]


def _seg_vectors(params):
    """(a stacked segment's norm scale of each unit, the final norm)."""
    return ([u["0"]["norm1"]["scale"] for u in params["segments"][0]],
            params["final_norm"]["scale"])


def test_stacked_vectors_decay_and_factor_as_the_reference():
    """AdamW decays a stacked segment's vectors (ndim 2 stacked) and
    leaves an unstacked one alone; Adafactor factors a stacked vector over
    (layer, d) and keeps an unfactored v for an unstacked one."""
    cfg = configs.get_smoke_config("qwen1.5-4b")
    params = tree_map(lambda t: t.float(), Model(cfg).init(0, "cpu"))
    zeros = tree_map(torch.zeros_like, params)
    before = [t.clone() for t in _seg_vectors(params)[0]]
    final = _seg_vectors(params)[1].clone()
    opt = AdamW(lr=cosine_schedule(0.1, 0, 10))
    state = opt.init(params)
    opt.update(zeros, state, params)
    units, fin = _seg_vectors(params)
    assert all(not torch.equal(a, b) for a, b in zip(units, before))
    assert torch.equal(fin, final)

    st = Adafactor().init(params)["per_param"]
    unit_state = st["segments"][0][0]["0"]["norm1"]["scale"]
    assert set(unit_state) == {"m", "vr", "vc"}
    assert unit_state["vr"].shape == () and unit_state["vc"].shape == (64,)
    assert set(st["final_norm"]["scale"]) == {"m", "v"}
    w_q = st["segments"][0][1]["0"]["mixer"]["w_q"]
    assert w_q["vr"].shape == (64,) and w_q["vc"].shape == (64,)


def test_cosine_schedule_and_clip_match_reference():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.optim.optimizer import clip_by_global_norm as ref_clip
    from repro.optim.optimizer import cosine_schedule as ref_cos
    for args in ((3e-4, 100, 10000), (1e-3, 5, 1000), (0.05, 0, 30)):
        ref, port = ref_cos(*args), cosine_schedule(*args)
        for step in (0, 1, 3, 5, 50, 99, 100, 101, 999, 5000, 20000):
            assert float(port(torch.tensor(step, dtype=torch.int32))) \
                == pytest.approx(float(ref(jnp.int32(step))), rel=1e-6,
                                 abs=1e-12), (args, step)
    rng = np.random.default_rng(4)
    tree = {"a": rng.normal(size=(5, 3)).astype(np.float32),
            "b": [rng.normal(size=(7,)).astype(np.float32) * 3]}
    for max_norm in (1.0, 100.0):
        got, gn = clip_by_global_norm(tree_map(torch.from_numpy, tree),
                                      max_norm)
        want, wn = ref_clip(jax.tree.map(jnp.asarray, tree), max_norm)
        assert float(gn) == pytest.approx(float(wn), rel=1e-6)
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=1e-6, atol=0)


def test_topk_and_int8_equal_reference():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.optim import compression as rc
    rng = np.random.default_rng(6)
    for shape, frac in (((256,), 0.1), ((16, 33), 0.05), ((1000,), 0.5)):
        g = rng.normal(size=shape).astype(np.float32)
        e = rng.normal(size=shape).astype(np.float32) * 0.1
        for err in (None, e):
            got = topk_sparsify(torch.from_numpy(g), frac,
                                None if err is None
                                else torch.from_numpy(err))
            want = rc.topk_sparsify(jnp.asarray(g), frac,
                                    None if err is None
                                    else jnp.asarray(err))
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        # planted ties at the threshold: every tied entry is kept
        t = np.round(g * 4) / 4
        a = topk_sparsify(torch.from_numpy(t), frac)[0].numpy()
        np.testing.assert_array_equal(
            a, np.asarray(rc.topk_sparsify(jnp.asarray(t), frac)[0]))
        # int8, half-way values included (round half to even)
        for x in (g, t * 127 / np.abs(t).max(), np.zeros_like(g)):
            q, s = int8_quantize(torch.from_numpy(x))
            rq, rs = rc.int8_quantize(jnp.asarray(x))
            assert q.dtype == torch.int8
            np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
            assert float(s) == float(rs)
            np.testing.assert_array_equal(
                int8_dequantize(q, s).numpy(),
                np.asarray(rc.int8_dequantize(rq, rs)))


def test_compressed_grad_fn_tree():
    compress, init = make_compressed_grad_fn(0.25)
    rng = np.random.default_rng(8)
    grads = {"w": torch.from_numpy(rng.normal(size=(4, 8)).astype(
        np.float32)), "seg": [{"b": torch.from_numpy(
            rng.normal(size=(8,)).astype(np.float32))}]}
    err = init(grads)
    sparse, new_err = compress(grads, err)
    for s, e, g in zip(tree_leaves(sparse), tree_leaves(new_err),
                       tree_leaves(grads)):
        assert torch.equal(s + e, g)
        assert int((s != 0).sum()) == max(int(g.numel() * 0.25), 1)


# ------------------------------------------- twins of tests/test_train.py --
def _quadratic_progress(opt):
    target = torch.from_numpy(
        np.random.default_rng(0).normal(size=(8, 8)).astype(np.float32))
    params = {"w": torch.zeros((8, 8), dtype=torch.float32)}
    state = opt.init(params)

    def loss(p):
        return torch.mean((p["w"] - target) ** 2)

    l0 = float(loss(params))
    for _ in range(60):
        w = params["w"].detach().requires_grad_(True)
        g = {"w": torch.autograd.grad(loss({"w": w}), w)[0]}
        params, state, _ = opt.update(g, state, params)
    return l0, float(loss(params))


def test_adamw_decreases_loss():
    l0, l1 = _quadratic_progress(AdamW(lr=cosine_schedule(0.05, 5, 1000),
                                       weight_decay=0.0))
    assert l1 < 0.3 * l0


def test_adafactor_decreases_loss():
    l0, l1 = _quadratic_progress(Adafactor(lr=cosine_schedule(0.05, 5, 1000)))
    assert l1 < 0.5 * l0


def test_adafactor_state_is_factored():
    opt = Adafactor()
    params = {"w": torch.zeros((64, 32), dtype=torch.float32)}
    st = opt.init(params)
    pp = st["per_param"]["w"]
    assert "vr" in pp and "vc" in pp and "v" not in pp
    assert pp["vr"].shape == (64,) and pp["vc"].shape == (32,)
    assert pp["m"].dtype == torch.bfloat16


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 10.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == 20.0
    np.testing.assert_allclose(float(torch.linalg.norm(clipped["a"])), 1.0,
                               rtol=1e-5)


def test_topk_error_feedback_identity():
    g = torch.from_numpy(np.random.default_rng(1).normal(size=(256,)).astype(
        np.float32))
    sparse, err = topk_sparsify(g, 0.1)
    np.testing.assert_allclose((sparse + err).numpy(), g.numpy(),
                               rtol=1e-6, atol=1e-6)
    assert int(torch.count_nonzero(sparse)) <= 26 + 1


def test_topk_error_feedback_converges():
    """Over steps, transmitted mass approaches the true accumulated grad."""
    rng = np.random.default_rng(2)
    err = torch.zeros((128,))
    total_sent = torch.zeros((128,))
    total_true = torch.zeros((128,))
    for _ in range(50):
        g = torch.from_numpy(rng.normal(size=(128,)).astype(np.float32))
        total_true = total_true + g
        sparse, err = topk_sparsify(g, 0.2, err)
        total_sent = total_sent + sparse
    resid = float(torch.linalg.norm(total_sent + err - total_true))
    assert resid < 1e-4


def test_int8_quantization_error_bound():
    g = torch.from_numpy(np.random.default_rng(3).normal(size=(1024,)).astype(
        np.float32))
    q, scale = int8_quantize(g)
    back = int8_dequantize(q, scale)
    assert q.dtype == torch.int8
    assert float(torch.max(torch.abs(back - g))) <= float(scale) / 2 + 1e-6


def test_straggler_monitor_flags_outlier():
    m = StragglerMonitor(threshold=2.0, warmup=3)
    for i in range(10):
        ev = m.observe(i, 0.1)
        assert ev is None
    ev = m.observe(10, 0.5)
    assert ev is not None and ev.ratio > 2.0
    # EMA not poisoned by the straggler
    assert abs(m.ema - 0.1) < 0.02


def test_failure_injector_fires_once():
    inj = FailureInjector([3])
    inj.maybe_fail(2)
    with pytest.raises(SimulatedFailure):
        inj.maybe_fail(3)
    inj.maybe_fail(3)   # second time: no-op


def test_supervise_restarts_until_done():
    state = {"ckpt": 0, "attempts": 0}

    def train_round(start):
        state["attempts"] += 1
        for step in range(start, 20):
            if step == 12 and state["attempts"] == 1:
                raise SimulatedFailure("boom")
            if step % 5 == 0:
                state["ckpt"] = step
        state["ckpt"] = 20
        return 20

    rep = supervise(train_round, total_steps=20,
                    latest_step=lambda: state["ckpt"])
    assert rep.restarts == 1 and rep.final_step == 20
