"""Port parity: ``Model.loss`` (chunked cross-entropy, z-loss, the MoE aux
loss, the MTP loss) and its gradients against repro's, on the smoke
configs of the ten archs of the registry: (a) for the five dense stacks
here, for the other five in ``tests/test_torch_loss_stacks.py``; (b)-(d)
for all ten here.

The reference's weights are carried over by ``bridge.load_model`` at
fp32, with the leaves it initialises to zero (biases, RWKV's token-shift
mixes, RG-LRU's gate biases) drawn from N(0, 0.5) in both trees, so that
a port that drops one in the backward fails. The batch is B 2 x S 32 of
seeded tokens and labels, three labels of the first row -1 (padding),
and, for whisper and llava, seeded N(0, 1) frames and patch embeddings.

(a) ``loss`` and each metric (``ce``, ``z_loss``, ``aux_loss``, and
    ``mtp`` for deepseek-v3) within 1e-4 of the reference's
    (``jax.value_and_grad`` under ``jax.jit``); every gradient leaf, the
    reference's mapped onto the port's tree by ``bridge.load_model``
    (a gradient tree has the params' structure), within
    1e-4 * max(1, max |g_ref|). The largest relative difference seen is
    1.8e-5 (rwkv6-3b), the others <= 1.5e-6. No MoE route near-ties at
    these inputs, so no route is forced.
(b) ``cfg.remat`` is invisible: the loss and every gradient leaf are the
    same bits with and without ``torch.utils.checkpoint``, and a
    ``RouteTape`` sees each MoE call once (the recomputation replays its
    routes); forcing the recorded routes gives the same bits again.
(c) Twins of ``tests/test_arch_smoke.py::test_forward_loss`` and
    ``::test_grad_step`` on the port's own bf16 weights.
(d) ``attention_impl="pallas"`` trains on a CPU tensor through the
    chunked path, bit for bit (the card raises instead:
    ``tests/test_torch_mesh.py::test_cuda_pallas_attention_refuses_grad``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import bridge, configs
from repro_torch.common.tree import leaves_with_paths, tree_leaves, tree_map
from repro_torch.models.layers.moe import RouteTape
from repro_torch.models.transformer import Model, build_segments

ARCHS = ["qwen3-8b", "internlm2-20b", "phi3-medium-14b", "qwen1.5-4b",
         "deepseek-moe-16b", "deepseek-v3-671b", "rwkv6-3b",
         "recurrentgemma-2b", "whisper-medium", "llava-next-34b"]
MOE = ("deepseek-moe-16b", "deepseek-v3-671b")
# leaves the reference initialises to zero, drawn non-zero in both trees
DRAWN = ("b_q", "b_k", "b_v", "mu_x", "mu", "mu_k", "mu_r", "gn_bias",
         "conv_b", "gate_a_b", "gate_x_b", "bias", "b_o", "b_in", "b_out")
TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's small CPU ops run faster on one thread, and the test
    workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, B=2, S=32):
    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    out["labels"][0, -3:] = -1
    if cfg.enc_dec:
        out["frames"] = rng.normal(
            size=(B, cfg.n_enc_frames, cfg.d_model)).astype(np.float32)
    if cfg.n_patches:
        out["patch_embeds"] = rng.normal(
            size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def _torch_batch(batch, dtype=torch.float32):
    return {k: torch.from_numpy(v) if v.dtype == np.int32
            else torch.from_numpy(v).to(dtype) for k, v in batch.items()}


# the reference's jitted gradients cost most of this file's time, so the
# stacks of the other five archs are held in tests/test_torch_loss_stacks.py
DENSE = ["qwen3-8b", "internlm2-20b", "phi3-medium-14b", "qwen1.5-4b",
         "llava-next-34b"]


@pytest.fixture(scope="module", params=DENSE)
def ref(request):
    return _reference(request.param)


def _reference(arch):
    """The reference's fp32 loss, metrics and gradients of ``arch``'s
    smoke config on ``_batch``, with its params and batch as numpy."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.models.transformer import Model as RefModel
    cfg = get_smoke_config(arch)
    model = RefModel(cfg)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)

    def draw(path, a):
        if getattr(path[-1], "key", None) not in DRAWN:
            return a
        return jnp.asarray(rng.normal(0.0, 0.5, a.shape), a.dtype)
    params = jax.tree_util.tree_map_with_path(draw, params)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    batch = _batch(cfg)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        model.loss, has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    return {"arch": arch, "batch": batch,
            "params": jax.tree.map(np.asarray, params),
            "loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": jax.tree.map(np.asarray, grads)}


def _port_cfg(arch, **kw):
    return dataclasses.replace(configs.get_smoke_config(arch), **kw)


def _loss_and_grads(cfg, params, batch, routes=None):
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, metrics = Model(cfg, routes=routes).loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def test_loss_and_grads_match_reference(ref):
    _check_against(ref)


def _check_against(ref):
    cfg = _port_cfg(ref["arch"])
    params = bridge.load_model(ref["params"], cfg)
    loss, metrics, grads = _loss_and_grads(cfg, params,
                                           _torch_batch(ref["batch"]))
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss) - ref["loss"]) <= TOL
    assert set(metrics) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        assert abs(float(metrics[k]) - v) <= TOL, k
    want = leaves_with_paths(bridge.load_model(ref["grads"], cfg))
    assert len(want) == len(grads)
    for (path, w), g in zip(want, grads):
        assert g.dtype == torch.float32 and g.shape == w.shape, path
        bar = TOL * max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= bar, path


def _fp32_params(cfg, seed=0):
    return tree_map(lambda t: t.float(), Model(cfg).init(seed, "cpu"))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_invisible(arch):
    batch = _torch_batch(_batch(_port_cfg(arch)))
    out = {}
    for remat in (True, False):
        cfg = _port_cfg(arch, remat=remat)
        tape = RouteTape()
        out[remat] = _loss_and_grads(cfg, _fp32_params(cfg), batch, tape)
        n_moe = sum(s.count for s in build_segments(cfg)
                    if s.unit[0].mlp == "moe")
        # one route per MoE call: the recomputation records nothing
        assert len(tape.recorded) == n_moe
    (la, ma, ga), (lb, mb, gb) = out[True], out[False]
    assert torch.equal(la, lb)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for a, b in zip(ga, gb):
        assert torch.equal(a, b)
    if arch in MOE:
        # forcing the recorded routes under remat: the same bits again
        cfg = _port_cfg(arch)
        tape = RouteTape()
        first = _loss_and_grads(cfg, _fp32_params(cfg), batch, tape)
        forced = _loss_and_grads(cfg, _fp32_params(cfg), batch,
                                 RouteTape(force=tape.recorded))
        assert torch.equal(first[0], forced[0])
        for a, b in zip(first[2], forced[2]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss(arch):
    cfg = _port_cfg(arch)
    params = Model(cfg).init(0, "cpu")
    loss, metrics = Model(cfg).loss(params,
                                    _torch_batch(_batch(cfg), torch.bfloat16))
    assert loss.shape == ()
    assert np.isfinite(float(loss)), f"{arch}: loss not finite"
    assert float(metrics["ce"]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_grad_step(arch):
    cfg = _port_cfg(arch)
    params = Model(cfg).init(0, "cpu")
    batch = _torch_batch(_batch(cfg), torch.bfloat16)
    loss, _, grads = _loss_and_grads(cfg, params, batch)
    assert np.isfinite(float(loss))
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads), \
        f"{arch}: non-finite grads"
    # one SGD step must change the loss
    with torch.no_grad():
        new = tree_map(lambda p: p.detach().clone(), params)
        for p, g in zip(tree_leaves(new), grads):
            p.sub_(0.1 * g.to(p.dtype))
        loss2 = Model(cfg).loss(new, batch)[0]
    assert float(loss2) != float(loss)


@pytest.mark.parametrize("arch", ["qwen3-8b", "recurrentgemma-2b",
                                  "whisper-medium"])
def test_pallas_impl_trains_on_cpu_as_chunked(arch):
    batch = _torch_batch(_batch(_port_cfg(arch)))
    runs = []
    for impl in ("pallas", "chunked"):
        cfg = _port_cfg(arch, attention_impl=impl)
        runs.append(_loss_and_grads(cfg, _fp32_params(cfg), batch))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][2], runs[1][2]):
        assert torch.equal(a, b)
