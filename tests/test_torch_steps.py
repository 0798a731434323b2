"""``launch/steps.py``: the port's cells against the reference's steps.

(a) ``build_cell``'s three steps on one device (no mesh), qwen3-8b's
    smoke config at fp32 from the reference's weights
    (``bridge.load_model``): ``train_step`` (loss, metrics, ``grad_norm``
    within the loss bar 1e-4; each new param within 1e-5, twice the first
    AdamW step's learning rate of 3e-6, as a near-zero gradient can take
    either sign), ``prefill_step`` and ``serve_step`` (logits within
    1e-4 * max(1, max |logits|), the serving parity bar) against the
    reference's ``Model.loss`` with ``jax.value_and_grad`` and its
    optimizer, ``Model.prefill`` and ``Model.decode_step``.
(b) ``Cell.trace`` on one device: the serving steps' kernels stand in
    (one launch a layer, nothing launched), the arguments' bytes are the
    declared bytes, and a trace allocates nothing that outlives it.
(c) Per-chip FLOPs of qwen3-8b's smoke cells (train, prefill, decode at
    batch 8, sequence 64) on a fake (2, 2, 2) mesh against the
    reference's ``HloCost`` on the same cells (its mesh of 8 forced host
    devices with Auto axes), each in a subprocess. Port over reference:
    train 1.10, prefill 0.88, decode 0.96 (the port's eager ops against
    XLA's fused program: the serving steps' kernels count the causal
    pairs alone where the reference's chunked attention computes every
    tile, and the train step recomputes each unit and runs the optimizer
    leaf by leaf). Held within ``FLOPS_RATIO``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import bridge, configs
from repro_torch.common.param import param_bytes
from repro_torch.common.tree import leaves_with_paths, tree_leaves
from repro_torch.configs import SHAPES
from repro_torch.launch.steps import build_cell

ARCH = "qwen3-8b"
TOL = 1e-4
PARAM_TOL = 1e-5
FLOPS_RATIO = (0.8, 1.25)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.models.transformer import Model as RefModel
    cfg = get_smoke_config(ARCH)
    model = RefModel(cfg)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          model.init(jax.random.PRNGKey(0)))
    return {"jax": jax, "cfg": cfg, "model": model, "params": params}


def _np(jax, tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _port_params(ref):
    return bridge.load_model(_np(ref["jax"], ref["params"]),
                             configs.get_smoke_config(ARCH))


def test_train_step_matches_reference(ref):
    jax = ref["jax"]
    import jax.numpy as jnp
    from repro.optim.optimizer import make_optimizer as ref_make
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, 256, (2, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    ropt = ref_make("adamw")
    (loss, metrics), grads = jax.value_and_grad(
        ref["model"].loss, has_aux=True)(
            ref["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    new_ref, _, om = ropt.update(grads, ropt.init(ref["params"]),
                                 ref["params"])

    cell = build_cell(configs.get_smoke_config(ARCH), SHAPES["train_4k"],
                      batch=2, seq=32)
    params = _port_params(ref)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    new, state, m = cell.run(params, cell.opt.init(params),
                             {k: torch.from_numpy(v)
                              for k, v in batch.items()})
    assert int(state["step"]) == 1
    assert float(m["loss"]) == pytest.approx(float(loss), abs=TOL)
    for k in ("ce", "z_loss", "aux_loss"):
        assert float(m[k]) == pytest.approx(float(metrics[k]), abs=TOL), k
    assert float(m["grad_norm"]) == pytest.approx(float(om["grad_norm"]),
                                                  rel=TOL)
    want = bridge.load_model(_np(jax, new_ref),
                             configs.get_smoke_config(ARCH))
    for (path, got), (_, exp) in zip(leaves_with_paths(new),
                                     leaves_with_paths(want)):
        np.testing.assert_allclose(got.detach().numpy(), exp.numpy(),
                                   rtol=0, atol=PARAM_TOL, err_msg=path)


def test_serve_steps_match_reference(ref):
    """prefill_step over an 8-token prompt into a 16-entry cache, then
    serve_step for one token, against the reference's prefill and
    decode_step on the same weights."""
    jax = ref["jax"]
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, 256, (2, 8)).astype(np.int32)
    token = rng.integers(0, 256, (2, 1)).astype(np.int32)
    rm = ref["model"]
    from repro.common.param import init_params as ref_init
    rcache = ref_init(rm.cache_decls(2, 16), jax.random.PRNGKey(1))
    rcache, rlogits = rm.prefill(ref["params"],
                                 {"tokens": jnp.asarray(prompt)}, rcache)
    rstep, _ = rm.decode_step(ref["params"], rcache, jnp.asarray(token))

    cfg = configs.get_smoke_config(ARCH)
    pre = build_cell(cfg, SHAPES["prefill_32k"], batch=2, seq=16)
    dec = build_cell(cfg, SHAPES["decode_32k"], batch=2, seq=16)
    assert pre.cfg.attention_impl == dec.cfg.attention_impl == "pallas"
    params = _port_params(ref)
    cache = pre.init_args("cpu")[2]
    cache, logits = pre.model.prefill(params, {"tokens": torch.from_numpy(
        prompt)}, cache)
    for got, want in ((logits, rlogits),):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=TOL * max(1.0, np.abs(want).max()))
    step, cache = dec.run(params, cache, torch.from_numpy(token))
    want = np.asarray(rstep, np.float32)
    np.testing.assert_allclose(step.numpy(), want, rtol=0,
                               atol=TOL * max(1.0, np.abs(want).max()))
    assert int(cache["len"]) == 9


def test_prefill_step_runs_its_own_cache():
    """The prefill cell's own arguments: its cache is as long as its
    prompt, and the step fills it."""
    cell = build_cell(configs.get_smoke_config(ARCH),
                      SHAPES["prefill_32k"], batch=2, seq=16)
    params, batch, cache = cell.init_args("cpu")
    cache, logits = cell.run(params, batch, cache)
    assert logits.shape == (2, cell.cfg.padded_vocab)
    assert int(cache["len"]) == 16
    assert cache["segments"][0]["0"]["k"].abs().sum() > 0


@pytest.mark.parametrize("shape,kernel", [("train_4k", None),
                                          ("prefill_32k", "flash_attention"),
                                          ("decode_32k", "decode_attention")])
def test_one_device_trace_counts_kernels_and_bytes(shape, kernel):
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    cfg = configs.get_smoke_config(ARCH)
    cell = build_cell(cfg, SHAPES[shape], batch=2, seq=32)
    fa.reset_launches()
    da.reset_launches()
    trace = cell.trace()
    assert trace.kernels == ({kernel: cfg.n_layers} if kernel else {})
    assert fa.LAUNCHES == {"flash_attention": 0}
    assert da.LAUNCHES == {"decode_attention": 0}
    assert trace.argument_bytes == sum(param_bytes(d)
                                       for d in cell.arg_decls)
    assert trace.memory()["fits"]
    assert trace.cost.flops > 0 and trace.cost.coll == {}


def _run_sub(code: str, env_extra=None) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               **(env_extra or {}))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=900)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    return r.stdout.strip().splitlines()[-1]


_CELLS = ("train_4k", "prefill_32k", "decode_32k")


def test_per_chip_flops_match_reference_hlo_cost():
    pytest.importorskip("jax")
    ref = json.loads(_run_sub(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import dataclasses, json
        import jax
        from jax.sharding import AxisType
        from repro.configs import SHAPES, get_smoke_config
        from repro.launch.steps import build_cell
        from repro.roofline import analysis
        mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                             axis_types=(AxisType.Auto,) * 3)
        cfg = get_smoke_config("{ARCH}")
        out = {{}}
        for name in {_CELLS!r}:
            shape = dataclasses.replace(SHAPES[name], global_batch=8,
                                        seq_len=64)
            comp = build_cell(cfg, shape, mesh).lower().compile()
            out[name] = analysis.analyze(comp, cfg, shape, 8).flops_per_chip
        print(json.dumps(out))
    """))
    ours = json.loads(_run_sub(f"""
        import json, logging
        logging.getLogger("torch.distributed.tensor._redistribute"
                          ).setLevel(logging.ERROR)
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs import SHAPES, get_smoke_config
        from repro_torch.launch.mesh import init_fake_world
        from repro_torch.launch.steps import build_cell
        init_fake_world(8)
        mesh = init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
        cfg = get_smoke_config("{ARCH}")
        out = {{}}
        for name in {_CELLS!r}:
            cell = build_cell(cfg, SHAPES[name], mesh, batch=8, seq=64)
            out[name] = cell.trace().cost.flops
        print(json.dumps(out))
    """))
    for name in _CELLS:
        ratio = ours[name] / ref[name]
        assert FLOPS_RATIO[0] <= ratio <= FLOPS_RATIO[1], (name, ratio)
