"""Port parity: ``launch/train.py``'s ``run_training`` against repro's on
the CPU, twins of ``tests/test_train.py``'s two slow end-to-end tests,
and ``data/prefetch.py``'s contract.

``run_training`` of qwen1.5-4b's smoke config is fed the reference's
params (its ``Model.init`` at seed 0 cast to fp32, carried over by
``bridge.load_model``), the same token pool and the same seed, with
AdamW at lr 1e-3 and warmup 5, B 2 x S 32, 16 steps: every per-step loss
within 1e-4 of the reference's (the largest difference seen is 9.5e-7),
with no checkpoint and with ``ckpt_every=5, fail_at=[8]``. The second
holds the reference's resume quirk: after the failure at step 8 the run
restores step 5's checkpoint, restarts the batch iterator from its seed
(so steps 5-15 take batches 0-10), and ``losses`` keeps the 8 steps
before the failure: 19 losses, ``restarts == 1``, checkpoints 10, 15, 16.
"""
import numpy as np
import pytest
import torch

from repro_torch import bridge, configs
from repro_torch.data.prefetch import prefetch_to_device
from repro_torch.data.synthetic import lm_pool
from repro_torch.launch.train import run_training

ARCH = "qwen1.5-4b"
KW = dict(smoke=True, steps=16, batch=2, seq=32, log_every=0, lr=1e-3,
          warmup=5)


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's small CPU ops run faster on one thread, and the test
    workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_params():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.models.transformer import Model as RefModel
    params = RefModel(get_smoke_config(ARCH)).init(jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), params)


@pytest.mark.parametrize("fail", [False, True])
def test_run_training_matches_reference(ref_params, tmp_path, fail):
    jax = pytest.importorskip("jax")
    from repro.launch.train import run_training as ref_run
    tokens, _ = lm_pool(32, KW["seq"] + 1, 256, seed=0)
    extra = (dict(ckpt_every=5, fail_at=[8]) if fail else {})
    want = ref_run(ARCH, tokens=tokens,
                   params_init=jax.tree.map(jax.numpy.asarray, ref_params),
                   ckpt_dir=str(tmp_path / "ref") if fail else None,
                   **extra, **KW)
    got = run_training(ARCH, tokens=tokens, device="cpu",
                       params_init=bridge.load_model(
                           ref_params, configs.get_smoke_config(ARCH)),
                       ckpt_dir=str(tmp_path / "port") if fail else None,
                       **extra, **KW)
    assert len(got.losses) == len(want.losses) == (19 if fail else 16)
    np.testing.assert_allclose(got.losses, want.losses, rtol=0, atol=1e-4)
    assert got.final_loss == got.losses[-1]
    assert (got.restarts, got.steps, got.ckpt_steps) == \
        (want.restarts, want.steps, want.ckpt_steps)
    assert len(got.step_s) == len(got.losses)
    if fail:
        assert got.restarts == 1 and got.ckpt_steps == [10, 15, 16]


def test_resume_replays_the_stream_from_its_start(ref_params, tmp_path):
    """The resumed round's first step (step 5 on batch 0) is the
    uninterrupted run's step 0 taken from step 5's params: its loss is
    not the uninterrupted run's step 5 (batch 5)."""
    cfg = configs.get_smoke_config(ARCH)
    tokens, _ = lm_pool(32, KW["seq"] + 1, 256, seed=0)
    clean = run_training(ARCH, tokens=tokens, device="cpu",
                         params_init=bridge.load_model(ref_params, cfg), **KW)
    resumed = run_training(ARCH, tokens=tokens, device="cpu",
                           params_init=bridge.load_model(ref_params, cfg),
                           ckpt_dir=str(tmp_path), ckpt_every=5,
                           fail_at=[8], **KW)
    assert resumed.losses[:8] == clean.losses[:8]
    assert resumed.losses[8] != clean.losses[5]


# ---------------------------------- twins of tests/test_train.py's e2e ----
def test_training_loss_decreases():
    rep = run_training("qwen1.5-4b", smoke=True, steps=30, batch=4, seq=32,
                       pool_size=64, log_every=0, lr=1e-3, warmup=5,
                       device="cpu")
    first = np.mean(rep.losses[:5])
    last = np.mean(rep.losses[-5:])
    assert last < first - 0.05, (first, last)


def test_training_failure_resume(tmp_path):
    rep = run_training("qwen1.5-4b", smoke=True, steps=16, batch=2, seq=32,
                       pool_size=32, ckpt_dir=str(tmp_path / "ck"),
                       ckpt_every=5, fail_at=[8], log_every=0, device="cpu")
    assert rep.restarts == 1
    assert rep.steps == 16
    assert rep.ckpt_steps[-1] == 16


# ------------------------------------------------------------- prefetch ----
def _items(n, fail_after=None):
    for i in range(n):
        if fail_after is not None and i == fail_after:
            raise RuntimeError("producer fault")
        yield {"tokens": np.full((2, 3), i, np.int32),
               "labels": np.full((2, 3), -i, np.int32)}


def test_prefetch_keeps_order_and_puts_tensors_on_the_device():
    out = list(prefetch_to_device(_items(7), size=2, device="cpu"))
    assert [int(b["tokens"][0, 0]) for b in out] == list(range(7))
    for b in out:
        assert isinstance(b["tokens"], torch.Tensor)
        assert b["tokens"].dtype == torch.int32
        assert b["labels"].device.type == "cpu"


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_prefetch_producer_error_ends_the_stream_as_the_reference():
    """The reference's contract, kept: an error in the iterator ends the
    stream after the items before it, and is not raised to the consumer
    (ROADMAP C: this can shorten a training run silently)."""
    pytest.importorskip("jax")
    from repro.data.prefetch import prefetch_to_device as ref_prefetch
    got = list(prefetch_to_device(_items(7, fail_after=3), device="cpu"))
    want = list(ref_prefetch(_items(7, fail_after=3)))
    assert len(got) == len(want) == 3


# ------------------------------------------- the AL-train example's twin --
def test_al_train_loop_evals_fall():
    """``repro_torch.examples.al_train_loop`` on the smoke config: es and
    random each fine-tune 3 rounds; the held-out loss is finite and falls
    with either."""
    from repro_torch.examples import al_train_loop as alt
    cfg = alt.config()
    for strategy in ("es", "random"):
        out = alt.run(strategy, cfg, "cpu", log=False)
        ev = np.asarray(out["evals"])
        assert len(ev) == alt.ROUNDS and np.isfinite(ev).all()
        assert ev[-1] < ev[0], (strategy, ev)
        assert len(out["round_s"]) == alt.ROUNDS
