"""Port: ``checkpoint/manager.py``. Twins of ``tests/test_checkpoint.py``
(roundtrip with bf16 and scalars, compressed, GC, async, a crashed save
ignored; not the elastic restore across device counts, which waits for
the tooling slice), and interop with repro's manager both ways:

* repro's manager saves a smoke model's params (bf16, the MoE router
  fp32); the port's manager reads them with bytes equal, ``bridge``
  carries them over, and the port's loss on them equals repro's within
  1e-4 (both in fp32);
* a port-written tree of bf16, fp32 and int32 leaves (and the reference's
  own ``_tree``) reads back in repro's manager with equal bytes, and the
  two managers write the same files, byte for byte.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch import bridge, configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.models.transformer import Model


def _tree():
    return {
        "w": torch.from_numpy(np.random.default_rng(0).normal(
            size=(8, 4)).astype(np.float32)).to(torch.bfloat16),
        "b": torch.arange(4, dtype=torch.float32),
        "step": torch.tensor(7, dtype=torch.int32),
        "nested": [{"m": torch.ones((3,), dtype=torch.float32)}],
    }


def test_roundtrip(tmp_path):
    m = CheckpointManager(str(tmp_path))
    t = _tree()
    m.save(3, t, metadata={"note": "x"})
    out, step, meta = m.restore(t)
    assert step == 3 and meta["note"] == "x"
    for a, b in zip(tree_leaves(t), tree_leaves(out)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_roundtrip_compressed(tmp_path):
    m = CheckpointManager(str(tmp_path), compress=True)
    t = _tree()
    m.save(1, t)
    out, _, _ = m.restore(t)
    assert torch.equal(t["w"], out["w"])


def test_gc_keeps_last_k(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    for s in (1, 2, 3, 4):
        m.save(s, t)
    assert m.all_steps() == [3, 4]


def test_async_save(tmp_path):
    m = CheckpointManager(str(tmp_path))
    t = _tree()
    m.save_async(5, t)
    t["b"].add_(1.0)             # the snapshot was taken before this
    m.wait()
    assert m.latest_step() == 5
    out, _, _ = m.restore(t)
    assert torch.equal(out["b"], torch.arange(4, dtype=torch.float32))


def test_incomplete_tmp_ignored(tmp_path):
    m = CheckpointManager(str(tmp_path))
    t = _tree()
    m.save(1, t)
    os.makedirs(tmp_path / "step_000000000009.tmp")   # simulated crash
    os.makedirs(tmp_path / "step_000000000010")        # no manifest
    assert m.latest_step() == 1
    out, step, _ = m.restore(t)
    assert step == 1


def test_empty_and_numpy_leaves(tmp_path):
    m = CheckpointManager(str(tmp_path))
    t = {"e": torch.zeros((0, 3), dtype=torch.int64), "n": np.float64(2.5),
         "f": np.arange(3, dtype=np.int16), "flag": torch.tensor(True)}
    m.save(2, t)
    out, _, _ = m.restore(t)
    assert out["e"].shape == (0, 3) and out["e"].dtype == torch.int64
    assert out["n"].dtype == torch.float64 and float(out["n"]) == 2.5
    assert torch.equal(out["f"], torch.arange(3, dtype=torch.int16))
    assert out["flag"].dtype == torch.bool and bool(out["flag"])


# ---------------------------------------------------------------- interop --
def _bf16_np(t):
    import ml_dtypes
    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def test_reads_reference_checkpoint_of_model_params(tmp_path):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.checkpoint.manager import CheckpointManager as RefManager
    from repro.configs import get_smoke_config
    from repro.models.transformer import Model as RefModel
    arch = "deepseek-moe-16b"
    rm = RefModel(get_smoke_config(arch))
    params = rm.init(jax.random.PRNGKey(0))
    RefManager(str(tmp_path)).save(4, params, metadata={"arch": arch})
    template = jax.tree.map(np.asarray, params)
    got, step, meta = CheckpointManager(str(tmp_path)).restore(template)
    assert step == 4 and meta == {"arch": arch}
    for a, b in zip(jax.tree.leaves(template), tree_leaves(got)):
        assert str(a.dtype) == str(b.dtype).split(".")[1]
        np.testing.assert_array_equal(
            a.view(np.int16) if a.dtype.name == "bfloat16" else a,
            b.view(torch.int16).numpy() if b.dtype == torch.bfloat16
            else b.numpy())
    cfg = configs.get_smoke_config(arch)
    as_np = tree_map(lambda t: _bf16_np(t) if t.dtype == torch.bfloat16
                     else t.numpy(), got)
    port = tree_map(lambda t: t.float(), bridge.load_model(as_np, cfg))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 256, (2, 32)).astype(np.int32),
             "labels": rng.integers(0, 256, (2, 32)).astype(np.int32)}
    want = float(rm.loss(jax.tree.map(lambda a: a.astype(jnp.float32),
                                      params),
                         {k: jnp.asarray(v) for k, v in batch.items()})[0])
    got_loss = float(Model(cfg).loss(
        port, {k: torch.from_numpy(v) for k, v in batch.items()})[0])
    assert abs(got_loss - want) <= 1e-4


def test_reference_reads_port_checkpoint(tmp_path):
    jax = pytest.importorskip("jax")
    from repro.checkpoint.manager import CheckpointManager as RefManager
    rng = np.random.default_rng(3)
    t = {"w": torch.from_numpy(rng.normal(size=(5, 7)).astype(
        np.float32)).to(torch.bfloat16),
        "seg": [{"b": torch.from_numpy(rng.normal(size=(7,)).astype(
            np.float32)), "i": torch.arange(-3, 3, dtype=torch.int32)},
            {"scalar": torch.tensor(11, dtype=torch.int32)}]}
    for compress in (False, True):
        d = tmp_path / f"c{int(compress)}"
        CheckpointManager(str(d), compress=compress).save(
            9, t, metadata={"k": [1, 2]})
        template = tree_map(lambda x: 0, t)
        out, step, meta = RefManager(str(d)).restore(template)
        assert step == 9 and meta == {"k": [1, 2]}
        for a, b in zip(tree_leaves(t), jax.tree.leaves(out)):
            b = np.asarray(b)
            assert str(a.dtype).split(".")[1] == str(b.dtype)
            assert a.reshape(-1).view(torch.uint8).numpy().tobytes() == \
                b.tobytes()


def test_both_managers_write_the_same_files(tmp_path):
    jax = pytest.importorskip("jax")
    from repro.checkpoint.manager import CheckpointManager as RefManager
    t = _tree()
    ref_tree = tree_map(lambda x: _bf16_np(x) if x.dtype == torch.bfloat16
                        else x.numpy(), t)
    CheckpointManager(str(tmp_path / "port")).save(3, t, {"note": "x"})
    RefManager(str(tmp_path / "ref")).save(
        3, jax.tree.map(jax.numpy.asarray, ref_tree), {"note": "x"})
    a = tmp_path / "port" / "step_000000000003"
    b = tmp_path / "ref" / "step_000000000003"
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
