"""Port parity: the mesh half of ``core/selection.py`` and
``optim/compression.py``'s ``compressed_psum`` over ``torch.distributed``
groups (``launch/mesh.py``: spawned gloo ranks on the CPU) against repro's
``shard_map`` programs on 4 forced host devices (run in a subprocess, as
``tests/test_distributed.py`` runs them).

On 4 ranks, with the same numpy inputs:

* ``distributed_top_k`` returns the reference's indices exactly, on
  scores with ties planted across ranks (values on a 1/4 grid) at a
  budget below and above a shard's 128 rows;
* ``distributed_k_center`` returns the reference's indices exactly:
  unweighted, with ones-weights (equal to unweighted, as the reference's
  test asserts), weighted (the reference's favoured upper half), and from
  a given ``init_center``;
* ``sharded_scores`` equals the port's unsharded scores bit for bit
  (each row's floats do not depend on the shard), and the reference's
  within its kernel bar, 3e-5 (the reference scores with jnp, the port's
  CPU path with torch: their last bits differ; ``test_torch_uncertainty``
  holds the same bar);
* ``compressed_psum`` equals the reference's bit for bit (quantize, a
  max, an int32 sum and one product: every step exact); without
  quantization it is the sum within 1e-6 (the backend's order);
* every result is the same at world sizes 1, 2 and 4.

Also: uneven shards raise, as the reference needs N divisible by the
ranks; a global index past 2**24 comes back exact (it rides the gathered
fp32 buffer as int64 bits); and, on the card, ``attention`` raises for
``"pallas"`` on a CUDA tensor that requires grad (the flash kernel has no
backward).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core.selection import (distributed_k_center,
                                        distributed_top_k, sharded_scores)
from repro_torch.launch.mesh import run_debug_mesh
from repro_torch.optim.compression import compressed_psum

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D, C, BUDGET_KC = 256, 16, 64, 12
TOP_BUDGETS = (16, 200)
KINDS = ("lc", "mc", "rc", "es")
KC_CASES = ("unweighted", "ones", "weighted", "init_center")


def _inputs():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(N, D)).astype(np.float32)
    w = rng.uniform(0.001, 1.0, size=(N,)).astype(np.float32)
    w[N // 2:] *= 1000.0
    return {
        "scores": (np.round(rng.normal(size=(N * 2,)) * 4) / 4).astype(
            np.float32),
        "pts": pts, "w": w,
        "center": rng.normal(size=(D,)).astype(np.float32),
        "logits": (rng.normal(size=(N, C)) * 2).astype(np.float32),
        "g": rng.normal(size=(4, 64)).astype(np.float32),
    }


def _shard(a, rank, world):
    n = a.shape[0] // world
    return torch.from_numpy(np.ascontiguousarray(a[rank * n:(rank + 1) * n]))


def _port_rank(rank, world, group, device, inp):
    out = {}
    sc = _shard(inp["scores"], rank, world)
    for b in TOP_BUDGETS:
        out[f"top_{b}"] = distributed_top_k(sc, b, group).numpy()
    pts = _shard(inp["pts"], rank, world)
    ones = torch.ones(pts.shape[0])
    kw = {"unweighted": {}, "ones": {"weights": ones},
          "weighted": {"weights": _shard(inp["w"], rank, world)},
          "init_center": {"init_center": torch.from_numpy(inp["center"])}}
    for case in KC_CASES:
        out[f"kc_{case}"] = distributed_k_center(pts, BUDGET_KC, group,
                                                 **kw[case]).numpy()
    lg = _shard(inp["logits"], rank, world)
    for k in KINDS:
        out[f"scores_{k}"] = sharded_scores(lg, k).numpy()
    if world == 4:
        g = torch.from_numpy(inp["g"][rank])
        out["psum"] = compressed_psum(g, group).numpy()
        out["psum_exact"] = compressed_psum(g, group, quantize=False).numpy()
    return out


@pytest.fixture(scope="module")
def port():
    inp = _inputs()
    return {w: run_debug_mesh(_port_rank, w, inp, device="cpu")
            for w in (1, 2, 4)}


_REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, "src")
    import jax, jax.numpy as jnp, numpy as np
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.core.selection import (distributed_k_center,
                                      distributed_top_k, sharded_scores)
    from repro.launch.mesh import make_debug_mesh, set_mesh
    from repro.optim.compression import compressed_psum
    inp = dict(np.load(sys.argv[1]))
    mesh = make_debug_mesh((4,), ("data",))
    out = {}
    with set_mesh(mesh):
        for b in (16, 200):
            out[f"top_{b}"] = distributed_top_k(
                jnp.asarray(inp["scores"]), b, mesh)
        pts = jnp.asarray(inp["pts"])
        kw = {"unweighted": {},
              "ones": {"weights": jnp.ones((pts.shape[0],), jnp.float32)},
              "weighted": {"weights": jnp.asarray(inp["w"])},
              "init_center": {"init_center": jnp.asarray(inp["center"])}}
        for case, k in kw.items():
            out[f"kc_{case}"] = distributed_k_center(pts, 12, mesh, **k)
        for kind in ("lc", "mc", "rc", "es"):
            out[f"scores_{kind}"] = sharded_scores(
                jnp.asarray(inp["logits"]), kind, mesh)
        fn = shard_map(lambda x: compressed_psum(x[0], "data"), mesh=mesh,
                       in_specs=P("data", None), out_specs=P(),
                       check_rep=False)
        out["psum"] = fn(jnp.asarray(inp["g"]))
    np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
    print("REF_OK")
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    pytest.importorskip("jax")
    d = tmp_path_factory.mktemp("mesh_ref")
    np.savez(d / "inp.npz", **_inputs())
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REF, str(d / "inp.npz"),
                        str(d / "out.npz")], capture_output=True, text=True,
                       env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0 and "REF_OK" in r.stdout, r.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


def test_distributed_top_k_matches_reference_with_planted_ties(port, ref):
    scores = _inputs()["scores"]
    assert len(np.unique(scores)) < len(scores) // 4     # many exact ties
    for b in TOP_BUDGETS:
        got = [o[f"top_{b}"] for o in port[4]]
        for g in got:
            np.testing.assert_array_equal(g, ref[f"top_{b}"])
        # lax.top_k's rule on the whole vector: ties to the lower index
        order = np.lexsort((np.arange(len(scores)), -scores))[:b]
        np.testing.assert_array_equal(got[0], order)


@pytest.mark.parametrize("case", KC_CASES)
def test_distributed_k_center_matches_reference(port, ref, case):
    for o in port[4]:
        np.testing.assert_array_equal(o[f"kc_{case}"], ref[f"kc_{case}"])
    got = port[4][0][f"kc_{case}"]
    assert len(set(got.tolist())) == BUDGET_KC
    if case == "unweighted":
        assert got[0] == 0                       # the seed is global row 0
    if case == "weighted":
        assert np.mean(got[1:] >= N // 2) >= 0.7, got


def test_ones_weights_equal_unweighted(port):
    for w in (1, 2, 4):
        np.testing.assert_array_equal(port[w][0]["kc_ones"],
                                      port[w][0]["kc_unweighted"])


def test_sharded_scores_bit_for_bit(port, ref):
    from repro_torch.kernels.uncertainty import ops
    logits = torch.from_numpy(_inputs()["logits"])
    for k in KINDS:
        whole = ops.uncertainty_scores(logits, k).numpy()
        for w in (1, 2, 4):
            got = np.concatenate([o[f"scores_{k}"] for o in port[w]])
            np.testing.assert_array_equal(got, whole)
        np.testing.assert_allclose(whole, ref[f"scores_{k}"], rtol=3e-5,
                                   atol=3e-5)


def test_compressed_psum_matches_reference(port, ref):
    g = _inputs()["g"]
    for o in port[4]:
        np.testing.assert_array_equal(o["psum"], ref["psum"])
        np.testing.assert_allclose(o["psum_exact"], g.sum(0), rtol=1e-6,
                                   atol=1e-6)
    err = np.abs(port[4][0]["psum"] - g.sum(0)).max() / np.abs(
        g.sum(0)).max()
    assert err < 0.05, err


def test_sharded_equals_world_1(port):
    keys = [k for k in port[1][0] if not k.startswith("scores_")]
    for w in (2, 4):
        for o in port[w]:
            for k in keys:
                np.testing.assert_array_equal(o[k], port[1][0][k], k)


def _uneven_rank(rank, world, group, device):
    pts = torch.zeros((5 + rank, 3))
    return distributed_k_center(pts, 2, group)


def test_uneven_shards_raise():
    with pytest.raises(RuntimeError, match="split evenly"):
        run_debug_mesh(_uneven_rank, 2, device="cpu")


BIG = 2 ** 24 + 8                      # rows a rank: global rows past 2**24


def _far_index_rank(rank, world, group, device):
    pts = torch.zeros((BIG, 1))
    scores = torch.zeros(BIG)
    if rank == 1:
        pts[5, 0] = 3.0                # global row 2**24 + 13: not an fp32
        scores[5] = 1.0
    return (distributed_k_center(pts, 2, group).numpy(),
            distributed_top_k(scores, 1, group).numpy())


def test_global_index_past_2_24_is_exact():
    far = BIG + 5
    assert float(np.float32(far)) != far
    for kc, top in run_debug_mesh(_far_index_rank, 2, device="cpu"):
        assert kc.tolist() == [0, far] and top.tolist() == [far]


@pytest.mark.cuda
def test_cuda_pallas_attention_refuses_grad():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.models.layers.attention import attention
    q = torch.randn(1, 8, 2, 16, device="cuda", requires_grad=True)
    k = torch.randn(1, 8, 2, 16, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        attention(q, k, k, impl="pallas", causal=True)
    with torch.no_grad():            # serving: the kernel runs
        assert attention(q, k, k, impl="pallas").shape == q.shape
