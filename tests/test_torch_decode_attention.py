"""Port parity: repro_torch's decode attention against repro's, on the
reference's four cases (tests/test_kernels.py) at fp32 and bf16.

* The port's plain ``decode_attention`` (what a CPU tensor takes, through
  ``decode_attention_auto`` too) against the reference's jnp
  ``decode_attention``: within 1e-6 at fp32 (the two sum in other orders;
  the largest difference seen is 1.5e-7), and bit-equal at bf16, where
  both round q to the cache dtype, p to the V dtype, and the output to
  bf16 (it holds on all four cases).
* The reference's Pallas kernel in interpret mode, which keeps q and p in
  fp32, against the port's plain version: the reference's own tolerances,
  2e-4 at fp32 and 3e-2 at bf16.

Inputs are numpy normals; bf16 inputs are rounded by JAX and carried over
exactly. The ``cuda`` tests hold the CUDA kernel against the plain version
on the card at the same tolerances; they need no JAX and skip where there
is no GPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import ops
from repro_torch.models.layers import attention as pattn

CASES = [
    dict(B=2, H=4, KH=2, D=32, S=128, cur=77, win=None),
    dict(B=1, H=8, KH=1, D=64, S=96, cur=96, win=None),
    dict(B=2, H=4, KH=4, D=16, S=64, cur=13, win=8),
    dict(B=3, H=16, KH=2, D=64, S=200, cur=1, win=None),
]
TOL = {"fp32": 2e-4, "bf16": 3e-2}


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    from repro.kernels.decode_attention.kernel import decode_attention_pallas
    from repro.models.layers import attention as rattn
    return rattn, decode_attention_pallas


def _inputs(seed, c, dtype):
    """(q, k, v) as arrays for JAX and as torch tensors, same values."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32) for s in (
        (c["B"], 1, c["H"], c["D"]), (c["B"], c["S"], c["KH"], c["D"]),
        (c["B"], c["S"], c["KH"], c["D"]))]
    if dtype == "bf16":
        import jax.numpy as jnp
        js = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
        return js, [torch.from_numpy(np.asarray(j, np.float32)).to(
            torch.bfloat16) for j in js]
    return arrs, [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("ci", range(len(CASES)))
def test_plain_matches_reference(ref, ci, dtype):
    rattn, pallas = ref
    c = CASES[ci]
    (jq, jk, jv), (q, k, v) = _inputs(ci * 10 + len(dtype), c, dtype)
    got = ops.decode_attention_auto(q, k, v, c["cur"], window=c["win"])
    assert got.dtype == q.dtype and got.shape == q.shape
    got = got.float().numpy()
    want = np.asarray(rattn.decode_attention(jq, jk, jv, c["cur"],
                                             window=c["win"]), np.float32)
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
    kern = np.asarray(pallas(jq, jk, jv, c["cur"], window=c["win"],
                             kv_block=32, interpret=True), np.float32)
    np.testing.assert_allclose(got, kern, rtol=TOL[dtype], atol=TOL[dtype])


def test_cur_len_tensor_and_dispatch():
    c = CASES[0]
    _, (q, k, v) = _inputs(5, c, "fp32")
    a = ops.decode_attention_auto(q, k, v, c["cur"])
    b = ops.decode_attention_auto(q, k, v,
                                  torch.tensor(c["cur"], dtype=torch.int32))
    assert torch.equal(a, b)
    assert torch.equal(a, ops.decode_attention_auto(q, k, v, c["cur"],
                                                    impl="ref"))
    assert torch.equal(a, pattn.decode_attention(q, k, v, c["cur"]))
    with pytest.raises(ValueError, match="impl"):
        ops.decode_attention_auto(q, k, v, 3, impl="pallas")
    with pytest.raises(ValueError, match="window"):
        ops.decode_attention_auto(q, k, v, 3, window=0)
    assert ops.LAUNCHES["decode_attention"] == 0   # the CPU launches none


# ------------------------------------------------------------- on the card --
@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card(seed, c, dtype, dev):
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev).to(tdt) for s in (
        (c["B"], 1, c["H"], c["D"]), (c["B"], c["S"], c["KH"], c["D"]),
        (c["B"], c["S"], c["KH"], c["D"]))]


QWEN3 = [dict(B=16, H=32, KH=8, D=128, S=1024, cur=577, win=w)
         for w in (None, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("ci", range(len(CASES) + len(QWEN3)))
def test_kernel_matches_plain(gpu, ci, dtype):
    c = (CASES + QWEN3)[ci]
    q, k, v = _card(ci, c, dtype, gpu)
    cur = torch.tensor(c["cur"], dtype=torch.int32, device=gpu)
    # the reference's cases at its test's kv_block, 32 (several KV blocks,
    # and with a window, skipped leading ones); the qwen3 shape at 256
    kb = 32 if ci < len(CASES) else ops.KV_BLOCK
    before = ops.LAUNCHES["decode_attention"]
    got = ops.decode_attention_auto(q, k, v, cur, window=c["win"],
                                    kv_block=kb)
    want = ops.decode_attention_auto(q, k, v, cur, window=c["win"],
                                     impl="ref")
    assert ops.LAUNCHES["decode_attention"] == before + 1
    assert got.dtype == q.dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.cuda
def test_kernel_refusals(gpu):
    c = dict(B=1, H=2, KH=1, D=320, S=8, cur=4, win=None)
    q, k, v = _card(0, c, "fp32", gpu)
    with pytest.raises(ValueError, match="head_dim"):
        ops.decode_attention_auto(q, k, v, 4)
    q, k, v = _card(0, CASES[0], "fp32", gpu)
    with pytest.raises(ValueError, match="one dtype"):
        ops.decode_attention_auto(q.bfloat16(), k, v, 4)
