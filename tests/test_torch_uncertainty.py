"""Port parity: repro_torch's fused uncertainty scoring (the plain version
the CPU takes, and ``scores_from_logits``) against repro's
``uncertainty_stats_ref`` and ``uncertainty_stats_pallas(...,
interpret=True)``, on the reference's own cases (tests/test_kernels.py)
at its tolerances: 3e-5 fp32, 2e-2 bf16, 1e-4 for scale-80 logits.

Inputs are numpy normals; bf16 inputs are rounded to bf16 by JAX and
carried over exactly. A tied top-2 must give mc == 0 and rc == 1 exactly.

The ``cuda`` tests hold the CUDA kernel against the plain version on the
card; they need no JAX and skip where there is no GPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.strategies import uncertainty as punc
from repro_torch.kernels.uncertainty import ops

KINDS = ("lc", "mc", "rc", "es")
SHAPES = [(16, 128), (5, 300), (64, 1024), (1, 37)]


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    from repro.kernels.uncertainty import ref as rref
    from repro.kernels.uncertainty.kernel import uncertainty_stats_pallas
    return rref, uncertainty_stats_pallas


def _logits(seed, shape, dtype, scale=3.0):
    """(numpy input for JAX, torch tensor of the same values)."""
    x = (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)
    if dtype == "bf16":
        import jax.numpy as jnp
        xj = jnp.asarray(x, jnp.bfloat16)
        return xj, torch.from_numpy(np.asarray(xj, np.float32)).to(
            torch.bfloat16)
    return x, torch.from_numpy(x)


def _ties(n=6, v=300, seed=3):
    """Logits on the bf16 grid with the top two of every row tied, at
    random columns (the leftmost of the pair first or second)."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.normal(size=(n, v)) * 8) / 8
    for r in range(n):
        a, b = rng.choice(v, 2, replace=False)
        x[r, a] = x[r, b] = x[r].max() + 1.0
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_reference(ref, shape, dtype):
    rref, pallas = ref
    seed = shape[0] * 1000 + shape[1]
    xj, xt = _logits(seed, shape, dtype)
    got = ops.uncertainty_stats(xt)
    want = rref.uncertainty_stats_ref(xj)
    kern = np.asarray(pallas(xj, row_block=8, v_block=128, interpret=True))
    tol = 3e-5 if dtype == "fp32" else 2e-2
    for i, k in enumerate(KINDS):
        assert got[k].dtype == torch.float32 and got[k].shape == (shape[0],)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=tol, atol=tol, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), kern[i], rtol=tol,
                                   atol=tol, err_msg=k)


def test_extreme_logits(ref):
    """Scale-80 logits: the online statistics must not overflow."""
    rref, pallas = ref
    xj, xt = _logits(7, (8, 512), "fp32", scale=80.0)
    got = ops.uncertainty_stats(xt)
    want = rref.uncertainty_stats_ref(xj)
    kern = np.asarray(pallas(xj, interpret=True))
    for i, k in enumerate(KINDS):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), kern[i], rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_tied_top2_is_exact(ref):
    rref, pallas = ref
    x = _ties()
    got = ops.uncertainty_stats(x)
    assert torch.all(got["mc"] == 0) and torch.all(got["rc"] == 1)
    kern = np.asarray(pallas(x.numpy(), row_block=8, v_block=128,
                             interpret=True))
    assert (kern[1] == 0).all() and (kern[2] == 1).all()


@pytest.mark.parametrize("kind", KINDS)
def test_scores_from_logits_matches_reference(kind):
    pytest.importorskip("jax")
    from repro.core.strategies import uncertainty as runc
    xj, xt = _logits(11, (32, 256), "fp32", scale=2.0)
    np.testing.assert_allclose(
        punc.scores_from_logits(xt, kind).numpy(),
        np.asarray(runc.scores_from_logits(xj, kind, impl="ref")),
        rtol=3e-5, atol=3e-5)


def test_dispatch():
    x = _logits(2, (4, 50), "fp32")[1]
    a = ops.uncertainty_stats(x)
    b = ops.uncertainty_stats(x, impl="ref")
    for k in KINDS:
        assert torch.equal(a[k], b[k])
        assert torch.equal(ops.uncertainty_scores(x, k), a[k])
    with pytest.raises(ValueError, match="impl"):
        ops.uncertainty_stats(x, impl="pallas")
    with pytest.raises(ValueError, match="kind"):
        ops.uncertainty_scores(x, "bald")
    assert ops.LAUNCHES["uncertainty_stats"] == 0   # the CPU launches none


def _split_ties(v, split, pairs, seed=4):
    """Logits on the bf16 grid whose row k has its top two tied at the
    columns ``pairs[k]``."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.normal(size=(len(pairs), v)) * 8) / 8
    for r, (a, b) in enumerate(pairs):
        x[r, a] = x[r, b] = x[r].max() + 1.0
    return x.astype(np.float32)


@pytest.mark.parametrize("split", [64, 100, 4_096])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_split_ref_matches_reference(ref, shape, dtype, split):
    """The kernel's split-and-merge arithmetic in plain form against the
    reference's plain version, at its tolerances."""
    rref, _ = ref
    seed = shape[0] * 1000 + shape[1]
    xj, xt = _logits(seed, shape, dtype)
    got = ops.ref.uncertainty_stats_split_ref(xt, split)
    want = rref.uncertainty_stats_ref(xj)
    tol = 3e-5 if dtype == "fp32" else 2e-2
    for k in KINDS:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=tol, atol=tol, err_msg=k)


# the padded vocabularies of the served archs other than qwen3-8b's and
# qwen1.5-4b's 152,064: internlm2-20b, phi3-medium-14b and
# deepseek-moe-16b (the last fp32 split is ragged: 2,560, 2,048 and 4,096
# of 8,192 logits)
SERVE_VOCABS = [92_672, 100_352, 102_400]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("v", SERVE_VOCABS)
def test_split_ref_at_serve_vocabs(ref, v, dtype):
    """The kernel's split plan and arithmetic at each served width
    against the reference's plain version."""
    rref, _ = ref
    xj, xt = _logits(v, (2, v), dtype)
    plan = ops.split_plan(2, v, xt.dtype)
    assert plan.splits == -(-v // ops.SPLIT_ELEMS[xt.dtype])
    got = ops.ref.uncertainty_stats_split_ref(xt, plan.split_elems)
    want = rref.uncertainty_stats_ref(xj)
    tol = 3e-5 if dtype == "fp32" else 2e-2
    for k in KINDS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=tol, atol=tol, err_msg=k)


def test_split_ref_extreme_logits(ref):
    rref, _ = ref
    xj, xt = _logits(7, (8, 512), "fp32", scale=80.0)
    got = ops.ref.uncertainty_stats_split_ref(xt, 100)
    want = rref.uncertainty_stats_ref(xj)
    for k in KINDS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("split", [64, 100])
def test_split_ref_ties_across_a_split_boundary(ref, split):
    """Tied top-2 logits in two different splits (adjacent across a
    boundary, far apart, and in one split) give mc == 0 and rc == 1
    exactly, as in the reference."""
    rref, _ = ref
    x = _split_ties(300, split, [(split - 1, split), (3, 2 * split + 7),
                                 (split, 299), (5, 6)])
    got = ops.ref.uncertainty_stats_split_ref(torch.from_numpy(x), split)
    assert torch.all(got["mc"] == 0) and torch.all(got["rc"] == 1)
    want = rref.uncertainty_stats_ref(x)
    assert (np.asarray(want["mc"]) == 0).all()
    for k in KINDS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=3e-5, atol=3e-5, err_msg=k)


def test_split_count_depends_on_v_and_dtype_alone():
    """The kernel's splits a row (and their width) are fixed by V and the
    dtype; the rows launched only multiply the grid."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=300, deadline=None, database=None)
    @given(n=st.integers(1, 100_000), m=st.integers(1, 100_000),
           v=st.integers(1, 2_000_000),
           dtype=st.sampled_from(list(ops.SPLIT_ELEMS)))
    def check(n, m, v, dtype):
        a, b = ops.split_plan(n, v, dtype), ops.split_plan(m, v, dtype)
        assert (a.splits, a.split_elems) == (b.splits, b.split_elems)
        assert a.split_elems == ops.SPLIT_ELEMS[dtype]
        assert (a.splits - 1) * a.split_elems < v <= a.splits * a.split_elems
        assert a.ctas == n * a.splits
    check()
    # 16 x 152,064 fp32, the decode shape: 19 splits of 32 KB a row
    assert ops.split_plan(16, 152_064, torch.float32).ctas == 16 * 19


# ------------------------------------------------------------- on the card --
@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 152_064), (1, 37), (7, 300),
                                   (64, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_kernel_matches_plain(gpu, shape, dtype):
    x = _logits(shape[0] + shape[1], shape, "fp32")[1].to(gpu, dtype)
    before = ops.LAUNCHES["uncertainty_stats"]
    got = ops.uncertainty_stats(x)
    want = ops.uncertainty_stats(x, impl="ref")
    assert ops.LAUNCHES["uncertainty_stats"] == before + 1
    tol = 3e-5 if dtype == torch.float32 else 2e-2
    for k in KINDS:
        torch.testing.assert_close(got[k], want[k], rtol=tol, atol=tol)


@pytest.mark.cuda
def test_kernel_extreme_ties_and_rows(gpu):
    x = _logits(5, (8, 512), "fp32", scale=80.0)[1].to(gpu)
    got, want = ops.uncertainty_stats(x), ops.uncertainty_stats(x, impl="ref")
    for k in KINDS:
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-4)
    t = ops.uncertainty_stats(_ties().to(gpu))
    assert torch.all(t["mc"] == 0) and torch.all(t["rc"] == 1)
    # a row's scores do not depend on the rows launched with it
    big = _logits(9, (64, 4096), "fp32")[1].to(gpu)
    whole = ops.uncertainty_stats(big)
    one = ops.uncertainty_stats(big[17:18])
    for k in KINDS:
        assert torch.equal(whole[k][17:18], one[k])
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        ops.uncertainty_stats(big.double())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 152_064), (7, 300), (3, 8_193)] +
                         [(16, v) for v in SERVE_VOCABS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_cuda_kernel_matches_split_ref(gpu, shape, dtype):
    x = _logits(shape[0] * 7 + shape[1], shape, "fp32")[1].to(gpu, dtype)
    got = ops.uncertainty_stats(x)
    want = ops.ref.uncertainty_stats_split_ref(x, ops.SPLIT_ELEMS[dtype])
    for k in KINDS:
        torch.testing.assert_close(got[k], want[k], rtol=3e-5, atol=3e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_row_bytes_alone_and_among_4096_rows(gpu, dtype):
    big = _logits(12, (4_096, 152_064), "fp32")[1].to(gpu, dtype)
    whole = ops.uncertainty_stats(big)
    for r in (0, 2_049, 4_095):
        one = ops.uncertainty_stats(big[r:r + 1])
        for k in KINDS:
            assert torch.equal(whole[k][r:r + 1], one[k]), (r, k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ties_straddle_split_boundary(gpu, dtype):
    split = ops.SPLIT_ELEMS[dtype]
    x = _split_ties(152_064, split, [(split - 1, split), (10, 150_000),
                                     (2 * split, 3 * split - 1)])
    got = ops.uncertainty_stats(torch.from_numpy(x).to(gpu, dtype))
    assert torch.all(got["mc"] == 0) and torch.all(got["rc"] == 1)
