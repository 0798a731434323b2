"""Port parity: repro_torch's pairwise ops against repro's ``impl="ref"``.

Inputs come from numpy seeds and go through both packages as numpy arrays.
Tolerance: fp32 values within atol 1e-5 (inputs are scaled so distances
stay O(1), where a few ulps of reordered sums are ~1e-6). Indices must be
exactly equal: on separated inputs and on planted exact ties (duplicated
rows or centers compute bitwise-equal distances in both packages, so the
lowest-index rule alone decides them).

The ``cuda`` tests hold the CUDA kernels against the port's plain
versions on the card; they need no JAX and skip where there is no GPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.pairwise import autotune, ops, ref

ATOL = 1e-5


@pytest.fixture
def rops(monkeypatch):
    """The reference ops module (skips when JAX is missing), with the
    reference's block autotuner kept off disk."""
    pytest.importorskip("jax")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE_DIR", "")
    from repro.kernels.pairwise import ops as reference_ops
    return reference_ops


def _pool(seed, n=96, d=16, scale=0.25):
    return (np.random.default_rng(seed).normal(size=(n, d)) * scale).astype(
        np.float32)


def _j(a):
    import jax.numpy as jnp
    return jnp.asarray(a)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("case", ["separated", "ties", "ragged"])
def test_pairwise_min_and_argmin_matches_reference(rops, case):
    x = _pool(1, n=97 if case == "ragged" else 96)
    c = _pool(2, n=13 if case == "ragged" else 12)
    if case == "ties":
        c[7] = c[3]              # duplicate center: index 3 must win
        c[11] = c[3]
        x[:10] = c[3] + 1e-3     # rows whose nearest center is the tie
    pm, pa = ops.pairwise_min_and_argmin(torch.from_numpy(x),
                                         torch.from_numpy(c))
    rm, ra = rops.pairwise_min_and_argmin(_j(x), _j(c), impl="ref")
    _close(pm, rm)
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ra))
    assert pa.dtype == torch.int32
    if case == "ties":
        assert (pa.numpy()[:10] == 3).all()


def test_sq_dists_and_center_distance_match_reference(rops):
    x, c = _pool(3), _pool(4, n=7)
    _close(ops.pairwise_sq_dists(torch.from_numpy(x), torch.from_numpy(c)),
           rops.pairwise_sq_dists(_j(x), _j(c)))
    _close(ops.sq_dist_to_center(torch.from_numpy(x), torch.from_numpy(c[2])),
           rops.sq_dist_to_center(_j(x), _j(c[2])))


@pytest.mark.parametrize("r", [1, 5])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", ["separated", "ties"])
def test_greedy_round_matches_reference(rops, r, weighted, case):
    rng = np.random.default_rng(10 + r)
    x = _pool(5)
    n = x.shape[0]
    mind = np.full((n,), 3.4e38, np.float32)
    mind[[4, 40, 77]] = -1.0                        # carried-in selections
    centers = x[[9, 18, 27, 36, 45][:r]]
    sel = np.asarray([9, 18, 27, 36, 45][:r], np.int32)
    w = None
    if weighted:
        w = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
        w[[4, 50, 51]] = 0.0                        # zero weights
    if case == "ties":
        x[70] = x[30] = x[30] * 4.0                 # far, duplicated rows
        if w is not None:
            w[70] = w[30]
    else:
        sel[0] = -1                                 # a no-mask slot
    pn, pi, ps = ops.greedy_round(
        torch.from_numpy(x), torch.from_numpy(mind),
        torch.from_numpy(x[[9, 18, 27, 36, 45][:r]] if case == "ties"
                         else centers),
        torch.from_numpy(sel), None if w is None else torch.from_numpy(w))
    rn, ri, rs = rops.greedy_round(
        _j(x), _j(mind), _j(x[[9, 18, 27, 36, 45][:r]] if case == "ties"
                            else centers),
        _j(sel), None if w is None else _j(w), impl="ref")
    _close(pn, rn)
    assert int(pi) == int(ri)
    np.testing.assert_allclose(float(ps), float(rs), rtol=1e-6)
    if case == "ties":
        assert int(pi) == 30
    assert (pn.numpy()[[4, 40, 77]] == -1.0).all()


def test_greedy_round_all_masked_with_zero_weights(rops):
    """Every row selected and every weight zero: masked rows still score
    -BIG (pinned before the multiply), so the argmax falls to index 0 in
    both packages instead of a -0.0 tie."""
    x = _pool(6, n=8)
    mind = np.full((8,), -1.0, np.float32)
    w = np.zeros((8,), np.float32)
    sel = np.asarray([-1], np.int32)
    pn, pi, ps = ops.greedy_round(torch.from_numpy(x), torch.from_numpy(mind),
                                  torch.from_numpy(x[:1]),
                                  torch.from_numpy(sel), torch.from_numpy(w))
    rn, ri, rs = rops.greedy_round(_j(x), _j(mind), _j(x[:1]), _j(sel),
                                   _j(w), impl="ref")
    assert int(pi) == int(ri) == 0
    assert float(ps) == float(rs) == float(np.float32(-ref.BIG))


def test_greedy_round_rejects_unmatched_sel_idx():
    x = torch.zeros((4, 2))
    with pytest.raises(ValueError):
        ops.greedy_round(x, torch.zeros(4), x[:2],
                         torch.full((1,), -1, dtype=torch.int32))


@pytest.mark.parametrize("m,r_block", [(9, 4), (8, 4), (3, None)])
def test_warm_start_chunking_matches_reference(rops, m, r_block):
    """Chunks of r_block centers, a trailing one-center chunk included
    (that chunk takes the difference form in both packages)."""
    x, c = _pool(7), _pool(8, n=m)
    p = ops.warm_start_min_dist(torch.from_numpy(x), torch.from_numpy(c),
                                r_block=r_block)
    r = rops.warm_start_min_dist(_j(x), _j(c), impl="ref", r_block=r_block)
    _close(p, r)


@pytest.mark.parametrize("n,d", [(96, 16), (400, 32), (50_000, 512),
                                 (10_000, 512)])
def test_block_rule_matches_reference_model(rops, n, d):
    from repro.kernels.pairwise import autotune as ref_autotune
    want = ref_autotune.autotune_blocks(n, d, measure=False)
    got = autotune.model_blocks(n, d)
    assert (got.n_block, got.r_block) == (want.n_block, want.r_block)


def test_masked_weighted_score_matches_reference(rops):
    mind = np.asarray([0.5, -1.0, 2.0, 0.0], np.float32)
    w = np.asarray([1.0, 0.0, 0.5, 0.0], np.float32)
    _close(ops.masked_weighted_score(torch.from_numpy(mind),
                                     torch.from_numpy(w)),
           rops.masked_weighted_score(_j(mind), _j(w)))


def test_cpu_dispatch_takes_plain_version_and_counts_no_launch():
    ops.reset_launches()
    x = torch.from_numpy(_pool(9))
    ops.greedy_round(x, torch.full((96,), ref.BIG), x[:1],
                     torch.full((1,), -1, dtype=torch.int32))
    ops.pairwise_min_and_argmin(x, x[:3])
    assert ops.LAUNCHES == {"greedy_round": 0, "pairwise_min_argmin": 0}


def test_dispatch_rejects_unknown_impl_and_device():
    x = torch.zeros((4, 2))
    with pytest.raises(ValueError):
        ops.pairwise_min_and_argmin(x, x, impl="pallas")
    meta = torch.zeros((4, 2), device="meta")
    with pytest.raises(RuntimeError):
        ops.pairwise_min_and_argmin(meta, meta)


def test_op_accounting_counts_pool_reads():
    x = torch.from_numpy(_pool(11))
    with ops.track_ops() as st:
        ops.greedy_round(x, torch.full((96,), ref.BIG), x[:1],
                         torch.full((1,), -1, dtype=torch.int32))
        ops.record_pool_rows(5)
    assert st["embedding_reads"] == 1 and st["vector_streams"] == 2
    assert st["pool_rows"] == 96 + 5
    assert st["hbm_bytes"] == 4 * (96 * 16 + 2 * 96)


# ------------------------------------------------------------ on the card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 8, 40])
@pytest.mark.parametrize("weighted", [False, True])
def test_cuda_greedy_round_matches_plain(cuda, r, weighted):
    rng = np.random.default_rng(r)
    n, d = 5003, 96
    x = (rng.normal(size=(n, d)) * 0.25).astype(np.float32)
    x[4000] = x[123] = x[123] * 3.0                 # tie: 123 must win
    mind = np.full((n,), ref.BIG, np.float32)
    mind[rng.choice(n, 50, replace=False)] = -1.0
    sel = rng.choice(n, r, replace=False).astype(np.int32)
    w = rng.uniform(0, 1, n).astype(np.float32) if weighted else None
    if w is not None:
        w[4000] = w[123]
    args = [torch.from_numpy(a).to(cuda) if a is not None else None
            for a in (x, mind, x[sel], sel, w)]
    kn, ki, ks = ops.greedy_round(*args)
    pn, pi, ps = ops.greedy_round(*args, impl="ref")
    torch.cuda.synchronize()
    torch.testing.assert_close(kn, pn, rtol=0, atol=ATOL)
    assert int(ki) == int(pi)
    torch.testing.assert_close(ks, ps, rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(1000, 64), (1001, 67), (257, 1)])
def test_cuda_pairwise_min_argmin_matches_plain(cuda, n, m):
    rng = np.random.default_rng(n + m)
    x = torch.from_numpy((rng.normal(size=(n, 80)) * 0.25).astype(
        np.float32)).to(cuda)
    c = torch.from_numpy((rng.normal(size=(m, 80)) * 0.25).astype(
        np.float32)).to(cuda)
    if m > 3:
        c[m - 1] = c[1]                             # tie: 1 must win
        x[:20] = c[1] + 1e-3
    km, ka = ops.pairwise_min_and_argmin(x, c)
    pm, pa = ops.pairwise_min_and_argmin(x, c, impl="ref")
    torch.cuda.synchronize()
    torch.testing.assert_close(km, pm, rtol=0, atol=ATOL)
    assert torch.equal(ka, pa)
