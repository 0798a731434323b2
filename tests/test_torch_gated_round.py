"""Port parity for the block-masked (gated) greedy round: repro_torch's
``ops.gated_greedy_round`` (its plain version on the CPU) against repro's
``gated_greedy_round_ref`` and the Pallas kernel in interpret mode.

Inputs are numpy draws from fixed seeds, handed to both packages.
Tolerances: min-dists and scores within rtol = atol = 1e-4 (the reference's
own kernel-vs-oracle tolerance, tests/test_kernels.py; distances here are
O(10-100) sums of d squared normals, where reordered fp32 sums differ by a
few ulps); indices exactly equal; rows of dead blocks bit for bit.

The ``cuda`` tests hold the CUDA kernel against the port's plain version
on the card and skip where there is no GPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.pairwise import ops, ref

TOL = 1e-4
CASES = [(64, 3, 16), (100, 5, 64), (33, 2, 100), (257, 9, 40)]
NB = 16


@pytest.fixture
def reference(monkeypatch):
    """(repro's plain module, its Pallas kernel, its ops), JAX on the CPU,
    the reference's block autotuner kept off disk."""
    pytest.importorskip("jax")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE_DIR", "")
    from repro.kernels.pairwise import kernel
    from repro.kernels.pairwise import ops as rops
    from repro.kernels.pairwise import ref as rref
    return rref, kernel.gated_greedy_round_pallas, rops


def _inputs(n, r, d, seed, nb=NB):
    rng = np.random.default_rng(seed)
    nn = -(-n // nb)
    x = rng.normal(size=(n, d)).astype(np.float32)
    c = rng.normal(size=(r, d)).astype(np.float32)
    mind = (np.abs(rng.normal(size=(n,))) * 10).astype(np.float32)
    live = rng.integers(0, 2, size=nn).astype(np.int32)
    pend = rng.integers(0, r + 1, size=nn).astype(np.int32)
    w = rng.uniform(0.1, 1.0, size=(n,)).astype(np.float32)
    return x, c, mind, live, pend, w


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    import jax.numpy as jnp
    return None if a is None else jnp.asarray(a)


def _dead_rows(live, n, nb=NB):
    rows = [np.arange(b * nb, min((b + 1) * nb, n))
            for b in np.nonzero(live == 0)[0]]
    return np.concatenate(rows) if rows else np.zeros(0, np.int64)


@pytest.mark.parametrize("nrd", CASES)
@pytest.mark.parametrize("weighted", [False, True])
def test_gated_round_matches_reference(reference, nrd, weighted):
    rref, pallas, _ = reference
    n, r, d = nrd
    x, c, mind, live, pend, w = _inputs(n, r, d, seed=n + r)
    w = w if weighted else None
    pn, pi, ps = ops.gated_greedy_round(_t(x), _t(mind), _t(c), live, pend,
                                        _t(w), n_block=NB)
    rn, ri, rs = rref.gated_greedy_round_ref(
        _j(x), _j(mind), _j(c), _j(live), _j(pend), _j(w), n_block=NB)
    kn, ki, ks = pallas(_j(x), _j(mind), _j(c), _j(live), _j(pend), _j(w),
                        n_block=NB, interpret=True)
    for want_n, want_i, want_s in ((rn, ri, rs), (kn, ki, ks)):
        np.testing.assert_allclose(pn.numpy(), np.asarray(want_n),
                                   rtol=TOL, atol=TOL)
        assert int(pi) == int(want_i)
        np.testing.assert_allclose(float(ps), float(want_s), rtol=TOL,
                                   atol=TOL)
    # dead blocks: mind passes through bit for bit
    dead = _dead_rows(live, n)
    np.testing.assert_array_equal(pn.numpy()[dead], mind[dead])


def test_dead_blocks_pass_through_and_never_win(reference):
    """Every block dead but one: the dead rows keep their (large) min-dist
    bit for bit and cannot win; the winner is the live block's best."""
    rref, _, _ = reference
    n, r, d = 80, 2, 8
    x, c, mind, _, _, _ = _inputs(n, r, d, seed=3)
    mind[:] = 1e6
    live = np.zeros(5, np.int32)
    live[3] = 1
    pend = np.zeros(5, np.int32)
    pn, pi, _ = ops.gated_greedy_round(_t(x), _t(mind), _t(c), live, pend,
                                       n_block=NB)
    rn, ri, _ = rref.gated_greedy_round_ref(
        _j(x), _j(mind), _j(c), _j(live), _j(pend), n_block=NB)
    dead = _dead_rows(live, n)
    np.testing.assert_array_equal(pn.numpy()[dead], mind[dead])
    assert 48 <= int(pi) < 64 and int(pi) == int(ri)


def test_all_live_matches_plain_round():
    """Every block live, nothing pending: the gated round is the plain
    fused round (same floats), R > 1."""
    x, c, mind, _, _, w = _inputs(90, 4, 32, seed=4)
    nn = -(-90 // NB)
    for weights in (None, w):
        gn, gi, gs = ops.gated_greedy_round(
            _t(x), _t(mind), _t(c), np.ones(nn, np.int64),
            np.zeros(nn, np.int64), _t(weights), n_block=NB)
        sel = torch.full((4,), -1, dtype=torch.int32)
        pn, pi, ps = ops.greedy_round(_t(x), _t(mind), _t(c), sel,
                                      _t(weights))
        assert torch.equal(gn, pn)
        assert int(gi) == int(pi) and float(gs) == float(ps)


def test_r1_takes_the_matmul_form(reference):
    """At R = 1 the gated round keeps the matmul form (the plain round
    switches to the difference form there): its min-dists are the
    ``x² + c² − 2x·c`` floats, within the tolerance of the reference's."""
    rref, _, _ = reference
    x, c, mind, _, _, _ = _inputs(70, 1, 24, seed=5)
    mind[:] = ref.BIG
    nn = -(-70 // NB)
    live, pend = np.ones(nn, np.int32), np.zeros(nn, np.int32)
    gn, _, _ = ops.gated_greedy_round(_t(x), _t(mind), _t(c), live, pend,
                                      n_block=NB)
    matmul = ref.pairwise_sq_dists_ref(_t(x), _t(c))[:, 0]
    assert torch.equal(gn, matmul)
    rn, _, _ = rref.gated_greedy_round_ref(
        _j(x), _j(mind), _j(c), _j(live), _j(pend), n_block=NB)
    np.testing.assert_allclose(gn.numpy(), np.asarray(rn), rtol=TOL,
                               atol=TOL)


def test_accounting_counts_live_rows_only(reference):
    _, _, rops = reference
    n, r, d = 100, 3, 12
    x, c, mind, live, pend, _ = _inputs(n, r, d, seed=6)
    live[-1] = 1                                  # the ragged last block
    with ops.track_ops() as st:
        ops.gated_greedy_round(_t(x), _t(mind), _t(c), live, pend,
                               n_block=NB)
    got = dict(st)
    with rops.track_ops() as rst:
        rops.gated_greedy_round(_j(x), _j(mind), _j(c), live, pend,
                                impl="ref", n_block=NB)
    assert got == dict(rst)
    rows = sum(min(NB, n - b * NB) for b in np.nonzero(live)[0])
    assert got["pool_rows"] == rows and got["vector_streams"] == 2
    assert got["hbm_bytes"] == 4 * (rows * d + 2 * n)
    with ops.track_ops() as st:
        ops.gated_greedy_round(_t(x), _t(mind), _t(c),
                               np.zeros_like(live), pend, n_block=NB)
    assert dict(st)["pool_rows"] == 0 and dict(st)["embedding_reads"] == 0


def test_block_live_length_is_checked(reference):
    _, _, rops = reference
    x, c, mind, live, pend, _ = _inputs(64, 2, 8, seed=7)
    with pytest.raises(ValueError, match="block_live"):
        ops.gated_greedy_round(_t(x), _t(mind), _t(c), live[:-1], pend,
                               n_block=NB)
    with pytest.raises(ValueError, match="block_live"):
        rops.gated_greedy_round(_j(x), _j(mind), _j(c), live[:-1], pend,
                                impl="ref", n_block=NB)
    # n_block clamps to N: one block covers a pool smaller than it
    gn, _, _ = ops.gated_greedy_round(_t(x), _t(mind), _t(c),
                                      np.ones(1, np.int32),
                                      np.zeros(1, np.int32), n_block=1024)
    assert gn.shape == (64,)


# ------------------------------------------------------------ on the card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _cuda_inputs(dev, n, r, d, nb, seed, live_share=0.5):
    rng = np.random.default_rng(seed)
    nn = -(-n // min(nb, n))
    x = (rng.normal(size=(n, d)) * 0.25).astype(np.float32)
    c = (rng.normal(size=(r, d)) * 0.25).astype(np.float32)
    mind = (np.abs(rng.normal(size=(n,))) * 5).astype(np.float32)
    mind[rng.choice(n, n // 20, replace=False)] = -1.0
    live = (rng.uniform(size=nn) < live_share).astype(np.int32)
    pend = rng.integers(0, r + 1, size=nn).astype(np.int32)
    w = rng.uniform(0, 1, n).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(dev)          # noqa: E731
    return to(x), to(c), to(mind), to(live), to(pend), to(w)


@pytest.mark.cuda
@pytest.mark.parametrize("n,r,d,nb", [(5003, 1, 96, 256), (5003, 8, 96, 64),
                                      (1000, 40, 80, 1000), (77, 3, 16, 16)])
@pytest.mark.parametrize("weighted", [False, True])
def test_cuda_gated_round_matches_plain(cuda, n, r, d, nb, weighted):
    x, c, mind, live, pend, w = _cuda_inputs(cuda, n, r, d, nb, seed=n + r)
    w = w if weighted else None
    kn, ki, ks = ops.gated_greedy_round(x, mind, c, live, pend, w,
                                        n_block=nb)
    pn, pi, ps = ops.gated_greedy_round(x, mind, c, live, pend, w,
                                        n_block=nb, impl="ref")
    torch.cuda.synchronize()
    torch.testing.assert_close(kn, pn, rtol=0, atol=1e-5)
    assert int(ki) == int(pi)
    torch.testing.assert_close(ks, ps, rtol=1e-6, atol=0)
    nbe = min(nb, n)
    dead = live.cpu().numpy() == 0
    rows = np.repeat(dead, nbe)[:n]
    assert torch.equal(kn[torch.from_numpy(rows).to(cuda)],
                       mind[torch.from_numpy(rows).to(cuda)])


@pytest.mark.cuda
def test_cuda_gated_ties_go_to_the_lowest_index(cuda):
    n, d, nb = 4096, 64, 256
    x, c, mind, _, _, _ = _cuda_inputs(cuda, n, 2, d, nb, seed=1)
    mind[:] = 3.4e38
    x[3000] = x[700] = x[700] * 4.0            # far, duplicated: two blocks
    nn = n // nb
    live = torch.ones((nn,), dtype=torch.int32, device=cuda)
    pend = torch.zeros((nn,), dtype=torch.int32, device=cuda)
    _, ki, _ = ops.gated_greedy_round(x, mind, c, live, pend, n_block=nb)
    _, pi, _ = ops.gated_greedy_round(x, mind, c, live, pend, n_block=nb,
                                      impl="ref")
    assert int(ki) == int(pi) == 700


@pytest.mark.cuda
def test_cuda_all_live_gated_equals_greedy_round_bitwise(cuda):
    n, r, d, nb = 5003, 8, 96, 256
    x, c, mind, _, _, w = _cuda_inputs(cuda, n, r, d, nb, seed=9)
    nn = -(-n // nb)
    live = torch.ones((nn,), dtype=torch.int32, device=cuda)
    pend = torch.zeros((nn,), dtype=torch.int32, device=cuda)
    sel = torch.full((r,), -1, dtype=torch.int32, device=cuda)
    for weights in (None, w):
        gn, gi, gs = ops.gated_greedy_round(x, mind, c, live, pend, weights,
                                            n_block=nb)
        for rows in (64, 256, 1024):
            bn, bi, bs = ops.greedy_round(x, mind, c, sel, weights,
                                          n_block=rows)
            assert torch.equal(gn, bn)
            assert int(gi) == int(bi) and float(gs) == float(bs)


@pytest.mark.cuda
def test_cuda_greedy_round_rows_per_block_invisible(cuda):
    """B1's rows per CTA changes no float and no index."""
    n, d = 5003, 96
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.normal(size=(n, d)) * 0.25).astype(
        np.float32)).to(cuda)
    x[4000] = x[123] = x[123] * 3.0
    mind = torch.full((n,), 3.4e38, device=cuda)
    for r in (1, 8):
        sel = torch.arange(10, 10 + r, dtype=torch.int32, device=cuda)
        outs = [ops.greedy_round(x, mind, x[sel.long()], sel, n_block=nb)
                for nb in (64, 128, 256, 512, 1024, 5003)]
        for nm, i, s in outs[1:]:
            assert torch.equal(nm, outs[0][0]) and int(i) == int(outs[0][1])
        assert int(outs[0][1]) == 123
