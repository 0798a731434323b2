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
import os
import subprocess
import sys

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


# ------------------------------------------------- per-center forms --
# entries as the prefilter queues them: warm-start chunks (matmul form)
# and single centers (difference form), a one-center last chunk included
ENTRY_SIZES = (5, 1, 3, 1, 1, 2, 1)


def _entries(rng, d, scale=1.0):
    """(centers (R, d), forms (R,) int8, entry start rows (E + 1,))."""
    rows = np.concatenate([[0], np.cumsum(ENTRY_SIZES)])
    c = (rng.normal(size=(int(rows[-1]), d)) * scale).astype(np.float32)
    forms = np.concatenate([np.full(k, 0 if k == 1 else 1, np.int8)
                            for k in ENTRY_SIZES])
    return c, forms, rows


def _sequential(x, mind, c, rows, live, entry_of_block, nb, fold):
    """``fold(x_rows, mind_rows, chunk)`` (one plain round) once per entry
    for each live block, from its own cursor on; dead blocks and blocks
    with nothing pending keep ``mind``. Returns the new min-dists."""
    n = x.shape[0]
    want = mind.clone()
    for b in range(live.shape[0]):
        lo, hi = b * nb, min((b + 1) * nb, n)
        if live[b]:
            for e in range(int(entry_of_block[b]), len(rows) - 1):
                want[lo:hi] = fold(x[lo:hi], want[lo:hi],
                                   c[int(rows[e]):int(rows[e + 1])])
    return want


def _block_pairs(nm, live, nb, w=None):
    """The gated round's score rule and per-block (max, first index) pairs
    over min-dists ``nm``: (scores, (2, nn) pairs as the wrapper gives)."""
    n = nm.shape[0]
    nn = live.shape[0]
    blk_live = torch.from_numpy(np.repeat(live, nb)[:n] > 0).to(nm.device)
    sc = nm if w is None else nm * w
    sc = torch.where(blk_live & ~(nm < 0), sc, -ref.BIG)
    padded = torch.full((nn * nb,), -ref.BIG, device=nm.device)
    padded[:n] = sc
    bi = torch.argmax(padded.view(nn, nb), dim=1)
    bv = padded.view(nn, nb).gather(1, bi[:, None])[:, 0]
    bi = (bi + torch.arange(nn, device=nm.device) * nb).to(torch.int32)
    return sc, torch.stack([bv, bi.view(torch.float32)])


def _ref_fold(x, m, chunk):
    sel = torch.full((chunk.shape[0],), -1, dtype=torch.int32)
    return ref.greedy_round_ref(x, m, chunk, sel)[0]


@pytest.mark.parametrize("d", (32, 192, 513))
@pytest.mark.parametrize("weighted", (False, True))
def test_mixed_forms_equal_one_plain_round_per_entry(d, weighted):
    """Forms 0/1 by entry: one gated fold of entries [p_b, R) per block
    equals ``greedy_round_ref`` once per entry, bit for bit; the argmax
    and the per-block pairs follow from those min-dists."""
    rng = np.random.default_rng(d)
    n, nb = 150, 16
    nn = -(-n // nb)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    c, forms, rows = _entries(rng, d)
    mind = torch.from_numpy((np.abs(rng.normal(size=n)) * 4 * d).astype(
        np.float32))
    mind[torch.from_numpy(rng.choice(n, 9, replace=False))] = -1.0
    live = rng.integers(0, 2, nn).astype(np.int32)
    live[:2] = 1
    ent = rng.integers(0, len(ENTRY_SIZES) + 1, nn)
    ent[0], ent[1] = 0, len(ENTRY_SIZES)          # all pending / none
    pend = rows[ent].astype(np.int32)
    w = (torch.from_numpy(rng.uniform(0.1, 1, n).astype(np.float32))
         if weighted else None)
    nm, idx, score, pairs = ops.gated_greedy_round(
        x, mind, torch.from_numpy(c), live, pend, w, n_block=nb,
        forms=forms, blocks=True)
    want = _sequential(x, mind, torch.from_numpy(c), rows, live, ent, nb,
                       _ref_fold)
    assert torch.equal(nm.view(torch.int32), want.view(torch.int32))
    sc, want_pairs = _block_pairs(want, live, nb, w)
    assert int(idx) == int(torch.argmax(sc)) and float(score) == float(
        sc.max())
    assert torch.equal(pairs.view(torch.int32), want_pairs.view(torch.int32))


def test_forms_none_is_the_matmul_form_for_every_center():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(40, 20)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(3, 20)).astype(np.float32))
    mind = torch.full((40,), ref.BIG)
    live, pend = np.ones(3, np.int32), np.zeros(3, np.int32)
    a = ops.gated_greedy_round(x, mind, c, live, pend, n_block=16)
    b = ops.gated_greedy_round(x, mind, c, live, pend, n_block=16,
                               forms=np.ones(3, np.int8))
    assert torch.equal(a[0], b[0]) and int(a[1]) == int(b[1])
    one = ops.gated_greedy_round(x, mind, c[:1], live, pend, n_block=16,
                                 forms=np.zeros(1, np.int8))[0]
    assert torch.equal(one, ref.diff_sq_dists_ref(x, c[0]))


def test_matmul_false_is_checked():
    """``matmul=False`` needs forms, and on the CPU raises where a live
    block has a matmul-form center pending; elsewhere it changes nothing."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(48, 20)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(4, 20)).astype(np.float32))
    mind = torch.full((48,), ref.BIG)
    forms = np.array([1, 1, 0, 0], np.int8)
    live = np.array([1, 0, 1], np.int32)
    with pytest.raises(ValueError):
        ops.gated_greedy_round(x, mind, c, live, np.zeros(3, np.int32),
                               n_block=16, matmul=False)
    with pytest.raises(ValueError):
        ops.gated_greedy_round(x, mind, c, live, np.array([2, 2, 1],
                                                          np.int32),
                               n_block=16, forms=forms, matmul=False)
    # form-1 centers only behind the live blocks' cursors or in dead ones
    pend = np.array([2, 0, 2], np.int32)
    a = ops.gated_greedy_round(x, mind, c, live, pend, n_block=16,
                               forms=forms, matmul=False, blocks=True)
    b = ops.gated_greedy_round(x, mind, c, live, pend, n_block=16,
                               forms=forms, blocks=True)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_plain_distances_are_row_and_center_local():
    """The rounds' plain distances do not depend on the rows or centers
    beside them (the kernels' property): slices and padded copies give the
    bits of the whole product."""
    rng = np.random.default_rng(4)
    for d in (7, 32, 192, 513):
        x = torch.from_numpy(rng.normal(size=(70, d)).astype(np.float32))
        c = torch.from_numpy(rng.normal(size=(12, d)).astype(np.float32))
        full = ref.pairwise_sq_dists_ref(x, c)
        assert torch.equal(full[5:9, 3:10], ref.pairwise_sq_dists_ref(
            x[5:9], c[3:10]))
        pad = torch.zeros((64, d))
        pad[:3] = x[40:43]
        assert torch.equal(full[40:43, 1:2], ref.pairwise_sq_dists_ref(
            pad, c[1:2])[:3])
        assert torch.equal(ref.diff_sq_dists_ref(x, c[2])[10:20],
                           ref.diff_sq_dists_ref(x[10:20], c[2]))


def test_gated_plan_tiles():
    """B1's rows per CTA at this d, clipped to the gate block."""
    assert ops.gated_plan(50_000, 512, 256) == 64
    assert ops.gated_plan(50_000, 192, 256) == 64
    assert ops.gated_plan(50_000, 512, 32) == 32
    assert ops.gated_plan(300, 32, 16) == 16
    assert ops.gated_plan(2_048, 4_096, 256) == 8
    assert ops.gated_plan(2_048, 1_000, 256) == 32
    assert ops.gated_plan(5, 512, 256) == 5
    for d in (1, 7, 100, 513, 2_000, 10 ** 5):
        t = ops.gated_plan(10 ** 6, d, 256)
        assert t in ops.GATED_TILE_ROWS and 8 <= t <= 64
        assert t * max(d, 512) <= 64 * 512 or t == 8


@pytest.mark.cuda
@pytest.mark.parametrize("d", (32, 192, 512))
@pytest.mark.parametrize("nb,tile", [(256, 16), (256, 64), (64, 8),
                                     (64, 64), (32, 32)])
def test_cuda_mixed_forms_equal_b1_per_entry(cuda, d, nb, tile):
    """On the card: one gated launch with forms equals one greedy_round
    launch per entry, bit for bit, at every tile size; exact ties planted
    in two tiles of one block and in two blocks go to the lowest index;
    the per-block pairs equal the plain version's."""
    rng = np.random.default_rng(d + nb + tile)
    n = 3_001
    nn = -(-n // nb)
    x = torch.from_numpy((rng.normal(size=(n, d)) * 0.25).astype(
        np.float32)).to(cuda)
    far = x[5] * 6.0
    ties = [nb + 3, nb + tile + 3, 3 * nb + 1]    # across tiles and blocks
    x[ties] = far
    c, forms, rows = _entries(rng, d, 0.25)
    c = torch.from_numpy(c).to(cuda)
    live = rng.integers(0, 2, nn).astype(np.int32)
    ent = rng.integers(0, len(ENTRY_SIZES) + 1, nn)
    tie_blocks = [t // nb for t in ties]        # live, every entry pending
    live[tie_blocks] = 1
    ent[tie_blocks] = 0
    pend = rows[ent].astype(np.int32)
    # rows of blocks with entries pending start far, the rest near: the
    # ties (folded far rows) score highest
    folds = np.repeat(ent < len(ENTRY_SIZES), nb)[:n]
    mind = torch.from_numpy(np.where(folds, 3.4e38, 1.0).astype(
        np.float32)).to(cuda)
    mind[torch.from_numpy(rng.choice(n, 50, replace=False)).to(cuda)] = -1.0
    mind[ties] = 3.4e38
    for mm in (None, True):
        nm, idx, score, pairs = ops.gated_greedy_round(
            x, mind, c, live, pend, n_block=nb, forms=forms, tile_rows=tile,
            matmul=mm, blocks=True)

        def b1(xs, m, chunk):
            sel = torch.full((chunk.shape[0],), -1, dtype=torch.int32,
                             device=cuda)
            return ops.greedy_round(xs, m, chunk, sel)[0]
        want = _sequential(x, mind, c, rows, live, ent, nb, b1)
        torch.cuda.synchronize()
        assert torch.equal(nm.view(torch.int32), want.view(torch.int32))
        _, want_pairs = _block_pairs(want, live, nb)
        assert torch.equal(pairs.view(torch.int32),
                           want_pairs.view(torch.int32))
        assert int(idx) == nb + 3
        # the plain version: values within its own rounding, the winner
        pn, pi, ps, pp = ops.gated_greedy_round(
            x, mind, c, live, pend, n_block=nb, forms=forms, blocks=True,
            impl="ref")
        assert int(pi) == nb + 3
        torch.testing.assert_close(nm, pn, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(pairs[0], pp[0], rtol=1e-6, atol=1e-5)


@pytest.mark.cuda
def test_cuda_tile_rows_invisible(cuda):
    """The tile size changes no float and no index, forms or not."""
    n, d, nb = 5_003, 96, 256
    x, c, mind, live, pend, w = _cuda_inputs(cuda, n, 6, d, nb, seed=12)
    forms = torch.tensor([1, 1, 0, 1, 0, 0], dtype=torch.int8, device=cuda)
    for f in (None, forms):
        outs = [ops.gated_greedy_round(x, mind, c, live, pend, w,
                                       n_block=nb, forms=f, tile_rows=t,
                                       blocks=True)
                for t in ops.GATED_TILE_ROWS]
        for nm, i, s, p in outs[1:]:
            assert torch.equal(nm, outs[0][0]) and int(i) == int(outs[0][1])
            assert torch.equal(p, outs[0][3])


@pytest.mark.cuda
def test_cuda_matmul_false_traps_on_a_matmul_center(cuda, tmp_path):
    """On the card ``matmul=False`` runs the kernel without the matmul
    body: with only difference-form centers pending it gives the bits of
    the full kernel, and a launch with a matmul-form center pending stops
    with a device fault (here in a process of its own) rather than skip
    the center."""
    n, d, nb = 3_001, 64, 32
    x, c, mind, live, _, _ = _cuda_inputs(cuda, n, 4, d, nb, seed=21)
    forms = torch.tensor([1, 1, 0, 0], dtype=torch.int8, device=cuda)
    pend = torch.full(live.shape, 2, dtype=torch.int32, device=cuda)
    a = ops.gated_greedy_round(x, mind, c, live, pend, n_block=nb,
                               forms=forms, matmul=False, blocks=True)
    b = ops.gated_greedy_round(x, mind, c, live, pend, n_block=nb,
                               forms=forms, matmul=True, blocks=True)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    script = tmp_path / "broken_promise.py"
    script.write_text(
        "import torch\n"
        "from repro_torch.kernels.pairwise import ops\n"
        "dev = torch.device('cuda')\n"
        "x = torch.randn(256, 64, device=dev)\n"
        "c = torch.randn(2, 64, device=dev)\n"
        "m = torch.full((256,), 3.4e38, device=dev)\n"
        "one = torch.ones(8, dtype=torch.int32, device=dev)\n"
        "zero = torch.zeros(8, dtype=torch.int32, device=dev)\n"
        "f = torch.tensor([1, 0], dtype=torch.int8, device=dev)\n"
        "ops.gated_greedy_round(x, m, c, one, zero, n_block=32, forms=f,\n"
        "                       matmul=False)\n"
        "torch.cuda.synchronize()\n")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    run = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": src})
    assert run.returncode != 0, run.stdout
    assert "Error" in run.stderr, run.stderr[-2000:]
