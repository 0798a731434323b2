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


@pytest.mark.parametrize("r", [1, 5])
@pytest.mark.parametrize("weighted", [False, True])
def test_greedy_round_index_centers_equal_gathered_rows(r, weighted):
    """Centers named by index into the pool give the bytes of the gathered
    rows (the plain version gathers; the kernel reads them in place)."""
    rng = np.random.default_rng(30 + r)
    x = torch.from_numpy(_pool(7))
    n = x.shape[0]
    mind = torch.full((n,), 3.4e38)
    idx = torch.from_numpy(rng.choice(n, r, replace=False).astype(np.int32))
    w = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)) \
        if weighted else None
    by_index = ops.greedy_round(x, mind, idx, idx, w)
    by_rows = ops.greedy_round(x, mind, x[idx.long()], idx, w)
    assert all(torch.equal(a, b) for a, b in zip(by_index, by_rows))


def test_round_plan_layout_depends_on_d_alone():
    """The fused round's layout (form, chunk, lanes a row, loads in flight)
    is a function of d and R alone; N only sizes the grid."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=300, deadline=None, database=None)
    @given(n=st.integers(1, 2_000_000), m=st.integers(1, 2_000_000),
           d=st.sampled_from([1, 16, 32, 80, 96, 127, 128, 192, 512, 513,
                              4_096, 16_384]),
           r=st.sampled_from([1, 2, 8, 256]))
    def check(n, m, d, r):
        a, b = ops.round_plan(n, d, r), ops.round_plan(m, d, r)
        layout = ("form", "chunk", "lanes", "chunks_in_flight",
                  "rows_in_flight")
        assert [getattr(a, k) for k in layout] == \
            [getattr(b, k) for k in layout]
        assert a.form == ("difference" if r == 1 else "matmul")
        assert a.chunk == (4 if d % 4 == 0 and d >= 128 else 1)
        assert a.lanes == 32 or a.lanes <= d // a.chunk < 2 * a.lanes
        assert a.ctas == -(-n // a.rows_per_cta)
        assert min(ops.CTA_THREADS // 32, n) <= a.rows_per_cta <= \
            ops.round_plan(10**7, d, r).rows_per_cta
    check()


def test_round_plan_default_rows_spread_the_main_paths():
    """The default rows per CTA: ROWS_PER_CTA at d <= 512 and in the
    matmul form; fewer at wider rows and in small pools, so the text pool
    (2,048 x 4,096) gives every SM of the H100 a CTA where ROWS_PER_CTA
    gave 32."""
    assert ops.round_plan(50_000, 512).rows_per_cta == ops.ROWS_PER_CTA
    assert ops.round_plan(50_000, 512, 256).rows_per_cta == ops.ROWS_PER_CTA
    text = ops.round_plan(2_048, 4_096)
    assert text.ctas >= ops.H100_SMS and text.rows_per_cta >= \
        ops.CTA_THREADS // 32
    assert ops.round_plan(2_048, 4_096, 8).rows_per_cta == ops.ROWS_PER_CTA
    # the prefilter's largest fold slice: one row a warp, 32 CTAs
    assert ops.round_plan(256, 512).rows_per_cta == ops.CTA_THREADS // 32


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
    ops.gated_greedy_round(x, torch.full((96,), ref.BIG), x[:1],
                           np.ones(6, np.int32), np.zeros(6, np.int32),
                           n_block=16)
    assert ops.LAUNCHES == {"greedy_round": 0, "pairwise_min_argmin": 0,
                            "gated_greedy_round": 0}


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


def _unfused_case(n, d, sel_rows, ties):
    """A pool (squared distances O(1) at every d), carried-in min-dists
    (some rows already selected), a center and the rows to mask. With
    ``ties`` two rows far from the rest are exact copies (their new
    min-dists are the same bits in both packages), so the lowest-index
    rule alone decides the argmax."""
    rng = np.random.default_rng(n + d + sel_rows)
    x = (rng.normal(size=(n, d)) * (0.8 / np.sqrt(d))).astype(np.float32)
    if ties:
        x[n - 5] = x[n // 3] = x[n // 3] * 4.0
    mind = np.full((n,), ref.BIG, np.float32)
    mind[rng.choice(n // 4, 7, replace=False)] = -1.0
    c = int(rng.integers(n // 2, n - 10))
    sel = np.asarray([c] + list(rng.choice(np.arange(n // 4, n // 3),
                                           sel_rows - 1, replace=False)),
                     np.int32)
    return x, mind, c, sel, (n // 3 if ties else None)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("sel_rows", [1, 4])
@pytest.mark.parametrize("n,d", [(257, 16), (1_000, 64)])
def test_greedy_round_unfused_matches_reference(rops, n, d, sel_rows, ties):
    """The pre-fusion round op for op: new min-dists within 1e-5 of their
    max, the next index equal (the lowest on planted ties), the score the
    min-dist at it; plain torch, no launch counted."""
    x, mind, c, sel, tie = _unfused_case(n, d, sel_rows, ties)
    ops.reset_launches()
    pn, pi, ps = ops.greedy_round_unfused(
        torch.from_numpy(x), torch.from_numpy(mind), torch.from_numpy(x[c]),
        torch.from_numpy(sel))
    rn, ri, rs = rops.greedy_round_unfused(_j(x), _j(mind), _j(x[c]),
                                           _j(sel))
    rn = np.asarray(rn)
    np.testing.assert_allclose(pn.numpy(), rn, rtol=0,
                               atol=1e-5 * np.abs(rn).max())
    assert pi.dtype == torch.int32 and pi.shape == ()
    assert ps.dtype == torch.float32 and ps.shape == ()
    assert int(pi) == int(ri)
    assert float(ps) == float(pn[int(pi)])
    np.testing.assert_allclose(float(ps), float(rs), rtol=1e-6)
    assert (pn.numpy()[sel] == -1.0).all()
    if tie is not None:
        assert int(pi) == tie
    assert sum(ops.LAUNCHES.values()) == 0


def test_greedy_round_unfused_takes_a_scalar_index_as_fig4b_calls_it(rops):
    """fig4b's baseline passes the center's own index as a scalar; the
    unfused and fused rounds then pick the same rows on the CPU."""
    x, _, _, _, _ = _unfused_case(257, 16, 1, False)
    xt = torch.from_numpy(x)
    mind_u = mind_f = torch.full((257,), ref.BIG)
    i_u = i_f = torch.tensor(3, dtype=torch.int32)
    for _ in range(12):
        mind_u, i_u, _ = ops.greedy_round_unfused(xt, mind_u, xt[i_u], i_u)
        mind_f, i_f, _ = ops.greedy_round(xt, mind_f, xt[i_f][None, :],
                                          i_f[None])
        assert int(i_u) == int(i_f)
    rn, ri, _ = rops.greedy_round_unfused(_j(x), _j(np.full(257, ref.BIG,
                                                            np.float32)),
                                          _j(x[3]), _j(np.int32(3)))
    pn, pi, _ = ops.greedy_round_unfused(xt, torch.full((257,), ref.BIG),
                                         xt[3], torch.tensor(3))
    assert int(pi) == int(ri)
    _close(pn, rn)


@pytest.mark.parametrize("case", ["separated", "ties"])
def test_pairwise_min_dist_and_refs_match_reference(rops, case):
    """``pairwise_min_dist`` (the min half of one B2 pass) and the two
    plain helpers against the reference's; argmin ties go to the lowest
    center."""
    from repro.kernels.pairwise import ref as rref
    x, c = _pool(21, n=131), _pool(22, n=9)
    if case == "ties":
        c[6] = c[2]
        x[:5] = c[2] + 1e-3
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    _close(ops.pairwise_min_dist(xt, ct),
           rops.pairwise_min_dist(_j(x), _j(c), impl="ref"))
    _close(ref.pairwise_min_dist_ref(xt, ct),
           rref.pairwise_min_dist_ref(_j(x), _j(c)))
    am = ref.pairwise_argmin_ref(xt, ct)
    assert am.dtype == torch.int32
    np.testing.assert_array_equal(am.numpy(), np.asarray(
        rref.pairwise_argmin_ref(_j(x), _j(c))))
    if case == "ties":
        assert (am.numpy()[:5] == 2).all()


def test_op_stats_match_reference_after_the_same_calls(rops):
    """``op_stats()`` after the unfused round, the fused round,
    ``pairwise_min_dist`` and ``pairwise_argmin`` under ``track_ops``
    equals the reference's, and is a copy."""
    x, mind, c, sel, _ = _unfused_case(257, 16, 1, False)
    cs = _pool(23, n=5)

    def calls(o, a):
        o.greedy_round_unfused(a(x), a(mind), a(x[c]), a(sel))
        o.greedy_round(a(x), a(mind), a(x[c][None, :]), a(sel))
        o.pairwise_min_dist(a(x), a(cs))
        o.pairwise_argmin(a(x), a(cs))

    with ops.track_ops():
        calls(ops, torch.from_numpy)
    with rops.track_ops():
        calls(rops, _j)
    got = ops.op_stats()
    assert got == rops.op_stats()
    assert got == {"embedding_reads": 4, "vector_streams": 12,
                   "hbm_bytes": 4 * (4 * 257 * 16 + 12 * 257),
                   "pool_rows": 4 * 257}
    got["pool_rows"] = -1
    assert ops.op_stats()["pool_rows"] == 4 * 257


@pytest.mark.parametrize("n,m", [(2_048, 256), (10_000, 1_000), (1, 1),
                                 (257, 65), (10_001, 1_001), (50_000, 1)])
@pytest.mark.parametrize("sms", [ops.H100_SMS, 8])
def test_argmin_plan_covers_centers_and_fills_the_card(n, m, sms):
    """The kernel's CTA tile: one of its instances, its center tiles cover
    M exactly with no empty tile, and its grid holds >= 2 CTAs per SM
    whenever the smallest tile's grid does (the largest such tile)."""
    bm, bn = ops.argmin_plan(n, m, sms)
    assert (bm, bn) in ops.ARGMIN_TILES
    tiles = -(-m // bn)
    assert (tiles - 1) * bn < m <= tiles * bn
    assert (-(-n // bm) - 1) * bm < n <= -(-n // bm) * bm

    def ctas(t):
        return -(-n // t[0]) * -(-m // t[1])
    fits = [t for t in ops.ARGMIN_TILES if ctas(t) >= 2 * sms]
    if fits:
        assert (bm, bn) == fits[0] and ctas((bm, bn)) >= 2 * sms
    else:
        assert (bm, bn) == ops.ARGMIN_TILES[-1]


def test_argmin_plan_at_the_main_paths_shapes():
    assert ops.argmin_plan(2_048, 256) == (32, 32)       # 512 CTAs, was 32
    assert ops.argmin_plan(10_000, 1_000) == (128, 64)   # 1,264 CTAs


def _int_pool(seed, n, d):
    """Small integers: every distance is exact in fp32 in any sum order,
    so exact ties are plentiful and every package computes equal bits."""
    return np.random.default_rng(seed).integers(-2, 3, size=(n, d)).astype(
        np.float32)


def _boundary_ties(x, c):
    """Duplicate centers on both sides of the 32- and 64-center tile
    boundaries, and rows nearest them: the lower index must win."""
    for lo in (31, 63):
        c[lo + 1] = c[lo]
    c[100] = c[31]
    x[:8] = c[31] + 0.25       # only exact copies of c[31] are as near
    x[8:16] = c[63] - 0.25


@pytest.mark.parametrize("bn", [32, 64])
def test_tiled_merge_equals_one_shot_bitwise(bn):
    """The kernel's cut in plain form (the plain version over each center
    tile, merged in ascending tile order under (value asc, index asc))
    equals the one-shot plain version bit for bit, ties at tile
    boundaries included."""
    x, c = _int_pool(21, 200, 6), _int_pool(22, 150, 6)
    _boundary_ties(x, c)
    tx, tc = torch.from_numpy(x), torch.from_numpy(c)
    tv, ti = ref.tiled_min_and_argmin_ref(tx, tc, bn)
    ov, oi = ref.pairwise_min_and_argmin_ref(tx, tc)
    assert torch.equal(tv, ov) and torch.equal(ti, oi)
    for rows, lo in ((slice(0, 8), 31), (slice(8, 16), 63)):
        first = int(np.flatnonzero((c == c[lo]).all(axis=1))[0])
        assert first <= lo and (ti[rows] == first).all()


@pytest.mark.parametrize("bn", [32, 64])
def test_tiled_merge_matches_reference_center_blocks(rops, bn):
    """The same tie rule as the reference kernel's center blocks
    (``pairwise_min_argmin_pallas`` with m_block = bn, interpret mode)."""
    from repro.kernels.pairwise.kernel import pairwise_min_argmin_pallas
    x, c = _int_pool(23, 96, 6), _int_pool(24, 130, 6)
    _boundary_ties(x, c)
    tv, ti = ref.tiled_min_and_argmin_ref(torch.from_numpy(x),
                                          torch.from_numpy(c), bn)
    rv, ri = pairwise_min_argmin_pallas(_j(x), _j(c), n_block=32,
                                        m_block=bn, interpret=True)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))


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
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n,d", [(5_003, 96), (2_048, 4_096)])
def test_cuda_greedy_round_unfused_matches_b1(cuda, n, d, ties):
    """The unfused round (plain torch on the card) against B1 at R = 1 on
    the same inputs: min-dists within ATOL, the same next index (the
    lowest on planted ties); B1 launched once, the unfused round never."""
    x, mind, c, sel, tie = _unfused_case(n, d, 1, ties)
    xt, mt = torch.from_numpy(x).to(cuda), torch.from_numpy(mind).to(cuda)
    st = torch.from_numpy(sel).to(cuda)
    ops.reset_launches()
    un, ui, _ = ops.greedy_round_unfused(xt, mt, xt[c], st)
    assert ops.LAUNCHES["greedy_round"] == 0
    kn, ki, _ = ops.greedy_round(xt, mt, xt[c][None, :], st)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["greedy_round"] == 1
    torch.testing.assert_close(un, kn, rtol=0, atol=ATOL)
    assert int(ui) == int(ki)
    if tie is not None:
        assert int(ki) == tie


@pytest.mark.cuda
def test_cuda_greedy_round_default_block_never_measures(cuda, monkeypatch):
    """Serving runs ``ROWS_PER_CTA`` rows a CTA: a round with no
    ``n_block`` never asks the block picker (no timed launches)."""
    def refuse(*a, **k):
        raise AssertionError("greedy_round measured a block size")
    monkeypatch.setattr(ops.autotune, "autotune_blocks", refuse)
    x = torch.randn(777, 32, device=cuda)
    mind = torch.full((777,), ref.BIG, device=cuda)
    sel = torch.tensor([5], dtype=torch.int32, device=cuda)
    before = ops.LAUNCHES["greedy_round"]
    kn, ki, _ = ops.greedy_round(x, mind, x[5:6], sel)
    assert ops.LAUNCHES["greedy_round"] == before + 1
    pn, pi, _ = ops.greedy_round(x, mind, x[5:6], sel, impl="ref")
    torch.testing.assert_close(kn, pn, rtol=0, atol=ATOL)
    assert int(ki) == int(pi)


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


ARGMIN_NS = [1, 257, 2_048, 10_001]
ARGMIN_MS = [1, 63, 64, 65, 1_001]
ARGMIN_DS = [3, 80, 513, 4_096]


@pytest.mark.cuda
@pytest.mark.parametrize("d", ARGMIN_DS)
@pytest.mark.parametrize("m", ARGMIN_MS)
@pytest.mark.parametrize("n", ARGMIN_NS)
def test_cuda_pairwise_min_argmin_tiles(cuda, n, m, d):
    """Values within ATOL of the plain version; indices equal to its on
    separated rows, and the lowest center on ties planted on both sides of
    the 32- and 64-center tile boundaries; bytes equal under two forced tile plans and for a row
    subset against the full call."""
    rng = np.random.default_rng(n * 7 + m * 3 + d)
    scale = 0.25 / np.sqrt(max(d / 16, 1.0))         # O(1) distances
    x = torch.from_numpy((rng.normal(size=(n, d)) * scale).astype(
        np.float32)).to(cuda)
    c = torch.from_numpy((rng.normal(size=(m, d)) * scale).astype(
        np.float32)).to(cuda)
    planted = torch.zeros(n, dtype=torch.bool, device=cuda)
    ties, k = [], min(n // 2, 8)
    for i, lo in enumerate((31, 63)):
        if m > lo + 1 and k > 0:
            c[lo + 1] = c[lo]                       # lo must win
            rows = slice(i * k, (i + 1) * k)
            x[rows] = c[lo] + 1e-3
            planted[rows] = True
            ties.append((rows, lo))
    km, ka = ops.pairwise_min_and_argmin(x, c)
    pm, pa = ops.pairwise_min_and_argmin(x, c, impl="ref")
    torch.cuda.synchronize()
    torch.testing.assert_close(km, pm, rtol=0, atol=ATOL)
    if m > 1:
        top2 = torch.topk(ops.pairwise_sq_dists(x, c), 2, dim=1,
                          largest=False).values
        sep = ((top2[:, 1] - top2[:, 0]) > 10 * ATOL) & ~planted
    else:
        sep = torch.ones(n, dtype=torch.bool, device=cuda)
    assert torch.equal(ka[sep], pa[sep])
    # planted ties are held to the rule itself: the plain version's cuBLAS
    # product need not give two equal centers equal bits (at d = 513 it
    # does not), the kernel's per-center fmaf chains do
    for rows, lo in ties:
        assert bool((ka[rows] == lo).all()), (rows, lo)
    for plan in ((128, 64), (32, 32)):
        vm, va = ops.pairwise_min_and_argmin(x, c, plan=plan)
        assert torch.equal(vm, km) and torch.equal(va, ka), plan
    if n > 8:
        sub = slice(5, n - 3)
        sm, sa = ops.pairwise_min_and_argmin(x[sub], c)
        assert torch.equal(sm, km[sub]) and torch.equal(sa, ka[sub])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 96, 512, 513])
@pytest.mark.parametrize("r", [1, 8, 40])
def test_cuda_greedy_round_bytes_across_plans_and_prefix(cuda, d, r):
    """A row's new min-dist bytes, and the round's index and score, do not
    depend on the rows per CTA, on N (a prefix of the pool) or on whether
    the centers come as rows or by index; exact ties planted in other CTAs
    go to the lower row, as in the plain version."""
    rng = np.random.default_rng(d + r)
    n = 20_000
    x = torch.from_numpy((rng.normal(size=(n, d)) * 0.25 / np.sqrt(d / 96))
                         .astype(np.float32)).to(cuda)
    x[15_000] = x[300] = x[300] * 3.0               # 300 must win
    idx = torch.from_numpy(rng.choice(np.setdiff1d(np.arange(n), [300, 15_000]),
                                      r, replace=False).astype(np.int32)).to(cuda)
    sel = idx if r == 1 else torch.full_like(idx, -1)
    mind = torch.full((n,), ref.BIG, device=cuda)
    base = ops.greedy_round(x, mind, x[idx.long()], sel)
    _, pi, _ = ops.greedy_round(x, mind, x[idx.long()], sel, impl="ref")
    assert int(base[1]) == int(pi) == 300
    outs = [ops.greedy_round(x, mind, x[idx.long()], sel, n_block=nb)
            for nb in (1, 8, 64, 256, 1024, n)]
    outs.append(ops.greedy_round(x, mind, idx, sel))
    for out in outs:
        assert all(torch.equal(a, b) for a, b in zip(out, base))
    pre = ops.greedy_round(x[:n - 1], mind[:n - 1], x[idx.long()], sel)
    assert torch.equal(pre[0], base[0][:n - 1])


@pytest.mark.cuda
def test_cuda_greedy_round_concurrent_streams(cuda):
    """Rounds launched from two threads on two streams at once (each
    stream's own ticket elects its last CTA) equal serial rounds."""
    import threading
    g = torch.Generator(device=cuda).manual_seed(3)
    pools = [torch.randn((20_000, 512), generator=g, device=cuda) * 0.05,
             torch.randn((2_048, 1_024), generator=g, device=cuda) * 0.05]

    def rounds(x):
        mind = torch.full((x.shape[0],), ref.BIG, device=cuda)
        nxt = torch.tensor(1, dtype=torch.int32, device=cuda)
        picks = []
        for _ in range(40):
            i = nxt.reshape(1)
            mind, nxt, _ = ops.greedy_round(x, mind, i, i)
            picks.append(nxt)
        return torch.stack(picks), mind

    serial = [rounds(x) for x in pools]
    out, start = [None, None], threading.Barrier(2)

    def lane(k):
        s = torch.cuda.Stream(cuda)
        with torch.cuda.stream(s):
            start.wait()
            out[k] = rounds(pools[k])
        s.synchronize()
    threads = [threading.Thread(target=lane, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    for (sp, sm), (cp, cm) in zip(serial, out):
        assert torch.equal(sp, cp) and torch.equal(sm, cm)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 96, 512, 513, 4_096])
def test_cuda_round_layout_matches_plan(cuda, d):
    import ctypes
    from repro_torch.kernels import build
    got = (ctypes.c_int * 4)()
    build.load("greedy_round").greedy_round_layout(ctypes.c_int(d), got)
    p = ops.round_plan(1000, d)
    assert list(got) == [p.chunk, p.lanes, p.chunks_in_flight,
                         p.rows_in_flight]
