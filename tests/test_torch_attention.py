"""Port parity: repro_torch's attention (naive, chunked, and the flash
wrapper's CPU path) against repro's ``naive_attention``,
``chunked_attention`` and ``flash_attention_pallas(..., interpret=True)``.

Inputs come from numpy seeds (standard normal q, k, v) and go through
both packages as numpy arrays. Tolerance: fp32 outputs within atol 1e-5.
The outputs are softmax-weighted means of O(1) values, and the packages
sum in other orders, which moves them by a few 1e-7.

The ``cuda`` tests hold the CUDA kernel against the port's plain version
(naive attention) on the card at the text path's widths; they need no JAX
and skip where there is no GPU.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops
from repro_torch.models.layers import attention as pattn

ATOL = 1e-5
H = 4
CHUNK = 16


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    from repro.kernels.flash_attention.kernel import flash_attention_pallas
    from repro.models.layers import attention as rattn
    return rattn, flash_attention_pallas


def _qkv(seed, S, KH, D, B=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KH, D)).astype(np.float32)
    return q, k, v


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


# every S x KH, each with one (D, window) pair: both head dims and both
# masks are covered at every shape without the full product's compiles
CASES = [(S, KH, D, w) for S in (37, 64) for KH in (1, 2, 4)
         for D, w in ((8, None), (16, 8))]


@pytest.mark.parametrize("S,KH,D,window", CASES)
def test_attention_matches_reference(ref, S, KH, D, window):
    import jax
    rattn, flash_pallas = ref
    q, k, v = _qkv(S * 100 + KH * 10 + D, S, KH, D)
    tq, tk, tv = _t(q, k, v)

    def want(fn, **kw):       # jitted: one compile instead of op-by-op
        return np.asarray(jax.jit(functools.partial(
            fn, causal=True, window=window, **kw))(q, k, v))

    got = pattn.naive_attention(tq, tk, tv, window=window).numpy()
    np.testing.assert_allclose(got, want(rattn.naive_attention), rtol=0,
                               atol=ATOL)
    got = pattn.chunked_attention(tq, tk, tv, window=window, q_chunk=CHUNK,
                                  kv_chunk=CHUNK).numpy()
    np.testing.assert_allclose(
        got, want(rattn.chunked_attention, q_chunk=CHUNK, kv_chunk=CHUNK),
        rtol=0, atol=ATOL)
    got = ops.flash_attention_auto(tq, tk, tv, window=window, q_chunk=CHUNK,
                                   kv_chunk=CHUNK).numpy()
    np.testing.assert_allclose(
        got, want(flash_pallas, q_block=CHUNK, kv_block=CHUNK,
                  interpret=True), rtol=0, atol=ATOL)


def test_dispatcher_routes_like_the_reference():
    q, k, v = _t(*_qkv(0, 40, 2, 8))
    kw = dict(causal=True, q_chunk=8, kv_chunk=16)
    assert torch.equal(pattn.attention(q, k, v, impl="naive", **kw),
                       pattn.naive_attention(q, k, v))
    chunked = pattn.chunked_attention(q, k, v, q_chunk=8, kv_chunk=16)
    assert torch.equal(pattn.attention(q, k, v, impl="chunked", **kw),
                       chunked)
    assert torch.equal(pattn.attention(q, k, v, impl="pallas", **kw), chunked)
    assert torch.equal(ops.flash_attention_auto(q, k, v, impl="ref"),
                       pattn.naive_attention(q, k, v))
    with pytest.raises(ValueError, match="impl"):
        pattn.attention(q, k, v, impl="flash")
    with pytest.raises(ValueError, match="impl"):
        ops.flash_attention_auto(q, k, v, impl="interpret")
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention_auto(q, k, v, window=0)
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.flash_attention_auto(*(t.to("meta") for t in (q, k, v)))


@pytest.mark.parametrize("window", [None, 7])
def test_query_tiling_is_bitwise_invisible(window):
    """A row's output depends on the KV grid only: any q_chunk, and any
    number of query rows, give the same bytes."""
    q, k, v = _t(*_qkv(3, 50, 2, 16))
    base = ops.flash_attention_auto(q, k, v, window=window, q_chunk=50,
                                    kv_chunk=16)
    for qc in (1, 5, 16, 64):
        assert torch.equal(ops.flash_attention_auto(
            q, k, v, window=window, q_chunk=qc, kv_chunk=16), base), qc
    assert torch.equal(ops.flash_attention_auto(
        q[:, :23], k, v, window=window, q_chunk=5, kv_chunk=16),
        base[:, :23])


def test_cpu_path_launches_nothing():
    ops.reset_launches()
    q, k, v = _t(*_qkv(4, 20, 1, 8))
    ops.flash_attention_auto(q, k, v, q_chunk=8, kv_chunk=8)
    assert ops.LAUNCHES == {"flash_attention": 0}


@pytest.mark.parametrize("d,want", [(1, 16), (16, 16), (17, 32), (64, 64),
                                    (96, 128), (128, 128), (200, 256),
                                    (256, 256)])
def test_bf16_head_dim_padding_rule(d, want):
    """The bf16 kernel's instances are D 16, 32, 64, 128, 256: any other
    head dim is padded to the next one."""
    assert ops.padded_head_dim(d) == want
    t = torch.ones((1, 3, 2, d), dtype=torch.bfloat16)
    p = ops.pad_head_dim(t, want)
    assert p.shape == (1, 3, 2, want) and p.is_contiguous()
    assert torch.equal(p[..., :d], t) and not p[..., d:].any()


@pytest.mark.parametrize("d", [257, 320])
def test_bf16_head_dim_over_256_raises(d):
    with pytest.raises(ValueError, match="does not take head_dim"):
        ops.padded_head_dim(d)


@pytest.mark.parametrize("d", [12, 96])
def test_head_dim_padding_is_exact(d):
    """Zero features add nothing to q.k and give zero output columns: the
    padded call, sliced, is the unpadded one at the caller's scale."""
    q, k, v = _t(*_qkv(5, 33, 2, d))
    dp = ops.padded_head_dim(d)
    want = pattn.naive_attention(q, k, v, window=9)
    got = pattn.naive_attention(*(ops.pad_head_dim(t, dp) for t in (q, k, v)),
                                window=9, scale=d ** -0.5)
    np.testing.assert_allclose(got[..., :d].numpy(), want.numpy(), rtol=0,
                               atol=1e-6)
    assert not got[..., d:].any()


# ------------------------------------------------------------ on the card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


CUDA_CASES = [(D, G, S, kb, w) for D in (64, 128) for G in (1, 4)
              for S in (512, 500) for kb in (64, 128) for w in (None, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("D,G,S,kb,window", CUDA_CASES)
def test_cuda_flash_attention_matches_plain(cuda, D, G, S, kb, window):
    rng = np.random.default_rng(D + G + S + kb)
    KH = 2
    q = torch.from_numpy(rng.standard_normal((2, S, KH * G, D)).astype(
        np.float32)).to(cuda)
    k, v = (torch.from_numpy(rng.standard_normal((2, S, KH, D)).astype(
        np.float32)).to(cuda) for _ in range(2))
    got = ops.flash_attention_auto(q, k, v, window=window, kv_chunk=kb)
    want = ops.flash_attention_auto(q, k, v, window=window, impl="ref")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    # a row's bytes do not depend on how many query rows were launched
    part = ops.flash_attention_auto(q[:, :300], k, v, window=window,
                                    kv_chunk=kb)
    assert torch.equal(part, got[:, :300])


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 96, 128, 256])
@pytest.mark.parametrize("kb", [64, 128, 256])
def test_cuda_flash_attention_fp32_tiles(cuda, kb, D):
    """The fp32 kernel over kv_chunk 64/128/256 (the KV block it keeps,
    whatever its query tile) and D 64/96/128/256 (96 zero-padded inside
    to 128): causal and windowed against the plain version at atol 2e-5;
    each row's bytes unchanged when fewer query rows are launched, so
    that the rows fall in other query tiles of the kernel."""
    rng = np.random.default_rng(kb * 1_000 + D)
    KH, G, S = 2, 4, 333
    q = torch.from_numpy(rng.standard_normal((2, S, KH * G, D)).astype(
        np.float32)).to(cuda)
    k, v = (torch.from_numpy(rng.standard_normal((2, S, KH, D)).astype(
        np.float32)).to(cuda) for _ in range(2))
    for window in (None, 100):
        ops.reset_launches()
        got = ops.flash_attention_auto(q, k, v, window=window, kv_chunk=kb)
        assert ops.LAUNCHES == {"flash_attention": 1}
        want = ops.flash_attention_auto(q, k, v, window=window, impl="ref")
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
        for rows in (70, 129, 200):
            part = ops.flash_attention_auto(q[:, :rows], k, v, window=window,
                                            kv_chunk=kb)
            assert torch.equal(part, got[:, :rows]), (window, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("D,kb", [(320, 64), (256, 1024)])
def test_cuda_flash_attention_rejects_what_it_cannot_take(cuda, D, kb):
    """The C entry refuses a head_dim over 256 and a carve larger than
    the card's shared memory per block; the wrapper raises ValueError."""
    q = torch.zeros((1, 1024, 2, D), device=cuda)
    k = torch.zeros((1, 1024, 1, D), device=cuda)
    ops.reset_launches()
    with pytest.raises(ValueError, match="does not take"):
        ops.flash_attention_auto(q, k, k, kv_chunk=kb)
    assert ops.LAUNCHES == {"flash_attention": 0}


BF16_TOL = 3e-2         # chip_smoke.ATT_TOL[bfloat16], as allclose
BF16_CASES = [(D, G, S, w, c) for D in (16, 64, 96, 128) for G in (1, 4)
              for S in (96, 500, 512) for w in (None, 128)
              for c in (True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("D,G,S,window,causal", BF16_CASES)
def test_cuda_flash_attention_bf16_matches_plain(cuda, D, G, S, window,
                                                 causal):
    """The bf16 tensor-core kernel against the plain version (naive
    attention) at ATT_TOL[bf16]; bf16 out; a row's bytes do not depend on
    how many query rows are launched."""
    rng = np.random.default_rng(D * 1_000 + G * 100 + S + (window or 0))
    KH = 2
    q = torch.from_numpy(rng.standard_normal((2, S, KH * G, D)).astype(
        np.float32)).to(cuda).bfloat16()
    k, v = (torch.from_numpy(rng.standard_normal((2, S, KH, D)).astype(
        np.float32)).to(cuda).bfloat16() for _ in range(2))
    ops.reset_launches()
    got = ops.flash_attention_auto(q, k, v, causal=causal, window=window)
    assert ops.LAUNCHES == {"flash_attention": 1}
    want = ops.flash_attention_auto(q, k, v, causal=causal, window=window,
                                    impl="ref")
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_TOL,
                               atol=BF16_TOL)
    rows = 300 if S > 300 else 50
    part = ops.flash_attention_auto(q[:, :rows], k, v, causal=causal,
                                    window=window)
    assert torch.equal(part, got[:, :rows])


# the enc-dec and patch-prefix archs' prefill layouts, (Sq, Skv, H, KH, D,
# causal): whisper-medium's cross-attention (512 decoder queries over
# 1,500 frames) and encoder (1,500 x 1,500), both non-causal and neither
# a multiple of the kernel's 64-key tiles; its decoder self-attention;
# llava-next-34b's G 7 at D 128
SERVE_BF16_CASES = [(512, 1500, 16, 16, 64, False),
                    (1500, 1500, 16, 16, 64, False),
                    (512, 512, 16, 16, 64, True),
                    (512, 512, 56, 8, 128, True),
                    (512, 1500, 56, 8, 128, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Skv,H,KH,D,causal", SERVE_BF16_CASES)
def test_cuda_flash_attention_bf16_serve_layouts(cuda, Sq, Skv, H, KH, D,
                                                 causal):
    """The bf16 kernel at the enc-dec and patch-prefix serve layouts (B 2)
    against the plain version at ATT_TOL[bf16]; a row's bytes do not
    depend on how many query rows are launched."""
    rng = np.random.default_rng(Sq + Skv + H + D)
    q = torch.from_numpy(rng.standard_normal((2, Sq, H, D)).astype(
        np.float32)).to(cuda).bfloat16()
    k, v = (torch.from_numpy(rng.standard_normal((2, Skv, KH, D)).astype(
        np.float32)).to(cuda).bfloat16() for _ in range(2))
    ops.reset_launches()
    got = ops.flash_attention_auto(q, k, v, causal=causal)
    assert ops.LAUNCHES == {"flash_attention": 1}
    want = ops.flash_attention_auto(q, k, v, causal=causal, impl="ref")
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_TOL,
                               atol=BF16_TOL)
    part = ops.flash_attention_auto(q[:, :300], k, v, causal=causal)
    assert torch.equal(part, got[:, :300])
