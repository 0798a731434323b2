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
* ``ref.decode_attention_split_ref`` (the CUDA kernel's split-KV
  arithmetic: per-chunk softmax, merge in chunk order) against the
  reference's Pallas kernel in interpret mode and the port's plain version,
  at fp32 2e-4 (ATT_TOL), over cur_len 1, cur_len on a chunk boundary, a
  window that starts inside a chunk and wholly masked leading chunks, at
  G 1 and 4 and D 16, 64 and 128.

Inputs are numpy normals; bf16 inputs are rounded by JAX and carried over
exactly. The ``cuda`` tests hold the CUDA kernel against the plain version
on the card at the same tolerances; they need no JAX and skip where there
is no GPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention import ref as dref
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


SPLIT = ops.SPLIT_KEYS
# (S, cur_len, window) against the split unit: a single live key; cur_len
# on a chunk boundary; a window whose first key falls inside a chunk; a
# window that leaves the leading chunks wholly masked
SPLIT_SCENARIOS = {
    "cur_len_1": (2 * SPLIT + 3, 1, None),
    "cur_on_boundary": (3 * SPLIT + 8, 2 * SPLIT, None),
    "window_mid_split": (3 * SPLIT, 2 * SPLIT + 22, SPLIT // 2 + 9),
    "leading_splits_masked": (4 * SPLIT + 5, 4 * SPLIT + 1, 20),
}


@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("scenario", sorted(SPLIT_SCENARIOS))
def test_split_ref_matches_reference(ref, scenario, G, D):
    """The kernel's split arithmetic, in plain PyTorch, against the
    reference's Pallas kernel (interpret mode, its own sequential KV
    blocks) and the port's plain version, at fp32 ATT_TOL."""
    rattn, pallas = ref
    S, cur, win = SPLIT_SCENARIOS[scenario]
    c = dict(B=2, H=2 * G, KH=2, D=D, S=S, cur=cur, win=win)
    (jq, jk, jv), (q, k, v) = _inputs(S + 7 * G + D, c, "fp32")
    got = dref.decode_attention_split_ref(q, k, v, cur, window=win,
                                          split=SPLIT)
    assert got.dtype == q.dtype and got.shape == q.shape
    kern = np.asarray(pallas(jq, jk, jv, cur, window=win, kv_block=32,
                             interpret=True), np.float32)
    np.testing.assert_allclose(got.numpy(), kern, rtol=TOL["fp32"],
                               atol=TOL["fp32"])
    plain = ops.decode_attention_auto(q, k, v, cur, window=win)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=TOL["fp32"],
                               atol=TOL["fp32"])


def test_split_ref_with_no_live_key_writes_zeros():
    c = dict(B=1, H=4, KH=2, D=16, S=SPLIT, cur=0, win=None)
    _, (q, k, v) = _inputs(1, c, "fp32")
    got = dref.decode_attention_split_ref(q, k, v, 0, split=SPLIT)
    assert not got.any()


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


# the serve decode shapes (B 16, cache 1,024, cur_len 577, D 128): qwen3-8b
# (H 32, KH 8) without and with a window, then the other ported archs'
# (H, KH): internlm2-20b (G 6), phi3-medium-14b (KH 10), qwen1.5-4b and
# deepseek-moe-16b (G 1)
SERVE_LAYOUTS = [(32, 8, None), (32, 8, 128), (48, 8, None), (40, 10, None),
                 (20, 20, None), (16, 16, None)]
SERVED = [dict(B=16, H=h, KH=kh, D=128, S=1024, cur=577, win=w)
          for h, kh, w in SERVE_LAYOUTS]
# the enc-dec and patch-prefix archs' decode shapes: whisper-medium's
# self-attention (16/16 at D 64) and cross-attention (every one of the
# 1,500 cached frames: cur_len = S), llava-next-34b's G 7 (56/8)
SERVED += [dict(B=16, H=16, KH=16, D=64, S=1024, cur=577, win=None),
           dict(B=16, H=16, KH=16, D=64, S=1500, cur=1500, win=None),
           dict(B=16, H=56, KH=8, D=128, S=1024, cur=577, win=None)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("ci", range(len(CASES) + len(SERVED)))
def test_kernel_matches_plain(gpu, ci, dtype):
    c = (CASES + SERVED)[ci]
    q, k, v = _card(ci, c, dtype, gpu)
    cur = torch.tensor(c["cur"], dtype=torch.int32, device=gpu)
    # the reference's cases at its test's kv_block, 32 (several KV blocks,
    # and with a window, skipped leading ones); the serve shapes at 256
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


DECODE_BF16_TOL = 1e-2      # chip_smoke.DECODE_BF16_TOL: outputs ~0.07


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("scenario", sorted(SPLIT_SCENARIOS))
def test_kernel_split_grid_matches_plain(gpu, scenario, G, D, dtype):
    """The split-KV kernel on the split scenarios' grid against the plain
    version (fp32 ATT_TOL, bf16 DECODE_BF16_TOL) and, at fp32, against
    the plain model of its own arithmetic (split_ref) at 1e-5."""
    S, cur, win = SPLIT_SCENARIOS[scenario]
    c = dict(B=2, H=2 * G, KH=2, D=D, S=S, cur=cur, win=win)
    q, k, v = _card(S + G + D, c, dtype, gpu)
    cur_t = torch.tensor(cur, dtype=torch.int32, device=gpu)
    got = ops.decode_attention_auto(q, k, v, cur_t, window=win)
    want = ops.decode_attention_auto(q, k, v, cur_t, window=win, impl="ref")
    tol = TOL["fp32"] if dtype == "fp32" else DECODE_BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == "fp32":
        model = dref.decode_attention_split_ref(q, k, v, cur, window=win,
                                                split=ops.SPLIT_KEYS)
        torch.testing.assert_close(got, model, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("H,KH,window", SERVE_LAYOUTS)
def test_kernel_bits_ignore_capacity_and_repeat(gpu, dtype, H, KH, window):
    """A row's bytes depend on the live prefix only: the same first 640
    cache entries in caches of capacity 640 and 1,024 give the same
    bytes, and so does a second run (at each serve head layout)."""
    c = dict(B=4, H=H, KH=KH, D=128, S=1024, cur=577, win=window)
    q, k, v = _card(9, c, dtype, gpu)
    cur = torch.tensor(c["cur"], dtype=torch.int32, device=gpu)
    big = ops.decode_attention_auto(q, k, v, cur, window=window)
    again = ops.decode_attention_auto(q, k, v, cur, window=window)
    small = ops.decode_attention_auto(q, k[:, :640].contiguous(),
                                      v[:, :640].contiguous(), cur,
                                      window=window)
    torch.cuda.synchronize()
    assert torch.equal(big, again)
    assert torch.equal(big, small)


@pytest.mark.cuda
def test_kernel_refusals(gpu):
    c = dict(B=1, H=2, KH=1, D=320, S=8, cur=4, win=None)
    q, k, v = _card(0, c, "fp32", gpu)
    with pytest.raises(ValueError, match="head_dim"):
        ops.decode_attention_auto(q, k, v, 4)
    q, k, v = _card(0, CASES[0], "fp32", gpu)
    with pytest.raises(ValueError, match="one dtype"):
        ops.decode_attention_auto(q.bfloat16(), k, v, 4)
