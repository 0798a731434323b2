"""Port parity: repro_torch's LM (``models/transformer.py``) and its
serving entry point (``launch/serve.py``) against repro's, on the smoke
configs of the ten archs of the registry (d_model 64, vocab 256 each):
qwen3-8b (GQA 4/2, qk_norm), internlm2-20b and phi3-medium-14b (GQA 4/2),
qwen1.5-4b (MHA 4/4 with qkv bias: the port's test of ``qkv_bias``),
deepseek-moe-16b (one dense layer, then one token-choice MoE layer: 8
experts top-2, a shared expert, groups of 64), deepseek-v3-671b (MLA, 4
heads, q/kv LoRA ranks 32/16, QK head dim 16 + 8 rope, V 16: one dense
layer, then three MoE layers of 8 experts top-2 and a shared expert,
groups of 64; the MTP head declared), rwkv6-3b (2 RWKV6 layers,
4 heads of 16, chunk 16, LayerNorm) and recurrentgemma-2b (6 layers, two
units of (rec, rec, attn_local): RG-LRU width 64, local GQA 4/1 over a
16-slot ring, which the 20 positions of these tests wrap, and the logit
soft cap 30: the port's test of ``logits_soft_cap``), whisper-medium (2
encoder layers over 24 frames, 2 decoder layers with cross-attention,
MHA 4/4, LayerNorm and GELU with every bias) and llava-next-34b (GQA
4/2, 8 patch embeddings spliced over the prompt's prefix), with the
reference's weights carried over by ``bridge.load_model``. The terms the
reference initialises to zero (qwen1.5's qkv biases, RWKV's token-shift
mixes ``mu_x``/``mu``/``mu_k``/``mu_r`` and ``gn_bias``, RG-LRU's
``conv_b`` and gate biases; and for the two frontend archs only, so that
the other archs' inputs stay as they were, the LayerNorm ``bias`` and
``b_o``, ``b_in``, ``b_out``) are drawn from N(0, 0.5) in both trees, so
that a port that drops or misplaces one fails; for deepseek-v3 alone the
MLA's RMSNorm scales (``q_norm``, ``kv_norm``, all ones in the
reference) are drawn from N(1, 0.5), so that swapping or dropping one
fails. The frontends are fed
seeded N(0, 1) frames and patch embeddings (rounded to bf16): zeros would
leave whisper's encoder output at its final norm's bias and hide a broken
splice, as the reference's own tests draw them (tests/test_arch_smoke.py).

(a) fp32: the reference's params and cache cast to fp32 (every reference
    cast follows its input dtype, so it then computes in fp32). prefill,
    8 teacher-forced decode steps, ``last_logits`` and ``embed_pool``
    agree within 1e-4 (the two sum in other orders: the largest difference
    seen is 2.4e-6, at logits up to 4.3), and greedy tokens are equal.
(b) bf16, as the reference serves: the reference's own decode-vs-forward
    bar (tests/test_models.py): argmax agreement >= 0.99, rtol = atol = 0.08
    (the largest logit difference seen is 0.046). Five rows, listed in
    ``NEAR_TIES`` with their gaps, count as agreeing if the port picks
    either of the reference's top two: the reference's top two logits there,
    rounded to bf16, lie within one bf16 step of each other, and the port
    picks the runner-up. Every other row of every arch counts as the
    reference's bar counts it. rwkv6-3b and recurrentgemma-2b are held to
    the reference's fp32 run instead, with its own bf16 run as the yardstick
    (``_bf16_noise_bar``: their bf16 noise exceeds the 0.08 bar between any
    two roundings). Also, for every arch but the MoE, the port's prefill +
    decode_step against its own last_logits over S+1 tokens, on the same bar
    (one listed row, whisper-medium's row 1, whose full-forward top two
    round to one bf16 value, counts if the decode step picks either of
    them). Not for the MoE at these sizes: a decode step routes B tokens as
    one group of capacity max(..., top_k), the full forward B*(S+1) tokens
    in other groups, so drops differ (the reference leaves deepseek-moe out
    of its own decode-vs-forward test); its prefill + decode is held against
    the reference's prefill + decode instead, by (a) and (b). deepseek-v3
    has the twin at the reference's own sizes (B 2, S 24), which its test
    lists. In bf16 one prefill route differs from the reference's at each
    MoE arch (deepseek-moe: token 4, second choice; deepseek-v3: one choice
    of its second MoE layer), so that case forces the reference's routes,
    read from its ``_dispatch_combine`` by a callback, through the port's
    ``routes=`` seam; so does (c)'s per-step replay at deepseek-moe (one
    prefill route differs there too); deepseek-v3's replay holds SCORE_TOL
    on its own routes.
(c) End to end: the port's ``run_serving(smoke=True, device="cpu")``
    against the reference's at the same seed, batch, lengths and weights,
    with the reference's fed tokens replayed so that a near-tie cannot
    fork the runs (and its zero frames and patch embeddings): the same
    ``final_len``, means within 1e-2, and every step's scores (a replay of the steps, the MoE's on the reference's
    routes) within SCORE_TOL. In bf16 the logits differ by a few
    1e-2, and rc, a ratio of two probabilities, moves most (2.7e-2 seen).

The ``cuda`` tests need no JAX and skip where there is no GPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import bridge, configs
from repro_torch.configs import qwen3_8b
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.uncertainty import ops as unc_ops
from repro_torch.launch import serve
from repro_torch.models import transformer
from repro_torch.models.layers.moe import RouteTape
from repro_torch.models.transformer import Model

B, S, T, MAX_LEN = 2, 12, 8, 24
KINDS = ("lc", "mc", "rc", "es")
SCORE_TOL = {"lc": 1e-2, "mc": 1e-2, "rc": 6e-2, "es": 1e-2}


ARCHS = ["qwen3-8b", "internlm2-20b", "phi3-medium-14b", "qwen1.5-4b",
         "deepseek-moe-16b", "deepseek-v3-671b", "rwkv6-3b",
         "recurrentgemma-2b", "whisper-medium", "llava-next-34b"]
MOE = ("deepseek-moe-16b", "deepseek-v3-671b")
NOT_MOE = [a for a in ARCHS if a not in MOE]
# leaves the reference initialises to zero, drawn non-zero in both trees
DRAWN = ("b_q", "b_k", "b_v", "mu_x", "mu", "mu_k", "mu_r", "gn_bias",
         "conv_b", "gate_a_b", "gate_x_b")
# ... and, for the frontend archs alone, the LayerNorm and linear biases
FRONTEND = ("whisper-medium", "llava-next-34b")
DRAWN_FRONTEND = ("bias", "b_o", "b_in", "b_out")
# ... and, for deepseek-v3 alone, the MLA's norm scales (ones)
MLA_NORMS = ("q_norm", "kv_norm")


def _port_cfg(arch="qwen3-8b", impl="pallas"):
    return dataclasses.replace(configs.get_smoke_config(arch),
                               attention_impl=impl)


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config
    from repro.models.transformer import Model as RefModel
    cfg = get_smoke_config(request.param)
    model = RefModel(cfg)
    params = model.init(jax.random.PRNGKey(0))
    # the reference declares these zero: draw them, so that a port that
    # drops or misplaces one fails
    rng = np.random.default_rng(2)

    drawn = DRAWN + (DRAWN_FRONTEND if request.param in FRONTEND else ())

    mla = request.param == "deepseek-v3-671b"

    def draw(path, a):
        if mla and len(path) > 1 and \
                getattr(path[-2], "key", None) in MLA_NORMS:
            return jax.numpy.asarray(rng.normal(1.0, 0.5, a.shape), a.dtype)
        if getattr(path[-1], "key", None) not in drawn:
            return a
        return jax.numpy.asarray(rng.normal(0.0, 0.5, a.shape), a.dtype)
    params = jax.tree_util.tree_map_with_path(draw, params)
    return {"jax": jax, "arch": request.param, "cfg": cfg, "model": model,
            "params": params,
            "prefill": jax.jit(model.prefill),
            "decode": jax.jit(model.decode_step)}


@pytest.fixture(scope="module")
def toks():
    return np.random.default_rng(1).integers(0, 256, (B, S + T)).astype(
        np.int32)


def _frontend(cfg, batch=B, zeros=False):
    """The frontend inputs of ``cfg`` as fp32 numpy arrays holding bf16
    values: frames (batch, n_enc_frames, d) for an enc-dec config, patch
    embeddings (batch, n_patches, d) for a patch-prefix one; seeded N(0,
    1), or zeros (what ``run_serving`` feeds)."""
    rng = np.random.default_rng(7)
    out = {}
    for key, n, on in (("frames", cfg.n_enc_frames, cfg.enc_dec),
                       ("patch_embeds", cfg.n_patches, cfg.n_patches > 0)):
        if on:
            a = (np.zeros if zeros else rng.standard_normal)(
                (batch, n, cfg.d_model)).astype(np.float32)
            out[key] = torch.from_numpy(a).bfloat16().float().numpy()
    return out


def _ref_batch(tokens, front, dtype):
    import jax.numpy as jnp
    out = {"tokens": jnp.asarray(tokens)}
    out.update({k: jnp.asarray(v, dtype) for k, v in front.items()})
    return out


def _port_batch(tokens, front, dtype):
    out = {"tokens": torch.from_numpy(np.ascontiguousarray(tokens))}
    out.update({k: torch.from_numpy(v).to(dtype) for k, v in front.items()})
    return out


# (arch, index in _ref_run's logits, "last_logits" or
# "decode_vs_forward", row): the reference's top-2 gap (for
# "decode_vs_forward", the port's own full forward's, which the decode
# step is held to). Each gap, with the two logits rounded to bf16 (the
# dtype both LM heads' products come out in), is at most one bf16 step
# at these logits (2**-6 in [2, 4); the eager last_logits are bf16
# values, so its smallest gap is that step, or 0: whisper's full forward
# rounds its two top logits to one bf16 value, 0.013 apart in fp32), so
# the rounding of either model decides the argmax: the port picks the
# runner-up in each row. deepseek-v3's row is 0.0194 apart as the
# reference's jit leaves it (2.2786 and 2.2980: XLA keeps fp32 through
# the fused head), one step apart in bf16 (2.28125, 2.296875); the
# port's two logits are one bf16 value, 2.296875, and its argmax takes
# the lower index.
NEAR_TIES = {("internlm2-20b", 1, 1): 0.0100,
             ("deepseek-moe-16b", 2, 1): 0.0011,
             ("deepseek-v3-671b", 2, 0): 0.0194,
             ("qwen1.5-4b", "last_logits", 1): 0.0156,
             ("whisper-medium", 7, 0): 0.0073,
             ("whisper-medium", "decode_vs_forward", 1): 0.0}
TIE_GAP = 2.0 ** -6


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float(
        ).numpy()


def _argmax_bar(want, got, ties=()):
    """The reference's bar: argmax agreement >= 0.99. ``ties`` are (row,
    gap) of listed near-tie rows: the gap is checked, and the row counts
    as agreeing if the port picks either of the reference's top two."""
    want, got = np.asarray(want), np.asarray(got)
    agree = np.argmax(want, -1) == np.argmax(got, -1)
    for row, gap in ties:
        top2 = np.argsort(want[row], kind="stable")[-2:]
        seen = want[row, top2[1]] - want[row, top2[0]]
        steps = np.diff(_bf16(want[row, top2]))[0]
        assert steps <= TIE_GAP and abs(seen - gap) < 1e-3, (row, seen)
        agree[row] = np.argmax(got[row]) in top2
    assert np.mean(agree) >= 0.99


def _ties(arch, step):
    return [(row, gap) for (a, i, row), gap in NEAR_TIES.items()
            if (a, i) == (arch, step)]


def _np_tree(jax, tree):
    return jax.tree.map(np.asarray, tree)


def _ref_run(ref, params, toks, cache_dtype=None, greedy=False):
    """Reference prefill + T decode steps (teacher-forced on ``toks``, or
    greedy), with ``_frontend``'s inputs in the cache dtype (bf16 unless
    given); returns (list of logits, fed tokens)."""
    import jax.numpy as jnp
    from repro.common.param import init_params
    jax, model = ref["jax"], ref["model"]
    cache = init_params(model.cache_decls(B, MAX_LEN), jax.random.PRNGKey(1))
    if cache_dtype is not None:
        cache = jax.tree.map(lambda a: a.astype(cache_dtype)
                             if a.dtype == jnp.bfloat16 else a, cache)
    batch = _ref_batch(toks[:, :S], _frontend(ref["cfg"]),
                       cache_dtype or jnp.bfloat16)
    cache, logits = ref["prefill"](params, batch, cache)
    out, fed = [np.asarray(logits)], []
    for t in range(T):
        tok = (jnp.argmax(logits, -1)[:, None].astype(jnp.int32) if greedy
               else jnp.asarray(toks[:, S + t:S + t + 1]))
        fed.append(np.asarray(tok)[:, 0])
        logits, cache = ref["decode"](params, cache, tok)
        out.append(np.asarray(logits))
    assert int(cache["len"]) == S + T
    return out, np.stack(fed)


def _record_routes(ref, monkeypatch):
    """A copy of ``ref`` on fresh jits whose every ``_dispatch_combine``
    call hands its top-k indices and dispatch to an ordered callback.
    Returns (the copy, a function that gives the calls' routes so far, in
    call order, as the port's ``Routes``: each choice's slot, C where
    dropped)."""
    from repro.models.layers import moe as rmoe
    from repro_torch.models.layers.moe import Routes
    jax, model, seen = ref["jax"], ref["model"], []
    inner = rmoe._dispatch_combine

    def recording(probs, mo, C):
        dispatch, combine, topi, topv = inner(probs, mo, C)
        jax.debug.callback(lambda t, d: seen.append((np.asarray(t),
                                                     np.asarray(d))),
                           topi, dispatch, ordered=True)
        return dispatch, combine, topi, topv
    monkeypatch.setattr(rmoe, "_dispatch_combine", recording)
    fresh = dict(ref, prefill=jax.jit(lambda p, b, c: model.prefill(p, b, c)),
                 decode=jax.jit(lambda p, c, t: model.decode_step(p, c, t)))

    def routes():
        jax.effects_barrier()
        out = []
        for topi, dispatch in seen:
            chosen = np.take_along_axis(dispatch, topi[..., None], 2)
            slot = np.where(chosen.any(-1), chosen.argmax(-1),
                            chosen.shape[-1])
            out.append(Routes(torch.from_numpy(topi.astype(np.int64)),
                              torch.from_numpy(slot.astype(np.int64))))
        return out
    return fresh, routes


def _port_run(cfg, params, toks, dtype, greedy=False, routes=None):
    model = Model(cfg, routes=routes)
    cache = model.init_cache(B, MAX_LEN, "cpu", dtype)
    cache, logits = model.prefill(
        params, _port_batch(toks[:, :S], _frontend(cfg), dtype), cache)
    out, fed = [logits.numpy()], []
    for t in range(T):
        tok = (torch.argmax(logits, -1)[:, None].to(torch.int32) if greedy
               else torch.from_numpy(toks[:, S + t:S + t + 1]))
        fed.append(tok[:, 0].numpy())
        logits, cache = model.decode_step(params, cache, tok)
        out.append(logits.numpy())
    assert cache["len"].dtype == torch.int32 and int(cache["len"]) == S + T
    return out, np.stack(fed)


def test_fp32_model_parity(ref, toks):
    import jax.numpy as jnp
    jax, arch = ref["jax"], ref["arch"]
    rp = jax.tree.map(lambda a: a.astype(jnp.float32), ref["params"])
    pp = bridge.load_model(_np_tree(jax, rp), _port_cfg(arch))
    assert pp["embed"].dtype == torch.float32
    want, _ = _ref_run(ref, rp, jnp.asarray(toks), cache_dtype=jnp.float32)
    got, _ = _port_run(_port_cfg(arch), pp, toks, torch.float32)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    # on a CPU tensor the kernel path ("pallas") is the chunked path, bit
    # for bit
    plain, _ = _port_run(_port_cfg(arch, "chunked"), pp, toks, torch.float32)
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a, b)
    want, want_fed = _ref_run(ref, rp, jnp.asarray(toks),
                              cache_dtype=jnp.float32, greedy=True)
    got, got_fed = _port_run(_port_cfg(arch), pp, toks, torch.float32,
                             greedy=True)
    np.testing.assert_array_equal(got_fed, want_fed)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    model = Model(_port_cfg(arch))
    front = _frontend(ref["cfg"])
    batch = _port_batch(toks, front, torch.float32)
    rbatch = _ref_batch(toks, front, jnp.float32)
    np.testing.assert_allclose(
        model.last_logits(pp, batch).numpy(),
        np.asarray(ref["model"].last_logits(rp, rbatch)), rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        model.embed_pool(pp, batch).numpy(),
        np.asarray(ref["model"].embed_pool(rp, rbatch)), rtol=0, atol=1e-4)


def test_bf16_model_parity(ref, toks, monkeypatch):
    import jax.numpy as jnp
    arch = ref["arch"]
    pp = bridge.load_model(_np_tree(ref["jax"], ref["params"]),
                           _port_cfg(arch))
    assert pp["embed"].dtype == torch.bfloat16
    assert {t.dtype for _, t in _leaves(
        pp["segments"][-1][-1]["0"]["mixer"])} == {torch.bfloat16}
    if arch == "deepseek-moe-16b":
        assert [len(s) for s in pp["segments"]] == [1, 1]
        mlp = pp["segments"][1][0]["0"]["mlp"]
        assert mlp["router"].dtype == torch.float32
        assert mlp["w_in"].dtype == torch.bfloat16
        assert tuple(mlp["w_in"].shape) == (8, 64, 32)
    if arch == "deepseek-v3-671b":
        assert [len(s) for s in pp["segments"]] == [1, 3]
        mixer = pp["segments"][1][2]["0"]["mixer"]
        assert tuple(mixer["w_uk"].shape) == (16, 4 * 16)
        assert tuple(mixer["w_dkv"].shape) == (64, 16 + 8)
        assert tuple(pp["mtp"]["proj"].shape) == (128, 64)
        assert set(pp["mtp"]["layer"]["mixer"]) == set(mixer)
    tape = None
    if arch in MOE:
        # one prefill route differs in bf16 at each MoE arch: replay the
        # reference's
        n_moe = ROUTERS[arch][1]
        recorded, routes = _record_routes(ref, monkeypatch)
        want, _ = _ref_run(recorded, ref["params"], jnp.asarray(toks))
        assert len(routes()) == n_moe * (T + 1)   # prefill + T steps
        tape = RouteTape(force=routes())
    else:
        want, _ = _ref_run(ref, ref["params"], jnp.asarray(toks))
    got, _ = _port_run(_port_cfg(arch), pp, toks, torch.bfloat16,
                       routes=tape)
    if tape is not None:
        assert len(tape.recorded) == len(tape._force)
    front = _frontend(ref["cfg"])
    last = Model(_port_cfg(arch)).last_logits(
        pp, _port_batch(toks, front, torch.bfloat16)).numpy()
    want_last = np.asarray(ref["model"].last_logits(
        ref["params"], _ref_batch(toks, front, jnp.bfloat16)))
    if arch in RECURRENT:
        rp = ref["jax"].tree.map(lambda a: a.astype(jnp.float32),
                                 ref["params"])
        exact, _ = _ref_run(ref, rp, jnp.asarray(toks),
                            cache_dtype=jnp.float32)
        exact.append(np.asarray(ref["model"].last_logits(
            rp, _ref_batch(toks, front, jnp.float32))))
        _bf16_noise_bar(np.stack(want + [want_last]),
                        np.stack(got + [last]), np.stack(exact))
        return
    for i, (w, g) in enumerate(zip(want, got)):
        _argmax_bar(w, g, _ties(arch, i))
        np.testing.assert_allclose(g, w, rtol=0.08, atol=0.08)
    _argmax_bar(want_last, last, _ties(arch, "last_logits"))
    np.testing.assert_allclose(last, want_last, rtol=0.08, atol=0.08)


# The recurrent archs' bf16 logits carry more rounding noise than the
# others' at the smoke size: the reference's own bf16 run differs from its
# fp32 run by up to 0.25 (rwkv6-3b: every cast is the reference's, and the
# WKV's fp32 inputs are bf16 products), where the dense archs stay within
# 0.06. Two implementations that round in different places (XLA fuses the
# bf16 elementwise chains and keeps their excess precision on the CPU; the
# port rounds each op) then differ by more than the 0.08 bar, though each
# is as close to the exact model as the other. So these archs' bf16 runs
# are held to the exact model, the reference's fp32 run, with the
# reference's own bf16 run as the yardstick.
RECURRENT = ("rwkv6-3b", "recurrentgemma-2b")


def _bf16_noise_bar(want, got, exact):
    """(steps, B, V) logits of the reference in bf16, the port in bf16 and
    the reference in fp32. The port's mean |error| against fp32 is within
    1.1x the reference's and its largest within 1.25x the reference's
    largest; every row whose fp32 top-2 gap exceeds twice the reference's
    largest bf16 error (no rounding at this noise can flip it) has the
    reference's argmax, and the rows agree at >= 0.9 overall."""
    ref_err, port_err = np.abs(want - exact), np.abs(got - exact)
    assert port_err.mean() <= 1.1 * ref_err.mean(), (port_err.mean(),
                                                     ref_err.mean())
    assert port_err.max() <= 1.25 * ref_err.max(), (port_err.max(),
                                                   ref_err.max())
    top2 = np.sort(exact, -1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > 2.0 * ref_err.max()
    agree = np.argmax(want, -1) == np.argmax(got, -1)
    assert sure.any() and agree[sure].all()
    assert agree.mean() >= 0.9


@pytest.mark.parametrize("arch", NOT_MOE)
def test_decode_matches_full_forward(toks, arch):
    """Port twin of the reference's test_decode_matches_full_forward:
    prefill(S) + decode(token S) equals last_logits over S+1 tokens."""
    model = Model(_port_cfg(arch))
    params = model.init(0, "cpu")
    front = _frontend(model.cfg)
    full = model.last_logits(params, _port_batch(
        toks[:, :S + 1], front, torch.bfloat16)).numpy()
    cache = model.init_cache(B, S + 4, "cpu")
    cache, _ = model.prefill(params, _port_batch(
        toks[:, :S], front, torch.bfloat16), cache)
    dec, cache = model.decode_step(params, cache, torch.from_numpy(
        toks[:, S:S + 1]))
    assert int(cache["len"]) == S + 1
    _argmax_bar(full, dec.numpy(), _ties(arch, "decode_vs_forward"))
    np.testing.assert_allclose(dec.numpy(), full, rtol=0.08, atol=0.08)


def test_decode_matches_full_forward_mla():
    """The twin for deepseek-v3, at the reference's own sizes (its test
    lists this arch, tests/test_models.py): B 2, S 24, so that the
    prefill routes its 48 tokens as one group of capacity 15, the full
    forward 50 at 16 and the decode step 2 at 2, and no choice the
    decode step keeps is one the forward drops; the reference's bar."""
    arch, seq = "deepseek-v3-671b", 24
    model = Model(_port_cfg(arch))
    params = model.init(0, "cpu")
    toks = np.random.default_rng(3).integers(0, 256, (B, seq + 1)).astype(
        np.int32)
    full = model.last_logits(params, _port_batch(toks, {}, None)).numpy()
    cache = model.init_cache(B, seq + 4, "cpu")
    cache, _ = model.prefill(params, _port_batch(toks[:, :seq], {}, None),
                             cache)
    dec, cache = model.decode_step(params, cache, torch.from_numpy(
        toks[:, seq:seq + 1]))
    assert int(cache["len"]) == seq + 1
    _argmax_bar(full, dec.numpy())
    np.testing.assert_allclose(dec.numpy(), full, rtol=0.08, atol=0.08)


def _ref_serving_replica(ref, seed, batch, prompt_len, steps, max_len):
    """The body of repro's run_serving (same jitted functions, same
    inputs: zero frames and patch embeddings), keeping what its dict
    throws away: the fed tokens and every step's scores."""
    import jax.numpy as jnp
    from repro.common.param import init_params
    from repro.data.synthetic import lm_pool
    from repro.kernels.uncertainty import ops as runc
    jax, model = ref["jax"], ref["model"]
    params = model.init(jax.random.PRNGKey(seed))
    prompt, _ = lm_pool(batch, prompt_len, ref["cfg"].vocab, seed=seed)
    cache = init_params(model.cache_decls(batch, max_len),
                        jax.random.PRNGKey(1))
    front = _zero_frontend(ref["cfg"], batch, prompt_len)
    cache, logits = ref["prefill"](
        params, _ref_batch(prompt, front, jnp.bfloat16), cache)
    fed, scores = [], []
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    for _ in range(steps):
        fed.append(np.asarray(tok)[:, 0])
        logits, cache = ref["decode"](params, cache, tok)
        s = runc.uncertainty_stats(logits)
        scores.append(np.stack([np.asarray(s[k]) for k in KINDS]))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    return params, np.stack(fed), np.stack(scores, 1), int(cache["len"])


def _zero_frontend(cfg, batch, prompt_len):
    """What both ``run_serving``s feed: zero frames (batch, n_enc_frames,
    d) and min(n_patches, prompt_len) zero patch embeddings."""
    front = _frontend(cfg, batch, zeros=True)
    if "patch_embeds" in front:
        front["patch_embeds"] = front["patch_embeds"][:, :prompt_len]
    return front


def test_run_serving_matches_reference(ref, monkeypatch):
    from repro.launch.serve import run_serving as ref_run_serving
    arch = ref["arch"]
    kw = dict(batch=2, prompt_len=8, decode_steps=4, max_len=16, seed=0)
    want = ref_run_serving(arch, smoke=True, log=False, **kw)
    replica, routes = ref, None
    if arch == "deepseek-moe-16b":
        replica, routes = _record_routes(ref, monkeypatch)
    rparams, fed, rscores, rlen = _ref_serving_replica(
        replica, kw["seed"], kw["batch"], kw["prompt_len"],
        kw["decode_steps"], kw["max_len"])
    assert rlen == want["final_len"]
    np.testing.assert_allclose(rscores[0].mean(), want["mean_lc"], rtol=1e-6)
    np.testing.assert_allclose(rscores[3].mean(), want["mean_es"], rtol=1e-6)

    params = bridge.load_model(_np_tree(ref["jax"], rparams),
                               _port_cfg(arch))
    got = serve.run_serving(arch, smoke=True, log=False, device="cpu",
                            params=params, tokens=torch.from_numpy(fed), **kw)
    assert got["arch"] == want["arch"] == ref["cfg"].name
    assert got["final_len"] == want["final_len"] == 12
    for key in ("mean_lc", "mean_es"):
        assert abs(got[key] - want[key]) <= 1e-2, key
    for key in ("prefill_s", "decode_s_per_step", "tokens_per_s"):
        assert got[key] > 0

    # every step's scores, through the same replay (and the MoE on the
    # reference's routes)
    from repro_torch.data.synthetic import lm_pool
    model = Model(_port_cfg(arch), routes=None if routes is None else
                  RouteTape(force=routes()))
    prompt, _ = lm_pool(kw["batch"], kw["prompt_len"], ref["cfg"].vocab,
                        seed=kw["seed"])
    cache = model.init_cache(kw["batch"], kw["max_len"], "cpu")
    front = _zero_frontend(model.cfg, kw["batch"], kw["prompt_len"])
    cache, logits = model.prefill(
        params, _port_batch(prompt, front, torch.bfloat16), cache)
    scores, pfed = serve.serve_steps(model, params, cache, logits,
                                     kw["decode_steps"],
                                     feed=torch.from_numpy(fed))
    assert scores.shape == (4, kw["decode_steps"], kw["batch"])
    np.testing.assert_array_equal(pfed.numpy(), fed)
    for i, k in enumerate(KINDS):
        np.testing.assert_allclose(scores[i].numpy(), rscores[i], rtol=0,
                                   atol=SCORE_TOL[k], err_msg=k)


def test_run_serving_greedy_on_cpu():
    out = serve.run_serving(batch=3, prompt_len=5, decode_steps=4,
                            max_len=9, device="cpu", log=False)
    # the default arch is the reference's, rwkv6-3b
    assert out["arch"] == "rwkv6-smoke" and out["final_len"] == 9
    assert 0.0 <= out["mean_lc"] <= 1.0 and np.isfinite(out["mean_es"])
    with pytest.raises(ValueError, match="max_len"):
        serve.run_serving(prompt_len=5, decode_steps=5, max_len=9,
                          device="cpu", log=False)
    for counts in (fa_ops.LAUNCHES, da_ops.LAUNCHES, unc_ops.LAUNCHES):
        assert set(counts.values()) == {0}       # the CPU launches none


def test_run_serving_takes_a_config():
    """``run_serving`` serves an ``ArchConfig`` as given (the depth cut
    the card serves deepseek-v3 with): deepseek-v3's smoke config cut to
    2 layers (1 dense, 1 MoE) serves, and its seeded weights are
    ``Model(cut).init(seed)``'s."""
    cut = dataclasses.replace(configs.get_smoke_config("deepseek-v3-671b"),
                              n_layers=2)
    kw = dict(batch=2, prompt_len=5, decode_steps=3, max_len=8,
              device="cpu", log=False)
    out = serve.run_serving(cut, **kw)
    assert out["arch"] == "dsv3-smoke" and out["final_len"] == 8
    same = serve.run_serving(cut, params=Model(cut).init(0, "cpu"), **kw)
    assert (same["mean_lc"], same["mean_es"]) == (out["mean_lc"],
                                                  out["mean_es"])


def test_run_serving_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda path runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run_serving(log=False)


@pytest.mark.parametrize("family", ["mla", "hybrid", "ssm", "audio", "vlm"])
def test_non_dense_configs_raise(family):
    """A family without its sub-config or frontend is refused. ``mla``:
    deepseek-v3's family is ``moe``, so a ``moe``-family config with
    neither ``moe`` nor ``mla`` (qwen3-8b's), and deepseek-v3's own
    config with its MoE sub-config removed (MLA alone is not its
    stack), are refused."""
    cfgs = [dataclasses.replace(qwen3_8b.smoke_config(),
                                family="moe" if family == "mla" else family)]
    if family == "mla":
        cfgs.append(dataclasses.replace(
            configs.get_smoke_config("deepseek-v3-671b"), moe=None))
    for cfg in cfgs:
        with pytest.raises(NotImplementedError, match="sub-config"):
            Model(cfg)
        with pytest.raises(NotImplementedError, match="sub-config"):
            transformer.build_segments(cfg)


def test_registry_and_declarations():
    assert configs.get_smoke_config("qwen3-8b") == \
        configs.get_smoke_config("qwen3_8b") == qwen3_8b.smoke_config()
    assert configs.get_config("qwen3-8b") is qwen3_8b.CONFIG
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("qwen3-9b")
    for name, mod in configs.ALIASES.items():
        assert configs.get_config(name) is configs.get_config(mod)
        assert mod in configs.ARCH_IDS
    assert set(configs.ALIASES) == set(ARCHS)
    cfg = qwen3_8b.smoke_config()
    assert (cfg.q_chunk, cfg.kv_chunk) == (16, 16)
    model = Model(cfg)
    params = model.init(3, "cpu")
    assert len(params["segments"]) == 1 and len(params["segments"][0]) == 2
    assert {t.dtype for t in (params["embed"], params["lm_head"],
                              params["final_norm"]["scale"])} == \
        {torch.bfloat16}
    cache = model.init_cache(2, 10, "cpu")
    assert cache["len"].shape == () and cache["len"].dtype == torch.int32
    k = cache["segments"][0]["0"]["k"]
    assert k.shape == (2, 2, 10, 2 * 16) and k.dtype == torch.bfloat16
    assert not k.any()
    # the blockwise encoder keeps its fp32 weights
    from repro_torch.models.blockwise import init_encoder
    enc = init_encoder(cfg, device="cpu")
    assert enc["embed"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_registry_fields(arch):
    """Every field of the port's config (full size and smoke) equals the
    reference's, the MoE, MLA, RWKV and Griffin sub-configs field by
    field."""
    pytest.importorskip("jax")
    from repro.configs import get_config, get_smoke_config
    for ours, theirs in ((configs.get_config(arch), get_config(arch)),
                         (configs.get_smoke_config(arch),
                          get_smoke_config(arch))):
        for field in dataclasses.fields(ours):
            mine, ref = getattr(ours, field.name), getattr(theirs, field.name)
            if field.name in ("moe", "mla", "rwkv", "griffin") and \
                    mine is not None:
                assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
            else:
                assert mine == ref, field.name
        for sub in ("moe", "mla", "rwkv", "griffin"):
            assert (getattr(ours, sub) is None) == \
                (getattr(theirs, sub) is None), sub


@pytest.mark.parametrize("name", ["deepseek_v3_671b"])
def test_unported_archs_raise(name):
    """The registry resolves the last arch it lacked, by module name and
    canonical id, and still refuses a name it does not list (a version
    that does not exist, in either form)."""
    canonical = name.replace("_", "-")
    assert configs.get_config(name) is configs.get_config(canonical)
    assert configs.get_smoke_config(name) == \
        configs.get_smoke_config(canonical)
    for unknown in (name.replace("v3", "v4"), canonical.replace("v3", "v4")):
        with pytest.raises(KeyError, match="unknown arch"):
            configs.get_config(unknown)
        with pytest.raises(KeyError, match="unknown arch"):
            configs.get_smoke_config(unknown)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _ref_decl_leaves(cfg):
    """(path in the port's layout, shape, dtype name) of every leaf of the
    reference's ``model_decls``, its stacked layer axes unstacked (the
    encoder's segment too)."""
    from repro.common.param import ParamDecl as RefDecl
    from repro.models.transformer import build_segments, model_decls
    decls = model_decls(cfg)
    out = {}

    def walk(node, path, stacked):
        if isinstance(node, RefDecl):
            shape = node.shape[1:] if stacked else node.shape
            for u in range(stacked or 1):
                at = path.replace("[u]", f"[{u}]")
                out[at] = (tuple(shape), np.dtype(node.dtype).name)
            return
        for k, v in node.items():
            walk(v, f"{path}/{k}", stacked)
    for k, v in decls.items():
        if k not in ("segments", "encoder"):
            walk(v, f"/{k}", 0)
    for si, (seg, sd) in enumerate(zip(build_segments(cfg),
                                       decls["segments"])):
        walk(sd, f"/segments[{si}][u]", seg.count if seg.count > 1 else 0)
    if "encoder" in decls:
        enc = decls["encoder"]
        walk(enc["final_norm"], "/encoder/final_norm", 0)
        n = cfg.n_enc_layers
        walk(enc["segment"], "/encoder/segment[u]", n if n > 1 else 0)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_init_dtypes_match_reference(arch):
    """``Model.init`` gives every leaf the shape and dtype of the
    reference's ``model_decls`` leaf at the same path (bf16, the MoE
    router fp32), at the smoke size; at full size the port's declarations
    do (nothing materialised)."""
    pytest.importorskip("jax")
    from repro.configs import get_config, get_smoke_config
    want = _ref_decl_leaves(get_smoke_config(arch))
    got = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for p, t in _leaves(Model(configs.get_smoke_config(arch)).init(
               0, "cpu"))}
    assert got == want
    routers = [p for p in got if p.endswith("/router")]
    assert len(routers) == ROUTERS.get(arch, (0, 0))[1]
    want = _ref_decl_leaves(get_config(arch))
    got = {p: (d.shape, str(d.dtype).replace("torch.", ""))
           for p, d in _leaves(Model(configs.get_config(arch)).param_decls())}
    assert got == want
    routers = [p for p in got if p.endswith("/router")]
    assert all(got[p][1] == "float32" for p in routers)
    assert len(routers) == ROUTERS.get(arch, (0, 0))[0]


# MoE layers (one router each) at full size and at the smoke size
ROUTERS = {"deepseek-moe-16b": (27, 1), "deepseek-v3-671b": (58, 3)}


# ------------------------------------------------------------- on the card --
@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_flash_kernel_keeps_bf16(gpu):
    """bf16 in gives bf16 out, within the bf16 tolerance of the plain
    path (the prefill shape's widths, causal, GQA)."""
    g = torch.Generator(device=gpu).manual_seed(0)
    q = torch.randn((2, 96, 8, 128), generator=g, device=gpu).bfloat16()
    k = torch.randn((2, 96, 2, 128), generator=g, device=gpu).bfloat16()
    v = torch.randn((2, 96, 2, 128), generator=g, device=gpu).bfloat16()
    got = fa_ops.flash_attention_auto(q, k, v, kv_chunk=64)
    want = fa_ops.flash_attention_auto(q, k, v, impl="ref")
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                               atol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_on_the_card_runs_every_kernel(gpu, arch):
    """The smoke config served on the card: every kernel of the path
    launches as often as the path says (flash once per attention layer,
    global or local, encoder layer and cross-attention layer; decode
    attention once per global attention layer and cross-attention layer
    a step; the scores once a step), and the means stay within 1e-2 of
    the CPU run on the same weights and fed tokens."""
    model = Model(_port_cfg(arch))
    params = model.init(0, "cpu")
    kw = dict(batch=3, prompt_len=8, decode_steps=5, max_len=16, log=False)
    cpu = serve.run_serving(arch, device="cpu", params=params, **kw)
    from repro_torch.data.synthetic import lm_pool
    prompt, _ = lm_pool(3, 8, model.cfg.vocab, seed=0)
    cache = model.init_cache(3, 16, "cpu")
    cache, logits = model.prefill(params, _port_batch(
        prompt, _zero_frontend(model.cfg, 3, 8), torch.bfloat16), cache)
    _, fed = serve.serve_steps(model, params, cache, logits, 5)
    on_card = _to(params, gpu)
    for ops in (fa_ops, da_ops, unc_ops):
        ops.reset_launches()
    out = serve.run_serving(arch, device="cuda", params=on_card, tokens=fed,
                            **kw)
    torch.cuda.synchronize()
    specs = [spec for seg in transformer.build_segments(model.cfg)
             for _ in range(seg.count) for spec in seg.unit]
    attn = sum(spec.mixer in ("attn", "attn_local") for spec in specs)
    glob = sum(spec.mixer == "attn" for spec in specs)
    cross = sum(spec.cross_attn for spec in specs)
    enc = model.cfg.n_enc_layers if model.cfg.enc_dec else 0
    assert fa_ops.LAUNCHES["flash_attention"] == attn + enc + cross
    assert da_ops.LAUNCHES["decode_attention"] == (glob + cross) * 5
    assert unc_ops.LAUNCHES["uncertainty_stats"] == 5
    assert out["final_len"] == cpu["final_len"] == 13
    for key in ("mean_lc", "mean_es"):
        assert abs(out[key] - cpu[key]) <= 1e-2, key


def _to(tree, dev):
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, list):
        return [_to(t, dev) for t in tree]
    return {k: _to(v, dev) for k, v in tree.items()}
