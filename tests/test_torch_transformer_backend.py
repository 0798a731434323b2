"""The port's TransformerBackend: parity with repro's, and the reference's
own contracts run inside the port.

Parity: the reference's ``init_encoder`` weights come over through
``bridge.load_encoder``; the same numpy inputs then give features within
atol 1e-5 of the reference's, for text and audio, mean and last pooling,
``tiny_encoder_config`` and ``qwen3_8b.smoke_config()`` (qk_norm, rope
θ 1e6). Features are O(1) and the packages sum in other orders, which
moves them by about 1e-6.

Contracts, inside the port and bit for bit: the block size is invisible
in the feature bytes; a sample's features do not depend on its batchmates;
right padding is invisible. ``activation_accounting`` gives the
reference's numbers.

Servers: a repro and a repro_torch server, fed the same text pushes over
TCP with the reference's weights and draws, select equal keys for
coreset, kcg, dbal and lc under the separation gate of
tests/test_torch_server.py.
"""
import dataclasses
import pathlib

import numpy as np
import pytest

from repro_torch import bridge, configs
from repro_torch.configs import qwen3_8b
from repro_torch.data.synthetic import audio_pool, text_pool
from repro_torch.models import blockwise
from repro_torch.service.backends import TransformerBackend, make_backend
from repro_torch.service.client import ALClient, serve_tcp
from repro_torch.service.config import ALServiceConfig
from repro_torch.service.server import ALServer

SEQ = 48
ATOL = 1e-5
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _backend(block=16, **kw):
    kw.setdefault("seq_len", SEQ)
    kw.setdefault("kv_chunk", 16)
    kw.setdefault("device", "cpu")
    return TransformerBackend(block_size=block, **kw)


def _inputs(modality, n=10, seed=0, vocab=512):
    if modality == "text":
        return text_pool(n, num_classes=4, seq_len=SEQ, vocab=vocab,
                         seed=seed)[0], {}
    return audio_pool(n, num_classes=4, n_frames=SEQ, n_mels=8,
                      seed=seed)[0], {"modality": "audio", "input_dim": 8}


# ----------------------------------------------------- parity with repro --
@pytest.mark.parametrize("pooling", ["mean", "last"])
@pytest.mark.parametrize("modality", ["text", "audio"])
@pytest.mark.parametrize("arch", ["tiny", "qwen3_smoke"])
def test_features_match_reference(arch, modality, pooling):
    jax = pytest.importorskip("jax")
    from repro.configs import qwen3_8b as ref_qwen3
    from repro.service.backends import TransformerBackend as RefBackend
    cfgs = {"tiny": (None, None),
            "qwen3_smoke": (ref_qwen3.smoke_config(),
                            qwen3_8b.smoke_config())}[arch]
    vocab = 256 if arch == "qwen3_smoke" else 512
    raw, kw = _inputs(modality, vocab=vocab)
    kw.update(seq_len=SEQ, kv_chunk=16, block_size=16, pooling=pooling)
    ref = RefBackend(cfg=cfgs[0], **kw)
    port = TransformerBackend(cfg=cfgs[1], device="cpu", **kw)
    bridge.load_encoder(port, jax.tree.map(np.asarray, ref.params))
    want = ref.features(ref.preprocess(raw))
    got = port.features(port.preprocess(raw))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("arch", ["tiny", "qwen3_smoke"])
@pytest.mark.parametrize("S,block,kv", [(512, 128, 128), (2048, 64, 256),
                                        (37, 5, 16)])
def test_activation_accounting_matches_reference(arch, S, block, kv):
    pytest.importorskip("jax")
    from repro.configs import qwen3_8b as ref_qwen3
    from repro.models import blockwise as ref_blockwise
    ref_cfg, cfg = {"tiny": (ref_blockwise.tiny_encoder_config(),
                             blockwise.tiny_encoder_config()),
                    "qwen3_smoke": (ref_qwen3.smoke_config(),
                                    qwen3_8b.smoke_config())}[arch]
    assert blockwise.activation_accounting(cfg, 16, S, block, kv) == \
        ref_blockwise.activation_accounting(ref_cfg, 16, S, block, kv)


def test_bridge_rejects_a_tree_of_another_shape():
    jax = pytest.importorskip("jax")
    from repro.service.backends import TransformerBackend as RefBackend
    ref = jax.tree.map(np.asarray, RefBackend(seq_len=8).params)
    port = _backend(seq_len=8)
    bad = dict(ref, final_norm={"scale": np.ones(7, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        bridge.load_encoder(port, bad)
    audio = TransformerBackend(modality="audio", input_dim=4, seq_len=8,
                               device="cpu")
    with pytest.raises(ValueError, match="keys"):
        bridge.load_encoder(audio, ref)


# ------------------------------------------- the reference's contracts --
@pytest.mark.parametrize("modality", ["text", "audio"])
def test_block_size_bitwise_invisible(modality):
    """blocks {5 (non-dividing), 16, 48 (=S), 64 (>S, unchunked)} produce
    the same feature bytes."""
    raw, kw = _inputs(modality)
    feats = {}
    for block in (5, 16, SEQ, 64):
        be = _backend(block, **kw)
        feats[block] = be.features(be.preprocess(raw))
    first = feats[5]
    assert first.dtype == np.float32 and first.shape == (10, be.feat_dim)
    for block, f in feats.items():
        assert np.array_equal(first, f), f"block={block} changed bytes"


def test_block_size_bitwise_invisible_with_qk_norm():
    raw, _ = _inputs("text", vocab=256)
    cfg = qwen3_8b.smoke_config()
    feats = [_backend(b, cfg=cfg).features(
        _backend(b, cfg=cfg).preprocess(raw)) for b in (5, 16, 64)]
    assert all(np.array_equal(feats[0], f) for f in feats[1:])


def test_batch_composition_row_local():
    """A sample's feature bytes survive any batchmates under the canonical
    batch padding (zero rows)."""
    raw, _ = text_pool(8, num_classes=4, seq_len=SEQ, vocab=512, seed=1)
    be = _backend(16)
    x = be.preprocess(raw)
    together = be.features(x[:4])
    alone = be.features(
        np.concatenate([x[:1], np.zeros((3,) + x.shape[1:], x.dtype)]))
    assert np.array_equal(together[0], alone[0])


def test_right_padding_invisible():
    raw, _ = text_pool(6, num_classes=3, seq_len=30, vocab=512, seed=2)
    padded = np.full((6, SEQ), -1, np.int32)
    padded[:, :30] = raw
    be = _backend(16)
    assert np.array_equal(be.features(be.preprocess(raw)),
                          be.features(be.preprocess(padded)))


def test_pooling_knobs():
    raw, _ = text_pool(6, num_classes=3, seq_len=SEQ, vocab=512, seed=3)
    mean, last = _backend(16, pooling="mean"), _backend(16, pooling="last")
    fm = mean.features(mean.preprocess(raw))
    fl = last.features(last.preprocess(raw))
    assert fm.shape == fl.shape and not np.array_equal(fm, fl)
    with pytest.raises(ValueError, match="pooling"):
        TransformerBackend(pooling="max", device="cpu")
    with pytest.raises(ValueError, match="modality"):
        TransformerBackend(modality="video", device="cpu")
    with pytest.raises(ValueError, match="input_dim"):
        TransformerBackend(modality="audio", device="cpu")


def test_preprocess_validation():
    be = _backend(16)
    with pytest.raises(ValueError, match="int"):
        be.preprocess(np.zeros((4, 10), np.float32))
    with pytest.raises(ValueError, match="out of range"):
        be.preprocess(np.full((2, 4), 2_000_000, np.int64))
    with pytest.raises(ValueError, match="tokens"):
        be.preprocess(np.zeros((4,), np.int32))
    aud = TransformerBackend(modality="audio", input_dim=8, seq_len=32,
                             device="cpu")
    with pytest.raises(ValueError, match="frames"):
        aud.preprocess(np.zeros((4, 32, 5), np.float32))
    assert be.kv_chunk == 16 and _backend(kv_chunk=4096).kv_chunk == SEQ


def test_activation_accounting_flat_in_seq_len():
    cfg = blockwise.tiny_encoder_config()
    accts = {S: blockwise.activation_accounting(cfg, 16, S, 128, 128)
             for S in (512, 2048, 8192)}
    peaks = [a["peak_activation_bytes"] for a in accts.values()]
    assert len(set(peaks)) == 1, peaks
    unchunked = [a["unchunked_peak_bytes"] for a in accts.values()]
    assert unchunked[-1] > unchunked[0] * 100
    assert accts[8192]["state_bytes"] > accts[512]["state_bytes"]
    assert _backend(16).activation_accounting(4) == \
        blockwise.activation_accounting(blockwise.tiny_encoder_config(), 4,
                                        SEQ, 16, 16)


def test_init_recipe_is_seeded_bf16_and_scaled():
    a, b = _backend(seed=5), _backend(seed=5)
    pa, pb = a.encoder.params, b.encoder.params
    w_q = pa["layers"][0]["mixer"]["w_q"]
    assert np.array_equal(w_q.numpy(), pb["layers"][0]["mixer"]["w_q"].numpy())
    assert not np.array_equal(w_q.numpy(), _backend(seed=6).encoder.params[
        "layers"][0]["mixer"]["w_q"].numpy())
    assert np.array_equal(w_q.numpy(), w_q.bfloat16().float().numpy())
    assert abs(float(w_q.std()) - 1 / np.sqrt(32)) < 0.02
    assert abs(float(pa["embed"].std()) - 0.02) < 0.002
    assert float(pa["final_norm"]["scale"].min()) == 1.0
    assert not any(p.requires_grad for p in a.encoder.parameters())
    # embed, final norm, and per layer two norms, w_q/k/v/o, w_in/gate/out
    assert len(list(a.encoder.parameters())) == 1 + 1 + 2 * 9


# ------------------------------------------------------- configs / yaml --
def test_committed_config_examples_build_backends():
    """The worked configs/ examples load in the port: audio builds its
    backend; text asks for replicas 3, which the port serves as written:
    a few sequences pushed, a kcg query over its three shards."""
    audio = ALServiceConfig.from_yaml(str(ROOT / "configs" / "audio_al.yml"))
    be = make_backend(audio.model_name, config=audio)
    assert isinstance(be, TransformerBackend)
    assert (be.modality, be.input_dim, be.pooling, be.device.type) == \
        ("audio", 16, "last", "cpu")
    text = ALServiceConfig.from_yaml(str(ROOT / "configs" / "text_al.yml"))
    assert (text.model_name, text.model_modality, text.replicas) == \
        ("transformer", "text", 3)
    srv = ALServer(text)
    try:
        from repro_torch.data.synthetic import text_pool
        toks, _ = text_pool(12, seq_len=text.model_seq_len, seed=2)
        srv.push_data(list(toks))
        assert len(set(srv.query(budget=3, strategy="kcg")["keys"])) == 3
        st = srv.stats()
        assert st["replicas"] == 3 and st["workers"]["lanes"] == 3
    finally:
        srv.close()


def test_arch_registry():
    """The port's registry holds the reference's configs, at the
    reference's widths, and refuses a name it does not list."""
    pytest.importorskip("jax")
    from repro.configs import qwen3_8b as ref_qwen3
    cfg = configs.get_config("qwen3_8b")
    assert cfg is qwen3_8b.CONFIG
    for field in dataclasses.fields(cfg):
        assert getattr(cfg, field.name) == getattr(ref_qwen3.CONFIG,
                                                   field.name), field.name
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("llama3_8b")


def test_make_backend_registry():
    cfg = ALServiceConfig(device="cpu", model_name="transformer",
                          model_block_size=4, model_seq_len=16,
                          model_pooling="last")
    be = make_backend("transformer", config=cfg)
    assert (be.block_size, be.seq_len, be.pooling, be.device.type) == \
        (4, 16, "last", "cpu")
    with pytest.raises(KeyError):
        make_backend("transformer9000")


def test_text_al_over_tcp_from_yaml():
    yml = """
name: TEXT_AL
active_learning:
  strategy:
    type: lc
  model:
    name: transformer
    batch_size: 8
    block_size: 16
    seq_len: 48
  device: CPU
al_worker:
  replicas: 1
"""
    srv = ALServer(ALServiceConfig.from_yaml(yml))
    assert isinstance(srv.backend, TransformerBackend)
    toks, y = text_pool(30, num_classes=3, seq_len=SEQ, vocab=512, seed=7)
    rpc = serve_tcp(srv, "127.0.0.1", 0)
    cli = ALClient(url=f"127.0.0.1:{rpc.port}")
    try:
        keys = cli.push_data(list(toks))
        cli.label(keys[:6], [int(v) for v in y[:6]])
        assert 0.0 <= cli.train_eval() <= 1.0
        for s in ("lc", "kcg", "dbal", "coreset"):
            assert len(set(cli.query(budget=5, strategy=s)["keys"])) == 5
    finally:
        cli.close()
        rpc.stop()
    assert srv.embed_rows == 30


# ------------------------------------------ repro vs repro_torch servers --
YML = """
name: "TEXT_AL"
active_learning:
  strategy:
    type: "lc"
  model:
    name: "transformer"
    batch_size: 16
    block_size: 16
    seq_len: 48
  device: CPU
al_worker:
  protocol: "tcp"
  host: "127.0.0.1"
  port: 0
  replicas: 1
"""
POOL, BUDGET = 160, 8


@pytest.fixture(scope="module")
def servers():
    jax = pytest.importorskip("jax")
    import test_torch_server as sv
    from repro.service import client as ref_client
    from repro.service.config import ALServiceConfig as RefConfig
    from repro.service.server import ALServer as RefServer
    ref_srv = RefServer(RefConfig.from_yaml(YML))
    cfg = ALServiceConfig.from_yaml(YML)
    be = make_backend(cfg.model_name, config=cfg)
    bridge.load_encoder(be, jax.tree.map(np.asarray,
                                         ref_srv.backend.params))
    h0 = ref_srv.backend.init_head()
    bridge.set_initial_head(be, np.asarray(h0.w), np.asarray(h0.b))
    port_srv = ALServer(cfg, backend=be, draws=sv.JaxDraws())
    ref_rpc = ref_client.serve_tcp(ref_srv, "127.0.0.1", 0)
    port_rpc = serve_tcp(port_srv, "127.0.0.1", 0)
    ref_cli = ref_client.ALClient(url=f"127.0.0.1:{ref_rpc.port}")
    port_cli = ALClient(url=f"127.0.0.1:{port_rpc.port}")
    toks, ys = text_pool(POOL, num_classes=4, seq_len=SEQ, vocab=512,
                         seed=3)
    keys = ref_cli.push_data(list(toks))
    assert port_cli.push_data(list(toks)) == keys
    key2y = dict(zip(keys, (int(y) for y in ys)))
    ex, ey = text_pool(64, num_classes=4, seq_len=SEQ, vocab=512, seed=11)
    for srv in (ref_srv, port_srv):
        srv.attach_oracle(lambda ks: [key2y[k] for k in ks], ex, ey)
    seed_keys = keys[::8]
    for cli in (ref_cli, port_cli):
        cli.label(seed_keys, [key2y[k] for k in seed_keys])
    assert port_cli.train_eval() == ref_cli.train_eval()
    yield sv, ref_srv, port_srv, ref_cli, port_cli
    for c in (ref_cli, port_cli):
        c.close()
    ref_rpc.stop()
    port_rpc.stop()


@pytest.mark.parametrize("strategy", ["lc", "kcg", "dbal", "coreset"])
def test_servers_select_equal_keys(servers, strategy):
    sv, ref_srv, port_srv, ref_cli, port_cli = servers
    want = ref_cli.query(budget=BUDGET, strategy=strategy, rng_seed=1)
    ref_art, port_art = sv._artifacts(ref_srv), sv._artifacts(port_srv)
    if strategy == "lc":
        sv._assert_top_k_separated(sv._lc(ref_art[1]), sv._lc(port_art[1]),
                                   BUDGET)
    elif strategy == "dbal":     # its LC prefilter boundary
        sv._assert_top_k_separated(sv._lc(ref_art[1]), sv._lc(port_art[1]),
                                   10 * BUDGET)
    else:                        # coreset warm-starts from the labels
        sv._assert_greedy_separated(ref_art, port_art, want["indices"],
                                    strategy == "coreset")
    got = port_cli.query(budget=BUDGET, strategy=strategy, rng_seed=1)
    assert got["keys"] == want["keys"]
    assert got["strategy"] == strategy
