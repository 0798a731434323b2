"""Port parity: the ResNet feature extractor and the softmax head.

The reference's weights reach the port through ``repro_torch.bridge``;
inputs come from numpy seeds. Features agree with the reference at
rtol/atol 1e-5 (convolution sums are taken in another order). The head
fit (200 full-batch steps) agrees at atol 1e-5 on weights and probs, and
``evaluate`` gives the same accuracy.

The chunk-invariance twin holds within the port only: a sample's features
are bitwise equal whether it is embedded alone or among others.
"""
import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.models import resnet
from repro_torch.service import backends
from repro_torch.service.config import ALServiceConfig
from repro_torch.service.server import ALServer

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def jax_ref():
    pytest.importorskip("jax")
    import jax
    from repro.models import resnet as ref_resnet
    from repro.service import backends as ref_backends
    return jax, ref_resnet, ref_backends


def _np_tree(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def _images(seed, n, hw, c=3):
    return np.random.default_rng(seed).uniform(
        0, 1, size=(n, hw, hw, c)).astype(np.float32)


@pytest.mark.parametrize("name,hw", [("synthetic_cnn", 8),
                                     ("synthetic_cnn", 7),
                                     ("resnet18", 32)])
def test_features_match_reference(jax_ref, name, hw):
    jax, ref_resnet, _ = jax_ref
    cfg = (ref_resnet.resnet18_config() if name == "resnet18"
           else ref_resnet.tiny_config())
    params = ref_resnet.init_resnet(cfg, jax.random.PRNGKey(42))
    x = _images(1, 2, hw)
    want = np.asarray(ref_resnet.resnet_features(params, cfg, x))
    port_cfg = (resnet.resnet18_config() if name == "resnet18"
                else resnet.tiny_config())
    model = resnet.ResNet(port_cfg)
    bridge.load_resnet(model, _np_tree(params))
    got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, port_cfg.widths[-1])
    np.testing.assert_allclose(got, want, **TOL)


def test_same_padding_matches_xla():
    """XLA SAME at stride 2 pads bottom/right only; at stride 1 evenly."""
    assert resnet._same_pad(8, 3, 2) == (0, 1)
    assert resnet._same_pad(7, 3, 2) == (1, 1)
    assert resnet._same_pad(8, 3, 1) == (1, 1)
    assert resnet._same_pad(8, 1, 2) == (0, 0)


def test_head_fit_probs_evaluate_match_reference(jax_ref):
    jax, _, ref_backends = jax_ref
    ref_be = ref_backends.ResNetBackend()
    port_be = backends.ResNetBackend(device="cpu")
    bridge.load_resnet(port_be.model, _np_tree(ref_be.params))
    h0 = ref_be.init_head()
    bridge.set_initial_head(port_be, np.asarray(h0.w), np.asarray(h0.b))
    raw = (_images(2, 60, 8) * 255).astype(np.uint8)
    x = ref_be.preprocess(raw)
    np.testing.assert_array_equal(port_be.preprocess(raw), x)
    feats = ref_be.features(x)
    np.testing.assert_allclose(port_be.features(x), feats, **TOL)
    labels = np.arange(60) % 10
    ref_head = ref_be.fit_head(feats, labels)
    port_head = port_be.fit_head(feats, labels)
    np.testing.assert_allclose(port_head.w.numpy(), np.asarray(ref_head.w),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(port_head.b.numpy(), np.asarray(ref_head.b),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(port_be.probs(feats, port_head),
                               ref_be.probs(feats, ref_head), rtol=0,
                               atol=1e-5)
    assert port_be.evaluate(feats, labels, port_head) == \
        ref_be.evaluate(feats, labels, ref_head)


def test_mlp_backend_matches_reference(jax_ref):
    _, _, ref_backends = jax_ref
    ref_be = ref_backends.MLPBackend(in_dim=12, feat_dim=8)
    port_be = backends.MLPBackend(in_dim=12, feat_dim=8, device="cpu")
    bridge.load_mlp(port_be, np.asarray(ref_be.w1), np.asarray(ref_be.w2))
    x = np.random.default_rng(3).normal(size=(20, 3, 4)).astype(np.float32)
    np.testing.assert_allclose(
        port_be.features(port_be.preprocess(x)),
        ref_be.features(ref_be.preprocess(x)), **TOL)


def test_bridged_trained_head_gives_reference_probs(jax_ref):
    _, _, ref_backends = jax_ref
    ref_be = ref_backends.MLPBackend(in_dim=6, feat_dim=8)
    feats = np.random.default_rng(4).normal(size=(30, 8)).astype(np.float32)
    head = ref_be.fit_head(feats, np.arange(30) % 10, steps=20)
    port_be = backends.MLPBackend(in_dim=6, feat_dim=8, device="cpu")
    np.testing.assert_allclose(
        port_be.probs(feats, bridge.head_state(np.asarray(head.w),
                                               np.asarray(head.b))),
        ref_be.probs(feats, head), rtol=0, atol=1e-6)


def test_chunk_invariance_within_port():
    """One sample embedded alone (in the canonical zero-padded batch) or
    inside a full batch: bitwise-equal features."""
    be = backends.ResNetBackend(device="cpu")
    x = be.preprocess(_images(5, 8, 8))
    full = be.features(x)
    for i in range(0, 8, 3):
        padded = np.concatenate([x[i:i + 1], np.zeros((7,) + x.shape[1:],
                                                      x.dtype)])
        assert np.array_equal(be.features(padded)[0], full[i]), i


def test_push_alone_or_in_batch_gives_same_feature_bytes():
    raw = list((_images(6, 20, 8) * 255).astype(np.uint8))
    cfg = ALServiceConfig(device="cpu", batch_size=8)
    batch, alone = ALServer(cfg), ALServer(cfg)
    keys = batch.push_data(raw)
    for i in (0, 7, 19):
        (k,) = alone.push_data([raw[i]])
        assert k == keys[i]
        assert np.array_equal(alone.cache.get(k), batch.cache.get(k))


def test_default_init_is_seeded():
    a, b = resnet.ResNet(resnet.tiny_config()), resnet.ResNet(
        resnet.tiny_config())
    assert torch.equal(a.stem, b.stem)
    assert a.stem.shape == (16, 3, 3, 3)
    std = float(a.blocks[1].conv1.std())
    assert abs(std - 1 / np.sqrt(9 * 16)) < 0.02


def test_transformer_backend_builds():
    """The registry's transformer entry, a NotImplementedError until
    ROADMAP A8 landed, now builds the port's TransformerBackend."""
    be = backends.make_backend("transformer", device="cpu", seq_len=16,
                               block_size=4)
    assert isinstance(be, backends.TransformerBackend)
    assert (be.device.type, be.seq_len, be.block_size) == ("cpu", 16, 4)
