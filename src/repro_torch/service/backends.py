"""Scorer backends for the AL service (port of repro/service/backends.py).

A backend = frozen feature extractor + trainable linear head (the paper's
'fine-tune ResNet-18's last layer' protocol), exposing exactly the
artifacts the strategy zoo needs: probs + embeddings. Numpy arrays cross
the backend's boundary; inside, tensors live on the backend's ``device``
("cuda" unless the caller asks for "cpu").

Every backend obeys the reference's batch-insensitivity contract:
``preprocess`` makes per-sample decisions only and ``features`` is
row-local, so a sample's feature bytes do not depend on its batchmates.
On the GPU that needs cuDNN's deterministic algorithms with autotuning
off, and fp32 without TF32 (``strict_fp32``). TransformerBackend extends
the contract to the sequence axis: its features are bit-identical at any
block size (models/blockwise.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blockwise as blockwise_lib
from repro_torch.models import resnet as resnet_lib


def strict_fp32() -> None:
    """Full fp32 matmuls and convolutions, deterministic cuDNN: TF32 would
    keep about three decimal digits and make results drift from the
    reference, and autotuned algorithms could change a row's floats."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


# rows per head-forward chunk (FeatureBackend.probs)
PROBS_ROWS = 1024


@dataclasses.dataclass
class HeadState:
    w: torch.Tensor      # (feat_dim, num_classes)
    b: torch.Tensor      # (num_classes,)


class FeatureBackend:
    """Shared logic: fit/eval a softmax head on frozen features."""

    num_classes: int
    feat_dim: int
    device: torch.device
    # the head every fit starts from; None = draw it (``init_head``). The
    # weight bridge sets it so a fit starts where the reference's does
    initial_head: Optional[HeadState] = None

    def preprocess(self, raw: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _tensor(self, a) -> torch.Tensor:
        """An fp32 copy of ``a`` on the backend's device."""
        return torch.tensor(np.asarray(a, np.float32), device=self.device)

    def features(self, batch: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    # -- head -------------------------------------------------------------
    def init_head(self) -> HeadState:
        if self.initial_head is not None:
            return self.initial_head
        g = torch.Generator().manual_seed(0)
        w = torch.randn((self.feat_dim, self.num_classes), generator=g) * 0.01
        return HeadState(w=w.to(self.device),
                         b=torch.zeros((self.num_classes,),
                                       device=self.device))

    def fit_head(self, feats: np.ndarray, labels: np.ndarray,
                 steps: int = 200, lr: float = 0.5,
                 head: Optional[HeadState] = None) -> HeadState:
        """Full-batch gradient descent on mean NLL + 1e-4 * sum(w²) (no
        decay on b)."""
        x = self._tensor(feats)
        y = torch.tensor(np.asarray(labels, np.int64), device=self.device)
        if head is None:
            head = self.init_head()
        w = head.w.detach().clone().requires_grad_(True)
        b = head.b.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            for _ in range(steps):
                lp = torch.log_softmax(x @ w + b, dim=-1)
                nll = -torch.mean(torch.gather(lp, 1, y[:, None]))
                loss = nll + 1e-4 * torch.sum(w ** 2)
                gw, gb = torch.autograd.grad(loss, (w, b))
                with torch.no_grad():
                    w -= lr * gw
                    b -= lr * gb
        return HeadState(w=w.detach(), b=b.detach())

    def probs(self, feats: np.ndarray, head: HeadState) -> np.ndarray:
        """Class probabilities, computed in canonical chunks of
        ``PROBS_ROWS`` rows (the last one zero-padded): every call runs the
        one (PROBS_ROWS, d) x (d, C) product, so a row's probabilities do
        not depend on how many rows share the call (a shard, a delta, the
        whole pool) even where the product's kernel would change with M."""
        x = self._tensor(feats)
        n = x.shape[0]
        out = []
        for s in range(0, n, PROBS_ROWS):
            chunk = x[s:s + PROBS_ROWS]
            m = chunk.shape[0]
            if m < PROBS_ROWS:
                chunk = torch.cat([chunk, chunk.new_zeros(
                    (PROBS_ROWS - m, x.shape[1]))])
            out.append(torch.softmax(chunk @ head.w + head.b, dim=-1)[:m])
        if not out:
            return np.zeros((0, self.num_classes), np.float32)
        return torch.cat(out).cpu().numpy()

    def evaluate(self, feats: np.ndarray, labels: np.ndarray,
                 head: HeadState) -> float:
        p = self.probs(feats, head)
        return float(np.mean(p.argmax(-1) == np.asarray(labels)))


class ResNetBackend(FeatureBackend):
    """Paper-faithful image scorer (resnet-18 or the tiny CPU variant)."""

    def __init__(self, cfg: Optional[resnet_lib.ResNetConfig] = None,
                 num_classes: int = 10, device="cuda"):
        self.device = torch.device(device)
        strict_fp32()
        self.cfg = cfg or resnet_lib.tiny_config(num_classes)
        self.num_classes = self.cfg.num_classes
        self.feat_dim = self.cfg.widths[-1]
        self.model = resnet_lib.ResNet(self.cfg, self.device)

    def preprocess(self, raw: np.ndarray) -> np.ndarray:
        x = np.asarray(raw, np.float32)
        # uint8-range detection is PER SAMPLE: a whole-batch x.max() would
        # rescale a [0,1] sample differently depending on its batchmates
        axes = tuple(range(1, x.ndim))
        mx = x.max(axis=axes, keepdims=True) if axes else x
        return np.where(mx > 1.5, x / 255.0, x)

    def features(self, batch: np.ndarray) -> np.ndarray:
        return self.model(self._tensor(batch)).cpu().numpy()


class MLPBackend(FeatureBackend):
    """Cheap random-projection feature backend for tests/property checks."""

    def __init__(self, in_dim: int, feat_dim: int = 64, num_classes: int = 10,
                 device="cuda"):
        self.device = torch.device(device)
        strict_fp32()
        g = torch.Generator().manual_seed(7)
        self.in_dim = in_dim
        self.w1 = (torch.randn((in_dim, 128), generator=g)
                   / math.sqrt(in_dim)).to(self.device)
        self.w2 = (torch.randn((128, feat_dim), generator=g)
                   / math.sqrt(128)).to(self.device)
        self.num_classes = num_classes
        self.feat_dim = feat_dim

    def preprocess(self, raw: np.ndarray) -> np.ndarray:
        x = np.asarray(raw, np.float32)
        if x.ndim < 2:
            raise ValueError(
                f"MLPBackend.preprocess expects a batch of samples "
                f"(N, features...); got shape {x.shape} — a 1-D payload "
                f"has no batch axis to flatten over")
        x = x.reshape(x.shape[0], -1)
        if x.shape[1] != self.in_dim:
            raise ValueError(
                f"MLPBackend.preprocess: sample flattens to {x.shape[1]} "
                f"features, backend was built with in_dim={self.in_dim}")
        return x

    def features(self, batch: np.ndarray) -> np.ndarray:
        x = self._tensor(batch)
        return torch.tanh(torch.tanh(x @ self.w1) @ self.w2).cpu().numpy()


class TransformerBackend(FeatureBackend):
    """Text/audio scorer: frozen blockwise-chunked transformer encoder.

    The forward (models/blockwise.py) runs attention block by block over
    the query axis (the flash-attention kernel on the card, the chunked
    online softmax on the CPU) and is bitwise-invisible in the block size.

    ``modality="text"``: raw items are int token rows, -1 = right-padding;
    ``modality="audio"``: raw items are (frames, input_dim) float frames.
    ``preprocess`` pads/truncates every sample to ``seq_len`` per sample
    (no cross-sample statistics). ``kv_chunk`` is clamped to ``seq_len``
    so the online-softmax KV grid never varies with block padding.
    ``attention_impl`` "pallas" (the configs' name) is the CUDA kernel on
    the card and the chunked path on the CPU; "chunked" and "naive" are
    the plain paths. Weights are drawn from ``seed``; the reference's come
    over through ``bridge.load_encoder``.
    """

    def __init__(self, cfg: Optional[ArchConfig] = None, seed: int = 11,
                 num_classes: int = 10, block_size: int = 64,
                 seq_len: int = 128, pooling: str = "mean",
                 modality: str = "text", input_dim: int = 0,
                 kv_chunk: int = 128, attention_impl: Optional[str] = None,
                 device="cuda"):
        if modality not in ("text", "audio"):
            raise ValueError(f"unknown modality {modality!r}")
        if pooling not in ("mean", "last"):
            raise ValueError(f"unknown pooling {pooling!r}")
        if modality == "audio" and not input_dim:
            raise ValueError("audio modality needs input_dim (frame features)")
        self.device = torch.device(device)
        strict_fp32()
        self.cfg = cfg or blockwise_lib.tiny_encoder_config()
        self.num_classes = num_classes
        self.feat_dim = self.cfg.d_model
        self.block_size = max(1, int(block_size))
        self.seq_len = max(1, int(seq_len))
        self.pooling = pooling
        self.modality = modality
        self.input_dim = int(input_dim)
        self.kv_chunk = max(1, min(int(kv_chunk), self.seq_len))
        self.impl = attention_impl or self.cfg.attention_impl
        self.encoder = blockwise_lib.BlockwiseEncoder(
            self.cfg, seed, self.input_dim if modality == "audio" else None,
            self.device)

    def preprocess(self, raw: np.ndarray) -> np.ndarray:
        x = np.asarray(raw)
        if self.modality == "text":
            if x.ndim != 2:
                raise ValueError(
                    f"text preprocess expects (N, tokens) int rows; got "
                    f"shape {x.shape}")
            if not np.issubdtype(x.dtype, np.integer):
                raise ValueError(
                    f"text preprocess expects integer tokens; got {x.dtype}")
            if x.size and int(x.max()) >= self.cfg.vocab:
                raise ValueError(
                    f"token id {int(x.max())} out of range for vocab "
                    f"{self.cfg.vocab}")
            out = np.full((x.shape[0], self.seq_len), -1, np.int32)
            L = min(x.shape[1], self.seq_len)
            out[:, :L] = x[:, :L]
            return out
        if x.ndim != 3 or x.shape[-1] != self.input_dim:
            raise ValueError(
                f"audio preprocess expects (N, frames, {self.input_dim}) "
                f"float frames; got shape {x.shape}")
        out = np.zeros((x.shape[0], self.seq_len, self.input_dim), np.float32)
        L = min(x.shape[1], self.seq_len)
        out[:, :L] = x[:, :L]
        return out

    def features(self, batch: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(batch), device=self.device)
        return self.encoder(x, block=self.block_size, kv_chunk=self.kv_chunk,
                            impl=self.impl, pooling=self.pooling).cpu().numpy()

    def activation_accounting(self, batch: int,
                              seq_len: Optional[int] = None) -> dict:
        return blockwise_lib.activation_accounting(
            self.cfg, batch, seq_len or self.seq_len, self.block_size,
            self.kv_chunk)


BACKENDS = {
    "resnet18": lambda **kw: ResNetBackend(resnet_lib.resnet18_config(), **kw),
    "synthetic_cnn": lambda **kw: ResNetBackend(**kw),
    "transformer": lambda **kw: TransformerBackend(**kw),
}


def make_backend(name: str, config=None, **kw) -> FeatureBackend:
    """Build a registered backend on ``config.device`` (or ``device=``);
    ``config`` (ALServiceConfig) also supplies the transformer knobs
    (block/seq-len/pooling/modality/input_dim)."""
    if name not in BACKENDS:
        raise KeyError(f"unknown backend {name!r}")
    if config is not None:
        kw.setdefault("device", config.device.lower())
        if name == "transformer":
            kw.setdefault("block_size", config.model_block_size)
            kw.setdefault("seq_len", config.model_seq_len)
            kw.setdefault("pooling", config.model_pooling)
            kw.setdefault("modality", config.model_modality)
            kw.setdefault("input_dim", config.model_input_dim)
    return BACKENDS[name](**kw)
