# Copied from repro/data/synthetic.py; imports renamed.
"""Synthetic datasets: LM token pools and CIFAR-like image pools.

Deterministic in seed; used by smoke tests, benchmarks, and examples (no
dataset downloads in this offline environment — documented in DESIGN.md).
The image pool plants a class-dependent localized activation so a frozen
random feature extractor + trained head genuinely separates classes, making
AL-strategy accuracy differences (paper Fig. 4a) measurable.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def lm_pool(n_seqs: int, seq_len: int, vocab: int, seed: int = 0,
            n_domains: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Token sequences from ``n_domains`` Markov-ish generators; returns
    (tokens (n, S) int32, domain_id (n,) int32). Domains give diversity
    structure for AL to find."""
    rng = np.random.default_rng(seed)
    dom = rng.integers(0, n_domains, n_seqs)
    base = rng.integers(0, vocab, (n_domains, 64))
    toks = np.empty((n_seqs, seq_len), np.int32)
    for i in range(n_seqs):
        table = base[dom[i]]
        walk = rng.integers(0, 64, seq_len)
        drift = rng.integers(0, vocab, seq_len)
        mix = rng.random(seq_len) < 0.15
        toks[i] = np.where(mix, drift, table[walk])
    return toks, dom.astype(np.int32)


def text_pool(n: int, num_classes: int = 10, seq_len: int = 64,
              vocab: int = 512, seed: int = 0
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(tokens (n, seq_len) i32 right-padded with -1, y (n,) i32).

    Variable-length sequences (half to full ``seq_len``) of uniform noise
    tokens with a class-specific 8-token motif planted on most 8-aligned
    spans — a frozen random transformer mean-pools those motifs into
    linearly separable features, the text analogue of ``image_pool``'s
    localized activations. Fixed-width rows (pad = -1) so pushed items
    share one shape per batch (the ingest pipeline stacks raw items)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, n)
    lengths = rng.integers(max(seq_len // 2, 1), seq_len + 1, n)
    motifs = rng.integers(0, vocab, (num_classes, 8))
    toks = np.full((n, seq_len), -1, np.int32)
    for i in range(n):
        L = int(lengths[i])
        t = rng.integers(0, vocab, L).astype(np.int32)
        for s in range(0, L - 8 + 1, 8):
            if rng.random() < 0.7:
                t[s:s + 8] = motifs[y[i]]
        toks[i, :L] = t
    return toks, y.astype(np.int32)


def audio_pool(n: int, num_classes: int = 10, n_frames: int = 64,
               n_mels: int = 16, seed: int = 0, noise: float = 0.3
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(x (n, n_frames, n_mels) f32, y (n,) i32) synthetic log-mel frames.

    Each class gets a fixed spectral band boost plus a slow tone in a
    second band — class-dependent signal a frozen random encoder + linear
    head genuinely separates."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, n)
    x = rng.normal(size=(n, n_frames, n_mels)).astype(np.float32) * noise
    t = np.arange(n_frames, dtype=np.float32)
    for c in range(num_classes):
        m = y == c
        band = c % n_mels
        x[m, :, band] += 1.5
        x[m, :, (band + 3) % n_mels] += 0.8 * np.sin(
            2.0 * np.pi * t * (c + 1) / n_frames)[None, :]
    return x, y.astype(np.int32)


def image_pool(n: int, num_classes: int = 10, hw: int = 8, seed: int = 0,
               noise: float = 0.15) -> Tuple[np.ndarray, np.ndarray]:
    """(x (n,hw,hw,3) f32, y (n,) i32) with class-dependent signal."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, n)
    x = rng.normal(size=(n, hw, hw, 3)).astype(np.float32) * noise
    for c in range(num_classes):
        m = y == c
        x[m, c % hw, (c * 3) % hw, c % 3] += 2.5
        x[m, (c * 2) % hw, c % hw, (c + 1) % 3] += 1.5
    return x, y.astype(np.int32)


def lm_batches(tokens: np.ndarray, batch: int, seed: int = 0,
               shard_index: int = 0, num_shards: int = 1
               ) -> Iterator[dict]:
    """Infinite shuffled batches of {tokens, labels} (labels = next token).

    Per-host sharding: each host sees a disjoint slice (the multi-host data
    pipeline contract; on CPU num_shards=1)."""
    n = tokens.shape[0]
    mine = np.arange(shard_index, n, num_shards)
    rng = np.random.default_rng(seed + shard_index)
    while True:
        order = rng.permutation(mine)
        for i in range(0, len(order) - batch + 1, batch):
            sel = order[i:i + batch]
            t = tokens[sel]
            yield {
                "tokens": t[:, :-1].astype(np.int32),
                "labels": t[:, 1:].astype(np.int32),
            }
