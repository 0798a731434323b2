"""The traffic generator: every traffic file names its ``kind``, and the
one kind so far is ``score_sweep``, an offline sweep that scores a pool of
documents in fixed batches, closed loop.

A batch is ``batch`` documents of ``prompt_len`` tokens, each followed by
a candidate answer of ``scored_steps`` tokens that the serving driver is
fed (teacher forcing: the way an active-learning user scores a candidate
label). Documents are token walks over per-domain tables, the structure of
the port's ``data/synthetic.py`` ``lm_pool`` (copied here and frozen,
vectorised): each document draws a domain, and each position draws a
table slot, or, with probability ``drift``, any token of the vocabulary.

The sizes and the number of batches never depend on the seed; the seed
picks the tokens alone. Batch ``i`` of a run is drawn from ``(seed, 1, i)``
and the domain tables from ``(seed, 0)``, so a batch is the same whatever
came before it. The warm-up's batch comes from ``(seed, 3, 0)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

KINDS = ("score_sweep",)


def seed_entropy(seed: int) -> int:
    """A run's seed as numpy's seed sequences take it (non-negative)."""
    return int(seed) % 2 ** 64


@dataclasses.dataclass(frozen=True)
class ScoreSweep:
    batch: int
    prompt_len: int
    scored_steps: int
    trace_batches: int
    n_domains: int
    table: int
    drift: float

    @classmethod
    def from_file(cls, spec: dict) -> "ScoreSweep":
        if spec.get("kind") not in KINDS:
            raise ValueError(f"unknown traffic kind {spec.get('kind')!r}; "
                             f"known: {KINDS}")
        if spec.get("in_flight", 1) != 1:
            raise ValueError("a score_sweep keeps one batch in flight")
        pool = spec.get("pool", {})
        return cls(batch=int(spec["batch"]),
                   prompt_len=int(spec["prompt_len"]),
                   scored_steps=int(spec["scored_steps"]),
                   trace_batches=int(spec.get("trace_batches", 2)),
                   n_domains=int(pool.get("n_domains", 8)),
                   table=int(pool.get("table", 64)),
                   drift=float(pool.get("drift", 0.15)))

    @property
    def positions(self) -> int:
        """Positions a document fills: prompt and candidate answer."""
        return self.prompt_len + self.scored_steps

    @property
    def tokens_per_batch(self) -> int:
        """Prompt and scored tokens of one batch."""
        return self.batch * self.positions


class Documents:
    """The documents of one run over a vocabulary of ``vocab`` tokens."""

    def __init__(self, traffic: ScoreSweep, vocab: int, seed: int):
        self.t = traffic
        self.vocab = int(vocab)
        self.seed = seed_entropy(seed)
        rng = np.random.default_rng([self.seed, 0])
        self.tables = rng.integers(0, self.vocab,
                                   (traffic.n_domains, traffic.table))

    def batch(self, i: int, stream: int = 1) -> np.ndarray:
        """(batch, prompt_len + scored_steps) int32 tokens of batch ``i``;
        the last ``scored_steps`` columns are the candidate answers.
        ``stream`` 1 is the window's, 3 the warm-up's."""
        t = self.t
        rng = np.random.default_rng([self.seed, stream, int(i)])
        shape = (t.batch, t.positions)
        dom = rng.integers(0, t.n_domains, t.batch)
        walk = rng.integers(0, t.table, shape)
        drift = rng.integers(0, self.vocab, shape)
        mix = rng.random(shape) < t.drift
        toks = np.where(mix, drift, self.tables[dom[:, None], walk])
        return toks.astype(np.int32)

    @staticmethod
    def split(tokens: np.ndarray, scored_steps: int):
        """(prompts (B, S), fed tokens (scored_steps, B)) of a batch."""
        return tokens[:, :-scored_steps], tokens[:, -scored_steps:].T.copy()
