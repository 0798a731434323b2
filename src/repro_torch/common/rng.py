"""The draw seam: every random draw a strategy makes goes through here.

``repro`` draws from ``jax.random`` at fixed places in its strategies. The
port's strategies call this module at exactly those places, through a
small key API:

    k = key(seed)                    # a Key bound to a draw implementation
    k1, k2 = split(k, 2)
    randint(k1, 0, n) -> int         categorical(k, logits) -> int
    gumbel(k, n, device) -> (n,) f32 choice(k, n, size) -> (size,) int64
    permutation(k, n) -> (n,) int64

A ``Key`` carries the implementation that made it, so strategies never
name one. ``TorchDraws`` (the default) derives child seeds by hashing and
draws each value from a freshly seeded CPU ``torch.Generator``, then moves
it to the device asked for: the same seed gives the same draws on every
device. Any object with the same six methods can stand in for it (the
parity tests pass one that calls ``jax.random``, so both packages see
identical draws).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, List, Optional

import torch

_SEED_MASK = (1 << 63) - 1


class TorchDraws:
    """Default draw implementation: a key is a 63-bit integer seed."""

    def key(self, seed: int) -> int:
        return int(seed) & _SEED_MASK

    def split(self, key: int, n: int) -> List[int]:
        return [int.from_bytes(hashlib.blake2b(
            f"{key}/{i}".encode(), digest_size=8).digest(), "little")
            & _SEED_MASK for i in range(n)]

    @staticmethod
    def _gen(key: int) -> torch.Generator:
        return torch.Generator().manual_seed(key)

    def randint(self, key: int, low: int, high: int) -> int:
        return int(torch.randint(low, high, (), generator=self._gen(key)))

    def gumbel(self, key: int, n: int, device) -> torch.Tensor:
        u = torch.rand(n, generator=self._gen(key), dtype=torch.float32)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        return (-torch.log(-torch.log(u))).to(device)

    def categorical(self, key: int, logits: torch.Tensor) -> int:
        g = self.gumbel(key, logits.shape[0], logits.device)
        return int(torch.argmax(logits.float() + g))

    def choice(self, key: int, n: int, size: int) -> torch.Tensor:
        """``size`` distinct draws from ``range(n)`` (without replacement)."""
        return torch.randperm(n, generator=self._gen(key))[:size]

    def permutation(self, key: int, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=self._gen(key))


DEFAULT_DRAWS = TorchDraws()


@dataclasses.dataclass(frozen=True)
class Key:
    draws: Any          # the implementation that made ``data``
    data: Any           # that implementation's own key value


def key(seed: int, draws: Optional[Any] = None) -> Key:
    draws = DEFAULT_DRAWS if draws is None else draws
    return Key(draws, draws.key(seed))


def split(k: Key, n: int) -> List[Key]:
    return [Key(k.draws, d) for d in k.draws.split(k.data, n)]


def randint(k: Key, low: int, high: int) -> int:
    return int(k.draws.randint(k.data, low, high))


def categorical(k: Key, logits: torch.Tensor) -> int:
    return int(k.draws.categorical(k.data, logits))


def gumbel(k: Key, n: int, device) -> torch.Tensor:
    return k.draws.gumbel(k.data, n, device)


def choice(k: Key, n: int, size: int) -> torch.Tensor:
    return k.draws.choice(k.data, n, size)


def permutation(k: Key, n: int) -> torch.Tensor:
    return k.draws.permutation(k.data, n)
