# Copied from repro/service/batcher.py; imports renamed.
"""Dynamic batching (paper §3.3; Clipper-style [10], TPU-adapted).

Requests accumulate until ``max_batch`` or ``timeout_s``; batches are padded
up to power-of-two *buckets* so the jitted scorer sees a small closed set of
shapes — on TPU every new shape is an XLA recompile, so bucketing is the
batching adaptation that actually matters on this hardware.
"""
from __future__ import annotations

import concurrent.futures as cf
import threading
import time
from typing import Any, Callable, List, Sequence

import numpy as np


def bucket_size(n: int, max_batch: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return min(b, max_batch)


class DynamicBatcher:
    """batch_fn: (stacked np.ndarray, n_valid) -> per-item results list."""

    def __init__(self, batch_fn: Callable[[np.ndarray, int], Sequence[Any]],
                 max_batch: int = 64, timeout_s: float = 0.005,
                 pad_to_max: bool = False):
        self.batch_fn = batch_fn
        self.max_batch = max_batch
        self.timeout_s = timeout_s
        # pad_to_max gives the scorer ONE canonical shape (max_batch) instead
        # of pow-2 buckets: the embedding path needs it so a row's features
        # never depend on how many neighbours happened to share its batch
        # (shape-canonical + row-local forward => bitwise batch-insensitive).
        self.pad_to_max = pad_to_max
        self._pending: List = []
        self._lock = threading.Condition()
        self._stop = False
        self.batches = 0
        self.items = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, item: np.ndarray) -> "cf.Future":
        fut: cf.Future = cf.Future()
        with self._lock:
            self._pending.append((item, fut))
            self._lock.notify()
        return fut

    def score(self, items: Sequence[np.ndarray]) -> List[Any]:
        futs = [self.submit(it) for it in items]
        return [f.result() for f in futs]

    def _loop(self):
        while True:
            with self._lock:
                if not self._pending and not self._stop:
                    self._lock.wait(timeout=0.05)
                if self._stop and not self._pending:
                    return
                if not self._pending:
                    continue
                deadline = time.perf_counter() + self.timeout_s
                while (len(self._pending) < self.max_batch
                       and time.perf_counter() < deadline):
                    self._lock.wait(timeout=max(
                        deadline - time.perf_counter(), 0.0))
                batch = self._pending[: self.max_batch]
                self._pending = self._pending[self.max_batch:]
            items = [b[0] for b in batch]
            futs = [b[1] for b in batch]
            n = len(items)
            b = self.max_batch if self.pad_to_max else bucket_size(
                n, self.max_batch)
            stacked = np.stack(items + [np.zeros_like(items[0])] * (b - n))
            try:
                results = self.batch_fn(stacked, n)
                for f, r in zip(futs, results):
                    f.set_result(r)
            except BaseException as e:
                for f in futs:
                    f.set_exception(e)
            self.batches += 1
            self.items += n

    def close(self):
        with self._lock:
            self._stop = True
            self._lock.notify_all()
        self._thread.join(timeout=5)

    def stats(self) -> dict:
        return {"batches": self.batches, "items": self.items,
                "mean_batch": self.items / max(self.batches, 1)}
