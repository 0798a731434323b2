"""Thread-safe kernel launch counters.

Every kernel module keeps a plain ``LAUNCHES`` dict (kernel name -> launches
on the card). Replica lanes launch kernels from several threads at once, so
a bare ``+=`` could lose counts; the wrappers bump and reset through these
two helpers, which serialize on one lock.
"""
from __future__ import annotations

import threading
from typing import Dict

_LOCK = threading.Lock()


def bump(counts: Dict[str, int], name: str, n: int = 1) -> None:
    with _LOCK:
        counts[name] += n


def reset(counts: Dict[str, int]) -> None:
    with _LOCK:
        for k in counts:
            counts[k] = 0
