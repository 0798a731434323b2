"""Thread-safe kernel launch counters.

Every kernel module keeps a plain ``LAUNCHES`` dict (kernel name -> launches
on the card). Replica lanes launch kernels from several threads at once, so
a bare ``+=`` could lose counts; the wrappers bump and reset through these
two helpers, which serialize on one lock.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List

import torch

_LOCK = threading.Lock()


def bump(counts: Dict[str, int], name: str, n: int = 1) -> None:
    with _LOCK:
        counts[name] += n


def reset(counts: Dict[str, int]) -> None:
    with _LOCK:
        for k in counts:
            counts[k] = 0


# --- a dry run's stand-ins ------------------------------------------------
# A step traced under FakeTensorMode (``launch/steps.py``) holds no data,
# so no kernel can launch. Inside ``roofline.cost.CostMode`` a wrapper
# handed a fake tensor returns an empty output of the kernel's shape and
# reports the kernel's FLOPs and bytes here, as a custom op's fake
# implementation would; outside it a fake tensor is no different from any
# other.
_HOOKS: List[Callable[[str, float, float], None]] = []


def add_stand_in_hook(fn) -> None:
    _HOOKS.append(fn)


def remove_stand_in_hook(fn) -> None:
    _HOOKS.remove(fn)


def standing_in(t) -> bool:
    """True where a wrapper must stand in for its launch: a fake tensor
    inside a counting trace."""
    if not _HOOKS:
        return False
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(t)


def stand_in(name: str, flops: float, nbytes: float) -> None:
    for fn in list(_HOOKS):
        fn(name, flops, nbytes)


def refuse_dtensor(*ts) -> None:
    """A kernel takes plain tensors: a DTensor raises (the model hands a
    kernel each rank's shards, ``partition.heads_local``)."""
    for t in ts:
        if type(t) is not torch.Tensor and isinstance(t, torch.Tensor):
            from torch.distributed.tensor import DTensor
            if isinstance(t, DTensor):
                raise TypeError("a kernel wrapper was handed a DTensor: "
                                "run it on the local shards")
