# Port of repro/data/prefetch.py.
"""Host -> device double-buffered prefetch.

The device-side analogue of the paper's stage pipeline: while step i
computes, batch i+1 is already being made and copied. A producer thread
turns each batch's numpy arrays (and tensors) into tensors on ``device``:
on a CUDA device through pinned host memory with ``non_blocking=True``,
so the copy is enqueued on the device's stream ahead of the steps that
read it; batches come out in the order the iterator made them.

The reference's contract is kept as it is: the producer puts an end
marker after the iterator's last item whether the iterator ended or
raised, so an error in the iterator ends the stream early and the error
itself is only reported by the thread (ROADMAP C records that this can
shorten ``launch.train.run_training`` silently).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch


def _to_device(item, device: torch.device):
    if isinstance(item, dict):
        return {k: _to_device(v, device) for k, v in item.items()}
    if isinstance(item, (list, tuple)):
        out = [_to_device(v, device) for v in item]
        return out if isinstance(item, list) else tuple(out)
    t = torch.from_numpy(np.ascontiguousarray(item)) \
        if isinstance(item, np.ndarray) else item
    if not isinstance(t, torch.Tensor):
        return t
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def prefetch_to_device(it: Iterator, size: int = 2,
                       device="cuda") -> Iterator:
    device = torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()

    def producer():
        try:
            for item in it:
                q.put(_to_device(item, device))
        finally:
            q.put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        yield item
