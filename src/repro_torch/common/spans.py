"""Spans at the layer boundaries of the scoring path, on the profiler's clock.

``span(name)`` is a context manager around one part of the path
(``model.prefill``, ``serve.step``, ``decode.graph`` (a step's body
replayed from CUDA graphs, ``models/decode_graphs.py``),
``layer.mixer``, ``layer.ffn``, ``moe.route``, ``moe.dispatch``,
``moe.combine``). It records only while a ``torch.profiler`` profile
records, read from the flag that torch's profiler sets for the whole
process on start and clears on stop; there is no other switch. Off, it
returns one shared object whose enter and exit do nothing: no clock
read, no allocation.

On, a span keeps a ``Record``: its name, start and end from
``time.time_ns()`` (the clock of the profiler's host events, so a
reader can set the spans beside the trace's launches and device
operations), its parent span on the same thread, and the thread. Each
thread keeps its own stack of open spans (replica lanes decode from
threads). ``recorded()`` returns the records in the order the spans
ended, oldest first; the buffer keeps the newest ``KEEP`` and drops the
oldest. ``clear()`` empties it.

A span adds no event to the profiler's trace. A ``record_function``
there would: with CUDA traced, the profiler adds a device-side copy of
each annotation, which a reader of the trace that knows only its own
annotations by name takes for a kernel (torch 2.11's events carry no
activity type), so the kernels a step and the idle share it reads
would change.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import List, NamedTuple, Optional

import torch.autograd.profiler as _profiler

# a traced benchmark window holds ~4,000 spans (3 batches of 8 steps of
# 138 and a prefill of 138): the buffer keeps over 100 such windows
KEEP = 1 << 19


class Record(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]        # id of the span open around it, or None
    thread: int


class _Off:
    """The span when nothing records. Its enter and exit are static, so
    a ``with`` makes no bound method either."""
    __slots__ = ()

    @staticmethod
    def __enter__():
        return None

    @staticmethod
    def __exit__(kind, value, tb):
        return None


_OFF = _Off()


class _On:
    __slots__ = ("recorder", "name", "id", "parent", "start")

    def __init__(self, recorder: "Recorder", name: str):
        self.recorder, self.name = recorder, name

    def __enter__(self):
        stack = self.recorder.stack()
        self.parent = stack[-1] if stack else None
        self.id = next(self.recorder.ids)
        stack.append(self.id)
        self.start = time.time_ns()
        return self

    def __exit__(self, kind, value, tb):
        end = time.time_ns()
        self.recorder.stack().pop()
        self.recorder.records.append(Record(
            self.id, self.name, self.start, end, self.parent,
            threading.get_ident()))
        return None


class Recorder:
    """The records, the span ids and each thread's stack of open spans."""

    def __init__(self, keep: int = KEEP):
        self.records = collections.deque(maxlen=keep)
        self.ids = itertools.count(1)
        self.local = threading.local()

    def stack(self) -> List[int]:
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack


_RECORDER = Recorder()


def span(name: str):
    """A context manager that records the part of the path it wraps
    while a ``torch.profiler`` profile records, and does nothing else."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _On(_RECORDER, name)


def recorded() -> List[Record]:
    """The kept records, in the order their spans ended."""
    return list(_RECORDER.records)


def clear() -> None:
    _RECORDER.records.clear()
