"""The port's program spans set beside the profiler's trace of a
``--trace 1`` run.

The port records a span at each layer boundary of the scoring path
(``repro_torch.common.spans``: ``model.prefill``, ``serve.step``,
``layer.mixer``, ``layer.ffn``, ``moe.route``, ``moe.dispatch``,
``moe.combine``) while the profiler records, stamped with
``time.time_ns()``, the clock of the trace's host events. The spans of
the traced window are the records that lie inside it.

Placement: a device operation goes in the innermost span whose host
interval holds its launch (``Trace.launches[correlation]``). An operation
whose launch the trace does not hold (``trace.py`` keeps the runtime
API's launches, so one made through the driver API is missing) goes in
the innermost span that holds the launches of both the nearest earlier
and the nearest later device operation whose launches are known. An
operation launched outside every span is placed nowhere. An operation
placed in a span lies within each span around it, so a ``layer.ffn``
holds what its ``moe.*`` spans hold.

Where the program records no span (a tree without the recorder) or the
trace holds no device operation (the CPU), ``place`` returns None and the
readers that use it report nothing.
"""
from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Optional, Tuple

LAUNCH, NEIGHBOURS = "launch", "neighbours"


def program_spans(trace, name: Optional[str] = None) -> list:
    """The port's span records inside the trace's window (all of them, or
    those named ``name``), in the order they started; [] where the
    program has no recorder."""
    if trace is None or not trace.of("bench.batch"):
        return []
    try:
        from repro_torch.common import spans
    except ImportError:
        return []
    w0, w1 = trace.window
    return sorted((r for r in spans.recorded()
                   if w0 <= r.start_ns and r.end_ns <= w1
                   and (name is None or r.name == name)),
                  key=lambda r: r.start_ns)


class _Innermost:
    """The innermost span at each host time: the spans' edges, with the
    span that holds the time from each edge to the next."""

    def __init__(self, records):
        edges = sorted([(r.start_ns, 0, r.id) for r in records] +
                       [(r.end_ns, 1, r.id) for r in records])
        self.times, self.ids, stack = [], [], []
        for t, closing, sid in edges:
            if closing:
                stack.remove(sid)
            else:
                stack.append(sid)
            self.times.append(t)
            self.ids.append(stack[-1] if stack else None)

    def at(self, t: int) -> Optional[int]:
        i = bisect.bisect_right(self.times, t) - 1
        return self.ids[i] if i >= 0 else None


class Placed:
    """Each device operation of the window with the span it is placed in
    (an id, or None) and how: ``LAUNCH`` where the trace holds its
    launch, else ``NEIGHBOURS``."""

    def __init__(self, trace, records):
        self.trace = trace
        self.spans = {r.id: r for r in records}
        inner = _Innermost(records)
        w0, w1 = trace.window
        ops = sorted((op for op in trace.ops if op[1] < w1 and op[2] > w0),
                     key=lambda op: op[1])
        launch = [trace.launches.get(op[3]) for op in ops]
        where = [None if t is None else inner.at(t) for t in launch]
        known = [i for i, t in enumerate(launch) if t is not None]
        self.ops: List[Tuple[tuple, Optional[int], str]] = []
        for i, op in enumerate(ops):
            if launch[i] is not None:
                self.ops.append((op, where[i], LAUNCH))
                continue
            k = bisect.bisect_left(known, i)
            sid = None
            if 0 < k < len(known):
                sid = self._common(where[known[k - 1]], where[known[k]])
            self.ops.append((op, sid, NEIGHBOURS))

    def chain(self, sid: Optional[int]) -> List[int]:
        out = []
        while sid is not None and sid in self.spans:
            out.append(sid)
            sid = self.spans[sid].parent
        return out

    def _common(self, a: Optional[int], b: Optional[int]) -> Optional[int]:
        """The innermost span around both ``a`` and ``b``."""
        around_b = set(self.chain(b))
        return next((s for s in self.chain(a) if s in around_b), None)

    def name_of(self, sid: Optional[int]) -> str:
        return "outside" if sid is None else self.spans[sid].name

    def within(self, name: str) -> list:
        """The operations placed in a span named ``name`` or inside one."""
        return [op for op, sid, _ in self.ops
                if any(self.spans[s].name == name for s in self.chain(sid))]

    def union_s(self, name: str) -> float:
        """The union of the intervals of the operations within ``name``
        spans, clipped to the window, in seconds."""
        w0, w1 = self.trace.window
        total, end = 0, w0
        for _, s, e, _, _ in sorted(self.within(name), key=lambda o: o[1]):
            s, e = max(s, end), min(e, w1)
            if e > s:
                total += e - s
                end = e
        return total / 1e9

    def shares(self) -> Dict[str, float]:
        """Device seconds of the window's operations by how they were
        placed: by launch, by neighbours, launched outside every span, or
        with no launch and no span around both neighbours'."""
        out = collections.Counter()
        for (_, s, e, _, _), sid, how in self.ops:
            key = how if sid is not None else (
                "outside" if how == LAUNCH else "unplaced")
            out[key] += (e - s) / 1e9
        return dict(out)

    def idle_by_span(self) -> Dict[str, float]:
        """The idle gaps inside the harness's ``bench.decode`` spans, in
        seconds, by the innermost program span of the operation that
        ended each gap."""
        holders = self.trace.of("bench.decode")
        starts = [s for s, _ in holders]
        first = {}
        for op, sid, _ in self.ops:
            first.setdefault(op[1], sid)
        busy = self.trace.busy_intervals()
        out = collections.Counter()
        for (_, g0), (g1, _) in zip(busy, busy[1:]):
            i = bisect.bisect_right(starts, g0) - 1
            if g1 <= g0 or i < 0 or g1 > holders[i][1]:
                continue
            out[self.name_of(first.get(g1))] += (g1 - g0) / 1e9
        return dict(out.most_common())


def place(trace) -> Optional[Placed]:
    """The window's device operations placed in the program's spans, or
    None where the trace holds no device operation or the program no
    span."""
    if trace is None or not trace.ops:
        return None
    records = program_spans(trace)
    if not records:
        return None
    return Placed(trace, records)
