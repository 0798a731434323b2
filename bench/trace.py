"""Reading torch.profiler's trace of a ``--trace 1`` run, in memory.

The harness wraps each batch, and in it the prefill and the scored
steps, in ``record_function`` spans named ``bench.batch``,
``bench.prefill`` and ``bench.decode``, and synchronises at each span's
end, so every device operation a span launched runs inside it. From the
trace this keeps the device operations (kernels, copies, fills) with
their start and end, the spans, the host's operator calls and the
launches' correlation ids; the traced window is the first batch's start
to the last traced batch's end. Busy time is the union of the device
operations' intervals inside it, so overlapping operations count once.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


@dataclasses.dataclass
class Trace:
    ops: List[Tuple[str, int, int, int, str]]  # name, start, end ns,
    #                                            correlation id, kind
    spans: List[Tuple[str, int, int]]         # bench.* spans, ns
    launches: Dict[int, int]                  # correlation -> host ns
    host_ops: List[Tuple[str, int, int]]      # outermost operator calls,
    #                                           in order

    def __post_init__(self):
        self._op_starts = [s for _, s, _ in self.host_ops]

    @property
    def window(self) -> Tuple[int, int]:
        batches = self.of("bench.batch")
        return batches[0][0], batches[-1][1]

    @property
    def window_s(self) -> float:
        w0, w1 = self.window
        return (w1 - w0) / 1e9

    def of(self, name: str) -> List[Tuple[int, int]]:
        return sorted((s, e) for n, s, e in self.spans if n == name)

    def busy_intervals(self) -> List[Tuple[int, int]]:
        w0, w1 = self.window
        merged: List[List[int]] = []
        for _, s, e, _, _ in sorted(self.ops, key=lambda o: o[1]):
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def ops_in(self, span: str, names: Optional[Tuple[str, ...]] = None,
               kinds: Tuple[str, ...] = DEVICE_OPS) -> list:
        """Device operations of ``kinds`` that start inside a span of
        ``span``; with ``names``, only those whose name contains one."""
        spans = self.of(span)
        starts = [s for s, _ in spans]
        out = []
        for op in self.ops:
            if op[4] not in kinds or (names is not None and
                                      not any(n in op[0] for n in names)):
                continue
            i = bisect.bisect_right(starts, op[1]) - 1
            if i >= 0 and op[1] <= spans[i][1]:
                out.append(op)
        return out

    def device_s(self, names: Tuple[str, ...]) -> float:
        """Device seconds of the kernels whose name contains one of
        ``names``, inside the traced window."""
        return sum(op[2] - op[1] for op in
                   self.ops_in("bench.batch", names)) / 1e9

    def _host_at(self, t: int) -> str:
        """The innermost bench span and outermost operator at host time
        ``t``: what the host was doing ("python" outside any operator)."""
        span = min(((e - s, n) for n, s, e in self.spans
                    if s <= t <= e), default=(0, "outside"))[1]
        i = bisect.bisect_right(self._op_starts, t) - 1
        op = "python"
        if i >= 0 and t <= self.host_ops[i][2]:
            op = self.host_ops[i][0]
        return f"{span.replace('bench.', '')}: {op}"

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest idle
        gaps by what the host was doing when the operation that ended each
        gap was launched, top ``TOP`` of each, in seconds."""
        by_op = collections.Counter()
        for name, s, e, _, _ in self.ops_in("bench.batch"):
            by_op[name[:120]] += (e - s) / 1e9
        after = {}
        for _, s, _, corr, _ in self.ops:
            after.setdefault(s, corr)
        gaps = collections.Counter()
        busy = self.busy_intervals()
        w0, w1 = self.window
        edges = [(w0, busy[0][0] if busy else w1)] + [
            (busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)] + (
            [(busy[-1][1], w1)] if busy else [])
        for g0, g1 in edges:
            if g1 <= g0:
                continue
            corr = after.get(g1)
            launched = self.launches.get(corr)
            where = (self._host_at(launched) if launched is not None
                     else self._host_at(g0))
            gaps[where] += (g1 - g0) / 1e9
        return {"device_ops": [[n, v] for n, v in by_op.most_common(TOP)],
                "idle_gaps": [[n, v] for n, v in gaps.most_common(TOP)]}


def kind_of(ev) -> str:
    """The kineto activity of an event: its ``activity_type()`` where the
    installed torch has it, else worked out from its device, name and
    correlation id."""
    if hasattr(ev, "activity_type"):
        return ev.activity_type()
    name = ev.name()
    on_device = str(ev.device_type()).endswith("CUDA")
    if name.startswith("bench."):
        return "gpu_user_annotation" if on_device else "user_annotation"
    if on_device:
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if name.startswith(("cuda", "cu")) and ev.correlation_id():
        return "cuda_runtime"
    return "cpu_op"


def read(prof) -> Trace:
    """The ``Trace`` of a finished ``torch.profiler.profile``."""
    ops, spans, launches, host = [], [], {}, []
    for ev in prof.profiler.kineto_results.events():
        kind = kind_of(ev)
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if kind in DEVICE_OPS:
            ops.append((name, s, e, ev.correlation_id(), kind))
        elif kind == "user_annotation" and name.startswith("bench."):
            spans.append((name, s, e))
        elif kind == "cuda_runtime":
            launches[ev.correlation_id()] = s
        elif kind == "cpu_op":
            host.append((name, s, e))
    host.sort(key=lambda o: (o[1], -o[2]))
    outer, end = [], -1
    for name, s, e in host:          # keep the outermost calls only
        if s >= end:
            outer.append((name, s, e))
            end = e
    return Trace(ops, spans, launches, outer)
