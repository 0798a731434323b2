# Copied from repro/service/admission.py; imports renamed.
"""Admission control + per-tenant weighted fair queueing for the RPC
transport.

Three pieces, all transport-agnostic (unit-testable without sockets):

``TokenBucket``
    Classic rate/burst bucket. ``try_take`` either takes a token or
    returns the exact wait until one accrues — that wait is the
    ``retry_after_s`` a shed response carries.

``AdmissionConfig``
    The knobs: a server-wide inflight bound (queued + executing frames)
    and a per-tenant rate/burst. ``enabled=False`` (the default) turns
    every admission check off — scheduling still runs, nothing is ever
    shed — which is the bit-identity oracle the overload drill twins
    against.

``FrameScheduler``
    The dispatch queue between the socket event loop and the worker
    pool. Frames are grouped per *stream* (one stream == one
    connection, FIFO order preserved: at most one frame of a stream is
    ever in flight) and streams are scheduled per *tenant* (the frame's
    session id) by start-time fair queueing: each tenant carries a
    virtual ``pass`` advanced by ``1/weight`` per served frame, the
    minimum-pass tenant is served next, and a tenant going active after
    idling resumes at the current virtual time (idle tenants bank no
    credit, so an idle connection costs nothing and a heavy tenant
    cannot starve light ones). Per-tenant counters
    (``admitted/shed/expired/retries``) feed ``stats()``.

Two kinds of entries ride a stream's queue: admitted frames (real
work, held to the inflight bound) and *control* entries — pre-built
responses (shed notices) the transport wants written in per-stream FIFO
order without the event loop ever blocking on a send. Control entries
bypass every admission check and don't occupy inflight slots.

A stream object must expose the attributes the scheduler owns
(``pending`` deque, ``inflight``/``queued``/``closed`` flags);
``attach_stream`` initializes them.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Dict, Optional, Tuple

__all__ = ["TokenBucket", "AdmissionConfig", "FrameScheduler",
           "attach_stream"]


class TokenBucket:
    """rate tokens/s, up to ``burst`` banked. Not thread-safe on its own —
    the scheduler serializes access under its lock."""

    def __init__(self, rate: float, burst: float,
                 clock=time.monotonic):
        self.rate = float(rate)
        self.burst = max(float(burst), 1.0)
        self.tokens = self.burst
        self._clock = clock
        self._t = clock()

    def try_take(self, n: float = 1.0) -> Tuple[bool, float]:
        """(True, 0.0) and debit on success; (False, wait_s) where
        ``wait_s`` is exactly how long until ``n`` tokens have accrued."""
        now = self._clock()
        self.tokens = min(self.burst, self.tokens + (now - self._t) * self.rate)
        self._t = now
        if self.tokens >= n:
            self.tokens -= n
            return True, 0.0
        if self.rate <= 0:
            return False, 1.0
        return False, (n - self.tokens) / self.rate


@dataclasses.dataclass
class AdmissionConfig:
    enabled: bool = False
    # server-wide bound on admitted-but-unfinished frames (queued +
    # executing); past it new frames shed with retry_after_s
    max_inflight: int = 64
    # per-tenant token bucket; rate <= 0 disables the bucket check
    tenant_rate: float = 0.0
    tenant_burst: float = 8.0


def attach_stream(stream: Any) -> Any:
    """Initialize the scheduler-owned attributes on a stream object."""
    stream.pending = deque()    # (tenant, payload, control) not yet served
    stream.inflight = False     # a worker is serving this stream's head
    stream.queued = False       # stream sits in some tenant's ready deque
    stream.closed = False       # dropped; lazily skipped when popped
    return stream


class _TenantQ:
    __slots__ = ("weight", "vpass", "streams")

    def __init__(self, weight: float):
        self.weight = max(float(weight), 1e-6)
        self.vpass = 0.0
        self.streams: deque = deque()   # ready streams, FIFO within tenant


_COUNTER_FIELDS = ("admitted", "shed", "expired", "retries")


class FrameScheduler:
    def __init__(self, cfg: Optional[AdmissionConfig] = None,
                 weights: Optional[Dict[str, float]] = None,
                 workers: int = 1,
                 clock=time.monotonic, wall=time.time):
        self.cfg = cfg or AdmissionConfig()
        self._weights = dict(weights or {})
        self._workers = max(int(workers), 1)
        self._clock = clock
        self._wall = wall
        self._cv = threading.Condition()
        self._tenants: Dict[str, _TenantQ] = {}
        self._buckets: Dict[str, TokenBucket] = {}
        self._counts: Dict[str, Dict[str, int]] = {}
        self._vtime = 0.0
        self._inflight = 0
        self.inflight_hw = 0
        self._svc_ema_s = 0.01      # smoothed per-frame service time
        self._admitting = True
        self._closed = False

    # ------------------------------------------------------------ intake --
    def submit(self, stream: Any, tenant: str,
               frame: dict) -> Tuple[str, Optional[str], float]:
        """Admit-or-shed one frame. Returns (verdict, code, retry_after_s)
        where verdict is "admitted" or "shed"; shed codes are
        "shutdown" | "deadline" | "overloaded". Admitted frames are
        queued on the stream and scheduled; the caller sends the shed
        response itself (nothing ran server-side)."""
        with self._cv:
            if not self._admitting:
                return "shed", "shutdown", 0.0
            # deadline shed-before-dispatch is independent of admission:
            # an already-expired frame is dead work whatever the load
            deadline = frame.get("deadline")
            if deadline is not None and self._wall() > float(deadline):
                self._count(tenant, "expired")
                self._count(tenant, "shed")
                return "shed", "deadline", 0.0
            if self.cfg.enabled:
                if self._inflight >= self.cfg.max_inflight:
                    self._count(tenant, "shed")
                    return "shed", "overloaded", self._retry_after()
                if self.cfg.tenant_rate > 0:
                    bucket = self._buckets.get(tenant)
                    if bucket is None:
                        bucket = self._buckets[tenant] = TokenBucket(
                            self.cfg.tenant_rate, self.cfg.tenant_burst,
                            clock=self._clock)
                    ok, wait_s = bucket.try_take(1.0)
                    if not ok:
                        self._count(tenant, "shed")
                        return "shed", "overloaded", wait_s
            self._count(tenant, "admitted")
            if frame.get("attempt"):
                self._count(tenant, "retries")
            self._inflight += 1
            self.inflight_hw = max(self.inflight_hw, self._inflight)
            stream.pending.append((tenant, frame, False))
            if not stream.inflight and not stream.queued:
                self._make_ready(stream, tenant)
            self._cv.notify()
            return "admitted", None, 0.0

    def submit_control(self, stream: Any, tenant: str,
                       payload: Any) -> bool:
        """Queue a pre-built response on the stream: rides the same
        per-stream FIFO as admitted frames (so a shed notice can never
        overtake the response of an earlier admitted frame) but bypasses
        admission and occupies no inflight slot. Returns False once the
        scheduler is closed (the connection is about to die anyway)."""
        with self._cv:
            if self._closed or stream.closed:
                return False
            stream.pending.append((tenant, payload, True))
            if not stream.inflight and not stream.queued:
                self._make_ready(stream, tenant)
            self._cv.notify()
            return True

    def _make_ready(self, stream: Any, tenant: str) -> None:
        tq = self._tenants.get(tenant)
        if tq is None:
            tq = self._tenants[tenant] = _TenantQ(
                self._weights.get(tenant, 1.0))
        if not tq.streams:
            # tenant goes active: resume at the virtual time, banking no
            # credit for the time it sat idle
            tq.vpass = max(tq.vpass, self._vtime)
        tq.streams.append(stream)
        stream.queued = True

    # ---------------------------------------------------------- dispatch --
    def next(self, timeout: float = 0.2):
        """Pop the next (stream, tenant, payload, control) in WFQ order,
        or None on timeout/close (workers loop and re-check ``closed``)."""
        with self._cv:
            item = self._pop()
            if item is not None:
                return item
            if self._closed:
                return None
            self._cv.wait(timeout)
            return self._pop()

    def _pop(self):
        while True:
            best = None
            for tq in self._tenants.values():
                if tq.streams and (best is None or tq.vpass < best.vpass):
                    best = tq
            if best is None:
                return None
            stream = best.streams.popleft()
            stream.queued = False
            if stream.closed or not stream.pending:
                continue            # dropped while queued: skip, no charge
            tenant, payload, control = stream.pending.popleft()
            stream.inflight = True
            self._vtime = max(self._vtime, best.vpass)
            best.vpass += 1.0 / best.weight
            return stream, tenant, payload, control

    def done(self, stream: Any, duration_s: float = 0.0,
             control: bool = False) -> None:
        """Entry served (or shed at queue-head): release the inflight
        slot (admitted frames only) and, if the stream has more queued
        entries, re-queue it under its new head's tenant (per-stream
        FIFO: one at a time)."""
        with self._cv:
            if not control:
                self._inflight = max(self._inflight - 1, 0)
                if duration_s > 0:
                    self._svc_ema_s += 0.2 * (duration_s - self._svc_ema_s)
            stream.inflight = False
            if stream.pending and not stream.closed and not stream.queued:
                self._make_ready(stream, stream.pending[0][0])
            self._cv.notify()

    def drop_stream(self, stream: Any) -> None:
        """Stream's connection died: discard its queued entries (their
        responses have nowhere to go) and release the admitted ones'
        inflight slots. A frame currently executing still gets its
        done() from the worker."""
        with self._cv:
            stream.closed = True
            n = sum(1 for _, _, control in stream.pending if not control)
            stream.pending.clear()
            self._inflight = max(self._inflight - n, 0)
            if n:
                self._cv.notify()

    def cancel_pending(self):
        """Deterministic stop: stop admitting, pop every queued-not-
        started entry and hand them back as (stream, tenant, payload,
        control) so the transport can answer each admitted frame with a
        "shutdown" shed (and flush pre-built responses) before closing."""
        out = []
        with self._cv:
            self._admitting = False
            for tq in self._tenants.values():
                while tq.streams:
                    stream = tq.streams.popleft()
                    stream.queued = False
                    while stream.pending:
                        tenant, payload, control = stream.pending.popleft()
                        if not control:
                            self._inflight = max(self._inflight - 1, 0)
                        out.append((stream, tenant, payload, control))
            self._cv.notify_all()
        return out

    def close(self) -> None:
        with self._cv:
            self._admitting = False
            self._closed = True
            self._cv.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    # ------------------------------------------------------------- stats --
    def count(self, tenant: str, field: str) -> None:
        """External counter bump (e.g. queue-head deadline expiry)."""
        with self._cv:
            self._count(tenant, field)

    def _count(self, tenant: str, field: str) -> None:
        c = self._counts.get(tenant)
        if c is None:
            c = self._counts[tenant] = dict.fromkeys(_COUNTER_FIELDS, 0)
        c[field] += 1

    def _retry_after(self) -> float:
        # how long until a worker slot frees for MY frame: smoothed
        # service time scaled by the backlog ahead of me per worker
        est = self._svc_ema_s * (self._inflight / self._workers + 1.0)
        return min(max(est, 0.01), 2.0)

    def stats(self) -> dict:
        with self._cv:
            totals = dict.fromkeys(_COUNTER_FIELDS, 0)
            for c in self._counts.values():
                for k in _COUNTER_FIELDS:
                    totals[k] += c[k]
            return {
                "enabled": self.cfg.enabled,
                "max_inflight": self.cfg.max_inflight,
                "tenant_rate": self.cfg.tenant_rate,
                "inflight": self._inflight,
                "inflight_hw": self.inflight_hw,
                "service_ema_s": self._svc_ema_s,
                "tenants": {t: dict(c) for t, c in self._counts.items()},
                **totals,
            }
