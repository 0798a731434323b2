# Copied from repro/service/errors.py; imports renamed.
"""Typed service errors shared by transport, server, and client.

These are the wire-visible failure modes of the overload-safe serving
layer. They live in their own leaf module so ``transport`` (which must
not import the server) and ``server``/``client`` can all raise and catch
the same types without an import cycle.

Over TCP each maps to a structured error ``code`` in the response frame
(``overloaded`` / ``deadline`` / ``timeout``) and is re-raised as the
same type client-side, so a caller's ``except ServerOverloaded`` works
identically in-process and across the wire.
"""
from __future__ import annotations


class ServerOverloaded(RuntimeError):
    """The request was REJECTED before any work ran — admission control
    (inflight bound / per-tenant token bucket) or a full ingest queue
    shed it. Carries ``retry_after_s``, the server's estimate of when
    capacity frees up.

    By construction the rejected op never executed, so retrying it is
    always safe — this is the one error ``ALClient``'s bounded
    retry-with-jitter acts on. A ``ConnectionError`` (poisoned
    connection) is NOT retried: the op may have executed server-side.
    """

    def __init__(self, retry_after_s: float = 0.05,
                 message: str = "server overloaded"):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class DeadlineExceeded(RuntimeError):
    """The frame's absolute deadline passed before (or while) the server
    could serve it — shed at admission or at queue-head, so abandoned
    requests stop burning shard-pool time. The op did not run."""
