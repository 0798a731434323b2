# Copied from repro/service/client.py; imports renamed (the server is
# the port's).
"""ALClient — the paper's few-LoC client API (Fig. 2), session-aware:

    client = ALClient(local=server)            # in-process
    client = ALClient(url="host:port")         # msgpack TCP
    client.push_data(data_list)
    selected = client.query(budget=10)

Multi-tenant: every client may claim its own server-side session — an
isolated pool/labels/head — so many clients share one server (and its
content-addressed embedding cache) without seeing each other's data:

    a = ALClient(url=u, session="new")         # fresh isolated session
    b = ALClient(url=u, session="new")
    a.push_data(xs)                            # invisible to b

``session=None`` (default) addresses the server's default session — the
original single-tenant behaviour.

Asynchronous ingest: ``push_data(xs, asynchronous=True)`` returns a
``PushTicket`` immediately (its ``keys`` are the content hashes, known
up front) and the server embeds in the background; ``flush()`` is the
barrier after which every prior push is visible to query/label/stats
(query and label also take it implicitly server-side). Over TCP the async
push rides a single-thread I/O executor, so requests stay strictly FIFO
on the shared connection.

Overload handling: a server running admission control (or a capped
ingest queue with ``ingest_policy: shed``) answers over-budget requests
with ``ServerOverloaded`` carrying ``retry_after_s``. Such an op never
ran server-side, so the client retries it up to ``retries`` times,
sleeping the server's hint plus deterministic jitter. A
``ConnectionError`` from a poisoned connection is NEVER retried — the op
may have executed. ``op_timeout_s`` stamps an absolute deadline into
every frame so the server sheds the op once the client has stopped
waiting (``DeadlineExceeded``).
"""
from __future__ import annotations

import concurrent.futures as cf
import random
import threading
import time
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.service import transport
from repro_torch.service.admission import AdmissionConfig
from repro_torch.service.cache import content_key
from repro_torch.service.errors import ServerOverloaded
from repro_torch.service.server import ALServer, PushTicket


def serve_tcp(server: ALServer, host: str = "127.0.0.1",
              port: int = 0,
              max_workers: Optional[int] = None) -> transport.RPCServer:
    def open_session(p, s, ctx):
        sid = server.create_session()
        # remembered per connection: if the client vanishes without
        # close_session, on_close reclaims the session (and its raw copies)
        ctx.setdefault("sessions", set()).add(sid)
        return {"session": sid}

    def close_session(p, s, ctx):
        server.close_session(s)
        ctx.get("sessions", set()).discard(s)
        return {}

    def on_close(ctx):
        for sid in ctx.get("sessions", ()):
            server.close_session(sid)

    handlers = {
        "push_data": lambda p, s, c: {
            "keys": server.push_data(list(p["items"]), session=s)},
        # async: enqueue on the session's ingest queue and ack immediately
        # with the content keys; "flush" is the integration barrier
        "push_data_async": lambda p, s, c: {
            "keys": server.push_data(list(p["items"]), session=s,
                                     asynchronous=True).keys},
        "flush": lambda p, s, c: server.flush(
            session=s, timeout=p.get("timeout")) or {},
        "query": lambda p, s, c: server.query(
            int(p["budget"]), p.get("strategy"),
            p.get("target_accuracy"), int(p.get("rng_seed") or 0),
            session=s),
        "label": lambda p, s, c: server.label(p["keys"], p["labels"],
                                              session=s) or {},
        "stats": lambda p, s, c: server.stats(session=s),
        "train_eval": lambda p, s, c: {
            "accuracy": server.train_and_eval(session=s)},
        # standing queries: register once, the server emits as the pool
        # streams in; poll returns emits since a sequence number
        "standing_register": lambda p, s, c: server.standing_register(
            int(p["budget"]), p.get("strategy"),
            int(p.get("rng_seed") or 0), session=s),
        "standing_cancel": lambda p, s, c: server.standing_cancel(
            p["query_id"], p.get("reason") or "cancelled by client",
            session=s) or {},
        "standing_poll": lambda p, s, c: server.standing_poll(
            p["query_id"], int(p.get("since") or 0), session=s),
        "open_session": open_session,
        "close_session": close_session,
    }
    if max_workers is None:
        max_workers = server.config.server_workers
    cfg = server.config
    admission = AdmissionConfig(
        enabled=bool(cfg.admission),
        max_inflight=int(cfg.admission_max_inflight),
        tenant_rate=float(cfg.admission_tenant_rate),
        tenant_burst=float(cfg.admission_tenant_burst))
    rpc = transport.RPCServer(handlers, host, port, max_workers=max_workers,
                              on_close=on_close,
                              admission=admission,
                              fairness_weights=cfg.fairness_weights,
                              idle_timeout_s=cfg.idle_timeout_s,
                              send_timeout_s=cfg.send_timeout_s)
    rpc.start()
    # let ALServer.stats() report the transport's admission counters
    server._transport_stats = rpc.stats
    return rpc


class ALClient:
    def __init__(self, local: Optional[ALServer] = None,
                 url: Optional[str] = None,
                 session: Optional[str] = None,
                 retries: int = 2,
                 retry_jitter_s: float = 0.05,
                 op_timeout_s: Optional[float] = None):
        assert (local is None) != (url is None), "pass local= xor url="
        self._local = local
        self._rpc = None
        self._io: Optional[cf.ThreadPoolExecutor] = None
        self._io_lock = threading.Lock()
        self._owns_session = False
        # bounded retry on ServerOverloaded ONLY (the op never ran; see
        # module docstring). Deterministic jitter rng: seeded, not wall-
        # clock — two same-seed runs sleep identically
        self.retries = max(int(retries), 0)
        self.retry_jitter_s = float(retry_jitter_s)
        self.op_timeout_s = op_timeout_s
        self._jitter = random.Random(0xA1AA5)
        if url:
            host, port = url.rsplit(":", 1)
            self._rpc = transport.RPCClient(host, int(port))
        if session == "new":
            session = self.open_session()
        self._session = session

    @property
    def session(self) -> Optional[str]:
        return self._session

    def _rpc_retrying(self, op: str, payload, session):
        """One logical RPC: stamp the deadline, retry ServerOverloaded
        sheds up to ``retries`` times honoring the server's
        ``retry_after_s`` hint (+ jitter). Anything else — including
        ConnectionError from a poisoned connection — propagates on the
        first raise; those ops may have executed server-side."""
        deadline = (time.time() + self.op_timeout_s
                    if self.op_timeout_s else None)
        attempt = 0
        while True:
            try:
                return self._rpc.call(op, payload, session=session,
                                      deadline=deadline, attempt=attempt)
            except ServerOverloaded as e:
                if attempt >= self.retries:
                    raise
                attempt += 1
                time.sleep(e.retry_after_s
                           + self._jitter.random() * self.retry_jitter_s)

    def _local_retrying(self, fn, *args, **kwargs):
        """Same bounded retry for the in-process path (a shed ingest
        enqueue raises ServerOverloaded there too)."""
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except ServerOverloaded as e:
                if attempt >= self.retries:
                    raise
                attempt += 1
                time.sleep(e.retry_after_s
                           + self._jitter.random() * self.retry_jitter_s)

    def _call(self, op: str, payload=None, session=None):
        """One RPC round trip. Once an async push exists, every op rides
        the same single-thread executor so the shared socket sees strictly
        FIFO request/response pairs (a flush can never overtake a push
        that was issued before it). Retries happen INSIDE the executor
        slot, so a retried push still cannot be overtaken by a later op."""
        if self._io is not None:
            return self._io.submit(self._rpc_retrying, op, payload,
                                   session).result()
        return self._rpc_retrying(op, payload, session)

    def open_session(self) -> str:
        """Claim a fresh isolated session and address it from now on."""
        if self._local is not None:
            sid = self._local.create_session()
        else:
            sid = self._call("open_session")["session"]
        self._session = sid
        self._owns_session = True
        return sid

    def close_session(self):
        if self._session is None or not self._owns_session:
            return
        if self._local is not None:
            self._local.close_session(self._session)
        else:
            self._call("close_session", session=self._session)
        self._session = None
        self._owns_session = False

    def push_data(self, data_list: Sequence[np.ndarray],
                  asynchronous: bool = False):
        """Synchronous (default): embed + append now, return the keys.
        ``asynchronous=True``: return a ``PushTicket`` immediately —
        ``ticket.keys`` are the content hashes, ``ticket.result()`` waits
        for the server's acceptance (``timeout=`` raises ``TimeoutError``
        past the deadline instead of blocking forever), and ``flush()``
        (or any query/label) is the barrier after which the rows are
        visible."""
        if self._local is not None:
            return self._local_retrying(
                self._local.push_data, data_list, session=self._session,
                asynchronous=asynchronous)
        items = [np.asarray(d) for d in data_list]
        if not asynchronous:
            return self._call("push_data", {"items": items},
                              session=self._session)["keys"]
        with self._io_lock:   # two threads' first pushes must not race
            if self._io is None:
                self._io = cf.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="alc-io")
        # a shed enqueue retries inside the I/O slot; only after the
        # bounded retries are exhausted does the ticket fail (with
        # ServerOverloaded — retryable, nothing was enqueued)
        fut = self._io.submit(self._rpc_retrying, "push_data_async",
                              {"items": items}, self._session)
        return PushTicket([content_key(it) for it in items], fut)

    def flush(self, timeout: Optional[float] = None) -> None:
        """Barrier: every ``push_data(asynchronous=True)`` issued before
        this call is embedded and visible to query/label/stats.
        ``timeout=`` raises ``TimeoutError`` once the deadline passes with
        the backlog intact (flush again to keep waiting)."""
        if self._local is not None:
            return self._local.flush(session=self._session, timeout=timeout)
        self._call("flush", {"timeout": timeout}, session=self._session)

    def query(self, budget: int, strategy: Optional[str] = None,
              target_accuracy: Optional[float] = None,
              rng_seed: int = 0) -> dict:
        if self._local is not None:
            return self._local.query(budget, strategy, target_accuracy,
                                     rng_seed, session=self._session)
        return self._call("query", {"budget": budget,
                                    "strategy": strategy,
                                    "target_accuracy": target_accuracy,
                                    "rng_seed": rng_seed},
                          session=self._session)

    def label(self, keys: Sequence[str], labels: Sequence[int]):
        if self._local is not None:
            return self._local.label(keys, labels, session=self._session)
        return self._call("label", {"keys": list(keys),
                                    "labels": [int(x) for x in labels]},
                          session=self._session)

    def train_eval(self) -> float:
        if self._local is not None:
            return self._local.train_and_eval(session=self._session)
        return self._call("train_eval", session=self._session)["accuracy"]

    # ------------------------------------------------- standing queries --
    def standing_register(self, budget: int, strategy: Optional[str] = None,
                          rng_seed: int = 0) -> dict:
        """Register a continuous query: the server keeps a ``budget``-sized
        selection live as data streams in. Returns the initial emit
        (``query_id``, ``seq``, ``keys``)."""
        if self._local is not None:
            return self._local.standing_register(budget, strategy, rng_seed,
                                                 session=self._session)
        return self._call("standing_register",
                          {"budget": int(budget), "strategy": strategy,
                           "rng_seed": int(rng_seed)},
                          session=self._session)

    def standing_cancel(self, query_id: str,
                        reason: str = "cancelled by client") -> None:
        if self._local is not None:
            return self._local.standing_cancel(query_id, reason,
                                               session=self._session)
        self._call("standing_cancel",
                   {"query_id": query_id, "reason": reason},
                   session=self._session)

    def standing_poll(self, query_id: str, since: int = 0) -> dict:
        """Current cumulative selection + the emits with ``seq > since``
        (each carries mode/added/removed and the pool/labels/head versions
        it was computed at). Takes the server-side flush barrier first, so
        a failed or dead async ingest raises here ticket-style."""
        if self._local is not None:
            return self._local.standing_poll(query_id, since,
                                             session=self._session)
        return self._call("standing_poll",
                          {"query_id": query_id, "since": int(since)},
                          session=self._session)

    def stats(self) -> dict:
        if self._local is not None:
            return self._local.stats(session=self._session)
        return self._call("stats", session=self._session)

    def close(self):
        self.close_session()
        if self._io:
            self._io.shutdown(wait=True)
            self._io = None
        if self._rpc:
            self._rpc.close()
