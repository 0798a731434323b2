# Copied from repro/service/transport.py; imports renamed.
"""msgpack-over-TCP transport (offline stand-in for the paper's gRPC).

Framing: 4-byte big-endian length + msgpack blob. numpy arrays are encoded
as {"__nd__": True, "d": dtype, "s": shape, "b": bytes}. Every request may
carry a ``session`` id, delivered to the handler as its second argument —
the multi-tenant hook the AL service uses to address per-client pools; a
per-connection ``ctx`` dict (third argument) lets handlers park state that
must be reclaimed when the connection dies (``on_close(ctx)``).

Dispatch is FRAME-level, not connection-level: one selector event loop
reads every socket and feeds complete frames through a
``FrameScheduler`` (service.admission) to a shared pool of ``max_workers``
handler threads. Per-connection ordering is preserved (at most one frame
of a connection is in flight at a time), idle connections cost nothing,
and frames are scheduled across tenants by weighted fair queueing — a
heavy tenant cannot starve light ones. With admission enabled, a frame
past the inflight bound or its tenant's token bucket is answered with a
structured ``overloaded`` rejection carrying ``retry_after_s`` instead of
queueing without bound, and a frame whose ``deadline`` already passed is
shed before dispatch and re-checked at queue-head.

Overload/robustness semantics:
  * ``send_timeout_s``: a stopped-reading client cannot wedge a worker —
    a send that makes no progress for that long closes the connection.
  * ``idle_timeout_s`` (0 = off): a silent/half-open client with nothing
    queued is closed and its ``on_close`` cleanup fired.
  * ``stop()`` is deterministic: stop admitting, answer every queued-not-
    started frame with a ``shutdown`` rejection, drain in-flight handlers,
    then close every connection (firing ``on_close`` exactly once each).

Responses echo the request's ``id``, and ``RPCClient.call`` poisons the
connection on a mid-call timeout: a late response frame from a timed-out
request can never be mistaken for the answer to a later call. Structured
error codes (``overloaded`` / ``deadline`` / ``timeout``) re-raise
client-side as the typed exceptions in service.errors, so ``except
ServerOverloaded`` works identically in-process and across the wire.
"""
from __future__ import annotations

import itertools
import select
import selectors
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, Optional

import msgpack
import numpy as np

from repro_torch.service.admission import (AdmissionConfig, FrameScheduler,
                                     attach_stream)
from repro_torch.service.errors import DeadlineExceeded, ServerOverloaded


def _default(obj):
    if isinstance(obj, np.ndarray):
        return {"__nd__": True, "d": str(obj.dtype), "s": list(obj.shape),
                "b": obj.tobytes()}
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    raise TypeError(f"unserializable: {type(obj)}")


def _object_hook(obj):
    if obj.get("__nd__"):
        # frombuffer returns a READ-ONLY view of the msgpack blob; decoded
        # payloads must be mutable (backends preprocess in place), so copy
        return np.frombuffer(obj["b"], dtype=obj["d"]).reshape(obj["s"]).copy()
    return obj


def encode_msg(obj: Any) -> bytes:
    blob = msgpack.packb(obj, default=_default, use_bin_type=True)
    return struct.pack(">I", len(blob)) + blob


def send_msg(sock: socket.socket, obj: Any) -> None:
    sock.sendall(encode_msg(obj))


def recv_msg(sock: socket.socket) -> Any:
    hdr = _recv_exact(sock, 4)
    if hdr is None:
        return None
    (n,) = struct.unpack(">I", hdr)
    blob = _recv_exact(sock, n)
    if blob is None:
        return None
    return msgpack.unpackb(blob, object_hook=_object_hook, raw=False)


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class _Conn:
    """One accepted connection: its parse buffer, per-connection handler
    ctx, send lock, liveness stamps — plus the scheduler-owned stream
    attributes (``attach_stream``)."""

    _ids = itertools.count(1)

    def __init__(self, sock: socket.socket, addr):
        self.sock = sock
        self.addr = addr
        self.cid = next(self._ids)
        self.ctx: dict = {}
        self.buf = bytearray()
        self.send_lock = threading.Lock()
        self.last_recv = time.monotonic()
        self.eof = False          # peer closed (or socket error): drain+die
        self.finalized = False    # closed + on_close fired (exactly once)
        attach_stream(self)


class RPCServer:
    """Serve a dict of op -> handler(payload, session, ctx) over TCP.

    ``max_workers`` bounds the handler threads shared across ALL
    connections (frame-level dispatch); the accept backlog is a fixed 128,
    so clients beyond the worker pool queue instead of being refused.
    ``admission``/``fairness_weights`` wire the overload layer; both
    default to off/uniform, which preserves unbounded-FIFO behaviour."""

    def __init__(self, handlers: Dict[str, Callable], host: str, port: int,
                 max_workers: int = 16,
                 on_close: Callable[[dict], None] = None,
                 admission: Optional[AdmissionConfig] = None,
                 fairness_weights: Optional[Dict[str, float]] = None,
                 idle_timeout_s: float = 0.0,
                 send_timeout_s: float = 30.0):
        self.handlers = handlers
        self.host, self.port = host, port
        self.max_workers = max(int(max_workers), 1)
        self.on_close = on_close
        self.idle_timeout_s = float(idle_timeout_s)
        self.send_timeout_s = float(send_timeout_s)
        self._sched = FrameScheduler(admission, weights=fairness_weights,
                                     workers=self.max_workers)
        self._sock: socket.socket = None
        self._sel: selectors.BaseSelector = None
        self._stop = threading.Event()
        self._stopped = False
        self._thread: threading.Thread = None
        self._workers: list = []
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._wake_r: socket.socket = None
        self._wake_w: socket.socket = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> int:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        self.port = self._sock.getsockname()[1]
        # fixed backlog, decoupled from the worker pool: clients beyond
        # max_workers must queue at accept, not get connection-refused
        self._sock.listen(128)
        self._sock.setblocking(False)
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._sock, selectors.EVENT_READ, "listen")
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="rpc-loop")
        self._thread.start()
        self._workers = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"rpc-w{i}")
            for i in range(self.max_workers)]
        for w in self._workers:
            w.start()
        return self.port

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    def stop(self):
        """Deterministic shutdown: stop accepting and admitting, answer
        every queued-not-started frame with a ``shutdown`` rejection,
        drain in-flight handlers (their responses still send), then close
        every connection — ``on_close`` fires exactly once per
        connection, with no socket-close race against live handlers."""
        if self._stopped:
            return
        self._stopped = True
        self._stop.set()
        self._wake()
        if self._thread:
            self._thread.join(timeout=5)
        # 1) every admitted-but-unstarted frame gets a shutdown answer
        #    (nothing ran server-side, so the client may safely retry
        #    elsewhere); queued control responses still flush
        for stream, _, payload, control in self._sched.cancel_pending():
            resp = (payload if control else
                    {"ok": False, "id": payload.get("id"),
                     "code": "shutdown", "error": "server stopped"})
            try:
                self._send(stream, resp)
            except OSError:
                pass
        # 2) drain: workers finish executing frames (and any follow-up
        #    frames those streams had admitted), then exit on the closed,
        #    empty scheduler
        self._sched.close()
        for w in self._workers:
            w.join(timeout=10)
        # 3) close every connection, firing on_close exactly once each
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            self._finalize(conn)
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass
        if self._sel is not None:
            self._sel.close()

    def stats(self) -> dict:
        """Scheduler/admission counters + live connection count."""
        with self._conns_lock:
            n = len(self._conns)
        return {"connections": n, **self._sched.stats()}

    # ----------------------------------------------------------- event loop
    def _loop(self):
        while not self._stop.is_set():
            try:
                events = self._sel.select(timeout=0.2)
            except OSError:
                break
            for key, _ in events:
                if key.data == "listen":
                    self._accept()
                elif key.data == "wake":
                    try:
                        while self._wake_r.recv(4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                else:
                    self._readable(key.data)
            self._tick()
        try:
            self._sock.close()
        except OSError:
            pass

    def _accept(self):
        while True:
            try:
                sock, addr = self._sock.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            conn = _Conn(sock, addr)
            with self._conns_lock:
                self._conns.add(conn)
            self._sel.register(sock, selectors.EVENT_READ, conn)

    def _readable(self, conn: _Conn):
        if conn.finalized:
            return
        try:
            while True:
                chunk = conn.sock.recv(65536)
                if not chunk:
                    conn.eof = True
                    break
                conn.buf += chunk
                conn.last_recv = time.monotonic()
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            conn.eof = True
        self._parse_frames(conn)
        self._maybe_finalize(conn)

    def _parse_frames(self, conn: _Conn):
        while not conn.eof or conn.buf:
            if len(conn.buf) < 4:
                return
            (n,) = struct.unpack(">I", bytes(conn.buf[:4]))
            if len(conn.buf) < 4 + n:
                return
            blob = bytes(conn.buf[4:4 + n])
            del conn.buf[:4 + n]
            try:
                msg = msgpack.unpackb(blob, object_hook=_object_hook,
                                      raw=False)
                if not isinstance(msg, dict):
                    raise ValueError("frame is not a request map")
            except Exception:
                conn.eof = True       # garbage on the wire: drop the conn
                conn.buf.clear()
                return
            self._submit(conn, msg)

    def _submit(self, conn: _Conn, msg: dict):
        # the tenant is the frame's session id; session-less frames fall
        # back to a per-connection tenant so WFQ still spreads them
        tenant = msg.get("session") or f"conn-{conn.cid}"
        verdict, code, retry = self._sched.submit(conn, tenant, msg)
        if verdict == "shed":
            resp = self._shed_response(msg.get("id"), code, retry)
            # the rejection rides the stream's FIFO like any response (it
            # must not overtake an earlier admitted frame's answer)
            self._sched.submit_control(conn, tenant, resp)

    @staticmethod
    def _shed_response(rid, code: str, retry_after_s: float) -> dict:
        if code == "overloaded":
            return {"ok": False, "id": rid, "code": "overloaded",
                    "retry_after_s": float(retry_after_s),
                    "error": "server overloaded (admission control); "
                             "the request did not run"}
        if code == "deadline":
            return {"ok": False, "id": rid, "code": "deadline",
                    "error": "deadline expired before dispatch"}
        return {"ok": False, "id": rid, "code": "shutdown",
                "error": "server shutting down"}

    def _tick(self):
        """Periodic sweep: finalize drained-EOF connections and enforce
        the idle timeout on silent/half-open clients."""
        now = time.monotonic()
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            if conn.eof:
                self._maybe_finalize(conn)
            elif (self.idle_timeout_s > 0 and not conn.pending
                  and not conn.inflight
                  and now - conn.last_recv > self.idle_timeout_s):
                self._finalize(conn)

    def _maybe_finalize(self, conn: _Conn):
        """EOF semantics: frames already received keep being served (their
        responses may still reach a half-closed peer); the connection dies
        once nothing of it remains queued or executing."""
        if conn.eof and not conn.pending and not conn.inflight:
            self._finalize(conn)

    def _finalize(self, conn: _Conn):
        """Close exactly once: unregister, drop queued frames, close the
        socket, fire on_close. Called from the event loop and stop()
        (never concurrently with each other for the same conn thanks to
        the ``finalized`` flag under the conns lock)."""
        with self._conns_lock:
            if conn.finalized:
                return
            conn.finalized = True
            self._conns.discard(conn)
        self._sched.drop_stream(conn)
        if self._sel is not None:
            try:
                self._sel.unregister(conn.sock)
            except (KeyError, ValueError, OSError):
                pass
        try:
            conn.sock.close()
        except OSError:
            pass
        if self.on_close:
            try:
                self.on_close(conn.ctx)
            except Exception:
                pass

    # -------------------------------------------------------------- workers
    def _worker(self):
        while True:
            item = self._sched.next(timeout=0.2)
            if item is None:
                if self._sched.closed:
                    return
                continue
            conn, tenant, payload, control = item
            t0 = time.perf_counter()
            try:
                if control:
                    self._send(conn, payload)
                else:
                    self._serve(conn, tenant, payload)
            finally:
                self._sched.done(conn, time.perf_counter() - t0,
                                 control=control)

    def _serve(self, conn: _Conn, tenant: str, msg: dict):
        rid = msg.get("id")
        deadline = msg.get("deadline")
        if deadline is not None and time.time() > float(deadline):
            # queue-head shed: the client stopped waiting while this frame
            # sat in the dispatch queue — don't burn shard-pool time on it
            self._sched.count(tenant, "expired")
            self._send(conn, {"ok": False, "id": rid, "code": "deadline",
                              "error": "deadline expired at queue head"})
            return
        try:
            fn = self.handlers[msg.get("op")]
            result = fn(msg.get("payload") or {}, msg.get("session"),
                        conn.ctx)
            self._send(conn, {"ok": True, "id": rid, "result": result})
        except ServerOverloaded as e:
            self._send(conn, {"ok": False, "id": rid, "code": "overloaded",
                              "retry_after_s": e.retry_after_s,
                              "error": repr(e)})
        except DeadlineExceeded as e:
            self._send(conn, {"ok": False, "id": rid, "code": "deadline",
                              "error": repr(e)})
        except TimeoutError as e:
            self._send(conn, {"ok": False, "id": rid, "code": "timeout",
                              "error": repr(e)})
        except Exception as e:
            self._send(conn, {"ok": False, "id": rid, "error": repr(e)})

    def _send(self, conn: _Conn, obj: Any):
        """Serialize + send under the connection's send lock. A send that
        stalls past ``send_timeout_s`` (stopped-reading client) or fails
        marks the connection dead — the event loop finalizes it — so no
        worker is ever wedged in a blocking send."""
        if conn.finalized:
            return
        data = encode_msg(obj)
        try:
            with conn.send_lock:
                self._sendall(conn.sock, data)
        except OSError:
            conn.eof = True
            self._wake()

    def _sendall(self, sock: socket.socket, data: bytes):
        t = self.send_timeout_s
        view = memoryview(data)
        off = 0
        stalled = time.monotonic()
        while off < len(view):
            try:
                off += sock.send(view[off:])
                stalled = time.monotonic()
            except (BlockingIOError, InterruptedError):
                if t > 0:
                    waited = time.monotonic() - stalled
                    if waited >= t:
                        raise socket.timeout(
                            f"send stalled {waited:.1f}s (client not "
                            f"reading)") from None
                    select.select([], [sock], [], min(t - waited, 0.2))
                else:
                    select.select([], [sock], [], 0.2)


class RPCClient:
    """One connection, serial request/response pairs. ``call`` holds a lock
    around the send+recv pair so multiple threads (e.g. the ALClient's
    async-push I/O thread and the caller's thread) can share the
    connection without interleaving frames.

    Requests carry a monotone ``id`` the server echoes, plus an optional
    absolute ``deadline`` (epoch seconds) the server sheds expired work
    by, and an ``attempt`` counter so server-side per-tenant retry
    accounting works. A ``call`` that times out mid-recv leaves its
    response frame in flight — the next recv on this socket would read
    THAT frame, a silent wrong answer — so a timeout POISONS the
    connection: the socket is closed, the call raises ``ConnectionError``,
    and every later call fails fast instead of desyncing. Mismatched ids
    (defense in depth) are dropped, never returned.

    Structured server rejections re-raise as typed exceptions:
    ``overloaded`` -> ServerOverloaded (carrying ``retry_after_s``; the op
    never ran, retrying is safe), ``deadline`` -> DeadlineExceeded,
    ``timeout`` -> TimeoutError, ``shutdown`` -> ConnectionError."""

    def __init__(self, host: str, port: int, timeout: float = 60.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self._lock = threading.Lock()
        self._req_id = 0
        self._poisoned: str = ""

    def call(self, op: str, payload: Any = None, session: Any = None,
             deadline: Optional[float] = None, attempt: int = 0):
        with self._lock:
            if self._poisoned:
                raise ConnectionError(self._poisoned)
            self._req_id += 1
            rid = self._req_id
            req = {"op": op, "payload": payload, "session": session,
                   "id": rid}
            if deadline is not None:
                req["deadline"] = float(deadline)
            if attempt:
                req["attempt"] = int(attempt)
            try:
                send_msg(self.sock, req)
                resp = recv_msg(self.sock)
                # a frame tagged for an OLDER request can only appear if a
                # past timeout somehow didn't poison us; drop it
                while resp is not None and resp.get("id") not in (None, rid):
                    resp = recv_msg(self.sock)
            except socket.timeout:
                self._poison(f"request {rid} ({op}) timed out mid-call; "
                             "connection closed to avoid response desync")
                raise ConnectionError(self._poisoned) from None
            except OSError as e:
                self._poison(f"connection broken during {op}: {e!r}")
                raise ConnectionError(self._poisoned) from e
        if resp is None:
            raise ConnectionError("server closed connection")
        if not resp["ok"]:
            code = resp.get("code")
            if code == "overloaded":
                raise ServerOverloaded(
                    float(resp.get("retry_after_s", 0.05)),
                    resp.get("error", "server overloaded"))
            if code == "deadline":
                raise DeadlineExceeded(resp.get("error",
                                                "deadline exceeded"))
            if code == "timeout":
                raise TimeoutError(resp.get("error", "server-side timeout"))
            if code == "shutdown":
                raise ConnectionError(
                    f"server shutting down: {resp.get('error')}")
            raise RuntimeError(f"server error: {resp['error']}")
        return resp["result"]

    def _poison(self, reason: str) -> None:
        self._poisoned = reason
        try:
            self.sock.close()
        except OSError:
            pass

    def close(self):
        self.sock.close()
