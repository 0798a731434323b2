"""ALServer — the paper's AL-as-a-service backend (Fig. 1), multi-tenant
(port of repro/service/server.py, at ``replicas: 1``).

One ``ALServer`` owns the *shared* resources — scorer backend on one
device, the content-addressed ``EmbeddingCache``, config — and hosts many
independent ``ALSession`` objects (one per client/tenant). A session
carries the pool key list, raw copies, labels, the trained head, the
oracle, and an incremental pool-artifact column.

Data path (stage-level pipeline, Fig. 3c):
  fetch (URI/bytes -> raw)  ->  preprocess  ->  infer (batched features via
  DynamicBatcher)  ->  EmbeddingCache

Query path:
  strategy != "auto": run one zoo strategy over the pooled artifacts, on
  the server's device (the k-center rounds and DBAL's assignment run the
  port's CUDA kernels there).
  strategy == "auto": run the PSHEA agent (performance predictor +
  successive halving) against the attached oracle, per paper Alg. 1.

The server computes on ``config.device``: "cuda" (the default) or "cpu".
A cuda server on a machine without a GPU raises; it never carries on on
the CPU. Random draws go through the draw seam (``common.rng``); ``draws=``
swaps in another implementation of it.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): ``replicas > 1`` and standing queries (A5), ``prefilter: true``
(A6), the process worker backend (A7). Every query takes the single-pool
path, which the reference's own oracle makes bit-identical to its
persisted k-center state path, so that state cache is reported inactive.
"""
from __future__ import annotations

import concurrent.futures as cf
import os
import shutil
import tempfile
import threading
import time
import uuid
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.common import rng as rnglib
from repro_torch.core.agent.controller import run_pshea
from repro_torch.core.selection import ColumnSpill, ShardColumns, grow_append
from repro_torch.core.strategies.zoo import HYBRIDS, PAPER_SEVEN, get_strategy
from repro_torch.service.backends import (FeatureBackend, HeadState,
                                          make_backend)
from repro_torch.service.batcher import DynamicBatcher
from repro_torch.service.cache import EmbeddingCache, content_key
from repro_torch.service.config import ALServiceConfig
from repro_torch.service.errors import ServerOverloaded
from repro_torch.service.pipeline import Stage, StagePipeline

DEFAULT_SESSION = "default"


def _strategy_seed(strategy: str, round_index: int) -> int:
    """Deterministic per-(strategy, round) rng stream. Independent of how
    many candidates are live and of the order they execute in — the property
    that makes parallel PSHEA bit-identical to the serial schedule."""
    return zlib.crc32(f"{strategy}/{round_index}".encode())


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue {item})")


class PushTicket:
    """Client-side future for ``push_data(asynchronous=True)``.

    ``keys`` (content hashes) are known at enqueue time. ``result()``
    blocks until the session's ingest worker has embedded and appended the
    batch (in-process mode) or until the server acknowledged the enqueue
    (TCP mode); either way ``flush()`` is the hard integration barrier.
    ``result(timeout=...)`` raises ``TimeoutError`` once the deadline
    passes, and at once if the ingest worker serving this push has died.
    """

    _POLL_S = 0.1     # liveness re-check cadence while blocked on result()

    def __init__(self, keys: Sequence[str], future: "cf.Future",
                 worker_alive: Optional[Callable[[], bool]] = None):
        self.keys = list(keys)
        self._future = future
        self._worker_alive = worker_alive

    def done(self) -> bool:
        return self._future.done()

    def result(self, timeout: Optional[float] = None) -> List[str]:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            wait = self._POLL_S
            if deadline is not None:
                wait = max(0.0, min(wait, deadline - time.monotonic()))
            try:
                self._future.result(wait)
                return self.keys
            except cf.TimeoutError:
                # cf.TimeoutError IS TimeoutError: a future that FAILED with
                # one must propagate, not be mistaken for a poll
                if self._future.done():
                    raise
            if self._worker_alive is not None and not self._worker_alive():
                raise TimeoutError(
                    "ingest worker died before integrating this push; "
                    "the session is unusable for async ingest") from None
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"push not integrated within {timeout}s (ingest queue "
                    f"busy or stalled); flush() is the hard barrier"
                ) from None


class ALSession:
    """Per-tenant AL state: pool, labels, head, oracle, artifact column."""

    def __init__(self, server: "ALServer", session_id: str):
        self.server = server
        self.session_id = session_id
        self._keys: List[str] = []
        self._raw: Dict[str, np.ndarray] = {}
        self._labels: Dict[str, int] = {}
        self._labeled_keys: List[str] = []
        self._head: Optional[HeadState] = None
        self._eval_set: Optional[tuple] = None
        self._oracle: Optional[Callable[[Sequence[str]], Sequence[int]]] = None
        self._lock = threading.RLock()
        self.last_pipeline_stats = None
        # -- incremental pool-artifact engine (one shard) -----------------
        #   rows appended -> rows_epoch moves; refresh embeds ONLY the
        #     appended rows into the growable feats buffer;
        #   train_and_eval -> head_version moves; refresh re-runs the head
        #     over cached feats, ZERO re-embeds;
        #   label -> labels_version moves; artifacts untouched.
        self.pool_version = 0
        self.head_version = 0
        self.labels_version = 0
        self.artifact_builds = 0
        self.full_builds = 0
        self.delta_builds = 0
        self.probs_refreshes = 0
        cfg = server.config
        self._spill: Optional[ColumnSpill] = None
        if int(cfg.shard_ram_bytes) > 0:
            base = cfg.shard_spill_dir or os.path.join(
                tempfile.gettempdir(), "repro-shard-spill")
            self._spill = ColumnSpill(
                os.path.join(base, f"{os.getpid()}-{uuid.uuid4().hex[:8]}"),
                int(cfg.shard_ram_bytes))
        self._col = ShardColumns(self._spill)
        self._index: Dict[str, int] = {}           # key -> row
        self._artifact_lock = threading.RLock()
        # -- async ingest queue -----------------------------------------
        self._ingest_queue: List[tuple] = []
        self._ingest_cv = threading.Condition()
        self._ingest_busy = False
        self._ingest_thread: Optional[threading.Thread] = None
        self._ingest_stop = False
        self._ingest_error: Optional[BaseException] = None
        self._ingest_rows = 0
        self._ingest_bytes = 0
        self._ingest_rows_hw = 0
        self._ingest_bytes_hw = 0
        self._ingest_depth_hw = 0
        self._ingest_shed = 0
        self._ingest_drain_ema_s = 0.05   # smoothed per-batch drain time
        self.ingest_batches = 0

    # ------------------------------------------------------------- data --
    def push_data(self, items: Sequence[np.ndarray], pipelined: bool = True,
                  asynchronous: bool = False):
        """Synchronous: embed + append now, return keys. Asynchronous:
        enqueue for the ingest worker and return a ``PushTicket`` whose
        ``keys`` are immediately known (content hashes)."""
        if asynchronous:
            return self._push_async(items)
        self.flush()     # sync pushes order AFTER every pending async push
        keys = [content_key(np.asarray(it)) for it in items]
        todo = [(k, it) for k, it in zip(keys, items)
                if k not in self.server.cache]
        with self._lock:
            self._append_rows(keys, [np.asarray(it) for it in items])
        if todo:
            self.last_pipeline_stats = self.server._process(
                todo, pipelined=pipelined)
        return keys

    def _append_rows(self, keys: Sequence[str],
                     items: Sequence[np.ndarray]) -> None:
        """Append the new (key, raw) rows; ONE rows_epoch and pool_version
        tick per appending event. Caller holds ``self._lock``."""
        appended = False
        for k, it in zip(keys, items):
            if k in self._raw:
                continue
            self._raw[k] = it
            self._keys.append(k)
            self._index[k] = len(self._col.keys)
            self._col.keys.append(k)
            appended = True
        if appended:
            self._col.rows_epoch += 1
            self.pool_version += 1

    # ----------------------------------------------------- async ingest --
    def _push_async(self, items: Sequence[np.ndarray]) -> PushTicket:
        items = [np.asarray(it) for it in items]
        keys = [content_key(it) for it in items]
        rows = len(items)
        nbytes = sum(int(it.nbytes) for it in items)
        cfg = self.server.config
        policy = cfg.ingest_policy
        if policy not in ("block", "shed"):
            raise ValueError(f"ingest_policy must be 'block' or 'shed', "
                             f"got {policy!r}")
        fut: cf.Future = cf.Future()
        with self._ingest_cv:
            if self._ingest_stop:
                raise RuntimeError(f"session {self.session_id!r} is closed")
            while self._ingest_over_cap(rows, nbytes):
                if policy == "shed":
                    self._ingest_shed += 1
                    raise ServerOverloaded(
                        self._ingest_retry_after(),
                        f"ingest queue full ({self._ingest_rows} rows / "
                        f"{self._ingest_bytes} bytes outstanding); "
                        f"retry after the worker drains")
                t = self._ingest_thread
                if t is not None and not t.is_alive():
                    raise RuntimeError(
                        "ingest worker died with the queue at capacity; "
                        "the session cannot drain")
                self._ingest_cv.wait(timeout=0.1)
                if self._ingest_stop:
                    raise RuntimeError(
                        f"session {self.session_id!r} is closed")
            self._ingest_rows += rows
            self._ingest_bytes += nbytes
            self._ingest_rows_hw = max(self._ingest_rows_hw,
                                       self._ingest_rows)
            self._ingest_bytes_hw = max(self._ingest_bytes_hw,
                                        self._ingest_bytes)
            self._ingest_queue.append((keys, items, fut))
            self._ingest_depth_hw = max(self._ingest_depth_hw,
                                        len(self._ingest_queue))
            if self._ingest_thread is None:
                self._ingest_thread = threading.Thread(
                    target=self._ingest_loop, daemon=True,
                    name=f"ingest-{self.session_id}")
                self._ingest_thread.start()
            self._ingest_cv.notify_all()
        return PushTicket(keys, fut, worker_alive=self._ingest_alive)

    def _ingest_over_cap(self, rows: int, nbytes: int) -> bool:
        """True when admitting (rows, nbytes) would exceed a configured
        cap; an oversize single push is admitted when nothing is
        outstanding. Caller holds ``_ingest_cv``."""
        if self._ingest_rows == 0 and self._ingest_bytes == 0:
            return False
        cfg = self.server.config
        max_rows = int(cfg.ingest_max_rows)
        max_bytes = int(cfg.ingest_max_bytes)
        return ((max_rows > 0 and self._ingest_rows + rows > max_rows)
                or (max_bytes > 0
                    and self._ingest_bytes + nbytes > max_bytes))

    def _ingest_retry_after(self) -> float:
        batches = (len(self._ingest_queue)
                   / max(self.server.config.ingest_batch, 1)
                   + (1 if self._ingest_busy else 0))
        return min(max(self._ingest_drain_ema_s * (batches + 1.0), 0.01),
                   5.0)

    def _ingest_alive(self) -> bool:
        t = self._ingest_thread
        return t is not None and t.is_alive()

    def _ingest_loop(self):
        while True:
            with self._ingest_cv:
                while not self._ingest_queue and not self._ingest_stop:
                    self._ingest_cv.wait()
                if not self._ingest_queue:   # stop requested, queue drained
                    return
                batch = self._ingest_queue[:self.server.config.ingest_batch]
                del self._ingest_queue[:len(batch)]
                self._ingest_busy = True
            t_drain = time.monotonic()
            err: Optional[BaseException] = None
            try:
                self._integrate(batch)
                for keys, _, fut in batch:
                    fut.set_result(keys)
            except BaseException as batch_err:
                if len(batch) == 1:
                    err = batch_err
                    batch[0][2].set_exception(batch_err)
                else:
                    # re-integrate each coalesced push on its own, so one
                    # malformed push cannot drop the rows of valid ones
                    for entry in batch:
                        keys, _, fut = entry
                        try:
                            self._integrate([entry])
                            fut.set_result(keys)
                        except BaseException as one_err:
                            err = one_err
                            fut.set_exception(one_err)
            with self._ingest_cv:
                self._ingest_busy = False
                self.ingest_batches += 1
                self._ingest_rows = max(
                    self._ingest_rows
                    - sum(len(keys) for keys, _, _ in batch), 0)
                self._ingest_bytes = max(
                    self._ingest_bytes
                    - sum(int(it.nbytes) for _, items, _ in batch
                          for it in items), 0)
                dt = time.monotonic() - t_drain
                self._ingest_drain_ema_s += 0.2 * (dt
                                                   - self._ingest_drain_ema_s)
                if err is not None:
                    self._ingest_error = err
                self._ingest_cv.notify_all()

    def _integrate(self, batch: List[tuple]) -> None:
        """Embed + append ONE drained ingest batch; pool_version bumps once
        for the whole batch."""
        todo, seen = [], set()
        for keys, items, _ in batch:
            for k, it in zip(keys, items):
                if k in seen or k in self.server.cache:
                    continue
                seen.add(k)
                todo.append((k, it))
        if todo:
            self.last_pipeline_stats = self.server._process(
                todo, pipelined=True)
        with self._lock:
            self._append_rows(
                [k for keys, _, _ in batch for k in keys],
                [it for _, items, _ in batch for it in items])

    def flush(self, timeout: Optional[float] = None) -> None:
        """Ingest barrier: returns once every previously queued async push
        has been embedded and appended. A failed ingest re-raises here
        (once); a DEAD worker with work pending raises; ``timeout`` bounds
        the wait with ``TimeoutError`` (the backlog stays intact)."""
        if self._ingest_thread is None:
            return
        deadline = (None if timeout is None
                    else time.monotonic() + float(timeout))
        with self._ingest_cv:
            while self._ingest_queue or self._ingest_busy:
                if not self._ingest_thread.is_alive():
                    raise RuntimeError(
                        "ingest worker died with pushes pending; the "
                        "session cannot drain its queue")
                wait = 0.1
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"flush(): ingest queue not drained within "
                            f"{timeout}s ({len(self._ingest_queue)} pushes "
                            f"still pending)")
                    wait = min(wait, remaining)
                self._ingest_cv.wait(timeout=wait)
            if self._ingest_error is not None:
                err, self._ingest_error = self._ingest_error, None
                raise RuntimeError("asynchronous ingest failed") from err

    def close(self) -> None:
        """Stop the ingest worker (drains what is already queued) and
        remove the session's spill directory, if any."""
        with self._ingest_cv:
            self._ingest_stop = True
            self._ingest_cv.notify_all()
        if self._spill is not None:
            t = self._ingest_thread
            if t is not None:
                t.join(timeout=5.0)
            shutil.rmtree(self._spill.directory, ignore_errors=True)

    # ------------------------------------------------------ label/oracle --
    def attach_oracle(self, oracle: Callable[[Sequence[str]], Sequence[int]],
                      eval_x: np.ndarray, eval_y: np.ndarray):
        """Oracle = the paper's human annotator; eval set scores rounds."""
        backend = self.server.backend
        self._oracle = oracle
        ex = backend.preprocess(np.asarray(eval_x))
        self._eval_set = (backend.features(ex), np.asarray(eval_y))

    def label(self, keys: Sequence[str], labels: Sequence[int]):
        """Bumps only ``labels_version``: the unlabeled set is a mask
        applied at query time, so the artifact column survives."""
        self.flush()
        with self._lock:
            changed = False
            for k, y in zip(keys, labels):
                if k not in self._labels:
                    self._labels[k] = int(y)
                    self._labeled_keys.append(k)
                    changed = True
            if changed:
                self.labels_version += 1

    # --------------------------------------------------------- artifacts --
    def _feats_for(self, keys: Sequence[str]) -> np.ndarray:
        """Features for ``keys``, recomputing entries the EmbeddingCache
        evicted from the session's raw copies, in the CANONICAL batch shape
        (``batch_size`` rows, zero-padded), so a recomputed row reproduces
        its ingest-time feature bytes."""
        cache = self.server.cache
        out: Dict[str, np.ndarray] = {}
        missing: List[str] = []
        for k in keys:
            v = cache.get(k)
            if v is None:
                missing.append(k)
            else:
                out[k] = v
        if missing:
            for k in missing:
                if k not in self._raw:
                    cache.require(k)   # no raw copy: canonical KeyError
            bs = max(int(self.server.config.batch_size), 1)
            for s in range(0, len(missing), bs):
                grp = missing[s:s + bs]
                raw = np.stack([np.asarray(self._raw[k]) for k in grp])
                for k, f in zip(grp, self.server._embed_chunk(raw, bs)):
                    f = np.asarray(f)
                    cache.put(k, f)
                    out[k] = f
            self.server.count_embeds(len(missing))
        return np.stack([out[k] for k in keys])

    def _refresh_artifacts(self):
        """Bring the (feats, probs) column up to date, O(change): appended
        rows are embedded and appended; a head bump recomputes probs from
        cached feats (zero re-embeds); rows appended at an unchanged head
        get probs for just the new rows. Caller holds _artifact_lock."""
        backend = self.server.backend
        with self._lock:
            rows, epoch = len(self._col.keys), self._col.rows_epoch
            head = self._head
            head_v = self.head_version
        if head is None:
            head = backend.init_head()
        col = self._col
        if col.feats_epoch == epoch and col.probs_head_epoch == head_v:
            return
        if not self.server.config.incremental_artifacts:
            col.reset()          # debugging fallback: O(pool) rebuilds
        kind = None
        if col.feats_epoch != epoch:
            if col.feats_rows < rows:
                kind = "full" if col.feats_rows == 0 else "delta"
                new = self._feats_for(col.keys[col.feats_rows:rows])
                col.feats, col.feats_rows = grow_append(
                    col.feats, col.feats_rows, new, col.spill)
            col.feats_epoch = epoch
        if col.probs_head_epoch != head_v:
            old = col.probs
            newp = (np.asarray(backend.probs(col.feats[:col.feats_rows],
                                             head))
                    if col.feats_rows else None)
            if newp is not None and col.spill is not None:
                newp = col.spill.adopt(newp)
            col.probs = newp
            if col.spill is not None and old is not None:
                col.spill.release(old)
            col.probs_rows = col.feats_rows
            col.probs_head_epoch = head_v
            kind = kind or "probs"
        elif col.probs_rows < col.feats_rows:
            newp = np.asarray(backend.probs(
                col.feats[col.probs_rows:col.feats_rows], head))
            col.probs, col.probs_rows = grow_append(
                col.probs, col.probs_rows, newp, col.spill)
        col.builds += 1
        self.full_builds += kind == "full"
        self.delta_builds += kind == "delta"
        self.probs_refreshes += kind == "probs"
        self.artifact_builds += 1

    def _artifact_snapshot(self):
        """(feats, probs, rows, key->row index) over the pool — immutable
        row-range views of the incremental column (``artifact_cache:
        true``) or a from-scratch O(pool) build (``artifact_cache: false``,
        the bit-identity oracle)."""
        backend = self.server.backend
        if not self.server.config.artifact_cache:
            return self._build_from_scratch()
        with self._artifact_lock:
            self._refresh_artifacts()
            c = self._col
            return (c.feats_view(backend.feat_dim),
                    c.probs_view(backend.num_classes), c.feats_rows,
                    self._index)

    def _build_from_scratch(self):
        backend = self.server.backend
        with self._lock:
            keys = list(self._col.keys)
            head = self._head
        head = head or backend.init_head()
        if keys:
            feats = self._feats_for(keys)
            probs = backend.probs(feats, head)
        else:
            feats = np.zeros((0, backend.feat_dim), np.float32)
            probs = np.zeros((0, backend.num_classes), np.float32)
        self.artifact_builds += 1
        return feats, probs, len(keys), {k: i for i, k in enumerate(keys)}

    def train_and_eval(self) -> float:
        self.flush()
        keys = list(self._labeled_keys)
        if not keys:
            return 0.0
        backend = self.server.backend
        feats = self._feats_for(keys)
        labels = np.asarray([self._labels[k] for k in keys])
        with self._lock:
            self._head = backend.fit_head(feats, labels, head=None)
            self.head_version += 1
        if self._eval_set is None:  # no eval set: train-set accuracy proxy
            return backend.evaluate(feats, labels, self._head)
        return backend.evaluate(*self._eval_set, self._head)

    # ------------------------------------------------------------- query --
    def query(self, budget: int, strategy: Optional[str] = None,
              target_accuracy: Optional[float] = None, rng_seed: int = 0,
              pshea_workers: Optional[int] = None) -> dict:
        config = self.server.config
        strategy = strategy or config.strategy
        self.flush()
        with self._lock:   # consistent (pool, labels) snapshot
            unlabeled = [k for k in self._keys if k not in self._labels]
        if strategy != "auto":
            return self._query_one(unlabeled, budget, strategy, rng_seed)
        workers = (config.pshea_workers
                   if pshea_workers is None else pshea_workers)
        return self._query_auto(budget,
                                target_accuracy or config.target_accuracy,
                                workers)

    def _query_one(self, unlabeled, budget, strategy, rng_seed) -> dict:
        strat = get_strategy(strategy)
        feats_all, probs_all, n_rows, index = self._artifact_snapshot()
        # a concurrent push_data may have appended keys after this query's
        # snapshot was pinned; score only the rows the snapshot covers
        unlabeled = [k for k in unlabeled
                     if k in index and index[k] < n_rows]
        budget = min(budget, len(unlabeled))
        if budget == 0:    # fully-labeled pool: strategies need >= 1 row
            return {"keys": [], "indices": [], "strategy": strategy,
                    "cache": self.server.cache.stats()}
        rows = np.asarray([index[k] for k in unlabeled], np.int64)
        dev = self.server.device
        labeled_emb = None
        if self._labeled_keys:
            lab_rows = [index[k] for k in self._labeled_keys
                        if k in index and index[k] < n_rows]
            if lab_rows:
                labeled_emb = torch.as_tensor(
                    feats_all[np.asarray(lab_rows, np.int64)], device=dev)
        idx = strat.select(
            rnglib.key(rng_seed, self.server.draws), budget,
            probs=(torch.as_tensor(probs_all[rows], device=dev)
                   if "probs" in strat.needs else None),
            embeddings=(torch.as_tensor(feats_all[rows], device=dev)
                        if "embeddings" in strat.needs else None),
            labeled_embeddings=labeled_emb)
        idx = idx.cpu().numpy()
        return {"keys": [unlabeled[i] for i in idx],
                "indices": idx.tolist(), "strategy": strategy,
                "cache": self.server.cache.stats()}

    def _query_auto(self, budget: int, target_accuracy: float,
                    workers: int) -> dict:
        """PSHEA (paper Alg. 1) — needs an attached oracle."""
        assert self._oracle is not None, "PSHEA needs attach_oracle(...)"
        session = self
        candidates = self.server._auto_candidates()

        class Task:
            """One independent AL line per strategy; the rng stream is a
            pure function of (strategy, round)."""

            def __init__(self):
                self.labeled: Dict[str, List[str]] = {s: [] for s in candidates}
                self.round: Dict[str, int] = {s: 0 for s in candidates}

            def initial_accuracy(self):
                return (session.train_and_eval()
                        if session._labeled_keys else 0.1)

            def select_and_label(self, strategy, round_budget):
                self.round[strategy] += 1
                pool = [k for k in session._keys
                        if k not in self.labeled[strategy]]
                res = session._query_one(
                    pool, round_budget, strategy,
                    _strategy_seed(strategy, self.round[strategy]))
                keys = res["keys"]
                self.labeled[strategy].extend(keys)
                return len(keys)

            def train_and_eval(self, strategy):
                keys = self.labeled[strategy]
                labels = session._oracle(keys)
                feats = session._feats_for(keys)
                head = session.server.backend.fit_head(
                    feats, np.asarray(labels))
                return session.server.backend.evaluate(
                    *session._eval_set, head)

        n_strats = len(candidates)
        round_budget = max(budget // (2 * n_strats), 1)
        result = run_pshea(Task(), candidates,
                           target_accuracy=target_accuracy,
                           budget_max=budget, round_budget=round_budget,
                           max_workers=workers)
        return {"strategy": result.best_strategy,
                "accuracy": result.best_accuracy,
                "stop_reason": result.stop_reason,
                "rounds": result.rounds,
                "eliminated": result.eliminated,
                "history": result.history,
                "budget_spent": result.budget_spent}

    # -------------------------------------------------------------- misc --
    def stats(self) -> dict:
        with self._ingest_cv:
            pending = len(self._ingest_queue) + (1 if self._ingest_busy
                                                 else 0)
            ingest = {
                "pending": pending,
                "rows": self._ingest_rows,
                "bytes": self._ingest_bytes,
                "rows_hw": self._ingest_rows_hw,
                "bytes_hw": self._ingest_bytes_hw,
                "depth_hw": self._ingest_depth_hw,
                "shed": self._ingest_shed,
                "policy": self.server.config.ingest_policy,
                "max_rows": self.server.config.ingest_max_rows,
                "max_bytes": self.server.config.ingest_max_bytes,
            }
        c = self._col
        return {"pool": len(self._keys), "labeled": len(self._labeled_keys),
                "pool_version": self.pool_version,
                "head_version": self.head_version,
                "labels_version": self.labels_version,
                "artifact_builds": self.artifact_builds,
                "artifacts": {
                    "builds": self.artifact_builds,
                    "full_builds": self.full_builds,
                    "delta_builds": self.delta_builds,
                    "probs_refreshes": self.probs_refreshes,
                    "shard_builds": [c.builds],
                    "rows_epoch": [c.rows_epoch],
                    "feats_rows": [c.feats_rows],
                    "head_epoch": self.head_version,
                    "spill_events": (self._spill.spill_events
                                     if self._spill else 0),
                    "spilled_bytes": (self._spill.spilled_bytes
                                      if self._spill else 0),
                },
                "replicas": 1,
                "ingest_pending": pending,
                "ingest_batches": self.ingest_batches,
                "ingest": ingest,
                # every query takes the single-pool path: the persisted
                # k-center state cache is not consulted (ROADMAP queue A5)
                "strategy_state": {
                    "enabled": self.server.config.strategy_state_cache,
                    "active": False},
                "pipeline": self.last_pipeline_stats}


class ALServer:
    """Hosts many ``ALSession`` tenants over one backend + embedding cache.

    All per-pool methods take ``session=`` (a session id from
    ``create_session``); omitted, they address the default session."""

    def __init__(self, config: Optional[ALServiceConfig] = None,
                 config_path: Optional[str] = None,
                 backend: Optional[FeatureBackend] = None,
                 fetch_fn: Optional[Callable] = None,
                 fetch_latency_s: float = 0.0,
                 draws: Optional[Any] = None):
        if config is None:
            config = (ALServiceConfig.from_yaml(config_path)
                      if config_path else ALServiceConfig())
        if int(config.replicas) > 1:
            raise _not_ported("replicas > 1 (replica sharding)", "A5")
        if config.prefilter:
            raise _not_ported("prefilter: true (the centroid prefilter)",
                              "A6")
        if config.worker_backend == "process":
            raise _not_ported("the process worker backend", "A7")
        self.device = torch.device(str(config.device).lower())
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {config.device!r} asked for, but no CUDA device "
                f"is available; set device: cpu to run on the CPU")
        self.config = config
        self.draws = draws if draws is not None else rnglib.DEFAULT_DRAWS
        self.backend = (backend if backend is not None
                        else make_backend(config.model_name, config=config))
        self.cache = EmbeddingCache(config.cache_bytes,
                                    config.cache_spill_dir)
        self.fetch_fn = fetch_fn or (lambda x: x)
        self.fetch_latency_s = fetch_latency_s
        self._sessions: Dict[str, ALSession] = {}
        self._sessions_lock = threading.Lock()
        # op accounting: pool rows run through the feature extractor
        # (batcher padding rows excluded)
        self.embed_rows = 0
        self.embed_calls = 0
        self._embed_lock = threading.Lock()
        # serve_tcp points this at RPCServer.stats
        self._transport_stats: Optional[Callable[[], dict]] = None
        self.create_session(DEFAULT_SESSION)

    def count_embeds(self, rows: int) -> None:
        with self._embed_lock:
            self.embed_rows += int(rows)
            self.embed_calls += 1

    # ---------------------------------------------------------- sessions --
    def create_session(self, session_id: Optional[str] = None) -> str:
        sid = session_id or uuid.uuid4().hex[:16]
        with self._sessions_lock:
            if sid in self._sessions:
                raise ValueError(f"session {sid!r} already exists")
            self._sessions[sid] = ALSession(self, sid)
        return sid

    def session(self, session_id: Optional[str] = None) -> ALSession:
        sid = session_id or DEFAULT_SESSION
        with self._sessions_lock:
            try:
                return self._sessions[sid]
            except KeyError:
                raise KeyError(f"unknown session {sid!r}; call "
                               f"create_session() first") from None

    def close_session(self, session_id: str) -> None:
        if session_id == DEFAULT_SESSION:
            raise ValueError("the default session cannot be closed")
        with self._sessions_lock:
            sess = self._sessions.pop(session_id, None)
        if sess is not None:
            sess.close()

    def session_ids(self) -> List[str]:
        with self._sessions_lock:
            return list(self._sessions)

    # -------------------------------------------- shared feature pipeline --
    def _process(self, todo, *, pipelined: bool, chunk: int = 64):
        bs = max(self.config.batch_size, 1)
        # pad_to_max: every inference batch has the one canonical (bs, ...)
        # shape, so each row's features are independent of its batchmates
        batcher = DynamicBatcher(self._infer_batch, max_batch=bs,
                                 pad_to_max=True)

        def fetch(chunk_items):
            if self.fetch_latency_s:
                time.sleep(self.fetch_latency_s)
            return [(k, self.fetch_fn(v)) for k, v in chunk_items]

        def preprocess(chunk_items):
            ks = [k for k, _ in chunk_items]
            raw = np.stack([np.asarray(v) for _, v in chunk_items])
            return ks, self.backend.preprocess(raw)

        def infer(args):
            ks, batch = args
            feats = batcher.score(list(batch))
            return list(zip(ks, feats))

        stages = [Stage("fetch", fetch), Stage("preprocess", preprocess),
                  Stage("infer", infer)]
        pipe = StagePipeline(stages)
        chunks = [todo[i:i + chunk] for i in range(0, len(todo), chunk)]
        runner = pipe.run if pipelined else pipe.run_serial
        try:
            for out in runner(chunks):
                for k, f in out:
                    self.cache.put(k, np.asarray(f))
        finally:
            batcher.close()
        return pipe.stats()

    def _embed_chunk(self, raw: np.ndarray, bs: int) -> np.ndarray:
        """One canonical embed chunk: preprocess, zero-pad to the one
        ``bs``-row shape, feature forward."""
        x = np.asarray(self.backend.preprocess(raw))
        n = x.shape[0]
        if n < bs:
            x = np.concatenate(
                [x, np.zeros((bs - n,) + x.shape[1:], x.dtype)])
        return np.asarray(self.backend.features(x))[:n]

    def _infer_batch(self, stacked: np.ndarray, n_valid: int):
        feats = self.backend.features(stacked)
        self.count_embeds(n_valid)
        return [feats[i] for i in range(n_valid)]

    def _auto_candidates(self) -> List[str]:
        """The PSHEA agent's strategy registry: the paper's 7, plus the
        weighted fused-round hybrids when configured ("hybrid")."""
        mode = self.config.auto_candidates
        if mode == "hybrid":
            return PAPER_SEVEN + HYBRIDS
        if mode != "paper":
            raise ValueError(f"auto_candidates must be 'paper' or 'hybrid', "
                             f"got {mode!r}")
        return list(PAPER_SEVEN)

    # --------------------------------------- single-tenant facade (compat) --
    def push_data(self, items: Sequence[np.ndarray], pipelined: bool = True,
                  session: Optional[str] = None,
                  asynchronous: bool = False):
        return self.session(session).push_data(items, pipelined=pipelined,
                                               asynchronous=asynchronous)

    def flush(self, session: Optional[str] = None,
              timeout: Optional[float] = None) -> None:
        return self.session(session).flush(timeout=timeout)

    def attach_oracle(self, oracle: Callable[[Sequence[str]], Sequence[int]],
                      eval_x: np.ndarray, eval_y: np.ndarray,
                      session: Optional[str] = None):
        return self.session(session).attach_oracle(oracle, eval_x, eval_y)

    def label(self, keys: Sequence[str], labels: Sequence[int],
              session: Optional[str] = None):
        return self.session(session).label(keys, labels)

    def train_and_eval(self, session: Optional[str] = None) -> float:
        return self.session(session).train_and_eval()

    def query(self, budget: int, strategy: Optional[str] = None,
              target_accuracy: Optional[float] = None, rng_seed: int = 0,
              session: Optional[str] = None,
              pshea_workers: Optional[int] = None) -> dict:
        return self.session(session).query(budget, strategy, target_accuracy,
                                           rng_seed, pshea_workers)

    def standing_register(self, *args, **kwargs):
        raise _not_ported("standing queries", "A5")

    standing_cancel = standing_poll = standing_register

    @property
    def last_pipeline_stats(self):
        return self.session().last_pipeline_stats

    def stats(self, session: Optional[str] = None) -> dict:
        s = self.session(session).stats()
        s["cache"] = self.cache.stats()
        s["embeds"] = {"rows": self.embed_rows, "calls": self.embed_calls}
        s["sessions"] = len(self.session_ids())
        s["workers"] = {"backend": "inline", "lanes": 0, "tasks": 0,
                        "restarts": 0, "straggler_events": 0}
        s["device"] = str(self.device)
        ts = self._transport_stats
        s["admission"] = (ts() if ts is not None else {"enabled": False})
        return s
