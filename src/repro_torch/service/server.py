"""ALServer — the paper's AL-as-a-service backend (Fig. 1), multi-tenant
(port of repro/service/server.py).

One ``ALServer`` owns the *shared* resources — scorer backend on one
device, the content-addressed ``EmbeddingCache``, config, the shard-worker
lanes — and hosts many independent ``ALSession`` objects (one per
client/tenant). A session carries the pool key list, raw copies, labels,
the trained head, the oracle, and incremental per-shard artifact columns.

Data path (stage-level pipeline, Fig. 3c):
  fetch (URI/bytes -> raw)  ->  preprocess  ->  infer (batched features via
  DynamicBatcher)  ->  EmbeddingCache

Query path:
  strategy != "auto": run one zoo strategy over the pooled artifacts, on
  the server's device (the k-center rounds and DBAL's assignment run the
  port's CUDA kernels there).
  strategy == "auto": run the PSHEA agent (performance predictor +
  successive halving) against the attached oracle, per paper Alg. 1.

Replica sharding (config ``replicas: N``): each session's pool is
hash-partitioned by content key across N shards, each with its own
artifact columns. Artifacts are built per shard on the shard-worker lanes
(``distributed.worker``: supervised, straggler-timed, restartable; with
``worker_backend: process`` each lane's re-embeds run as ``embed_batch``
jobs in a spawned process of its own, bit for bit the in-process bytes),
every query strategy runs its replica-sharded path (local
propose, global merge — core.selection), and selections are bit-identical
to ``replicas: 1``. ``prefilter: true`` gates the uncertainty top-k and the
unweighted k-center lineage through per-shard centroid summaries
(core.prefilter), and warm-started k-center queries reuse the session's
persisted min-dist vectors (``KCenterStateCache``); both ride the sharded
path, so either routes a query through it even at ``replicas: 1``.

Standing queries (``standing_register`` / ``_poll`` / ``_cancel``): a
registered ``(budget, strategy)`` subscription re-emits after every
integrated ingest batch (on the ingest worker) and lazily at a poll after
sync mutations; every emit is the exact one-shot ``query()`` selection at
that moment. A coreset emit over near-duplicate deltas replays the stored
selection against just the delta rows (``_standing_replay``): budget - 1
fused rounds on the device and one readback, O(delta) instead of
O(pool).

The server computes on ``config.device``: "cuda" (the default) or "cpu".
A cuda server on a machine without a GPU raises; it never carries on on
the CPU. Random draws go through the draw seam (``common.rng``); ``draws=``
swaps in another implementation of it.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os
import shutil
import tempfile
import threading
import time
import uuid
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common import rng as rnglib
from repro_torch.core.agent.controller import run_pshea
from repro_torch.core.prefilter import PrefilterConfig, maintain_summary
from repro_torch.core.selection import (ColumnSpill, KCenterStateCache,
                                        ShardColumns, ShardView, grow_append,
                                        replica_map, replica_of)
from repro_torch.core.strategies.zoo import HYBRIDS, PAPER_SEVEN, get_strategy
from repro_torch.distributed.worker import (PhaseFailureInjector,
                                            ShardWorkerPool)
from repro_torch.service.backends import (FeatureBackend, HeadState,
                                          make_backend)
from repro_torch.service.batcher import DynamicBatcher
from repro_torch.service.cache import EmbeddingCache, content_key
from repro_torch.service.config import ALServiceConfig
from repro_torch.service.errors import ServerOverloaded
from repro_torch.service.pipeline import Stage, StagePipeline

DEFAULT_SESSION = "default"

# strategies whose sharded path starts from a warm (labeled-centers)
# min-dist fold — the ones the persisted KCenterStateCache can feed
_WARM_STATE_STRATEGIES = frozenset({"coreset", "weighted_kcenter"})


def _strategy_seed(strategy: str, round_index: int) -> int:
    """Deterministic per-(strategy, round) rng stream. Independent of how
    many candidates are live and of the order they execute in — the property
    that makes parallel PSHEA bit-identical to the serial schedule."""
    return zlib.crc32(f"{strategy}/{round_index}".encode())


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


class StandingQuery:
    """One registered ``(budget, strategy)`` subscription on a session.

    Every emit is the EXACT selection a one-shot ``query()`` would return
    over the pool at that moment (emits carry added/removed diffs against
    the previous emit), so the final emit after the stream settles equals
    a one-shot query over the final pool. Between emits the replay engine
    (``ALSession._standing_replay``) keeps the previous selection plus the
    per-slot merged winner scores captured by ``replica_greedy_select``;
    when no delta row beats any recorded winner, the selection is provably
    unchanged and the emit streams only the delta rows.

    All mutable fields are guarded by ``lock``; an emit holds it end to
    end, so concurrent triggers (ingest worker + a poll) serialize and the
    second sees fresh versions and stays quiet.
    """

    def __init__(self, qid: str, budget: int, strategy: str, rng_seed: int):
        self.qid = qid
        self.budget = int(budget)
        self.strategy = strategy
        self.rng_seed = int(rng_seed)
        self.lock = threading.RLock()
        self.emits: List[dict] = []
        self.seq = 0
        self.cancelled: Optional[str] = None      # cancellation reason
        self.error: Optional[BaseException] = None
        # -- replay state (valid when the last emit used the full budget) --
        self.keys: Optional[List[str]] = None     # last emitted selection
        self.values: Optional[List[float]] = None  # per-slot winner scores
        self.n_unlabeled = 0      # unlabeled-list length at the last emit
        self.pool_version = -1
        self.labels_version = -1
        self.head_version = -1


def replay_holds(x: torch.Tensor, mind: torch.Tensor,
                 centers: torch.Tensor, values: Sequence[float]) -> bool:
    """Whether a stored k-center selection survives appended rows.

    ``x`` (n, d) are the appended rows, ``mind`` (n,) their min sq-dists to
    the warm-start centers, ``centers`` (budget - 1, d) the stored picks in
    slot order, ``values`` the stored per-slot winner scores. Slot j is
    displaced iff the best appended row's score after folding centers
    0..j-1 STRICTLY beats ``values[j]`` (a tie loses on the higher global
    index every appended row has). The reference folds one round a slot
    and reads each round's max back; here every round's max stays on the
    device (a fused round leaves it in its output), the ``budget`` maxima
    come back in one copy, and the first displaced slot decides — the same
    decision, since a round after the first displaced slot changes nothing
    the answer reads. ``values`` are ``float()`` of fp32 scores, so the
    fp32 comparison is exact."""
    from repro_torch.kernels.pairwise import ops
    no_mask = torch.full((1,), -1, dtype=torch.int32, device=x.device)
    best = [ops.masked_weighted_score(mind).max()]
    for j in range(centers.shape[0]):
        mind, _, lv = ops.greedy_round(x, mind, centers[j:j + 1], no_mask)
        best.append(lv)
    maxima = torch.stack(best).cpu()           # the emit's one readback
    want = torch.tensor(list(values)[:len(best)], dtype=torch.float32)
    return not bool((maxima > want).any())


class ALSession:
    """Per-tenant AL state: pool, labels, head, oracle, artifact columns."""

    def __init__(self, server: "ALServer", session_id: str):
        self.server = server
        self.session_id = session_id
        self.replicas = max(int(server.config.replicas), 1)
        self._keys: List[str] = []
        self._raw: Dict[str, np.ndarray] = {}
        self._labels: Dict[str, int] = {}
        self._labeled_keys: List[str] = []
        self._head: Optional[HeadState] = None
        self._eval_set: Optional[tuple] = None
        self._oracle: Optional[Callable[[Sequence[str]], Sequence[int]]] = None
        self._lock = threading.RLock()
        self.last_pipeline_stats = None
        # -- incremental pool-artifact engine ---------------------------
        # One ShardColumns per replica shard (ONE shard at replicas=1),
        # epoch-stamped and refreshed incrementally:
        #   rows appended -> only the touched shards' rows_epoch moves;
        #     refresh embeds ONLY the appended rows (growable buffers);
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
        # centroid prefilter (core.prefilter): summaries are maintained
        # alongside the columns when enabled; None = ungated full scans
        self._prefilter_cfg: Optional[PrefilterConfig] = None
        if cfg.prefilter:
            self._prefilter_cfg = PrefilterConfig(
                slack=float(cfg.prefilter_slack),
                clusters=int(cfg.prefilter_clusters),
                min_rows=int(cfg.prefilter_min_rows))
        self._columns = [ShardColumns(self._spill)
                         for _ in range(self.replicas)]
        self._index: Dict[str, Tuple[int, int]] = {}  # key -> (shard, row)
        # RLock: the worker runtime's on_death recovery hook resets a
        # shard's columns from INSIDE a refresh (which already holds the
        # lock on the supervising thread) as well as from query threads
        self._artifact_lock = threading.RLock()
        # worker deaths whose on_death hook reset this session's columns
        self.shard_recoveries = 0
        # persisted k-center strategy state (strategy_state_cache): per-
        # shard min-dist vectors delta-extended on push, dropped on retrain
        self._kstate = KCenterStateCache()
        # -- standing queries -------------------------------------------
        # qid -> StandingQuery; the ingest worker emits after every
        # integrated batch, polls emit lazily for sync mutations
        self._standing: Dict[str, StandingQuery] = {}
        self._standing_lock = threading.Lock()
        self.standing_emits = 0
        self.standing_replay_emits = 0
        self.standing_full_emits = 0
        # replay work: fused rounds launched and device-to-host readbacks
        self.standing_replay_rounds = 0
        self.standing_replay_readbacks = 0
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
        """Append the new (key, raw) rows to the pool and stamp the shards
        they land on: ONE rows_epoch tick per touched shard and ONE
        pool_version tick per appending event. Caller holds
        ``self._lock``."""
        touched = set()
        for k, it in zip(keys, items):
            if k in self._raw:
                continue
            self._raw[k] = it
            self._keys.append(k)
            si = 0 if self.replicas == 1 else replica_of(k, self.replicas)
            col = self._columns[si]
            self._index[k] = (si, len(col.keys))
            col.keys.append(k)
            touched.add(si)
        if touched:
            for si in touched:
                self._columns[si].rows_epoch += 1
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
            # standing-query emits ride the ingest worker: every integrated
            # batch re-emits for each live subscription (still marked busy,
            # so flush()-takers observe the emit as part of the drain).
            # _standing_refresh never raises — an emit failure parks on the
            # query for the next poll to surface
            self._notify_standing()
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
        """Embed + append ONE drained ingest batch: the un-cached items are
        grouped by replica shard and embedded in parallel; pool_version
        bumps once for the whole batch."""
        todo, seen = [], set()
        for keys, items, _ in batch:
            for k, it in zip(keys, items):
                if k in seen or k in self.server.cache:
                    continue
                seen.add(k)
                todo.append((k, it))
        if todo:
            self.last_pipeline_stats = self.server._process_replicated(todo)
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
        remove the session's spill directory, if any. Standing queries are
        cancelled FIRST, so the draining worker integrates the remaining
        pushes without emitting to a subscription whose owner is gone."""
        with self._standing_lock:
            for sq in self._standing.values():
                if sq.cancelled is None:
                    sq.cancelled = "session closed"
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
    def _recover_shard(self, si: int) -> None:
        """Worker-death recovery hook (distributed.worker ``on_death``):
        drop the shard's artifact columns entirely. The retried task then
        rebuilds them through ``_feats_for`` (re-embedding from raw +
        content keys in canonical batches, so the rebuilt bytes and every
        later selection are bit-identical to the no-failure run); the
        lineage bump ``reset()`` performs also invalidates the persisted
        k-center state derived from the lost columns."""
        with self._artifact_lock:
            self._columns[si % self.replicas].reset()
            self.shard_recoveries += 1

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
                feats = self.server._embed_chunk(
                    raw, bs, shard_hint=(replica_of(grp[0], self.replicas)
                                         if self.replicas > 1 else 0),
                    backend=self.server.backend)
                for k, f in zip(grp, feats):
                    f = np.asarray(f)
                    cache.put(k, f)
                    out[k] = f
            self.server.count_embeds(len(missing))
        return np.stack([out[k] for k in keys])

    def _refresh_artifacts(self):
        """Bring every shard's (feats, probs) columns up to date, touched
        shards in parallel on the worker lanes. Caller holds
        _artifact_lock. Per shard, O(change): appended rows are embedded
        and appended; a head bump recomputes probs from cached feats (zero
        re-embeds); rows appended at an unchanged head get probs for just
        the new rows. An untouched shard is a pure cache hit."""
        backend = self.server.backend
        incremental = self.server.config.incremental_artifacts
        with self._lock:   # consistent (row count, epoch) per shard
            targets = [(len(c.keys), c.rows_epoch) for c in self._columns]
            head = self._head
            head_v = self.head_version
        if head is None:
            head = backend.init_head()
        work = [(si, rows, epoch) for si, (rows, epoch) in enumerate(targets)
                if self._columns[si].feats_epoch != epoch
                or self._columns[si].probs_head_epoch != head_v]
        if not work:
            return

        def refresh(item):
            si, rows, epoch = item
            col = self._columns[si]
            if not incremental:
                col.reset()          # debugging fallback: O(shard) rebuilds
            kind = None
            if col.feats_epoch != epoch:
                if col.feats_rows < rows:    # every epoch tick appends rows
                    kind = "full" if col.feats_rows == 0 else "delta"
                    new = self._feats_for(col.keys[col.feats_rows:rows])
                    col.feats, col.feats_rows = grow_append(
                        col.feats, col.feats_rows, new, col.spill)
                col.feats_epoch = epoch
            if col.probs_head_epoch != head_v:
                # head-only refresh: fresh buffer (pinned snapshots keep
                # their rows), computed from cached feats — zero embeds
                old = col.probs
                newp = (np.asarray(backend.probs(
                    col.feats[:col.feats_rows], head))
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
            if self._prefilter_cfg is not None:
                # the centroid summary rides the same epoch discipline:
                # rebuilt only when the tail outgrows the covered prefix,
                # caps refreshed per head bump (copy-on-write)
                col.summary = maintain_summary(
                    col.summary,
                    col.feats[:col.feats_rows] if col.feats_rows else None,
                    col.probs[:col.probs_rows] if col.probs_rows else None,
                    head_epoch=head_v, cfg=self._prefilter_cfg,
                    spill=col.spill, salt=f"{self.session_id}/{si}",
                    device=self.server.device, draws=self.server.draws)
            col.builds += 1
            return kind

        kinds = replica_map(
            refresh, work,
            self.server.shard_scoped("embed", on_death=self._recover_shard,
                                     shard_of=lambda i, it: it[0]))
        self.full_builds += sum(k == "full" for k in kinds)
        self.delta_builds += sum(k == "delta" for k in kinds)
        self.probs_refreshes += sum(k == "probs" for k in kinds)
        self.artifact_builds += 1

    def _artifact_snapshot(self):
        """(feats_l, probs_l, rows_l, key->(shard, row) index) over the
        pool — per-shard immutable row-range views of the incremental
        columns (``artifact_cache: true``) or a from-scratch O(pool) build
        (``artifact_cache: false``, the bit-identity oracle). Rows appended
        after the snapshot is pinned sit beyond ``rows_l``."""
        return self._artifact_snapshot_ex()[:4]

    def _artifact_snapshot_ex(self):
        """``_artifact_snapshot`` plus the prefilter context pinned under
        the SAME lock hold: per-shard summary refs, the probs head epochs
        and the column lineages the snapshot is consistent at."""
        backend = self.server.backend
        if not self.server.config.artifact_cache:
            f, p, r, i = self._build_from_scratch()
            return (f, p, r, i, [None] * self.replicas,
                    [-1] * self.replicas, [0] * self.replicas)
        with self._artifact_lock:
            self._refresh_artifacts()
            cols = self._columns
            return ([c.feats_view(backend.feat_dim) for c in cols],
                    [c.probs_view(backend.num_classes) for c in cols],
                    [c.feats_rows for c in cols], self._index,
                    [c.summary for c in cols],
                    [c.probs_head_epoch for c in cols],
                    [c.lineage for c in cols])

    def _build_from_scratch(self):
        """The O(pool) reference engine: re-gather + re-forward every shard
        on every call, no incremental state consulted."""
        backend = self.server.backend
        with self._lock:
            shard_keys = [list(c.keys) for c in self._columns]
            head = self._head
        head = head or backend.init_head()

        def build(ks):
            if not ks:
                return (np.zeros((0, backend.feat_dim), np.float32),
                        np.zeros((0, backend.num_classes), np.float32))
            feats = self._feats_for(ks)
            return feats, backend.probs(feats, head)

        parts = replica_map(
            build, shard_keys,
            self.server.shard_scoped("embed", on_death=self._recover_shard))
        index: Dict[str, Tuple[int, int]] = {}
        for si, ks in enumerate(shard_keys):
            for li, k in enumerate(ks):
                index[k] = (si, li)
        self.artifact_builds += 1
        return ([p[0] for p in parts], [p[1] for p in parts],
                [len(ks) for ks in shard_keys], index)

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
        # a retrain drops the persisted min-dist vectors on every shard
        # (feats columns are untouched, so nothing re-embeds)
        self._kstate.invalidate()
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

    def _query_one(self, unlabeled, budget, strategy, rng_seed,
                   _capture=None) -> dict:
        if (self.replicas > 1 or self._prefilter_cfg is not None
                or self._use_kstate(strategy)):
            # the prefilter and the persisted k-center state live in the
            # sharded paths (their engines ARE the per-shard propose
            # step), so either routes through them even at replicas=1 —
            # the 1-shard case of the same bit-identical merge
            return self._query_one_sharded(unlabeled, budget, strategy,
                                           rng_seed, _capture=_capture)
        strat = get_strategy(strategy)
        feats_l, probs_l, rows_l, index = self._artifact_snapshot()
        feats_all, probs_all, n_rows = feats_l[0], probs_l[0], rows_l[0]
        # a concurrent push_data may have appended keys after this query's
        # snapshot was pinned; score only the rows the snapshot covers
        unlabeled = [k for k in unlabeled
                     if k in index and index[k][1] < n_rows]
        budget = min(budget, len(unlabeled))
        if budget == 0:    # fully-labeled pool: strategies need >= 1 row
            return self._empty_result(strategy)
        rows = np.asarray([index[k][1] for k in unlabeled], np.int64)
        dev = self.server.device
        labeled_emb = None
        if self._labeled_keys:
            lab_rows = [index[k][1] for k in self._labeled_keys
                        if k in index and index[k][1] < n_rows]
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

    def _empty_result(self, strategy: str) -> dict:
        return {"keys": [], "indices": [], "strategy": strategy,
                "cache": self.server.cache.stats()}

    def _use_kstate(self, strategy: str) -> bool:
        """Whether this query should run with the persisted k-center
        min-dist state. Requires the incremental artifact columns — their
        lineage stamps are what proves a cached vector is still an
        append-extension of the shard's feats."""
        cfg = self.server.config
        return bool(cfg.strategy_state_cache and cfg.artifact_cache
                    and strategy in _WARM_STATE_STRATEGIES)

    def _query_one_sharded(self, unlabeled, budget, strategy,
                           rng_seed, _capture=None) -> dict:
        """One strategy over the replica-sharded pool: per-shard views of
        the unlabeled rows (global order preserved inside each shard) feed
        the strategy's sharded path — selections bit-identical to
        ``replicas=1`` by construction."""
        strat = get_strategy(strategy)
        feats_l, probs_l, rows_l, index, summaries, epochs, lineages = \
            self._artifact_snapshot_ex()

        def covered(k):   # pinned-snapshot bound, per shard
            e = index.get(k)
            return e is not None and e[1] < rows_l[e[0]]

        unlabeled = [k for k in unlabeled if covered(k)]
        budget = min(budget, len(unlabeled))
        if budget == 0:
            return self._empty_result(strategy)
        rows: List[List[int]] = [[] for _ in range(self.replicas)]
        gpos: List[List[int]] = [[] for _ in range(self.replicas)]
        for g, k in enumerate(unlabeled):
            si, li = index[k]
            rows[si].append(li)
            gpos[si].append(g)
        pf_cfg = self._prefilter_cfg
        dev = self.server.device
        shards = []
        for si in range(self.replicas):
            r = np.asarray(rows[si], np.int64)
            summ = summaries[si]
            # a summary older than the pinned view is fine (its tail is
            # scanned in full); one COVERING MORE rows than the view — a
            # racing refresh that rebuilt past our pin — is not usable
            if summ is not None and summ.covered > rows_l[si]:
                summ = None
            shards.append(ShardView(
                feats=feats_l[si][r] if r.size else feats_l[si][:0],
                probs=probs_l[si][r] if r.size else probs_l[si][:0],
                gidx=np.asarray(gpos[si], np.int64),
                summary=summ if pf_cfg is not None else None,
                pool_rows=r, pool_feats=feats_l[si],
                probs_epoch=epochs[si], device=dev))
        labeled_emb = centers = None
        lab: List[Tuple[int, int]] = []
        if self._labeled_keys:
            lab = [index[k] for k in self._labeled_keys if covered(k)]
            if lab:
                centers = np.stack([feats_l[si][li] for si, li in lab])
                labeled_emb = torch.as_tensor(centers, device=dev)
        state = None
        if self._use_kstate(strategy) and labeled_emb is not None:
            state = self._kstate.prepare(
                feats_l=feats_l, rows_l=rows_l, lineages=lineages,
                head_version=self.head_version, locs=lab, centers=centers,
                capture=_capture, device=dev)
        idx = np.asarray(strat.select_sharded(
            rnglib.key(rng_seed, self.server.draws), budget, shards,
            labeled_embeddings=labeled_emb,
            executor=self.server.shard_scoped(
                "propose", on_death=self._recover_shard),
            prefilter=pf_cfg, state=state))
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

    # --------------------------------------------------- standing queries --
    def standing_register(self, budget: int, strategy: Optional[str] = None,
                          rng_seed: int = 0) -> dict:
        """Register a ``(budget, strategy)`` subscription: one initial emit
        now, then the ingest worker re-emits after every integrated batch
        and ``standing_poll`` re-emits lazily after sync mutations. Every
        emit is the exact one-shot ``query()`` selection at that moment."""
        strategy = strategy or self.server.config.strategy
        if strategy == "auto":
            raise ValueError(
                "standing queries need a concrete strategy (the PSHEA "
                "auto agent consumes oracle labels per round)")
        get_strategy(strategy)            # unknown names fail at register
        if int(budget) < 1:
            raise ValueError("standing query budget must be >= 1")
        self.flush()
        sq = StandingQuery(uuid.uuid4().hex[:12], budget, strategy,
                           rng_seed)
        with self._standing_lock:
            self._standing[sq.qid] = sq
        self._standing_refresh(sq)
        with sq.lock:
            if sq.error is not None:
                err = sq.error
                with self._standing_lock:
                    self._standing.pop(sq.qid, None)
                raise RuntimeError(
                    "standing query initial emit failed") from err
            return {"query_id": sq.qid, "seq": sq.seq,
                    "keys": list(sq.keys or [])}

    def standing_cancel(self, query_id: str,
                        reason: str = "cancelled by client") -> None:
        """Cancel a subscription: later emits are suppressed (including
        from an ingest worker mid-drain) and polls raise."""
        sq = self._standing_query(query_id)
        with sq.lock:
            if sq.cancelled is None:
                sq.cancelled = reason

    def standing_poll(self, query_id: str, since: int = 0) -> dict:
        """Emits with ``seq > since`` plus the current cumulative
        selection. Takes the flush() barrier FIRST, so a dead ingest
        worker or a failed async push raises here ticket-style instead of
        the poll serving a stale selection; sync mutations since the last
        emit trigger a fresh emit on this thread."""
        sq = self._standing_query(query_id)
        if sq.cancelled is not None:
            raise RuntimeError(
                f"standing query {query_id} cancelled: {sq.cancelled}")
        self.flush()
        self._standing_refresh(sq)
        with sq.lock:
            if sq.error is not None:
                raise RuntimeError(
                    "standing query emit failed") from sq.error
            emits = [dict(e) for e in sq.emits if e["seq"] > int(since)]
            return {"query_id": query_id, "seq": sq.seq,
                    "keys": list(sq.keys or []), "emits": emits,
                    "pool_version": sq.pool_version,
                    "labels_version": sq.labels_version,
                    "head_version": sq.head_version}

    def _standing_query(self, query_id: str) -> StandingQuery:
        with self._standing_lock:
            sq = self._standing.get(query_id)
        if sq is None:
            raise KeyError(f"unknown standing query {query_id!r}")
        return sq

    def _notify_standing(self) -> None:
        """Ingest-worker hook: re-emit every live subscription after an
        integrated batch. Emit failures park on the query (``sq.error``),
        never kill the worker."""
        with self._standing_lock:
            sqs = [sq for sq in self._standing.values()
                   if sq.cancelled is None]
        for sq in sqs:
            self._standing_refresh(sq)

    def _standing_refresh(self, sq: StandingQuery) -> None:
        """Emit iff the session moved since ``sq``'s last emit. Never
        raises: failures park on ``sq.error`` for the next poll."""
        if sq.cancelled is not None:
            return
        with sq.lock:
            if sq.cancelled is not None:
                return
            try:
                self._standing_emit_locked(sq)
                sq.error = None
            except BaseException as e:
                sq.error = e

    def _standing_emit_locked(self, sq: StandingQuery) -> None:
        """One emit attempt; caller holds ``sq.lock``. Replays the stored
        selection against just the delta rows when provably unchanged,
        otherwise runs the full (equal to ``query()``) path."""
        with self._lock:
            unlabeled = [k for k in self._keys if k not in self._labels]
            pv, lv, hv = (self.pool_version, self.labels_version,
                          self.head_version)
        if sq.keys is not None and (pv, lv, hv) == (
                sq.pool_version, sq.labels_version, sq.head_version):
            return                           # nothing moved: stay quiet
        keys = self._standing_replay(sq, unlabeled, lv, hv)
        if keys is not None:
            mode, values = "replay", sq.values
        else:
            cap: List[float] = []
            res = self._query_one(unlabeled, sq.budget, sq.strategy,
                                  sq.rng_seed, _capture=cap)
            keys, mode = res["keys"], "full"
            values = (cap if len(cap) == sq.budget
                      and len(keys) == sq.budget else None)
        prev = sq.keys or []
        prev_set, new_set = set(prev), set(keys)
        sq.seq += 1
        sq.emits.append({
            "seq": sq.seq, "mode": mode,
            "pool_version": pv, "labels_version": lv, "head_version": hv,
            "keys": list(keys),
            "added": [k for k in keys if k not in prev_set],
            "removed": [k for k in prev if k not in new_set]})
        sq.keys = list(keys)
        sq.values = values
        sq.n_unlabeled = len(unlabeled)
        sq.pool_version, sq.labels_version, sq.head_version = pv, lv, hv
        with self._standing_lock:
            self.standing_emits += 1
            if mode == "replay":
                self.standing_replay_emits += 1
            else:
                self.standing_full_emits += 1

    def _standing_replay(self, sq: StandingQuery, unlabeled, lv,
                         hv) -> Optional[List[str]]:
        """O(delta) emit: prove the stored selection is unchanged over the
        grown pool by streaming ONLY the delta rows, or return None for an
        honest full recompute.

        Eligibility: unweighted warm-started coreset with no prefilter, a
        full-budget previous emit and unchanged labels/head — then the
        previous unlabeled list is an exact prefix of the current one
        (append-only keys), every old row's min-dist trajectory is
        unchanged, and the stored per-slot winner scores remain the max
        over all old rows. ``replay_holds`` then decides the emit with
        budget - 1 fused rounds over the delta rows on the server's
        device."""
        cfg = self.server.config
        if not (cfg.standing_replay and cfg.strategy_state_cache
                and cfg.artifact_cache):
            return None
        if sq.strategy != "coreset" or self._prefilter_cfg is not None:
            return None
        if sq.keys is None or sq.values is None:
            return None
        if (sq.labels_version, sq.head_version) != (lv, hv):
            return None
        if len(sq.keys) != sq.budget or len(sq.values) != sq.budget:
            return None
        n_prev = sq.n_unlabeled
        if len(unlabeled) < n_prev:
            return None
        delta = unlabeled[n_prev:]
        if not delta:
            return list(sq.keys)
        feats_l, _, rows_l, index, _, _, lineages = \
            self._artifact_snapshot_ex()

        def covered(k):
            e = index.get(k)
            return e is not None and e[1] < rows_l[e[0]]

        if not all(covered(k) for k in delta):
            return None                      # racing snapshot: full path
        lab = [index[k] for k in self._labeled_keys if covered(k)]
        if not lab:
            return None
        dev = self.server.device
        state = self._kstate.prepare(
            feats_l=feats_l, rows_l=rows_l, lineages=lineages,
            head_version=self.head_version, locs=lab,
            centers=np.stack([feats_l[si][li] for si, li in lab]),
            device=dev)
        if state is None:
            return None
        if not all(covered(k) for k in sq.keys):
            return None
        # the stored picks the replay folds (the last one never is), the
        # delta rows' persisted min-dists and their embeddings: O(delta)
        # gathers, each copied to the device once
        sel = np.asarray([feats_l[si][li] for si, li in
                          (index[k] for k in sq.keys[:-1])],
                         np.float32).reshape(-1, self.server.backend.feat_dim)
        drows = [index[k] for k in delta]
        mj = torch.as_tensor(np.asarray(
            [state.minds[si][li] for si, li in drows], np.float32),
            device=dev)
        ej = torch.as_tensor(np.stack([feats_l[si][li] for si, li in drows]),
                             dtype=torch.float32, device=dev)
        held = replay_holds(ej, mj, torch.as_tensor(
            sel, dtype=torch.float32, device=dev), sq.values)
        with self._standing_lock:
            self.standing_replay_rounds += sq.budget - 1
            self.standing_replay_readbacks += 1
        return list(sq.keys) if held else None

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
        cols = self._columns
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
                    "shard_builds": [c.builds for c in cols],
                    "rows_epoch": [c.rows_epoch for c in cols],
                    "feats_rows": [c.feats_rows for c in cols],
                    "head_epoch": self.head_version,
                    "spill_events": (self._spill.spill_events
                                     if self._spill else 0),
                    "spilled_bytes": (self._spill.spilled_bytes
                                      if self._spill else 0),
                    # centroid-prefilter summaries per shard (0 = that
                    # shard full-scans: below min_rows or prefilter off)
                    "summary_builds": [
                        (c.summary.builds if c.summary is not None else 0)
                        for c in cols],
                    "summary_covered": [
                        (c.summary.covered if c.summary is not None else 0)
                        for c in cols],
                },
                "replicas": self.replicas,
                # worker deaths recovered by resetting this session's
                # shard columns (re-embed from raw + content keys on retry)
                "worker_recoveries": self.shard_recoveries,
                "ingest_pending": pending,
                "ingest_batches": self.ingest_batches,
                "ingest": ingest,
                # persisted k-center min-dist state (KCenterStateCache)
                "strategy_state": {
                    "enabled": self.server.config.strategy_state_cache,
                    **self._kstate.stats()},
                "standing_queries": self._standing_stats(),
                "pipeline": self.last_pipeline_stats}

    def _standing_stats(self) -> dict:
        with self._standing_lock:
            live = sum(1 for sq in self._standing.values()
                       if sq.cancelled is None)
            return {"registered": len(self._standing), "live": live,
                    "emits": self.standing_emits,
                    "replay_emits": self.standing_replay_emits,
                    "full_emits": self.standing_full_emits,
                    "replay_rounds": self.standing_replay_rounds,
                    "replay_readbacks": self.standing_replay_readbacks}


class ALServer:
    """Hosts many ``ALSession`` tenants over one backend + embedding cache.

    All per-pool methods take ``session=`` (a session id from
    ``create_session``); omitted, they address the default session."""

    def __init__(self, config: Optional[ALServiceConfig] = None,
                 config_path: Optional[str] = None,
                 backend: Optional[FeatureBackend] = None,
                 fetch_fn: Optional[Callable] = None,
                 fetch_latency_s: float = 0.0,
                 draws: Optional[Any] = None,
                 failure_injector: Optional[PhaseFailureInjector] = None):
        if config is None:
            config = (ALServiceConfig.from_yaml(config_path)
                      if config_path else ALServiceConfig())
        self.device = torch.device(str(config.device).lower())
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {config.device!r} asked for, but no CUDA device "
                f"is available; set device: cpu to run on the CPU")
        self.config = config
        self.draws = draws if draws is not None else rnglib.DEFAULT_DRAWS
        # process-backed embed jobs rebuild the backend from the config in
        # the worker process; only valid when OUR backend came from the
        # same config (a hand-constructed backend can't be reproduced)
        self._backend_from_config = backend is None
        self.backend = (backend if backend is not None
                        else make_backend(config.model_name, config=config))
        self.cache = EmbeddingCache(config.cache_bytes,
                                    config.cache_spill_dir)
        self.fetch_fn = fetch_fn or (lambda x: x)
        self.fetch_latency_s = fetch_latency_s
        self.failure_injector = failure_injector
        self._sessions: Dict[str, ALSession] = {}
        self._sessions_lock = threading.Lock()
        self._shard_runtime: Optional[ShardWorkerPool] = None
        self._shard_pool_lock = threading.Lock()
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

    def shard_runtime(self) -> Optional[ShardWorkerPool]:
        """The shard-worker runtime (distributed.worker): one supervised
        lane per replica shard (``worker_backend``: a thread, or a thread
        paired with a spawned process for embed jobs) — straggler-timed,
        failure-injectable, restartable, pinned round-robin to CUDA
        devices on a multi-device host. Lazy; None at replicas=1 (the
        serial path needs no workers)."""
        if self.config.replicas <= 1:
            return None
        with self._shard_pool_lock:
            if self._shard_runtime is None:
                cfg = self.config
                self._shard_runtime = ShardWorkerPool(
                    cfg.replicas, kind=cfg.worker_backend,
                    timeout_s=cfg.worker_timeout_s,
                    max_retries=cfg.worker_retries,
                    backoff_s=cfg.worker_backoff_s,
                    injector=self.failure_injector)
            return self._shard_runtime

    def shard_executor(self) -> Optional[ShardWorkerPool]:
        """``shard_runtime()`` under the reference server's other name
        for it: the worker pool duck-types ``executor.map`` (default
        phase, no recovery hook)."""
        return self.shard_runtime()

    def shard_scoped(self, phase: str, on_death: Optional[Callable] = None,
                     shard_of: Optional[Callable] = None):
        """Phase-scoped executor facade for ``replica_map`` fan-outs: a
        worker death during ``phase`` triggers ``on_death(shard)`` (the
        session's column-reset recovery) before the bounded retry. None at
        replicas=1."""
        rt = self.shard_runtime()
        if rt is None:
            return None
        return rt.scoped(phase, on_death=on_death, shard_of=shard_of)

    def close(self) -> None:
        """Stop every session's ingest worker and the shard-worker lanes."""
        for sid in self.session_ids():
            self.session(sid).close()
        with self._shard_pool_lock:
            rt, self._shard_runtime = self._shard_runtime, None
        if rt is not None:
            rt.shutdown()

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

    def _embed_chunk(self, raw: np.ndarray, bs: int, *, shard_hint: int,
                     backend: FeatureBackend) -> np.ndarray:
        """One canonical embed chunk (preprocess, zero-pad to the one
        ``bs``-row shape, feature forward). On a process-backed worker
        runtime the chunk ships to the shard's paired worker process as the
        registered ``embed_batch`` job — the backend there is rebuilt from
        the SAME config, so the bytes match the in-process path bit for
        bit; any other configuration computes inline."""
        rt = self.shard_runtime()
        if (rt is not None and rt.kind == "process"
                and self._backend_from_config):
            feats = rt.run_job(shard_hint, "embed_batch", {
                "config": dataclasses.asdict(self.config),
                "raw": raw, "bs": bs})
            return np.asarray(feats)
        x = np.asarray(backend.preprocess(raw))
        n = x.shape[0]
        if n < bs:           # zero-pad to the one canonical shape
            x = np.concatenate(
                [x, np.zeros((bs - n,) + x.shape[1:], x.dtype)])
        return np.asarray(backend.features(x))[:n]

    def _infer_batch(self, stacked: np.ndarray, n_valid: int):
        feats = self.backend.features(stacked)
        self.count_embeds(n_valid)
        return [feats[i] for i in range(n_valid)]

    def _process_replicated(self, todo):
        """Embed a drained ingest batch: group items by replica shard and
        run the stage pipeline per shard in parallel on the worker lanes
        (each group rides its own DynamicBatcher). One pipeline at
        replicas=1."""
        replicas = max(self.config.replicas, 1)
        if replicas == 1:
            return self._process(todo, pipelined=True)
        groups = [[] for _ in range(replicas)]
        for k, it in todo:
            groups[replica_of(k, replicas)].append((k, it))
        groups = [g for g in groups if g]
        if len(groups) == 1:
            return self._process(groups[0], pipelined=True)
        # ingest-phase fan-out: a worker killed mid-drain restarts and the
        # group's pipeline retries — cache puts are content-addressed and
        # idempotent, and the rows append only after every group lands
        per_group = list(self.shard_scoped("ingest").map(
            lambda g: self._process(g, pipelined=True), groups))
        # keep the single-pipeline stats shape: sum each stage's counters
        merged = [dict(stage) for stage in per_group[0]]
        for stats in per_group[1:]:
            for agg, stage in zip(merged, stats):
                for field in ("items", "busy_s", "wait_s"):
                    agg[field] += stage[field]
        return merged

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

    def standing_register(self, budget: int, strategy: Optional[str] = None,
                          rng_seed: int = 0,
                          session: Optional[str] = None) -> dict:
        return self.session(session).standing_register(
            budget, strategy, rng_seed)

    def standing_cancel(self, query_id: str,
                        reason: str = "cancelled by client",
                        session: Optional[str] = None) -> None:
        return self.session(session).standing_cancel(query_id, reason)

    def standing_poll(self, query_id: str, since: int = 0,
                      session: Optional[str] = None) -> dict:
        return self.session(session).standing_poll(query_id, since)

    @property
    def last_pipeline_stats(self):
        return self.session().last_pipeline_stats

    def stats(self, session: Optional[str] = None) -> dict:
        s = self.session(session).stats()
        s["cache"] = self.cache.stats()
        s["embeds"] = {"rows": self.embed_rows, "calls": self.embed_calls}
        s["sessions"] = len(self.session_ids())
        rt = self._shard_runtime       # no lazy spin-up just for stats
        s["workers"] = (rt.stats() if rt is not None else {
            "backend": "inline", "lanes": 0, "tasks": 0, "restarts": 0,
            "straggler_events": 0})
        s["device"] = str(self.device)
        ts = self._transport_stats
        s["admission"] = (ts() if ts is not None else {"enabled": False})
        return s
