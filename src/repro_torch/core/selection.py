# Port of the host half of repro/core/selection.py: the storage classes
# (replica_of, ShardView, ColumnSpill, grow_append, ShardColumns) are
# copied; the sharded merges and the persisted k-center state are ported
# to torch. The jax mesh half (distributed_top_k, distributed_k_center)
# is ROADMAP A11.
"""Host-level replica sharding (the serving layer's ``replicas: N``).

A pool is hash-partitioned by content key (``replica_of``), each shard
scores its rows on a worker lane, and the merges (``replica_top_k`` for the
uncertainty family, ``replica_greedy_select`` for every greedy/k-center
lineage strategy) are bit-identical to the single-pool path:

  * every per-row computation (distances, uncertainty scores, weights) is
    slice-invariant: a shard's rows produce the floats they would inside
    the full matrix (on the card the selection kernels give every row a
    fixed reduction order, independent of N and of the block size);
  * shard-local row order preserves global pool order, so a shard-local
    argmax tie-break (lowest local index) IS the lowest global index within
    that shard;
  * cross-shard merges order candidates by (value desc, global index asc),
    exactly ``torch.argmax`` / a stable descending sort on the
    concatenated vector.

``ShardColumns`` + ``grow_append`` keep each shard's (feats, probs)
artifact columns in growable append-only buffers with per-column epoch
stamps, so a data change refreshes O(delta) rows on the touched shards
only while queries pin immutable row-range snapshots. ``KCenterStateCache``
persists per-shard k-center min-dist vectors on the same discipline.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import zlib
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch


def replica_of(key: str, replicas: int) -> int:
    """Content-hash shard assignment: stable across pool mutations, so a
    sample lands on the same replica no matter when (or how often) it is
    pushed."""
    return zlib.crc32(key.encode()) % max(int(replicas), 1)


@dataclasses.dataclass
class ShardView:
    """One replica shard's slice of the (unlabeled) pool.

    Rows are in global pool order; ``gidx[i]`` is row ``i``'s position in
    that global order. Preserving the order inside each shard is what makes
    shard-local argmax tie-breaks (lowest local index) compose with the
    cross-shard merge (lowest global index) into exactly the single-pool
    ``jnp.argmax`` rule.
    """
    feats: np.ndarray                 # (n, d)
    probs: Optional[np.ndarray]       # (n, C) or None
    gidx: np.ndarray                  # (n,) int64 global positions
    # -- centroid-prefilter context (optional; None = ungated) ----------
    # the shard's pinned CentroidSummary (core.prefilter), its pool-local
    # row ids for the view rows, the full pinned (rows, d) feats view the
    # summary's permutation indexes into, and the probs head epoch the
    # snapshot was pinned at (gates the summary's cached score caps)
    summary: Optional[Any] = None
    pool_rows: Optional[np.ndarray] = None    # (n,) int64 shard-local rows
    pool_feats: Optional[np.ndarray] = None   # (rows, d) pinned feats view
    probs_epoch: int = -1
    # the device the shard's rows are scored on (the server's)
    device: Any = "cpu"

    @property
    def n(self) -> int:
        return int(self.gidx.shape[0])


class ColumnSpill:
    """mmap-backed allocation for artifact columns past a RAM budget.

    Buffers whose capacity exceeds ``ram_bytes`` are allocated as
    ``np.memmap`` files instead of RAM arrays, so a shard's pool can
    outgrow memory with NO change to the epoch/snapshot contract: the
    append-only discipline means spilled rows are immutable once written,
    and a pinned ``buf[:rows]`` view over a memmap behaves exactly like
    one over a RAM array.

    Files follow the cache's atomic-publish idiom (size via truncate on a
    tmp name, then ``os.replace``) so a killed process never leaves a
    half-sized file for a later reader to map. Unlike the cache's zstd
    spill, columns stay uncompressed — they are live random-access
    mappings, not cold blobs. ``release`` unlinks a superseded buffer's
    file; POSIX keeps the data alive for any still-pinned mapping, so
    snapshot views survive both growth and release.
    """

    def __init__(self, directory: str, ram_bytes: int):
        self.directory = directory
        self.ram_bytes = int(ram_bytes)
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._seq = 0
        self.spill_events = 0       # allocations that went to disk
        self.spilled_bytes = 0      # capacity bytes currently mmap-backed

    def should_spill(self, nbytes: int) -> bool:
        return int(nbytes) > self.ram_bytes

    def allocate(self, shape: Tuple[int, ...], dtype) -> np.memmap:
        dt = np.dtype(dtype)
        nbytes = int(np.prod(shape)) * dt.itemsize
        with self._lock:
            seq = self._seq
            self._seq += 1
        final = os.path.join(self.directory, f"col-{seq:08d}.mmap")
        tmp = final + f".tmp.{os.getpid()}"
        os.makedirs(self.directory, exist_ok=True)   # survive a cleanup race
        with open(tmp, "wb") as f:
            f.truncate(max(nbytes, 1))
        os.replace(tmp, final)
        # open AFTER the rename so the mapping's .filename is the final
        # path — release() unlinks by that name
        m = np.memmap(final, dtype=dt, mode="r+", shape=shape)
        with self._lock:
            self.spill_events += 1
            self.spilled_bytes += nbytes
        return m

    def release(self, arr) -> None:
        """Unlink a superseded buffer's backing file (no-op for RAM
        arrays). Pinned snapshot views keep reading the unlinked data."""
        if not isinstance(arr, np.memmap):
            return
        with self._lock:
            self.spilled_bytes -= int(arr.nbytes)
        try:
            os.unlink(arr.filename)
        except OSError:
            pass

    def adopt(self, arr: np.ndarray) -> np.ndarray:
        """Copy ``arr`` into a fresh mmap buffer when it is past the RAM
        budget; return it unchanged otherwise (whole-buffer allocations
        such as head-refresh probs and summary permutations)."""
        if not self.should_spill(arr.nbytes):
            return arr
        m = self.allocate(arr.shape, arr.dtype)
        m[...] = arr
        return m


def grow_append(buf: Optional[np.ndarray], rows: int, new: np.ndarray,
                spill: Optional[ColumnSpill] = None
                ) -> Tuple[np.ndarray, int]:
    """Append ``new`` rows to a growable buffer; amortized O(rows added).

    Returns ``(buffer, valid_rows)``. Capacity doubles on overflow, so a
    pool built from B-row pushes costs O(N) row copies total instead of the
    O(N^2) of re-stacking the pool per push. The append discipline is what
    makes buffers safe to snapshot concurrently: rows ``[0:rows]`` are
    never rewritten (a reallocation leaves the old buffer intact for any
    pinned view), so a reader holding ``buf[:rows]`` can never observe a
    mutation.

    With ``spill`` (a ``ColumnSpill``), a reallocation whose capacity
    bytes exceed the spill's RAM budget lands in an mmap-backed file
    instead of RAM, and the superseded buffer's file (if any) is
    unlinked — pinned views keep their mapping either way.
    """
    new = np.asarray(new)
    if buf is not None and rows and (buf.shape[1:] != new.shape[1:]
                                     or buf.dtype != new.dtype):
        # appending incompatible rows would either crash the copy or
        # silently cast the old rows — both corrupt the column; fail loud
        raise ValueError(
            f"grow_append: rows of shape {new.shape[1:]}/{new.dtype} "
            f"cannot extend a buffer of {buf.shape[1:]}/{buf.dtype}")
    need = rows + int(new.shape[0])
    if buf is None or buf.shape[0] < need or buf.shape[1:] != new.shape[1:] \
            or buf.dtype != new.dtype:     # latter two only when rows == 0
        cap = max(need, 2 * (0 if buf is None else int(buf.shape[0])), 8)
        shape = (cap,) + new.shape[1:]
        nbytes = int(np.prod(shape)) * new.dtype.itemsize
        if spill is not None and spill.should_spill(nbytes):
            grown = spill.allocate(shape, new.dtype)
        else:
            grown = np.empty(shape, new.dtype)
        if buf is not None and rows:
            grown[:rows] = buf[:rows]
        if spill is not None and buf is not None:
            spill.release(buf)
        buf = grown
    buf[rows:need] = new
    return buf, need


class ShardColumns:
    """Incrementally-maintained artifact columns for ONE replica shard.

    The two columns have decoupled lifetimes, each stamped with the epoch
    it is fresh at:

    ``feats``
        Growable (cap, d) buffer; rows ``[0:feats_rows]`` valid, stamped
        ``feats_epoch`` (the shard's ``rows_epoch`` at refresh). A delta
        refresh embeds ONLY ``keys[feats_rows:]`` and extends the buffer
        in place — O(delta), never a full re-stack.
    ``probs``
        Growable (cap, C) buffer; rows ``[0:probs_rows]`` valid, stamped
        ``probs_head_epoch``. A head bump recomputes all rows from the
        cached feats into a FRESH buffer (zero re-embeds, and pinned
        snapshots keep their old rows); a rows-only change appends probs
        for just the new rows.

    Thread contract: mutated only under the owning session's artifact
    lock; ``keys`` is append-only (appends happen under the session pool
    lock), so slicing it against a captured bound is race-free.
    """

    __slots__ = ("keys", "rows_epoch", "feats", "feats_rows", "feats_epoch",
                 "probs", "probs_rows", "probs_head_epoch", "builds",
                 "spill", "summary", "lineage")

    def __init__(self, spill: Optional[ColumnSpill] = None):
        self.keys: list = []          # shard-local key order == global order
        self.rows_epoch = 0           # bumps per row-appending event
        self.feats: Optional[np.ndarray] = None
        self.feats_rows = 0
        self.feats_epoch = 0
        self.probs: Optional[np.ndarray] = None
        self.probs_rows = 0
        self.probs_head_epoch = -1    # -1 = never computed
        self.builds = 0               # refresh events that touched this shard
        self.spill = spill            # None = RAM-only columns
        self.summary = None           # CentroidSummary (core.prefilter)
        self.lineage = 0              # bumps when rows [0:feats_rows] are
        #                               no longer append-extensions of what a
        #                               cached per-row state saw (reset())

    def reset(self) -> None:
        """Drop both columns (the non-incremental full-rebuild path)."""
        if self.spill is not None:
            self.spill.release(self.feats)
            self.spill.release(self.probs)
            if self.summary is not None:
                self.spill.release(getattr(self.summary, "xperm", None))
        self.feats, self.feats_rows, self.feats_epoch = None, 0, 0
        self.probs, self.probs_rows, self.probs_head_epoch = None, 0, -1
        self.summary = None
        self.lineage += 1

    def feats_view(self, d: int) -> np.ndarray:
        if self.feats is None:
            return np.zeros((0, d), np.float32)
        return self.feats[:self.feats_rows]

    def probs_view(self, c: int) -> np.ndarray:
        if self.probs is None:
            return np.zeros((0, c), np.float32)
        return self.probs[:self.probs_rows]



# ===========================================================================
# Sharded merges
# ===========================================================================

def replica_map(fn: Callable, items: Sequence, executor=None) -> list:
    """Apply ``fn`` to every item — across the shard worker lanes when an
    executor is given (per-shard scoring runs in parallel), serially
    otherwise."""
    items = list(items)
    if executor is None or len(items) <= 1:
        return [fn(it) for it in items]
    return list(executor.map(fn, items))


def replica_total(shards: Sequence[ShardView]) -> int:
    return sum(s.n for s in shards)


def locate_row(shards: Sequence[ShardView], gidx: int) -> Tuple[int, int]:
    """(shard, local row) of a global pool position."""
    for si, s in enumerate(shards):
        j = int(np.searchsorted(s.gidx, gidx))
        if j < s.n and int(s.gidx[j]) == gidx:
            return si, j
    raise IndexError(f"global row {gidx} not on any shard")


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def gather_rows(shards: Sequence[ShardView], rows: Sequence[int],
                arrays: Optional[Sequence[Any]] = None) -> np.ndarray:
    """Gather global pool rows into one host array — the coordinator-side
    collect for warm starts, density references, DBAL's prefiltered subset
    and per-row scalars (``arrays``, numpy or tensors, may have any
    trailing shape; defaults to the shard feature matrices)."""
    if arrays is None:
        arrays = [s.feats for s in shards]
    arrays = [_host(a) for a in arrays]
    out = []
    for g in rows:
        si, li = locate_row(shards, int(g))
        out.append(arrays[si][li])
    if not out:
        return np.zeros((0,) + arrays[0].shape[1:], arrays[0].dtype)
    return np.stack(out)


def stable_top_k(scores: torch.Tensor, k: int):
    """(values, indices) of the ``k`` highest scores, ties to the lower
    index: ``lax.top_k``'s rule, as a stable descending sort."""
    order = torch.sort(scores, descending=True, stable=True)
    return order.values[:k], order.indices[:k]


def replica_top_k(shards: Sequence[ShardView],
                  scores_list: Sequence[torch.Tensor], budget: int,
                  executor=None) -> Tuple[np.ndarray, np.ndarray]:
    """Exact top-k over a sharded score vector.

    Each shard ships only its local top-min(budget, n) candidates; the merge
    orders them by (value desc, global index asc), so the returned
    (indices, values) match the single-pool top-k bit for bit.
    """
    def local(args):
        s, sc = args
        if s.n == 0:
            return np.zeros((0,), np.float32), np.zeros((0,), np.int64)
        v, i = stable_top_k(sc, min(budget, s.n))
        return _host(v), s.gidx[_host(i)]

    parts = replica_map(local, list(zip(shards, scores_list)), executor)
    vals = np.concatenate([p[0] for p in parts])
    gidx = np.concatenate([p[1] for p in parts])
    order = np.lexsort((gidx, -vals))[:budget]
    return gidx[order], vals[order]


def replica_seed_min_dist(shards: Sequence[ShardView],
                          emb_list: Sequence[torch.Tensor], first: int):
    """Per-shard min sq-dists to the seed center at global row ``first``,
    with the seed's own row masked (-1.0) on its home shard — the shared
    init for every greedy loop whose first center is a random draw
    (k-center greedy, BADGE's D² sampling)."""
    from repro_torch.kernels.pairwise import ops
    fsi, fli = locate_row(shards, first)
    seed = emb_list[fsi][fli]
    mind = []
    for i, s in enumerate(shards):
        if s.n == 0:
            mind.append(None)
            continue
        m = ops.sq_dist_to_center(emb_list[i], seed.to(emb_list[i].device))
        if i == fsi:
            m[fli] = -1.0
        mind.append(m)
    return mind


def _merge_proposals(props):
    """Cross-shard winner: max value, ties to the lowest global index —
    the sharded spelling of ``torch.argmax`` over the concatenated
    scores."""
    best = None
    for p in props:
        if p is None:
            continue
        if best is None or p[0] > best[0] or (p[0] == best[0]
                                              and p[1] < best[1]):
            best = p
    return best


def replica_greedy_select(shards: Sequence[ShardView],
                          emb_list: Sequence[torch.Tensor], budget: int, *,
                          mind_list: Sequence[Optional[torch.Tensor]],
                          sel: np.ndarray, start: int,
                          weight_for_slot: Callable[[int, int],
                                                    Optional[torch.Tensor]],
                          executor=None, impl: str = "auto",
                          capture: Optional[list] = None) -> np.ndarray:
    """Local-propose / global-merge greedy rounds over replica shards,
    with per-slot weights (static weights for weighted k-center, fresh
    Gumbel draws per slot for BADGE's D² sampling).

    Per slot: every shard runs ONE fused ``greedy_round`` over its rows
    (min-dist fold + winner masking + local weighted argmax), proposes
    ``(score, global index)``, and the coordinator merge picks the winner.
    ``weight_for_slot(slot, shard)`` supplies the weights ranking the
    candidate for ``slot``. Bit-identical to the single-pool greedy loop:
    the per-row floats are slice-invariant and both tie-break layers reduce
    to the lowest global index.

    ``capture`` (optional list) records the merged winner's score per slot
    in slot order.
    """
    from repro_torch.kernels.pairwise import ops
    nsh = len(shards)
    mind = list(mind_list)

    def propose(i):
        s = shards[i]
        if s.n == 0:
            return None
        sc = ops.masked_weighted_score(mind[i], weight_for_slot(start, i))
        li = int(torch.argmax(sc))
        return (float(sc[li]), int(s.gidx[li]), i, li)

    props = replica_map(propose, range(nsh), executor)
    for slot in range(start, budget):
        v, g, win_shard, win_local = _merge_proposals(props)
        if capture is not None:
            capture.append(float(v))
        sel[slot] = g
        center = emb_list[win_shard][win_local]

        def fold(i, win_shard=win_shard, win_local=win_local,
                 center=center, slot=slot):
            s = shards[i]
            if s.n == 0:
                return None
            x = emb_list[i]
            mask = torch.tensor([win_local if i == win_shard else -1],
                                dtype=torch.int32, device=x.device)
            nm, li, lv = ops.greedy_round(
                x, mind[i], center.to(x.device)[None, :], mask,
                weights=weight_for_slot(slot + 1, i), impl=impl)
            mind[i] = nm
            li = int(li)
            return (float(lv), int(s.gidx[li]), i, li)

        props = replica_map(fold, range(nsh), executor)
    return sel


# ===========================================================================
# Persistent per-session k-center strategy state (O(delta) warm starts)
# ===========================================================================

@dataclasses.dataclass
class KCenterState:
    """One query's view of the persisted min-dist state.

    ``minds[si]`` is the shard's (rows,) float32 min squared distance of
    every POOL row (labeled and unlabeled alike) to the folded center set.
    The arrays are owned by the cache and treated as immutable — consumers
    gather or copy, never write.
    """
    minds: Sequence[np.ndarray]
    rows: Sequence[int]
    capture: Optional[list] = None

    def view_minds(self, shards) -> list:
        """Per-shard min-dists gathered down to the query's (unlabeled)
        view rows, as tensors on each shard's device. Requires
        ``ShardView.pool_rows``. Row gathers reproduce the exact floats a
        from-scratch ``warm_start_min_dist`` over the view would compute:
        per-(row, center) distances are slice-invariant and the min fold
        is exact."""
        out = []
        for i, s in enumerate(shards):
            if s.n == 0:
                out.append(None)
                continue
            out.append(torch.as_tensor(
                self.minds[i][np.asarray(s.pool_rows)], device=s.device))
        return out

    def pool_mind(self, i: int) -> np.ndarray:
        return self.minds[i]


class KCenterStateCache:
    """Per-session persisted k-center min-dist vectors.

    The cache keys per-shard min-dist columns on the same append-only
    discipline as ``ShardColumns``: a vector computed over rows
    ``[0:rows]`` against centers ``locs[:k]`` stays exact when rows are
    appended (extend by folding ALL centers over just the new rows) or
    centers are appended (fold just the new centers over all rows and take
    the elementwise min) — both O(delta), both bitwise equal to a
    from-scratch fold because per-(row, center) squared distances are
    invariant to which other rows/centers share the call and ``min`` is an
    exact, order-independent fold. Validity stamps:

      * shard ``lineage`` — a ``ShardColumns.reset()`` invalidates the
        shard;
      * ``head_version`` — a head retrain invalidates everything;
      * center ``locs`` prefix — cached center order must be a prefix of
        the query's fold order, else rebuild.

    The folds run on ``device`` (the server's); the vectors are kept on
    the host. Thread contract: ``prepare`` is the only mutator and
    serializes on an internal lock; handed-out arrays are never written
    again.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._minds: dict = {}       # si -> np (rows,) f32
        self._rows: dict = {}        # si -> int
        self._lineage: dict = {}     # si -> int
        self._locs: tuple = ()       # ((si, li), ...) centers in fold order
        self._head_version = -1
        self.counters = {
            "rebuilds": 0, "extends": 0, "center_extends": 0,
            "invalidations": 0, "hits": 0,
            "rows_extended": 0, "rows_reused": 0,
        }

    def _drop_all(self):
        if self._minds or self._locs:
            self.counters["invalidations"] += 1
        self._minds, self._rows, self._lineage = {}, {}, {}
        self._locs = ()

    def invalidate(self) -> None:
        """Head retrain: min-dists are conservatively dropped on every
        shard; feats columns are untouched so nothing re-embeds."""
        with self._lock:
            self._drop_all()
            self._head_version = -1

    def stats(self) -> dict:
        with self._lock:
            return dict(self.counters)

    def prepare(self, *, feats_l, rows_l, lineages, head_version, locs,
                centers, capture=None,
                device="cpu") -> Optional[KCenterState]:
        """Produce this query's :class:`KCenterState`, reusing cached
        vectors where the stamps allow and folding only the row/center
        deltas. ``centers[k]`` must be the feats row at ``locs[k]``."""
        from repro_torch.kernels.pairwise import ops
        locs = tuple(tuple(p) for p in locs)
        k = len(locs)
        if k == 0:
            return None
        centers = np.asarray(centers, np.float32)
        nsh = len(feats_l)

        def fold(rows_x, cs) -> np.ndarray:
            return ops.warm_start_min_dist(
                torch.as_tensor(np.ascontiguousarray(rows_x), device=device),
                torch.as_tensor(cs, device=device)).cpu().numpy()

        with self._lock:
            if head_version != self._head_version:
                self._drop_all()
                self._head_version = head_version
            kc = len(self._locs)
            if self._locs != locs[:kc]:
                # non-prefix center reorder: exactness is unprovable
                # incrementally
                self._drop_all()
                kc = 0
            new_centers = centers[kc:]
            reused = False
            minds, rows_out = [], []
            for si in range(nsh):
                rows = int(rows_l[si])
                feats = np.asarray(feats_l[si])[:rows]
                m = self._minds.get(si)
                if m is not None and self._lineage.get(si) != lineages[si]:
                    self.counters["invalidations"] += 1
                    m = None
                if m is None:
                    m = fold(feats, centers) if rows \
                        else np.zeros((0,), np.float32)
                    self.counters["rebuilds"] += 1
                else:
                    reused = True
                    rc = int(self._rows[si])
                    if len(new_centers) and rc:
                        # center delta: fold only the new centers over the
                        # cached rows; elementwise min == one joint fold
                        m = np.minimum(m[:rc], fold(feats[:rc], new_centers))
                        self.counters["center_extends"] += 1
                    if rows > rc:
                        # row delta: fold ALL centers over just the new rows
                        m = np.concatenate([m[:rc],
                                            fold(feats[rc:rows], centers)])
                        self.counters["extends"] += 1
                        self.counters["rows_extended"] += rows - rc
                    self.counters["rows_reused"] += min(rows, rc)
                if rows >= int(self._rows.get(si, -1)):
                    # store the newest view (a raced query pinned at older
                    # rows serves a slice without shrinking the cache)
                    self._minds[si] = m
                    self._rows[si] = max(rows, int(self._rows.get(si, 0)))
                    self._lineage[si] = lineages[si]
                minds.append(m[:rows])
                rows_out.append(rows)
            self._locs = locs
            if reused:
                self.counters["hits"] += 1
            return KCenterState(minds=minds, rows=rows_out, capture=capture)
