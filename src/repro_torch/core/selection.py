# Copied from repro/core/selection.py (the numpy-only replica-sharding
# storage half: replica_of, ShardView, ColumnSpill, grow_append,
# ShardColumns); the jax mesh half and the sharded merges are not copied.
"""Host-level replica-shard storage for the serving layer.

``ShardColumns`` + ``grow_append`` keep each shard's (feats, probs)
artifact columns in growable append-only buffers with per-column epoch
stamps, so a data change refreshes O(delta) rows on the touched shards
only while queries pin immutable row-range snapshots.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import zlib
from typing import Any, Optional, Tuple

import numpy as np


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

