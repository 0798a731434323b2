# Copied from repro/service/cache.py; imports renamed.
"""Content-addressed embedding/logit cache (paper §3.3 'data cache').

Keyed by content hash so re-pushed samples never recompute embeddings —
public clouds separate storage and compute, so the paper keeps processed
samples close to the workers. LRU-bounded in RAM with optional zstd disk
spill (evicted entries remain retrievable).
"""
from __future__ import annotations

import collections
import hashlib
import os
import pickle
import threading
from typing import Any, Dict, Optional

import numpy as np

try:
    import zstandard as zstd
except ImportError:  # pragma: no cover
    zstd = None


def content_key(data) -> str:
    if isinstance(data, np.ndarray):
        h = hashlib.sha1(data.tobytes())
        h.update(str(data.shape).encode())
        h.update(str(data.dtype).encode())
    else:
        h = hashlib.sha1(bytes(data))
    return h.hexdigest()


class EmbeddingCache:
    def __init__(self, max_bytes: int = 1 << 30,
                 spill_dir: Optional[str] = None):
        self.max_bytes = max_bytes
        self.spill_dir = spill_dir
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)
        self._lru: "collections.OrderedDict[str, Any]" = collections.OrderedDict()
        self._sizes: Dict[str, int] = {}
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.spills = 0
        self.spill_bytes = 0     # compressed bytes written to spill files

    @staticmethod
    def _size(value) -> int:
        if isinstance(value, np.ndarray):
            return int(value.nbytes)
        if isinstance(value, (list, tuple)):
            return sum(int(v.nbytes) if isinstance(v, np.ndarray)
                       else len(pickle.dumps(v)) for v in value)
        if isinstance(value, dict):
            return sum(int(v.nbytes) if isinstance(v, np.ndarray)
                       else len(pickle.dumps(v)) for v in value.values())
        return len(pickle.dumps(value))

    def put(self, key: str, value) -> None:
        size = self._size(value)
        evicted = []
        with self._lock:
            if key in self._lru:
                self._bytes -= self._sizes[key]
                del self._lru[key]
            self._lru[key] = value
            self._sizes[key] = size
            self._bytes += size
            while self._bytes > self.max_bytes and len(self._lru) > 1:
                old_key, old_val = self._lru.popitem(last=False)
                self._bytes -= self._sizes.pop(old_key)
                evicted.append((old_key, old_val))
        # zstd compression + disk writes happen OUTSIDE the lock so readers
        # are never blocked behind a spill. Two racing spills of one key can
        # land in either order — safe because keys are content hashes, so
        # every spill of a key carries the same value.
        for old_key, old_val in evicted:
            self._spill(old_key, old_val)

    def get(self, key: str):
        with self._lock:
            if key in self._lru:
                self._lru.move_to_end(key)
                self.hits += 1
                return self._lru[key]
        val = self._unspill(key)
        # counted under the lock: parallel per-shard artifact builds hammer
        # get(), and the hit/miss tallies are part of the served stats now,
        # so lost increments would misreport the cache's effectiveness
        with self._lock:
            if val is not None:
                self.hits += 1
            else:
                self.misses += 1
        if val is not None:
            self.put(key, val)
            return val
        return None

    def require(self, key: str):
        """``get`` that refuses to return None: a miss (entry evicted with
        no spill_dir, or never inserted) raises a clear KeyError instead of
        letting callers feed None into np.stack and crash elsewhere."""
        val = self.get(key)
        if val is None:
            where = ("no spill file found" if self.spill_dir
                     else "no spill_dir configured")
            raise KeyError(f"cache entry {key!r} unavailable: evicted from "
                           f"RAM and {where}; raise cache_bytes or set "
                           f"cache_spill_dir")
        return val

    def __contains__(self, key: str) -> bool:
        with self._lock:
            if key in self._lru:
                return True
        return self.spill_dir is not None and os.path.exists(self._path(key))

    # -- disk spill -------------------------------------------------------
    def _path(self, key: str) -> str:
        return os.path.join(self.spill_dir, key + ".zst")

    def _spill(self, key: str, value) -> None:
        if not self.spill_dir:
            return
        blob = pickle.dumps(value, protocol=4)
        if zstd is not None:
            blob = zstd.ZstdCompressor(level=3).compress(blob)
        # write-then-rename: _unspill reads without the lock, so a spill
        # file must never be observable half-written
        tmp = self._path(key) + f".tmp.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, self._path(key))
        with self._lock:     # racing spills: counters must not lose ticks
            self.spills += 1
            self.spill_bytes += len(blob)

    def _unspill(self, key: str):
        if not self.spill_dir:
            return None
        p = self._path(key)
        if not os.path.exists(p):
            return None
        with open(p, "rb") as f:
            blob = f.read()
        if zstd is not None:
            blob = zstd.ZstdDecompressor().decompress(blob)
        return pickle.loads(blob)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._lru), "bytes": self._bytes,
                    "hits": self.hits, "misses": self.misses,
                    "spills": self.spills,
                    "spill_bytes": self.spill_bytes,
                    "resident_bytes": self._bytes}
