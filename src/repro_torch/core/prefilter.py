"""Centroid-gated pool prefilter: sublinear selection over shard pools
(port of repro/core/prefilter.py).

Each shard keeps a ``CentroidSummary`` — k-means centroids over its feats
column, the pool rows permuted into contiguous per-cluster segments,
per-cluster radii, and per-cluster cached uncertainty-score maxima
("caps") stamped with the head epoch they were computed at. Queries then
touch only the pool rows whose cluster survives a bound check:

``gated_greedy_select`` (k-center / Core-Set lineage)
    Per slot, every cluster carries an upper bound on its best score:
    ``ub_j = min(M_j, T_j)`` where ``T_j = (min_c sqrt(d2(cent_j, c)) +
    radius_j)^2`` is the triangle-inequality bound over all folded centers
    ``c`` and ``M_j`` is the cluster's last exactly-computed max (valid
    forever: min-dists only decrease). A best-first loop evaluates
    clusters in descending-``ub`` order and stops once
    ``ub * (1 + slack) < best``. Skipped clusters accumulate *pending*
    centers and catch up (fold the centers they missed) when their bound
    finally fails, so their min-dists are always exact when read.

    Exactness: pending centers fold ONE AT A TIME through the same
    single-center fused round as the ungated path, and ``min`` is exact
    and order-independent — so evaluated rows carry bitwise the min-dists
    the ungated oracle computes, and a loose bound (large ``slack``, every
    cluster always live) reproduces ``prefilter: false`` bit for bit.

``gated_top_k`` (uncertainty family)
    Clusters are scanned in descending order of their cached score cap;
    the scan stops when the cap of the next cluster is strictly below the
    current budget-th best candidate, so the result is ALWAYS bit-identical
    to the full scan. A stale or missing cap falls back to the shard's
    full scan, never to a wrong answer.

Rows appended after the last summary build form the *tail*: always
scanned, folded with the same exact rounds. The summary rebuilds once the
tail outgrows the covered prefix.

Each summary also lays its segments out in gate blocks of ``GATE_ROWS``
rows on the server's device (``xgate_dev``, built once per build), so a
segment is a run of whole gate blocks. An engine keeps its fold state
(segment and tail min-dists, the queued centers, one row each) there for
the whole query and folds a slot's segments in WAVES: one block-masked
round (``ops.gated_greedy_round``) over a run of segments in bound order
(the first wave also one over the tail's rows, which sit in a buffer of
their own), one copy of the pairs to the host, where the reference's
sequential stop rule is replayed; only the folded prefix is committed. The decisions, the floats and the ``pool_rows``
tally are the per-segment loop's (``tests/test_torch_prefilter.py``
keeps that loop as its oracle).
"""
from __future__ import annotations

import dataclasses
import threading
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common import rng as rnglib
from repro_torch.core import selection
from repro_torch.core.strategies.base import shard_tensor
from repro_torch.kernels.pairwise import autotune, ops

BIG = 3.4e38
# rows a gate block of a summary's device layout: each segment is padded
# to whole gate blocks, so one block belongs to one segment
GATE_ROWS = 32


@dataclasses.dataclass(frozen=True)
class PrefilterConfig:
    """The serving config's prefilter knobs (``prefilter: true``)."""
    slack: float = 0.05       # relative bound slack; large = loose = oracle
    clusters: int = 0         # centroids per shard summary; 0 = auto
    min_rows: int = 256       # pools below this skip summaries (full scan)

    def auto_k(self, rows: int) -> int:
        k = self.clusters or min(max(rows // 256, 4), 64)
        return max(1, min(k, rows))


class CentroidSummary:
    """Per-shard centroid summary (immutable once published).

    ``xperm`` is a permuted COPY of the shard's first ``covered`` feats
    rows, contiguous per cluster: cluster ``j`` occupies
    ``xperm[starts[j]:starts[j+1]]`` and ``rowid`` maps each permuted
    position back to its shard-local pool row (ascending within a
    cluster, so within-cluster argmax tie-breaks match pool order).
    ``cents``/``radii`` (f64) anchor the triangle bounds; ``caps`` maps a
    score kind to per-cluster exact maxima over the covered rows, stamped
    with ``caps_head_epoch``. Caps refreshes publish a NEW object sharing
    the geometry arrays.

    ``xgate_dev`` holds the same rows on the server's device, laid out for
    the gated rounds: segment ``j`` starts at row ``gstarts[j]`` and is
    padded with zero rows to a multiple of ``GATE_ROWS``; ``gpos`` maps
    each permuted position to its row there.
    """

    __slots__ = ("k", "cents", "radii", "starts", "rowid", "xperm",
                 "covered", "caps", "caps_head_epoch", "builds", "gstarts",
                 "gpos", "xgate_dev")

    def __init__(self, k, cents, radii, starts, rowid, xperm, covered,
                 xgate_dev, caps=None, caps_head_epoch=-1, builds=0):
        self.k = int(k)
        self.cents = cents                  # (k, d) f64
        self.radii = radii                  # (k,) f64, sqrt-space
        self.starts = starts                # (k+1,) i64 segment offsets
        self.rowid = rowid                  # (covered,) i64 pool rows
        self.xperm = xperm                  # (covered, d) f32 permuted copy
        self.covered = int(covered)
        self.caps: Optional[Dict[str, np.ndarray]] = caps
        self.caps_head_epoch = int(caps_head_epoch)
        self.builds = int(builds)
        self.gstarts, self.gpos = _gate_layout(starts)
        self.xgate_dev = xgate_dev          # (gstarts[-1], d) f32

    def with_caps(self, probs: np.ndarray, head_epoch: int
                  ) -> "CentroidSummary":
        """Copy-on-write caps refresh from the covered probs rows."""
        from repro_torch.core.strategies.uncertainty import SCORE_FNS
        p = torch.as_tensor(np.asarray(probs[:self.covered], np.float32),
                            device=self.xgate_dev.device)
        caps: Dict[str, np.ndarray] = {}
        for kind, fn in SCORE_FNS.items():
            sc = fn(p).cpu().numpy()[self.rowid]      # permuted scores
            cap = np.full(self.k, -np.inf, np.float32)
            for j in range(self.k):
                s, e = int(self.starts[j]), int(self.starts[j + 1])
                if e > s:
                    cap[j] = sc[s:e].max()
            caps[kind] = cap
        return CentroidSummary(self.k, self.cents, self.radii, self.starts,
                               self.rowid, self.xperm, self.covered,
                               self.xgate_dev, caps=caps,
                               caps_head_epoch=head_epoch, builds=self.builds)


def _gate_layout(starts) -> Tuple[np.ndarray, np.ndarray]:
    """Segments padded to whole gate blocks: (each segment's first row,
    each permuted position's row)."""
    starts = np.asarray(starts, np.int64)
    counts = np.diff(starts)
    gstarts = np.zeros(counts.size + 1, np.int64)
    gstarts[1:] = np.cumsum(-(-counts // GATE_ROWS) * GATE_ROWS)
    gpos = (np.arange(int(starts[-1]), dtype=np.int64)
            + np.repeat(gstarts[:-1] - starts[:-1], counts))
    return gstarts, gpos


def build_summary(feats: np.ndarray, k: int, salt: str, spill=None,
                  device="cpu", draws=None) -> CentroidSummary:
    """K-means the shard's feats on ``device`` (fused ``greedy_round``
    seeding and the min/argmin kernel's assignment — the same kernel
    substrate as selection itself) and lay the pool out in cluster
    segments. Deterministic per (salt, rows, k); ``draws`` is the draw
    seam's implementation (``common.rng``; None = the default)."""
    from repro_torch.core.strategies.diversity import _kmeans
    rows, d = feats.shape
    x = torch.as_tensor(np.asarray(feats, np.float32), device=device)
    key = rnglib.key(zlib.crc32(f"{salt}/{rows}/{k}".encode()), draws)
    cents32 = _kmeans(key, x, k, iters=4)
    assign = ops.pairwise_argmin(x, cents32).cpu().numpy()
    cents = cents32.cpu().numpy().astype(np.float64)
    order = np.argsort(assign, kind="stable").astype(np.int64)
    counts = np.bincount(assign, minlength=k)
    starts = np.zeros(k + 1, np.int64)
    starts[1:] = np.cumsum(counts)
    xperm = np.ascontiguousarray(np.asarray(feats, np.float32)[order])
    if spill is not None:
        xperm = spill.adopt(xperm)
    # the gate layout goes to the device once per build, not once per fold
    gstarts, gpos = _gate_layout(starts)
    at = np.empty(rows, np.int64)
    at[order] = gpos                          # pool row -> layout row
    xgate = x.new_zeros((int(gstarts[-1]), d)).index_copy_(
        0, torch.as_tensor(at, device=x.device), x)
    diffs = np.asarray(feats, np.float64) - cents[assign]
    d2 = np.einsum("ij,ij->i", diffs, diffs)
    radii = np.zeros(k, np.float64)
    np.maximum.at(radii, assign, d2)
    return CentroidSummary(k, cents, np.sqrt(radii), starts, order, xperm,
                           covered=rows, xgate_dev=xgate)


def maintain_summary(summary: Optional[CentroidSummary],
                     feats: Optional[np.ndarray],
                     probs: Optional[np.ndarray], head_epoch: int,
                     cfg: PrefilterConfig, spill=None, salt: str = "",
                     device="cpu", draws=None) -> Optional[CentroidSummary]:
    """Incremental summary maintenance: ingest grows the (always-scanned)
    tail and only triggers a rebuild once the tail outgrows the covered
    prefix; a retrain refreshes the score caps from cached probs (zero
    embeds, copy-on-write); labeling touches nothing (caps over a superset
    stay upper bounds)."""
    if feats is None or feats.shape[0] < cfg.min_rows:
        return None
    rows = int(feats.shape[0])
    k = cfg.auto_k(rows)
    if summary is None or summary.k != k \
            or rows - summary.covered > max(summary.covered, cfg.min_rows):
        fresh = build_summary(feats, k, salt, spill, device=device,
                              draws=draws)
        fresh.builds = (0 if summary is None else summary.builds) + 1
        if summary is not None and spill is not None:
            spill.release(summary.xperm)
        summary = fresh
    if probs is not None and probs.shape[0] >= summary.covered \
            and summary.caps_head_epoch != head_epoch:
        summary = summary.with_caps(probs, head_epoch)
    return summary


# ===========================================================================
# Gated uncertainty top-k
# ===========================================================================

def gated_top_k(shards: Sequence, kind: str, budget: int,
                executor=None) -> Tuple[np.ndarray, np.ndarray]:
    """``replica_top_k`` with per-shard cap-ordered cluster scans —
    bit-identical to the full scan by the stopping rule (strictly-below
    caps cannot contribute), at a fraction of the rows scored."""
    from repro_torch.core.strategies.uncertainty import SCORE_FNS
    fn = SCORE_FNS[kind]

    def local(s):
        if s.n == 0:
            return np.zeros((0,), np.float32), np.zeros((0,), np.int64)
        b = min(budget, s.n)
        summ = s.summary
        usable = (summ is not None and summ.caps is not None
                  and kind in summ.caps and s.probs_epoch >= 0
                  and summ.caps_head_epoch == s.probs_epoch
                  and s.pool_rows is not None)
        if not usable:
            # missing/stale summary: exact fallback to the full scan
            ops.record_pool_rows(s.n)
            v, i = selection.stable_top_k(fn(shard_tensor(s, s.probs)), b)
            return v.cpu().numpy(), s.gidx[i.cpu().numpy()]
        pool_rows = np.asarray(s.pool_rows)
        n_pool = (s.pool_feats.shape[0] if s.pool_feats is not None
                  else int(pool_rows.max()) + 1)
        inv = np.full(n_pool, -1, np.int64)
        inv[pool_rows] = np.arange(s.n)
        gidx = np.asarray(s.gidx)
        probs = np.asarray(s.probs)
        cand_v: List[np.ndarray] = []
        cand_g: List[np.ndarray] = []

        def score_rows(view_pos):
            if view_pos.size == 0:
                return
            ops.record_pool_rows(int(view_pos.size))
            v = fn(shard_tensor(s, probs[view_pos])).cpu().numpy()
            cand_v.append(np.asarray(v, np.float32))
            cand_g.append(gidx[view_pos])

        # tail rows (appended after the summary build) carry no cap:
        # always scanned
        score_rows(np.nonzero(pool_rows >= summ.covered)[0])
        caps = summ.caps[kind]
        order = np.argsort(-caps, kind="stable")
        for j in order:
            have = sum(v.size for v in cand_v)
            if have >= b:
                kth = np.partition(np.concatenate(cand_v), have - b)[have - b]
                # strictly below the b-th best: no row in this cluster
                # (score <= cap < kth) can enter or reorder the top-b.
                # Equal caps keep scanning — a tie could still displace
                # on the lower-global-index rule.
                if caps[j] < kth:
                    break
            members = summ.rowid[int(summ.starts[j]):
                                 int(summ.starts[j + 1])]
            vp = inv[members]
            score_rows(vp[vp >= 0])
        vals = np.concatenate(cand_v) if cand_v else np.zeros(0, np.float32)
        gs = np.concatenate(cand_g) if cand_g else np.zeros(0, np.int64)
        take = np.lexsort((gs, -vals))[:b]
        return vals[take], gs[take]

    parts = selection.replica_map(local, shards, executor)
    vals = np.concatenate([p[0] for p in parts])
    gidx = np.concatenate([p[1] for p in parts])
    order = np.lexsort((gidx, -vals))[:budget]
    return gidx[order], vals[order]


# ===========================================================================
# Gated greedy (k-center lineage)
# ===========================================================================

def _bucket(m: int) -> int:
    """The per-segment loop's padded slice length, the next power of two
    (min 8), as the reference pads (there it bounds jit retraces across
    ragged clusters): ``pool_rows`` counts a slice's fold in these rows."""
    p = 8
    while p < m:
        p <<= 1
    return p


# Engine counters (``reset_engine_stats``/``ENGINE_STATS``): ``proposals``
# counts (slot, shard) scans, ``waves`` the folds they made (each one
# ``gated_greedy_round`` launch, and one more for the tail), ``syncs`` the
# transfers that make the host wait for the device (one read of a wave's
# pairs; the blocking uploads of an engine's setup and its first
# centers), ``partial_commits`` the waves that discarded segments folded
# past the stop, ``segments_folded`` the segments committed.
ENGINE_STATS = {"proposals": 0, "waves": 0, "syncs": 0, "partial_commits": 0,
                "segments_folded": 0}
_ENGINE_LOCK = threading.Lock()


def reset_engine_stats() -> None:
    with _ENGINE_LOCK:
        for k in ENGINE_STATS:
            ENGINE_STATS[k] = 0


def _engine_add(**kw) -> None:
    with _ENGINE_LOCK:
        for k, v in kw.items():
            ENGINE_STATS[k] += v


class _ShardEngine:
    """Per-shard gated greedy state: segment min-dists over the summary's
    gate-block layout + the always-live tail's (its rows in gate blocks of
    their own, numbered after the segments'), a queue of folded center
    entries (one device row per center, with its form), and per-segment
    pending cursors / bounds.

    ``propose`` makes the per-segment loop's decisions in its order (the
    tail first, clusters by descending bound, stop at the first
    ``ub * (1 + slack) < best``), but folds a run of segments per
    block-masked round: wave 1 is every segment the stop rule could reach
    given a lower bound on ``best`` known without folding, later waves
    double. The host replays the stop rule on the round's per-block pairs
    and commits only the prefix it folds, so min-dists, ``M``, the pending
    cursors (``seg_pending``, in entries) and ``pool_rows`` are the
    per-segment loop's after every slot. Fold state lives on the shard's
    device."""

    def __init__(self, shard, slack: float, impl: str = "auto",
                 warm_mind=None, warm_centers=None, capacity: int = 64):
        self.impl = impl
        self.slack = float(slack)
        self.device = torch.device(shard.device)
        self.summary: Optional[CentroidSummary] = shard.summary
        feats = (shard.pool_feats if shard.pool_feats is not None
                 else np.asarray(shard.feats))
        self.pool_feats = feats
        n_pool = int(feats.shape[0])
        self.d = d = int(feats.shape[1])
        pool_rows = (np.asarray(shard.pool_rows)
                     if shard.pool_rows is not None
                     else np.arange(n_pool, dtype=np.int64))
        self.gpos = np.full(n_pool, -1, np.int64)
        self.gpos[pool_rows] = np.asarray(shard.gidx)
        in_view = np.zeros(n_pool, bool)
        in_view[pool_rows] = True
        # the queue: entry e is centers [erow[e], erow[e + 1]), e < ne
        self.erow = np.zeros(max(capacity, 1) + 1, np.int64)
        self.ne = 0
        self.centers = torch.empty((max(capacity, 1), d), dtype=torch.float32,
                                   device=self.device)
        self.forms = np.zeros(max(capacity, 1), np.int8)
        self.forms_dev = torch.zeros(max(capacity, 1), dtype=torch.int8,
                                     device=self.device)
        # warm_mind: persisted pool-level min-dists vs warm_centers
        # (core.selection.KCenterState). Segments/tail start from those
        # floats with ZERO entries queued; warm_centers still tighten the
        # triangle bounds exactly as queueing them would.
        if warm_mind is not None:
            assert int(warm_mind.shape[0]) == n_pool
            warm_mind = np.asarray(warm_mind, np.float32)
        summ = self.summary
        self.covered = 0 if summ is None else min(summ.covered, n_pool)
        k = 0 if summ is None else summ.k
        self.k = k
        self.G = GATE_ROWS
        gstarts = np.zeros(1, np.int64) if summ is None else summ.gstarts
        self.x = torch.zeros((0, d), device=self.device)
        m = np.zeros(0, np.float32)
        if summ is not None:
            self.starts = np.asarray(summ.starts)
            self.rowid = np.asarray(summ.rowid)
            self.inv_perm = np.empty(self.covered, np.int64)
            self.inv_perm[self.rowid] = np.arange(self.covered)
            self.lay = summ.gpos                  # permuted pos -> layout row
            view_perm = in_view[self.rowid]
            live = (BIG if warm_mind is None
                    else warm_mind[self.rowid].astype(np.float64))
            m = np.full(int(gstarts[-1]), -1.0, np.float32)
            m[self.lay] = np.where(view_perm, live, -1.0)
            self.x = summ.xgate_dev.to(self.device)
            self.seg_alive = np.array(
                [int(view_perm[int(self.starts[j]):
                               int(self.starts[j + 1])].sum())
                 for j in range(k)])
            self.seg_pending = np.zeros(k, np.int64)
            self.T_sqrt = np.full(k, np.inf, np.float64)
            self.M = np.full(k, np.inf, np.float64)
            # the lower bound's inputs: the nearest pending center to each
            # centroid, and whether M[j] is a live row's exact min-dist
            self.P_sqrt = np.full(k, np.inf, np.float64)
            self.M_exact = np.zeros(k, bool)
            self.seg_len = np.diff(self.starts).astype(np.int64)
            # rows of the per-segment loop's padded slice (pool_rows' unit)
            self.seg_bucket = np.array([_bucket(int(m)) for m in
                                        self.seg_len], np.int64)
        self.mind = self._dev(m)
        # the tail: rows past the covered prefix, always scanned, padded to
        # gate blocks in buffers of their own (its own round each wave 1)
        self.n_tail = n_pool - self.covered
        self.tail_off = int(gstarts[-1])      # the tail's first row number
        tail_pad = -(-self.n_tail // self.G) * self.G
        self.xt = self.mind_t = None
        if self.n_tail:
            tail_live = (BIG if warm_mind is None
                         else warm_mind[self.covered:].astype(np.float64))
            m = np.full(tail_pad, -1.0, np.float32)
            m[:self.n_tail] = np.where(in_view[self.covered:], tail_live,
                                       -1.0)
            self.mind_t = self._dev(m)
            xt = np.zeros((tail_pad, d), np.float32)
            xt[:self.n_tail] = feats[self.covered:]
            self.xt = self._dev(xt)
        self.tail_alive = int(in_view[self.covered:].sum())
        self.tail_pending = 0
        # gate blocks: segment j owns blocks [blk0[j], blk0[j + 1]), the
        # tail (index k) the ns.. ones after them
        self.ns = self.tail_off // self.G
        self.nn = self.ns + tail_pad // self.G
        self.blk0 = np.append(gstarts // self.G, self.nn).astype(np.int64)
        self.blk_seg = np.repeat(np.arange(k + 1), np.diff(self.blk0))
        self.nonempty = np.nonzero(np.diff(self.blk0) > 0)[0]
        # pinned staging for a wave's block vectors (rows 0-1) and its
        # commit mask over the segments' blocks (row 2): uploads that do
        # not make the host wait
        self._stage = (torch.empty((3, self.nn), dtype=torch.int32,
                                   pin_memory=True)
                       if self.device.type == "cuda" else None)
        self.last_folded: List[int] = []
        if warm_mind is not None and warm_centers is not None \
                and len(warm_centers):
            self._tighten(np.asarray(warm_centers, np.float32), pending=False)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A blocking upload (the host waits on the card)."""
        _engine_add(syncs=1)
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def _upload(self, a: np.ndarray, row: int) -> torch.Tensor:
        """(k, nn) int32 to the device through staging rows [row, row + k)
        without a wait: each row set is rewritten only after the wave that
        read it has returned its pairs, so its copy is done."""
        if self._stage is None:
            return torch.as_tensor(np.ascontiguousarray(a, np.int32))
        st = self._stage[row:row + a.shape[0], :a.shape[1]]
        st.numpy()[:] = a
        return st.to(self.device, non_blocking=True)

    # ------------------------------------------------------------ state --
    def row_vec(self, pool_row: int) -> np.ndarray:
        return np.asarray(self.pool_feats[pool_row], np.float32)

    def row_dev(self, pool_row: int) -> torch.Tensor:
        """Pool row ``pool_row`` as a (1, d) view of the device layout."""
        if pool_row >= self.covered:
            r = pool_row - self.covered
            return self.xt[r:r + 1]
        r = int(self.lay[self.inv_perm[pool_row]])
        return self.x[r:r + 1]

    def _queue(self, batch: np.ndarray, rows=None) -> None:
        """Append one entry: its centers as rows of the device queue, each
        in the entry's form (difference for one center, matmul for more,
        as ``greedy_round`` folds an entry). ``rows``: the same centers
        already on a device (copied there without a wait)."""
        r0 = int(self.erow[self.ne])
        r1 = r0 + batch.shape[0]
        if r1 > self.centers.shape[0]:
            cap = max(r1, 2 * self.centers.shape[0])
            grown = torch.empty((cap, self.d), dtype=torch.float32,
                                device=self.device)
            grown[:r0] = self.centers[:r0]
            self.centers = grown
            self.forms = np.concatenate(
                [self.forms, np.zeros(cap - self.forms.shape[0], np.int8)])
            self.forms_dev = self._dev(self.forms)
        if self.ne + 2 > self.erow.shape[0]:
            self.erow = np.concatenate([self.erow, np.zeros_like(self.erow)])
        form = 0 if batch.shape[0] == 1 else 1
        self.centers[r0:r1] = self._dev(batch) if rows is None else rows
        self.forms[r0:r1] = form
        if form:
            self.forms_dev[r0:r1] = form
        self.ne += 1
        self.erow[self.ne] = r1
        self._tighten(batch)

    def add_center(self, vec: np.ndarray, row=None) -> None:
        """Queue one center (``row``: the same (1, d) on a device, copied
        on the caller's stream, which the lanes share)."""
        self._queue(np.asarray(vec, np.float32)[None, :], row)

    def add_warm_start(self, centers: np.ndarray, r_block: int) -> None:
        """Queue init centers in the SAME r_block chunks the ungated
        ``warm_start_min_dist`` folds, so the multi-center matmul path
        produces the identical floats per chunk."""
        c = np.asarray(centers, np.float32)
        for s in range(0, c.shape[0], r_block):
            self._queue(c[s:s + r_block])

    def _tighten(self, batch: np.ndarray, pending: bool = True) -> None:
        if self.summary is None:
            return
        c = np.asarray(batch, np.float64)                  # (R, d)
        diff = self.summary.cents[:, None, :] - c[None, :, :]
        d2 = np.einsum("krd,krd->kr", diff, diff)          # (k, R)
        near = np.sqrt(d2).min(axis=1)
        self.T_sqrt = np.minimum(self.T_sqrt, near + self.summary.radii)
        if pending:
            self.P_sqrt = np.minimum(self.P_sqrt, near)

    def mask_pool_row(self, pool_row: int) -> None:
        if pool_row >= self.covered:
            self.mind_t[pool_row - self.covered] = -1.0
            self.tail_alive -= 1
            return
        xp = int(self.inv_perm[pool_row])
        self.mind[int(self.lay[xp])] = -1.0
        j = int(np.searchsorted(self.starts, xp, side="right")) - 1
        self.seg_alive[j] -= 1
        self.M_exact[j] = False

    # ------------------------------------------------------------ folds --
    def _lower_bound(self) -> float:
        """A lower bound on this slot's best score, known without folding:
        a segment whose ``M`` is a live row's exact min-dist still scores
        at least ``min(M, (dist(centroid, pending center) - radius)^2)``.
        -inf where no segment gives one. It only sizes wave 1."""
        ok = self.M_exact & (self.seg_alive > 0)
        if not ok.any():
            return -np.inf
        gap = np.maximum(self.P_sqrt - self.summary.radii, 0.0)
        lb = np.minimum(self.M, np.square(gap))[ok].max()
        return float(lb) * (1.0 - 1e-6) if lb > 0 else float(lb)

    def _wave(self, segs: np.ndarray, tail: bool):
        """One block-masked round over ``segs``' gate blocks, and one over
        the tail's with ``tail``, out of place. Returns (the segments' new
        min-dists, the tail's, per-block max (nn,) f32, per-block row
        number (nn,) i64) with the pairs on the host; the blocks of a part
        not folded score -inf."""
        on = np.zeros(self.k + 1, bool)
        on[segs] = True
        on[self.k] = tail
        pending = np.empty(self.k + 1, np.int64)
        pending[:self.k] = self.seg_pending if self.k else 0
        pending[self.k] = self.tail_pending
        live = on[self.blk_seg].astype(np.int32)
        pend = self.erow[pending][self.blk_seg].astype(np.int32)
        r = int(self.erow[self.ne])
        vec = self._upload(np.stack([live, pend]), 0)
        ns, parts, nm, nmt = self.ns, [], None, None

        def fold(x, mind, lv, pn, lo):
            return ops.gated_greedy_round(
                x, mind, self.centers[:r], lv, pn, impl=self.impl,
                n_block=self.G, forms=self.forms_dev[:r],
                matmul=bool(self.forms[lo:r].any()), blocks=True,
                account=False)
        if len(segs):
            nm, _, _, p = fold(self.x, self.mind, vec[0, :ns], vec[1, :ns],
                               int(pend[:ns][live[:ns] > 0].min()))
            parts.append(p)
        if tail:
            nmt, _, _, p = fold(self.xt, self.mind_t, vec[0, ns:],
                                vec[1, ns:], int(self.erow[self.tail_pending]))
            parts.append(p)
        pairs = (torch.cat(parts, 1) if len(parts) > 1 else parts[0]
                 ).cpu().numpy()
        _engine_add(waves=1, syncs=1)
        bv = np.full(self.nn, -np.inf, np.float32)
        bi = np.zeros(self.nn, np.int64)
        got = pairs.shape[1] - (self.nn - ns if tail else 0)
        if len(segs):
            bv[:ns], bi[:ns] = pairs[0, :got], pairs[1, :got].view(np.int32)
        if tail:
            bv[ns:] = pairs[0, got:]
            bi[ns:] = pairs[1, got:].view(np.int32) + self.tail_off
        return nm, nmt, bv, bi

    def _segment_pairs(self, bv, bi):
        """Each segment's (max, lowest layout row reaching it), from the
        per-block pairs (index k: the tail)."""
        v = np.full(self.k + 1, -np.inf, np.float32)
        i = np.zeros(self.k + 1, np.int64)
        starts = self.blk0[self.nonempty]
        v[self.nonempty] = np.maximum.reduceat(bv, starts)
        top = np.where(bv == v[self.blk_seg], bi, np.iinfo(np.int32).max)
        i[self.nonempty] = np.minimum.reduceat(top, starts)
        return v, i

    def _fold_tail(self, v: float, li: int):
        """Record the tail's fold as the per-segment loop does (pool_rows
        per pending entry, cursor). Returns its candidate or None."""
        ops.record_folds(_bucket(self.n_tail), self.d,
                         self.ne - self.tail_pending)
        self.tail_pending = self.ne
        return None if li >= self.n_tail else (v, self.covered + li)

    def _fold_segments(self, segs: np.ndarray, sv, si, best, ub):
        """Replay the sequential scan over ``segs`` (in bound order) on
        this wave's segment pairs: the scan stops at the first segment
        with ``ub * (1 + slack) < best``, ``best`` folding in each
        candidate before it. Records the folded prefix as the
        per-segment loop does (pool_rows per pending entry, cursor, M).
        Returns (segments folded, best, stopped)."""
        li = si[segs] - self.blk0[segs] * self.G
        ok = li < self.seg_len[segs]          # else all rows dead: no cand
        vals = sv[segs].astype(np.float64)
        cand = np.where(ok, vals, -np.inf)
        before = np.maximum.accumulate(np.concatenate(
            [[-np.inf if best is None else best[0]], cand]))[:-1]
        cut = ub[segs] * (1.0 + self.slack) < before
        n = int(np.argmax(cut)) if cut.any() else len(segs)
        done = segs[:n]
        ops.record_folds(self.seg_bucket[done], self.d,
                         self.ne - self.seg_pending[done])
        self.seg_pending[done] = self.ne
        self.M[done] = vals[:n]
        self.M_exact[done] = True
        self.P_sqrt[done] = np.inf
        self.last_folded.extend(done.tolist())
        keep = ok[:n]
        if keep.any():
            rows = self.rowid[self.starts[done[keep]] + li[:n][keep]]
            top = np.lexsort((rows, -vals[:n][keep]))[0]
            c = (float(vals[:n][keep][top]), int(rows[top]))
            if best is None or c[0] > best[0] or (c[0] == best[0]
                                                 and c[1] < best[1]):
                best = c
        return n, best, n < len(segs)

    # ---------------------------------------------------------- propose --
    def propose(self):
        """Best-first gated scan: evaluate the tail + clusters in
        descending upper-bound order until ``ub * (1 + slack) < best``.
        Returns ``(score, global index, pool row)`` or None."""
        self.last_folded = []
        tail = self.n_tail > 0 and self.tail_alive > 0
        order = np.zeros(0, np.int64)
        if self.summary is not None:
            ub = np.minimum(self.M, np.square(self.T_sqrt))
            alive = np.nonzero(self.seg_alive > 0)[0]
            order = alive[np.lexsort((alive, -ub[alive]))]
            size = max(1, int(np.count_nonzero(
                ub[order] * (1.0 + self.slack) >= self._lower_bound())))
        best, pos = None, 0
        while tail or pos < len(order):
            segs = order[pos:pos + size] if len(order) else order
            nm, nmt, bv, bi = self._wave(segs, tail)
            sv, si = self._segment_pairs(bv, bi)
            done = np.zeros(self.k + 1, bool)
            if tail:
                best = self._fold_tail(float(sv[self.k]),
                                       int(si[self.k]) - self.tail_off)
                done[self.k] = True
                tail = False
            n, stop = 0, False
            if len(segs):
                n, best, stop = self._fold_segments(segs, sv, si, best, ub)
            done[segs[:n]] = True
            pos += n
            # a stop leaves this wave's later segments unfolded
            self._apply(nm, nmt, done, partial=stop)
            if stop or pos >= len(order) or (
                    best is not None and
                    ub[order[pos]] * (1.0 + self.slack) < best[0]):
                break                        # the next segment is pruned
            size *= 2
        _engine_add(proposals=1, segments_folded=len(self.last_folded))
        if best is None:
            return None
        val, pool_row = best
        return (val, int(self.gpos[pool_row]), pool_row)

    def _apply(self, nm, nmt, done: np.ndarray, partial: bool):
        """Make the wave's new min-dists the state where ``done`` (by
        segment, index k the tail); elsewhere keep the old ones."""
        if done[self.k]:
            self.mind_t = nmt
        if not done[:self.k].any():
            return
        if not partial:
            self.mind = nm
            return
        _engine_add(partial_commits=1)
        keep = self._upload(done[self.blk_seg[:self.ns]][None, :], 2)[0] > 0
        G = self.G
        self.mind = torch.where(keep[:, None], nm.view(-1, G),
                                self.mind.view(-1, G)).view(-1)


def gated_greedy_select(rng, budget: int, shards: Sequence, *,
                        init_centers=None, slack: float = 0.05,
                        executor=None, impl: str = "auto",
                        state=None) -> np.ndarray:
    """Replica-sharded greedy k-center with the centroid gate — same
    local-propose / global-merge round structure as
    ``selection.replica_greedy_select``, same draw schedule, same
    (value desc, global index asc) merges.

    ``state`` (a ``core.selection.KCenterState``) seeds each engine's
    segment/tail min-dists from the session's persisted pool-level fold,
    so the warm start streams ZERO pool rows."""
    N = selection.replica_total(shards)
    nsh = len(shards)
    warm = init_centers is not None and init_centers.shape[0] > 0
    init = None
    if warm:
        init = (init_centers.detach().cpu().numpy()
                if isinstance(init_centers, torch.Tensor)
                else np.asarray(init_centers, np.float32))
    queued = budget + (init.shape[0] if warm and state is None else 0)
    engines = [(_ShardEngine(s, slack, impl,
                             warm_mind=(state.pool_mind(i)
                                        if state is not None and warm
                                        else None),
                             warm_centers=init if state is not None else None,
                             capacity=queued)
                if s.n else None)
               for i, s in enumerate(shards)]
    sel = np.zeros((budget,), np.int64)
    if warm:
        if state is None:
            for i, e in enumerate(engines):
                if e is not None:
                    # the r_block warm_start_min_dist folds with: the
                    # reference's model pick, never a measured one
                    rb = autotune.model_blocks(shards[i].n,
                                               init.shape[1]).r_block
                    e.add_warm_start(init, rb)
        start = 0
    else:
        # the same draw over the same N as the ungated path: same seed row
        first = rnglib.randint(rng, 0, N)
        fsi, fli = selection.locate_row(shards, first)
        seed = np.asarray(shards[fsi].feats[fli], np.float32)
        for e in engines:
            if e is not None:
                e.add_center(seed)
        fpool = (int(shards[fsi].pool_rows[fli])
                 if shards[fsi].pool_rows is not None else fli)
        engines[fsi].mask_pool_row(fpool)
        sel[0] = first
        start = 1

    def propose(i):
        e = engines[i]
        if e is None:
            return None
        p = e.propose()
        if p is None:
            return None
        return (p[0], p[1], i, p[2])

    for slot in range(start, budget):
        props = selection.replica_map(propose, range(nsh), executor)
        _, g, wi, pool_row = selection._merge_proposals(props)
        sel[slot] = g
        center = engines[wi].row_vec(pool_row)
        row = engines[wi].row_dev(pool_row)
        engines[wi].mask_pool_row(pool_row)
        if slot + 1 < budget:
            for e in engines:
                if e is not None:
                    e.add_center(center, row)
    return sel
