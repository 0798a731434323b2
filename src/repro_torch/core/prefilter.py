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

On a CUDA server the summary's permuted rows (``xperm_dev``) are moved to
the card once per summary build, and an engine's fold state (segment and
tail min-dists, queued centers, the tail rows) lives there for the whole
query, so a fold reads its segment from device memory. The host loop, the
f64 bounds and the bucket padding stay as the reference has them.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common import rng as rnglib
from repro_torch.core import selection
from repro_torch.core.strategies.base import shard_tensor
from repro_torch.kernels.pairwise import autotune, ops

BIG = 3.4e38


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
    rows, contiguous per cluster (``xperm_dev`` the same rows on the
    server's device): cluster ``j`` occupies ``xperm[starts[j]:starts[j+1]]``
    and ``rowid`` maps each permuted position back to its shard-local pool
    row (ascending within a cluster, so within-cluster argmax tie-breaks
    match pool order). ``cents``/``radii`` (f64) anchor the triangle
    bounds; ``caps`` maps a score kind to per-cluster exact maxima over
    the covered rows, stamped with ``caps_head_epoch``. Caps refreshes
    publish a NEW object sharing the geometry arrays.
    """

    __slots__ = ("k", "cents", "radii", "starts", "rowid", "xperm",
                 "xperm_dev", "covered", "caps", "caps_head_epoch",
                 "builds")

    def __init__(self, k, cents, radii, starts, rowid, xperm, covered,
                 caps=None, caps_head_epoch=-1, builds=0, xperm_dev=None):
        self.k = int(k)
        self.cents = cents                  # (k, d) f64
        self.radii = radii                  # (k,) f64, sqrt-space
        self.starts = starts                # (k+1,) i64 segment offsets
        self.rowid = rowid                  # (covered,) i64 pool rows
        self.xperm = xperm                  # (covered, d) f32 permuted copy
        self.xperm_dev = (xperm_dev if xperm_dev is not None
                          else torch.as_tensor(np.asarray(xperm)))
        self.covered = int(covered)
        self.caps: Optional[Dict[str, np.ndarray]] = caps
        self.caps_head_epoch = int(caps_head_epoch)
        self.builds = int(builds)

    def with_caps(self, probs: np.ndarray, head_epoch: int
                  ) -> "CentroidSummary":
        """Copy-on-write caps refresh from the covered probs rows."""
        from repro_torch.core.strategies.uncertainty import SCORE_FNS
        p = torch.as_tensor(np.asarray(probs[:self.covered], np.float32),
                            device=self.xperm_dev.device)
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
                               caps=caps, caps_head_epoch=head_epoch,
                               builds=self.builds, xperm_dev=self.xperm_dev)


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
    # the permuted rows go to the device once per build, not once per fold
    xperm_dev = (torch.from_numpy(np.asarray(xperm)) if x.device.type == "cpu"
                 else x[torch.as_tensor(order, device=x.device)])
    diffs = np.asarray(feats, np.float64) - cents[assign]
    d2 = np.einsum("ij,ij->i", diffs, diffs)
    radii = np.zeros(k, np.float64)
    np.maximum.at(radii, assign, d2)
    return CentroidSummary(k, cents, np.sqrt(radii), starts, order, xperm,
                           covered=rows, xperm_dev=xperm_dev)


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
    """Pad slice lengths to the next power of two (min 8), as the
    reference does (there it bounds jit retraces across ragged clusters).
    Pad rows enter with mind=-1, so they fold harmlessly and can never win
    an argmax."""
    p = 8
    while p < m:
        p <<= 1
    return p


class _ShardEngine:
    """Per-shard gated greedy state: segment min-dists over the summary's
    permuted layout + the always-live tail, a shared queue of folded
    center entries, and per-segment pending cursors / bounds. Fold state
    (min-dists, queued centers, tail rows) lives on the shard's device."""

    def __init__(self, shard, slack: float, impl: str = "auto",
                 warm_mind=None, warm_centers=None):
        self.impl = impl
        self.slack = float(slack)
        self.device = torch.device(shard.device)
        self.summary: Optional[CentroidSummary] = shard.summary
        feats = (shard.pool_feats if shard.pool_feats is not None
                 else np.asarray(shard.feats))
        self.pool_feats = feats
        n_pool = int(feats.shape[0])
        pool_rows = (np.asarray(shard.pool_rows)
                     if shard.pool_rows is not None
                     else np.arange(n_pool, dtype=np.int64))
        self.gpos = np.full(n_pool, -1, np.int64)
        self.gpos[pool_rows] = np.asarray(shard.gidx)
        in_view = np.zeros(n_pool, bool)
        in_view[pool_rows] = True
        self.entries: List[torch.Tensor] = []    # queued center batches
        self._masks: Dict[int, torch.Tensor] = {}  # R -> (R,) of -1
        # warm_mind: persisted pool-level min-dists vs warm_centers
        # (core.selection.KCenterState). Segments/tail start from those
        # floats with ZERO entries queued; warm_centers still tighten the
        # triangle bounds exactly as queueing them would.
        if warm_mind is not None:
            assert int(warm_mind.shape[0]) == n_pool
            warm_mind = np.asarray(warm_mind, np.float32)
        summ = self.summary
        self.covered = 0 if summ is None else min(summ.covered, n_pool)
        if summ is not None:
            k = summ.k
            self.starts = np.asarray(summ.starts)
            self.rowid = np.asarray(summ.rowid)
            self.xperm = summ.xperm_dev.to(self.device)
            self.inv_perm = np.empty(self.covered, np.int64)
            self.inv_perm[self.rowid] = np.arange(self.covered)
            view_perm = in_view[self.rowid]
            live = (BIG if warm_mind is None
                    else warm_mind[self.rowid].astype(np.float64))
            self.mind_x = self._dev(
                np.where(view_perm, live, -1.0).astype(np.float32))
            self.seg_alive = np.array(
                [int(view_perm[int(self.starts[j]):
                               int(self.starts[j + 1])].sum())
                 for j in range(k)])
            self.seg_pending = np.zeros(k, np.int64)
            self.T_sqrt = np.full(k, np.inf, np.float64)
            self.M = np.full(k, np.inf, np.float64)
        # the tail: rows past the covered prefix, always scanned
        tail_live = (BIG if warm_mind is None
                     else warm_mind[self.covered:].astype(np.float64))
        self.tail_mind = self._dev(np.where(
            in_view[self.covered:], tail_live, -1.0).astype(np.float32))
        self.tail_x = self._dev(np.asarray(feats[self.covered:], np.float32))
        self.tail_alive = int(in_view[self.covered:].sum())
        self.tail_pending = 0
        if warm_mind is not None and warm_centers is not None \
                and len(warm_centers):
            self._tighten(np.asarray(warm_centers, np.float32))

    def _no_mask(self, r: int) -> torch.Tensor:
        m = self._masks.get(r)
        if m is None:
            m = torch.full((r,), -1, dtype=torch.int32, device=self.device)
            self._masks[r] = m
        return m

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    # ------------------------------------------------------------ state --
    def row_vec(self, pool_row: int) -> np.ndarray:
        return np.asarray(self.pool_feats[pool_row], np.float32)

    def _queue(self, batch: np.ndarray) -> None:
        self.entries.append(self._dev(batch))
        self._tighten(batch)

    def add_center(self, vec: np.ndarray) -> None:
        self._queue(np.asarray(vec, np.float32)[None, :])

    def add_warm_start(self, centers: np.ndarray, r_block: int) -> None:
        """Queue init centers in the SAME r_block chunks the ungated
        ``warm_start_min_dist`` folds, so the multi-center matmul path
        produces the identical floats per chunk."""
        c = np.asarray(centers, np.float32)
        for s in range(0, c.shape[0], r_block):
            self._queue(c[s:s + r_block])

    def _tighten(self, batch: np.ndarray) -> None:
        if self.summary is None:
            return
        c = np.asarray(batch, np.float64)                  # (R, d)
        diff = self.summary.cents[:, None, :] - c[None, :, :]
        d2 = np.einsum("krd,krd->kr", diff, diff)          # (k, R)
        t = np.sqrt(d2) + self.summary.radii[:, None]
        self.T_sqrt = np.minimum(self.T_sqrt, t.min(axis=1))

    def mask_pool_row(self, pool_row: int) -> None:
        if pool_row >= self.covered:
            self.tail_mind[pool_row - self.covered] = -1.0
            self.tail_alive -= 1
            return
        xp = int(self.inv_perm[pool_row])
        self.mind_x[xp] = -1.0
        j = int(np.searchsorted(self.starts, xp, side="right")) - 1
        self.seg_alive[j] -= 1

    # ------------------------------------------------------------ folds --
    def _fold_slice(self, x_slice, mind_slice, pending_from: int):
        """Fold entries[pending_from:] into one contiguous row slice (both
        on the device) via the exact single/multi-center fused rounds,
        padded to a bucketed length. Returns (new mind (m,) on the device,
        best score, best slice-local row)."""
        m = int(x_slice.shape[0])
        p = _bucket(m)
        d = x_slice.shape[1]
        xp = torch.zeros((p, d), dtype=torch.float32, device=self.device)
        xp[:m] = x_slice
        nm = torch.full((p,), -1.0, dtype=torch.float32, device=self.device)
        nm[:m] = mind_slice
        li, lv = 0, -BIG
        for entry in self.entries[pending_from:]:
            nm, li, lv = ops.greedy_round(xp, nm, entry,
                                          self._no_mask(entry.shape[0]),
                                          impl=self.impl)
        if pending_from >= len(self.entries):
            # nothing pending: score the current min-dists (vector op, no
            # pool rows read)
            sc = ops.masked_weighted_score(nm)
            li = torch.argmax(sc)
            lv = sc[li]
        return nm[:m], float(lv), int(li)

    def _fold_seg(self, j: int):
        s, e = int(self.starts[j]), int(self.starts[j + 1])
        nm, lv, li = self._fold_slice(self.xperm[s:e], self.mind_x[s:e],
                                      int(self.seg_pending[j]))
        self.mind_x[s:e] = nm
        self.seg_pending[j] = len(self.entries)
        self.M[j] = lv
        if li >= e - s:                      # all rows dead: pad row won
            return None
        return (lv, int(self.rowid[s + li]))

    def _fold_tail(self):
        n_tail = self.tail_mind.shape[0]
        if n_tail == 0 or self.tail_alive <= 0:
            return None
        nm, lv, li = self._fold_slice(self.tail_x, self.tail_mind,
                                      self.tail_pending)
        self.tail_mind = nm
        self.tail_pending = len(self.entries)
        if li >= n_tail:
            return None
        return (lv, self.covered + li)

    # ---------------------------------------------------------- propose --
    def propose(self):
        """Best-first gated scan: evaluate the tail + clusters in
        descending upper-bound order until ``ub * (1 + slack) < best``.
        Returns ``(score, global index, pool row)`` or None."""
        best = self._fold_tail()
        if self.summary is not None:
            ub = np.minimum(self.M, np.square(self.T_sqrt))
            order = sorted((j for j in range(self.summary.k)
                            if self.seg_alive[j] > 0),
                           key=lambda j: (-ub[j], j))
            for j in order:
                if best is not None and ub[j] * (1.0 + self.slack) < best[0]:
                    break                    # ordered desc: rest is pruned
                cand = self._fold_seg(j)
                if cand is not None and (best is None or cand[0] > best[0]
                                         or (cand[0] == best[0]
                                             and cand[1] < best[1])):
                    best = cand
        if best is None:
            return None
        val, pool_row = best
        return (val, int(self.gpos[pool_row]), pool_row)


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
    engines = [(_ShardEngine(s, slack, impl,
                             warm_mind=(state.pool_mind(i)
                                        if state is not None and warm
                                        else None),
                             warm_centers=init if state is not None else None)
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
        engines[wi].mask_pool_row(pool_row)
        if slot + 1 < budget:
            for e in engines:
                if e is not None:
                    e.add_center(center)
    return sel
