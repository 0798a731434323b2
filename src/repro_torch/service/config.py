# Copied from repro/service/config.py; the one change is the `device`
# default, which is "cuda" here.
"""Configuration-as-a-service (paper Fig. 2).

A minimal offline YAML-subset parser (nested maps, lists, scalars, comments)
so the paper's ``example.yml`` schema works verbatim without a yaml
dependency, plus the typed ``ALServiceConfig`` it loads into.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Union


def _scalar(s: str) -> Any:
    s = s.strip()
    if s in ("null", "~", ""):
        return None
    if s in ("true", "True"):
        return True
    if s in ("false", "False"):
        return False
    if (s.startswith('"') and s.endswith('"')) or \
       (s.startswith("'") and s.endswith("'")):
        return s[1:-1]
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return s


def parse_yaml(text: str) -> Any:
    """Indentation-based subset: maps, lists of scalars/maps, scalars."""
    lines = []
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if line.strip():
            lines.append(line)

    def parse_block(idx: int, indent: int):
        if idx >= len(lines):
            return None, idx
        first = lines[idx]
        cur_indent = len(first) - len(first.lstrip())
        if first.lstrip().startswith("- "):
            items = []
            while idx < len(lines):
                line = lines[idx]
                ind = len(line) - len(line.lstrip())
                if ind != cur_indent or not line.lstrip().startswith("- "):
                    break
                body = line.lstrip()[2:]
                if ":" in body:
                    k, _, rest = body.partition(":")
                    if rest.strip():
                        items.append({k.strip(): _scalar(rest)})
                        idx += 1
                    else:
                        sub, idx2 = parse_block(idx + 1, cur_indent + 1)
                        items.append({k.strip(): sub})
                        idx = idx2
                else:
                    items.append(_scalar(body))
                    idx += 1
            return items, idx
        out: Dict[str, Any] = {}
        while idx < len(lines):
            line = lines[idx]
            ind = len(line) - len(line.lstrip())
            if ind < cur_indent:
                break
            if ind > cur_indent:
                raise ValueError(f"bad indent: {line!r}")
            if ":" not in line:
                raise ValueError(f"expected key: {line!r}")
            key, _, rest = line.lstrip().partition(":")
            if rest.strip():
                out[key.strip()] = _scalar(rest)
                idx += 1
            else:
                nxt = idx + 1
                if nxt < len(lines):
                    nind = len(lines[nxt]) - len(lines[nxt].lstrip())
                    if nind > cur_indent:
                        sub, idx = parse_block(nxt, nind)
                        out[key.strip()] = sub
                        continue
                out[key.strip()] = None
                idx += 1
        return out, idx

    obj, _ = parse_block(0, 0)
    return obj


@dataclasses.dataclass
class ALServiceConfig:
    name: str = "AL_SERVICE"
    version: str = "0.1"
    strategy: str = "auto"              # auto -> PSHEA agent
    model_name: str = "synthetic_cnn"   # backend scorer id
    batch_size: int = 16
    # transformer backend knobs (model.name: transformer): the blockwise
    # forward's row-block size (activation-memory lever; bitwise-invisible
    # in the feature bytes), the canonical per-sample sequence length
    # preprocess pads/truncates to, the pooling reduction (mean | last),
    # the input modality (text | audio) and, for audio, the per-frame
    # feature width
    model_block_size: int = 64
    model_seq_len: int = 128
    model_pooling: str = "mean"
    model_modality: str = "text"
    model_input_dim: int = 0
    # where the port's server computes: "cuda" (the default) runs on the
    # GPU and raises if there is none; "cpu" (or "CPU") is the explicit
    # request for the CPU
    device: str = "cuda"
    protocol: str = "tcp"
    host: str = "127.0.0.1"
    port: int = 60035
    # pool shards per session: artifacts build and strategies score
    # per-shard in parallel, selections stay bit-identical to replicas=1
    replicas: int = 1
    # max queued push_data(asynchronous=True) calls folded into one drained
    # ingest batch (one pool_version bump per batch)
    ingest_batch: int = 256
    cache_bytes: int = 1 << 30
    cache_spill_dir: Optional[str] = None
    target_accuracy: float = 0.95
    budget_max: int = 10000
    # PSHEA candidate set: "paper" = the paper's 7; "hybrid" adds the
    # weighted fused-round strategies (badge/margin_density/weighted_kcenter)
    auto_candidates: str = "paper"
    # PSHEA racing: >1 fans surviving candidates across that many worker
    # threads per round (bit-identical to serial; 0/1 = serial)
    pshea_workers: int = 0
    # memoize (feats, probs) pool artifacts in per-shard epoch-stamped
    # columns; False = from-scratch O(pool) builds every query (the
    # bit-identity oracle the incremental engine is tested against)
    artifact_cache: bool = True
    # True (default): delta builds — a push refreshes only the rows it
    # appended on the shards it touched, a retrain refreshes probs only.
    # False: a stale shard column rebuilds in full (debugging fallback;
    # selections are bit-identical either way)
    incremental_artifacts: bool = True
    # centroid-gated pool prefilter (core.prefilter): selection scores only
    # the pool blocks whose cluster summary survives a bound check.
    # False = every query scans the full pool (the from-scratch oracle the
    # gated paths are tested against)
    prefilter: bool = False
    # relative slack on the triangle-inequality bound: larger = looser =
    # more rows scanned; a very large value degenerates to the exact full
    # scan bit-for-bit
    prefilter_slack: float = 0.05
    # centroids per shard summary (0 = auto: ~1 per 256 rows, capped 64)
    prefilter_clusters: int = 0
    # shards below this row count skip summaries and always full-scan
    prefilter_min_rows: int = 256
    # persist per-session k-center min-dist vectors across queries
    # (core.selection.KCenterStateCache): warm-started strategies
    # (coreset, weighted_kcenter) fold only the rows/centers appended since
    # the last query. False = every query re-folds from scratch (the
    # bit-identity oracle the cache is tested against)
    strategy_state_cache: bool = True
    # standing-query emits replay the previous selection against just the
    # delta rows (O(new rows) when no new row displaces a recorded winner).
    # False = every emit is a full re-selection (the bit-identity oracle;
    # emitted selections are identical either way)
    standing_replay: bool = True
    # RAM budget per artifact-column buffer: allocations past it go to
    # mmap-backed spill files (core.selection.ColumnSpill). 0 = unlimited
    # RAM (no spill)
    shard_ram_bytes: int = 0
    # spill file directory (default: a per-session dir under the system
    # tempdir, removed on session close)
    shard_spill_dir: Optional[str] = None
    # handler threads shared across ALL connections (frame-level dispatch:
    # idle connections cost nothing; extra clients queue, never refused)
    server_workers: int = 16
    # -- overload-safe serving (transport admission layer) ----------------
    # False (default) = admit everything: the bit-identity oracle the
    # overload drill twins against. True = enforce the inflight bound and
    # per-tenant token buckets; rejected frames carry retry_after_s
    admission: bool = False
    # server-wide bound on admitted-but-unfinished frames (queued +
    # executing across all tenants)
    admission_max_inflight: int = 64
    # per-tenant token bucket: sustained ops/s (<= 0 disables the bucket
    # check) and burst allowance
    admission_tenant_rate: float = 0.0
    admission_tenant_burst: float = 8.0
    # per-tenant WFQ weights (session id -> relative share; default 1.0)
    fairness_weights: Optional[Dict[str, float]] = None
    # close an accepted connection silent for this long with nothing
    # queued or executing (half-open client reclamation; 0 = never)
    idle_timeout_s: float = 0.0
    # a response send stalled this long (stopped-reading client) closes
    # the connection instead of wedging a handler thread (0 = never)
    send_timeout_s: float = 30.0
    # -- bounded async ingest ---------------------------------------------
    # caps on rows/bytes outstanding in a session's ingest queue (enqueue
    # until integration); 0 = unbounded. An oversize single push is still
    # admitted when nothing is outstanding
    ingest_max_rows: int = 0
    ingest_max_bytes: int = 0
    # at the cap: "block" = backpressure the producer until the worker
    # drains; "shed" = raise ServerOverloaded (retryable; the TCP
    # PushTicket fails with it, nothing was enqueued)
    ingest_policy: str = "block"
    # shard-worker runtime (distributed.worker, replicas > 1): "thread"
    # runs each shard's rounds on a dedicated supervised lane thread;
    # "process" additionally pairs each lane with an OS worker process
    # that executes the registered embed jobs (true process isolation for
    # the heavy step; closures stay on the lane thread)
    worker_backend: str = "thread"
    # a shard task past this wall-clock is presumed a dead worker: the
    # lane restarts, the shard recovers (re-embed from raw + content
    # keys), and the task retries
    worker_timeout_s: float = 30.0
    # bounded retries after a worker death before the failure propagates
    worker_retries: int = 2
    # linear backoff between retries (attempt * backoff seconds)
    worker_backoff_s: float = 0.05

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ALServiceConfig":
        al = d.get("active_learning", {}) or {}
        strat = (al.get("strategy", {}) or {})
        model = (al.get("model", {}) or {})
        worker = d.get("al_worker", {}) or {}
        adm = worker.get("admission", {}) or {}
        weights = adm.get("weights") or None
        if weights is not None:
            weights = {str(k): float(v) for k, v in weights.items()}
        return cls(
            name=d.get("name", "AL_SERVICE"),
            version=str(d.get("version", "0.1")),
            strategy=strat.get("type", "auto"),
            model_name=model.get("name", "synthetic_cnn"),
            batch_size=int(model.get("batch_size", 16)),
            model_block_size=int(model.get("block_size", 64)),
            model_seq_len=int(model.get("seq_len", 128)),
            model_pooling=model.get("pooling", "mean"),
            model_modality=model.get("modality", "text"),
            model_input_dim=int(model.get("input_dim", 0)),
            device=str(al.get("device", "cuda")),
            protocol=worker.get("protocol", "tcp"),
            host=worker.get("host", "127.0.0.1"),
            port=int(worker.get("port", 60035)),
            replicas=int(worker.get("replicas", 1)),
            ingest_batch=int(worker.get("ingest_batch", 256)),
            target_accuracy=float(al.get("target_accuracy", 0.95)),
            budget_max=int(al.get("budget_max", 10000)),
            auto_candidates=strat.get("candidates", "paper"),
            pshea_workers=int(al.get("pshea_workers", 0)),
            artifact_cache=bool(al.get("artifact_cache", True)),
            incremental_artifacts=bool(al.get("incremental_artifacts", True)),
            server_workers=int(worker.get("workers", 16)),
            strategy_state_cache=bool(al.get("strategy_state_cache", True)),
            standing_replay=bool(al.get("standing_replay", True)),
            prefilter=bool(al.get("prefilter", False)),
            prefilter_slack=float(al.get("prefilter_slack", 0.05)),
            prefilter_clusters=int(al.get("prefilter_clusters", 0)),
            prefilter_min_rows=int(al.get("prefilter_min_rows", 256)),
            shard_ram_bytes=int(worker.get("shard_ram_bytes", 0)),
            shard_spill_dir=worker.get("shard_spill_dir"),
            worker_backend=worker.get("backend", "thread"),
            worker_timeout_s=float(worker.get("timeout_s", 30.0)),
            worker_retries=int(worker.get("retries", 2)),
            worker_backoff_s=float(worker.get("backoff_s", 0.05)),
            admission=bool(adm.get("enabled", False)),
            admission_max_inflight=int(adm.get("max_inflight", 64)),
            admission_tenant_rate=float(adm.get("tenant_rate", 0.0)),
            admission_tenant_burst=float(adm.get("tenant_burst", 8.0)),
            fairness_weights=weights,
            idle_timeout_s=float(worker.get("idle_timeout_s", 0.0)),
            send_timeout_s=float(worker.get("send_timeout_s", 30.0)),
            ingest_max_rows=int(worker.get("ingest_max_rows", 0)),
            ingest_max_bytes=int(worker.get("ingest_max_bytes", 0)),
            ingest_policy=worker.get("ingest_policy", "block"),
        )

    @classmethod
    def from_yaml(cls, path_or_text: str) -> "ALServiceConfig":
        if "\n" not in path_or_text:
            with open(path_or_text) as f:
                path_or_text = f.read()
        return cls.from_dict(parse_yaml(path_or_text))
