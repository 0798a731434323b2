"""Shard-worker runtime (port of repro/distributed/worker.py).

Each replica shard runs its embed / ingest / propose work on its own
supervised worker lane. ``ShardWorkerPool`` duck-types the ``executor.map``
protocol that ``core.selection.replica_map`` (and every ``select_sharded``
strategy) fans out on, so the local-propose / global-merge selection is
the cross-worker protocol unchanged, but each map runs under supervision:

  * one LANE per shard: a dedicated single-thread executor (``thread``
    backend, the default), paired under the ``process`` backend with an OS
    process that executes registered picklable jobs such as the canonical
    embed batch;
  * every task is timed and fed to a ``StragglerMonitor``
    (``distributed.fault_tolerance``); straggler events surface in
    ``stats()``;
  * a ``PhaseFailureInjector`` can deterministically kill a worker at the
    Nth task of a named phase (``embed`` / ``propose`` / ``ingest`` /
    ``job``), and ``kill()`` hard-kills a lane (SIGKILL for its process);
  * a dead worker (injected kill, hard kill, a task hung past
    ``timeout_s``, or a broken process pipe) is detected by the
    supervising caller, the lane is RESTARTED (generation bump, fresh
    thread and process), the caller's ``on_death(shard)`` recovery hook
    runs (the AL service resets the shard's artifact columns there,
    forcing a re-embed from raw + content keys), and the task retries with
    bounded backoff. Selections stay bit-identical to the no-failure run
    because every retried task is a pure function of pinned inputs.

Process lanes start their processes with the ``spawn`` method, never
``fork``: the parent holds a live CUDA context, which a forked child cannot
use. A child builds what a job needs on the device its payload names (the
embed job: the config's ``device``).

Device pinning: on a host with more than one CUDA device, lanes are pinned
round-robin to ``torch.cuda`` devices and each task runs under
``torch.cuda.device(lane.device)``; on one device (or none) nothing is
pinned.
"""
from __future__ import annotations

import concurrent.futures as cf
import multiprocessing as mp
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.distributed.fault_tolerance import (SimulatedFailure,
                                                     StragglerMonitor)


class WorkerDeath(RuntimeError):
    """A shard worker died (injected, killed, hung, or broken pipe)."""


class PhaseFailureInjector:
    """Deterministic worker-kill schedule keyed by PHASE of the shard path.

    ``fail_at`` maps a phase name (``embed`` / ``propose`` / ``ingest`` /
    ``job``) to the 0-based task indices *within that phase* at which the
    worker executing the task dies (raises ``SimulatedFailure``, which the
    pool treats exactly like a hard kill: restart + recover + retry). Each
    scheduled index fires once, so the retried task survives.
    """

    def __init__(self, fail_at: Dict[str, Sequence[int]]):
        self.fail_at = {ph: set(idx) for ph, idx in fail_at.items()}
        self.counts: Dict[str, int] = {}
        self.fired: List[tuple] = []
        self._lock = threading.Lock()

    def maybe_fail(self, phase: str) -> None:
        with self._lock:
            i = self.counts.get(phase, 0)
            self.counts[phase] = i + 1
            sched = self.fail_at.get(phase)
            if sched and i in sched:
                sched.discard(i)
                self.fired.append((phase, i))
                raise SimulatedFailure(
                    f"injected worker death at {phase}[{i}]")


# --------------------------------------------------------------------------
# Registered process jobs: the only work shipped across the process
# boundary. Jobs are pure functions of their (picklable) payload plus a
# per-process cache dict for expensive lazy state (e.g. the backend).
# --------------------------------------------------------------------------
_JOBS: Dict[str, Callable[[Any, dict], Any]] = {}


def register_job(name: str):
    def deco(fn):
        _JOBS[name] = fn
        return fn
    return deco


@register_job("echo")
def _job_echo(payload, cache):
    return payload


@register_job("embed_batch")
def _job_embed_batch(payload, cache):
    """The canonical embed chunk (the service layer's ``_feats_for``
    contract): preprocess the raw rows, zero-pad to the one canonical
    ``bs``-row shape, run the feature forward, return the valid rows. Pure
    in (config, raw bytes): the process rebuilds the backend from the
    config once (on the config's ``device``) and caches it, so the feature
    bytes match the in-process path bit for bit (backend construction is
    deterministic from the config)."""
    import numpy as np

    from repro_torch.service.backends import make_backend
    from repro_torch.service.config import ALServiceConfig

    cfg_d = payload["config"]
    key = repr(sorted(cfg_d.items()))
    backend = cache.get(key)
    if backend is None:
        cfg = ALServiceConfig(**cfg_d)
        backend = make_backend(cfg.model_name, config=cfg)
        cache[key] = backend
    raw = np.asarray(payload["raw"])
    bs = max(int(payload["bs"]), 1)
    x = np.asarray(backend.preprocess(raw))
    n = x.shape[0]
    if n < bs:
        x = np.concatenate([x, np.zeros((bs - n,) + x.shape[1:], x.dtype)])
    return np.asarray(backend.features(x))[:n]


def _process_main(conn):
    """Worker-process loop: execute registered jobs until EOF/None."""
    cache: dict = {}
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            return
        if msg is None:
            return
        name, payload = msg
        try:
            conn.send(("ok", _JOBS[name](payload, cache)))
        except BaseException as e:  # ship the failure, keep serving
            conn.send(("err", f"{type(e).__name__}: {e}"))


class _Lane:
    """One shard's worker lane: a dedicated single-thread executor, plus a
    paired OS process under the ``process`` backend. ``generation`` bumps
    on every restart."""

    def __init__(self, index: int, device=None):
        self.index = index
        self.device = device
        self.generation = 0
        self.dead = False
        self._proc = None
        self._conn = None
        self._ex = cf.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"shard{index}-g0")

    def alive(self) -> bool:
        if self.dead:
            return False
        return self._proc is None or self._proc.is_alive()

    def kill(self) -> None:
        """Hard-kill the lane: SIGKILL the paired process (if any) and mark
        the lane dead so its next task raises ``WorkerDeath``. A thread
        cannot be preempted mid-task, so an in-flight thread task is caught
        by the supervisor's timeout instead."""
        self.dead = True
        if self._proc is not None and self._proc.is_alive():
            self._proc.kill()

    def restart(self) -> None:
        self.generation += 1
        self.dead = False
        old = self._ex
        self._ex = cf.ThreadPoolExecutor(
            max_workers=1,
            thread_name_prefix=f"shard{self.index}-g{self.generation}")
        old.shutdown(wait=False)   # a hung task finishes into the void
        self._stop_process()

    def submit(self, fn, *args) -> cf.Future:
        return self._ex.submit(fn, *args)

    # -- process jobs -----------------------------------------------------
    def _ensure_process(self):
        if self._proc is None or not self._proc.is_alive():
            # spawn, never fork: the parent holds a live CUDA context
            ctx = mp.get_context("spawn")
            self._conn, child = ctx.Pipe()
            self._proc = ctx.Process(target=_process_main, args=(child,),
                                     daemon=True,
                                     name=f"shard{self.index}-proc")
            self._proc.start()
            child.close()
        return self._conn

    def run_job(self, name: str, payload, timeout_s: float):
        """One registered job on the paired process; raises ``WorkerDeath``
        on a dead or hung process, ``RuntimeError`` on a job error."""
        if self.dead:
            raise WorkerDeath(f"lane {self.index} was killed")
        try:
            conn = self._ensure_process()
            conn.send((name, payload))
            if not conn.poll(timeout_s):
                raise WorkerDeath(
                    f"shard {self.index} job {name!r} hung past "
                    f"{timeout_s}s")
            status, value = conn.recv()
        except (EOFError, BrokenPipeError, OSError) as e:
            raise WorkerDeath(
                f"shard {self.index} worker process died during "
                f"{name!r}: {e!r}") from e
        if status != "ok":
            raise RuntimeError(f"job {name!r} failed on shard "
                               f"{self.index}: {value}")
        return value

    def _stop_process(self):
        if self._proc is not None:
            if self._proc.is_alive():
                try:
                    self._conn.send(None)
                except (BrokenPipeError, OSError):
                    pass
                self._proc.join(timeout=1.0)
                if self._proc.is_alive():
                    self._proc.kill()
                    self._proc.join(timeout=1.0)
            self._conn.close()
            self._proc = None
            self._conn = None

    def shutdown(self):
        self._ex.shutdown(wait=False)
        self._stop_process()


def _lane_devices(n_lanes: int, devices=None) -> List[Any]:
    """Round-robin lane -> CUDA device pinning; all-None on a host with
    fewer than two devices (no pinning needed)."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(count)]
    devs = list(devices)
    if len(devs) <= 1:
        return [None] * n_lanes
    return [devs[i % len(devs)] for i in range(n_lanes)]


class ShardWorkerPool:
    """Supervised per-shard worker lanes behind the ``executor.map``
    protocol.

    ``map`` runs under the default phase; ``scoped(phase, on_death,
    shard_of)`` returns a facade whose ``map`` tags tasks with that phase,
    maps each item to its shard via ``shard_of(position, item)``
    (positional by default), and calls ``on_death(shard)`` after a worker
    death before the retry: the service layer's shard-recovery hook.
    """

    def __init__(self, n_shards: int, *, kind: str = "thread",
                 timeout_s: float = 30.0, max_retries: int = 2,
                 backoff_s: float = 0.05,
                 injector: Optional[PhaseFailureInjector] = None,
                 monitor: Optional[StragglerMonitor] = None,
                 devices=None):
        if kind not in ("thread", "process"):
            raise ValueError(f"worker backend must be 'thread' or "
                             f"'process', got {kind!r}")
        self.n_shards = max(int(n_shards), 1)
        self.kind = kind
        self.timeout_s = float(timeout_s)
        self.max_retries = max(int(max_retries), 0)
        self.backoff_s = float(backoff_s)
        self.injector = injector
        self.monitor = monitor if monitor is not None else StragglerMonitor()
        self._devices = _lane_devices(self.n_shards, devices)
        self._lanes = [_Lane(i, self._devices[i])
                       for i in range(self.n_shards)]
        self._lock = threading.Lock()
        self.restarts = 0          # lane restarts after a worker death
        self.tasks = 0             # supervised tasks completed
        self.deaths: List[str] = []   # human-readable death log

    # -- executor protocol -------------------------------------------------
    def map(self, fn: Callable, items) -> list:
        return self._map(fn, items, phase="shard", on_death=None,
                         shard_of=None)

    def scoped(self, phase: str, on_death: Optional[Callable] = None,
               shard_of: Optional[Callable] = None) -> "_ScopedExecutor":
        return _ScopedExecutor(self, phase, on_death, shard_of)

    # -- supervision core --------------------------------------------------
    def _map(self, fn, items, *, phase, on_death, shard_of) -> list:
        items = list(items)
        if not items:
            return []
        shards = [(shard_of(i, it) if shard_of is not None else i)
                  % self.n_shards for i, it in enumerate(items)]
        futs = [self._lanes[s].submit(self._wrap, phase, fn, it,
                                      self._lanes[s])
                for s, it in zip(shards, items)]
        return [self._gather(futs[i], shards[i], phase, fn, items[i],
                             on_death)
                for i in range(len(items))]

    def _wrap(self, phase, fn, item, lane):
        if lane.dead:
            raise WorkerDeath(f"lane {lane.index} was killed")
        if self.injector is not None:
            self.injector.maybe_fail(phase)
        t0 = time.perf_counter()
        if lane.device is not None:
            with torch.cuda.device(lane.device):
                out = fn(item)
        else:
            out = fn(item)
        return time.perf_counter() - t0, out

    def _gather(self, fut, shard, phase, fn, item, on_death):
        lane = self._lanes[shard]
        attempt = 0
        while True:
            death = None
            try:
                dur, out = fut.result(timeout=self.timeout_s)
                with self._lock:
                    self.tasks += 1
                    self.monitor.observe(self.tasks, dur)
                return out
            except (SimulatedFailure, WorkerDeath) as e:
                death = e
            except cf.TimeoutError:
                # cf.TimeoutError IS TimeoutError: one raised BY the task
                # itself must propagate, not read as a hang
                if fut.done():
                    raise
                death = WorkerDeath(
                    f"shard {shard} {phase} task hung past "
                    f"{self.timeout_s}s (worker presumed dead)")
            # -- death path: restart lane, recover shard, bounded retry --
            with self._lock:
                self.restarts += 1
                self.deaths.append(f"{phase}/shard{shard}: {death}")
            lane.restart()
            if on_death is not None:
                on_death(shard)
            attempt += 1
            if attempt > self.max_retries:
                raise WorkerDeath(
                    f"shard {shard} {phase} task failed after "
                    f"{attempt} attempts: {death}") from death
            time.sleep(self.backoff_s * attempt)
            fut = lane.submit(self._wrap, phase, fn, item, lane)

    # -- process jobs ------------------------------------------------------
    def run_job(self, shard: int, name: str, payload,
                on_death: Optional[Callable] = None):
        """A registered job on the shard's paired worker process, under the
        same supervision as tasks (injection phase ``"job"``, straggler
        timing, restart + bounded retry). The thread backend runs jobs
        inline, for parity."""
        shard = shard % self.n_shards
        lane = self._lanes[shard]
        attempt = 0
        while True:
            try:
                if self.injector is not None:
                    self.injector.maybe_fail("job")
                t0 = time.perf_counter()
                if self.kind == "process":
                    out = lane.run_job(name, payload, self.timeout_s)
                else:
                    out = _JOBS[name](payload, {})
                with self._lock:
                    self.tasks += 1
                    self.monitor.observe(self.tasks,
                                         time.perf_counter() - t0)
                return out
            except (SimulatedFailure, WorkerDeath) as e:
                death = e
            with self._lock:
                self.restarts += 1
                self.deaths.append(f"job/{name}/shard{shard}: {death}")
            lane.restart()
            if on_death is not None:
                on_death(shard)
            attempt += 1
            if attempt > self.max_retries:
                raise WorkerDeath(
                    f"shard {shard} job {name!r} failed after "
                    f"{attempt} attempts: {death}") from death
            time.sleep(self.backoff_s * attempt)

    # -- probes / chaos ----------------------------------------------------
    def kill(self, shard: int) -> None:
        self._lanes[shard % self.n_shards].kill()

    def probe(self) -> List[bool]:
        """Per-lane liveness (the detection half of kill-recovery)."""
        return [lane.alive() for lane in self._lanes]

    def stats(self) -> dict:
        with self._lock:
            return {
                "backend": self.kind,
                "lanes": self.n_shards,
                "generations": [ln.generation for ln in self._lanes],
                "alive": [ln.alive() for ln in self._lanes],
                "pinned_devices": sum(d is not None for d in self._devices),
                "tasks": self.tasks,
                "restarts": self.restarts,
                "straggler_events": len(self.monitor.events),
                "deaths": list(self.deaths),
            }

    def shutdown(self) -> None:
        for lane in self._lanes:
            lane.shutdown()


class _ScopedExecutor:
    """Phase-tagged view of a pool: what the service layer hands to
    ``replica_map`` / ``select_sharded`` so deaths in that phase run the
    right recovery hook."""

    def __init__(self, pool: ShardWorkerPool, phase: str,
                 on_death: Optional[Callable],
                 shard_of: Optional[Callable]):
        self.pool = pool
        self.phase = phase
        self.on_death = on_death
        self.shard_of = shard_of

    def map(self, fn: Callable, items) -> list:
        return self.pool._map(fn, items, phase=self.phase,
                              on_death=self.on_death,
                              shard_of=self.shard_of)
