"""The port's shard-worker runtime (``distributed.worker``): supervision,
failure injection, kill-recovery bit-identity against the AL service, the
copied fault-tolerance helpers, and the process lanes (spawned children
running registered jobs) — twins of tests/test_worker_runtime.py.

The process tests spawn real children (about 2 s each here, importing
torch); every pool they build is shut down, which stops its children.
"""
import dataclasses
import os
import time

import numpy as np
import pytest

from repro_torch.distributed.fault_tolerance import (SimulatedFailure,
                                                     StragglerMonitor,
                                                     supervise)
from repro_torch.data.synthetic import image_pool
from repro_torch.distributed.worker import (PhaseFailureInjector,
                                            ShardWorkerPool, WorkerDeath,
                                            _lane_devices)
from repro_torch.service.config import ALServiceConfig
from repro_torch.service.server import ALServer


# ---------------------------------------------------------------------------
# pool-level supervision
# ---------------------------------------------------------------------------

def test_map_runs_items_on_lanes_and_counts_tasks():
    pool = ShardWorkerPool(3, backoff_s=0.0)
    try:
        assert pool.map(lambda x: x * 2, [1, 2, 3]) == [2, 4, 6]
        st = pool.stats()
        assert st["tasks"] == 3 and st["restarts"] == 0
        assert st["backend"] == "thread" and st["lanes"] == 3
        assert st["pinned_devices"] == 0           # no multi-GPU host here
    finally:
        pool.shutdown()


def test_injected_death_restarts_lane_and_retries():
    inj = PhaseFailureInjector({"embed": [1]})
    pool = ShardWorkerPool(2, injector=inj, backoff_s=0.0)
    deaths = []
    try:
        ex = pool.scoped("embed", on_death=deaths.append)
        assert ex.map(lambda x: x + 10, [1, 2]) == [11, 12]
        st = pool.stats()
        assert st["restarts"] == 1 and st["generations"] == [0, 1]
        assert deaths == [1] and inj.fired == [("embed", 1)]
    finally:
        pool.shutdown()


def test_injector_fires_once_per_scheduled_index():
    inj = PhaseFailureInjector({"p": [0]})
    with pytest.raises(SimulatedFailure):
        inj.maybe_fail("p")
    inj.maybe_fail("p")
    inj.maybe_fail("q")


def test_death_every_attempt_exhausts_bounded_retries():
    inj = PhaseFailureInjector({"embed": [0, 1, 2]})
    pool = ShardWorkerPool(1, injector=inj, max_retries=2, backoff_s=0.0)
    try:
        with pytest.raises(WorkerDeath, match="after 3 attempts"):
            pool.scoped("embed").map(lambda x: x, [0])
    finally:
        pool.shutdown()


def test_hung_task_detected_by_timeout_and_retried():
    calls = []
    pool = ShardWorkerPool(1, timeout_s=0.2, backoff_s=0.0)

    def fn(x):
        calls.append(x)
        if len(calls) == 1:
            time.sleep(1.2)
        return x + 1

    try:
        assert pool.map(fn, [5]) == [6]
        st = pool.stats()
        assert st["restarts"] == 1 and st["generations"] == [1]
    finally:
        pool.shutdown()


def test_task_raising_timeouterror_propagates_not_retried():
    def fn(x):
        raise TimeoutError("from the task itself")

    pool = ShardWorkerPool(1, backoff_s=0.0)
    try:
        with pytest.raises(TimeoutError, match="from the task itself"):
            pool.map(fn, [0])
        assert pool.stats()["restarts"] == 0
    finally:
        pool.shutdown()


def test_kill_marks_lane_dead_probe_detects_next_task_recovers():
    pool = ShardWorkerPool(2, backoff_s=0.0)
    try:
        pool.kill(0)
        assert pool.probe() == [False, True]
        deaths = []
        out = pool.scoped("shard", on_death=deaths.append).map(
            lambda x: x, ["a", "b"])
        assert out == ["a", "b"] and deaths == [0]
        assert pool.probe() == [True, True]
    finally:
        pool.shutdown()


def test_process_lanes_are_not_ported_and_devices_pin_round_robin():
    """Process lanes construct (ROADMAP A7's process lanes are ported; the
    name is the one this check has always had); an unknown kind raises;
    lanes pin round robin to CUDA devices on a multi-device host."""
    pool = ShardWorkerPool(2, kind="process")
    try:
        st = pool.stats()
        assert st["backend"] == "process" and st["lanes"] == 2
        assert pool.probe() == [True, True]        # no process spawned yet
    finally:
        pool.shutdown()
    with pytest.raises(ValueError, match="thread"):
        ShardWorkerPool(2, kind="fiber")
    assert _lane_devices(3, devices=["cuda:0"]) == [None, None, None]
    assert _lane_devices(5, devices=["cuda:0", "cuda:1"]) == [
        "cuda:0", "cuda:1", "cuda:0", "cuda:1", "cuda:0"]


# ---------------------------------------------------------------------------
# fault_tolerance (copied unchanged from the reference)
# ---------------------------------------------------------------------------

def test_straggler_outlier_during_warmup_does_not_poison_ema():
    mon = StragglerMonitor(threshold=2.5, alpha=0.5, warmup=5)
    mon.observe(0, 1.0)
    mon.observe(1, 1.0)
    assert mon.observe(2, 100.0) is None
    assert mon.ema == pytest.approx(1.0)
    for s in range(3, 8):
        mon.observe(s, 1.0)
    ev = mon.observe(8, 100.0)
    assert ev is not None and ev.ratio > 2.5
    assert mon.ema == pytest.approx(1.0) and len(mon.events) == 1


def test_supervise_reports_straggler_events_from_monitor():
    mon = StragglerMonitor(threshold=2.0, warmup=1)
    state = {"step": 0}

    def train_round(start):
        for s in range(start, 4):
            mon.observe(s, 10.0 if s == 3 else 0.01)
            state["step"] = s + 1
        return 4

    rep = supervise(train_round, total_steps=4,
                    latest_step=lambda: state["step"], monitor=mon)
    assert rep.straggler_events == len(mon.events) == 1
    assert rep.restarts == 0


# ---------------------------------------------------------------------------
# fault-injection matrix against the AL service
# ---------------------------------------------------------------------------

def _pool(n=36, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 8, 8, 3)).astype(np.float32)


def _build(injector=None, **cfg_kw):
    cfg = ALServiceConfig(device="cpu", replicas=3, batch_size=8,
                          worker_backoff_s=0.0, model_name="synthetic_cnn",
                          **cfg_kw)
    srv = ALServer(config=cfg, failure_injector=injector)
    keys = srv.push_data(list(_pool()))
    srv.label(keys[:6], [0, 1, 0, 1, 0, 1])
    srv.train_and_eval()
    return srv, keys


@pytest.fixture(scope="module")
def clean_selection():
    srv, _ = _build()
    out = {s: srv.query(6, strategy=s, rng_seed=7)["keys"]
           for s in ("coreset", "mc")}
    srv.close()
    return out


@pytest.mark.parametrize("phase", ["embed", "propose"])
def test_kill_during_query_phase_recovers_bit_identical(phase,
                                                        clean_selection):
    inj = PhaseFailureInjector({phase: [0]})
    srv, _ = _build(injector=inj)
    for strat in ("coreset", "mc"):
        got = srv.query(6, strategy=strat, rng_seed=7)["keys"]
        assert got == clean_selection[strat], (phase, strat)
    st = srv.stats()
    assert inj.fired and st["workers"]["restarts"] >= 1
    assert st["worker_recoveries"] >= 1
    assert st["workers"]["straggler_events"] == len(
        srv.shard_runtime().monitor.events)
    srv.close()


def test_kill_during_ingest_drain_loses_no_rows(clean_selection):
    inj = PhaseFailureInjector({"ingest": [0]})
    cfg = ALServiceConfig(device="cpu", replicas=3, batch_size=8,
                          worker_backoff_s=0.0, model_name="synthetic_cnn")
    srv = ALServer(config=cfg, failure_injector=inj)
    tickets = [srv.push_data([x], asynchronous=True) for x in _pool()]
    srv.flush()
    uniq = {k for t in tickets for k in t.keys}
    st = srv.stats()
    assert inj.fired == [("ingest", 0)]
    assert st["pool"] == len(uniq)
    assert st["workers"]["restarts"] >= 1
    srv.label([t.keys[0] for t in tickets[:6]], [0, 1, 0, 1, 0, 1])
    srv.train_and_eval()
    assert srv.query(6, strategy="coreset", rng_seed=7)["keys"] == \
        clean_selection["coreset"]
    srv.close()


def test_recovery_reembeds_from_raw_when_cache_evicted(clean_selection):
    inj = PhaseFailureInjector({"embed": [0]})
    srv, _ = _build(injector=inj, cache_bytes=1)
    assert srv.query(6, strategy="coreset", rng_seed=7)["keys"] == \
        clean_selection["coreset"]
    assert srv.stats()["worker_recoveries"] >= 1
    srv.close()


# ---------------------------------------------------------------------------
# process-backed lanes (real OS children, spawned)
# ---------------------------------------------------------------------------

def test_process_lane_kill_probe_restart_roundtrip():
    pool = ShardWorkerPool(2, kind="process", timeout_s=60.0, backoff_s=0.0)
    try:
        assert pool.run_job(0, "echo", {"v": 42}) == {"v": 42}
        pool.kill(0)
        deadline = time.monotonic() + 5.0
        while pool.probe()[0] and time.monotonic() < deadline:
            time.sleep(0.05)
        assert pool.probe() == [False, True]
        assert pool.run_job(0, "echo", 7) == 7     # restarted + retried
        st = pool.stats()
        assert st["restarts"] >= 1 and st["generations"][0] >= 1
        # a job that raises in the child is a job error, not a death
        with pytest.raises(RuntimeError, match="failed on shard 1"):
            pool.run_job(1, "no_such_job", None)
        assert pool.stats()["restarts"] == st["restarts"]
        assert pool.run_job(1, "echo", "alive") == "alive"
    finally:
        pool.shutdown()


class _Interrupt(BaseException):
    """A BaseException that is not an Exception (as KeyboardInterrupt)."""


class _RaisesInChild:
    """Pickles in the process that made it; pickling it anywhere else (the
    child sending an ``echo`` job's result back) raises ``_Interrupt``."""

    def __init__(self, pid):
        self.pid = pid

    def __reduce__(self):
        if os.getpid() != self.pid:
            raise _Interrupt("interrupted in the child")
        return (_RaisesInChild, (self.pid,))


def test_job_raising_base_exception_is_a_job_error_not_a_death():
    """A job that raises a BaseException that is not an Exception comes
    back as a job error and the child keeps serving, as the reference's
    ``except BaseException`` ships it: no restart, the same generation."""
    pool = ShardWorkerPool(1, kind="process", timeout_s=60.0, backoff_s=0.0)
    try:
        assert pool.run_job(0, "echo", 1) == 1
        with pytest.raises(RuntimeError, match="_Interrupt: interrupted"):
            pool.run_job(0, "echo", _RaisesInChild(os.getpid()))
        st = pool.stats()
        assert st["restarts"] == 0 and st["generations"] == [0]
        assert pool.probe() == [True]
        assert pool.run_job(0, "echo", "alive") == "alive"
        assert pool.stats()["restarts"] == 0
    finally:
        pool.shutdown()


def test_injected_job_death_retries_then_exhausts():
    """An injected death in phase ``"job"`` restarts the lane and retries
    (the retried job runs in a fresh child); a death on every attempt
    raises ``WorkerDeath`` after ``max_retries`` retries."""
    inj = PhaseFailureInjector({"job": [0]})
    pool = ShardWorkerPool(1, kind="process", injector=inj, timeout_s=60.0,
                           backoff_s=0.0)
    deaths = []
    try:
        assert pool.run_job(0, "echo", 3, on_death=deaths.append) == 3
        st = pool.stats()
        assert st["restarts"] == 1 and st["generations"] == [1]
        assert deaths == [0] and inj.fired == [("job", 0)]
    finally:
        pool.shutdown()
    inj = PhaseFailureInjector({"job": [0, 1, 2]})
    pool = ShardWorkerPool(1, kind="process", injector=inj, max_retries=2,
                           backoff_s=0.0)
    try:
        with pytest.raises(WorkerDeath, match="after 3 attempts"):
            pool.run_job(0, "echo", 1)
        assert pool.stats()["restarts"] == 3
    finally:
        pool.shutdown()


def _process_cfg(kind, **kw):
    # cache_bytes=1 forces every artifact build through the re-embed
    # path, which is what ships to the worker processes
    return ALServiceConfig(device="cpu", replicas=2, batch_size=8,
                           worker_backend=kind, cache_bytes=1,
                           worker_timeout_s=120.0, worker_backoff_s=0.0,
                           model_name="synthetic_cnn", **kw)


def test_process_backend_selections_match_thread_backend():
    sel, jobs = {}, {}
    for kind in ("thread", "process"):
        srv = ALServer(config=_process_cfg(kind))
        try:
            keys = srv.push_data(list(_pool(24, seed=3)))
            srv.label(keys[:4], [0, 1, 0, 1])
            srv.train_and_eval()
            sel[kind] = [srv.query(5, strategy=s, rng_seed=3)["keys"]
                         for s in ("coreset", "kcg")]
            st = srv.stats()["workers"]
            assert st["backend"] == kind
            jobs[kind] = st["tasks"]
        finally:
            srv.close()
    assert sel["process"] == sel["thread"]
    # the process server ran its re-embeds as jobs, on top of the tasks
    assert jobs["process"] > jobs["thread"]


def test_embed_batch_job_bytes_equal_inline_embed():
    """The ``embed_batch`` job's feature bytes equal the in-process
    ``_embed_chunk`` bytes for the same chunk (full and ragged)."""
    xs, _ = image_pool(13, seed=5)
    inline = ALServer(config=_process_cfg("thread"))
    proc = ALServer(config=_process_cfg("process"))
    try:
        rt = proc.shard_runtime()
        for raw in (xs[:8], xs[8:]):
            want = inline._embed_chunk(raw, 8, shard_hint=0,
                                       backend=inline.backend)
            got = rt.run_job(1, "embed_batch", {
                "config": dataclasses.asdict(proc.config), "raw": raw,
                "bs": 8})
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                proc._embed_chunk(raw, 8, shard_hint=0,
                                  backend=proc.backend), want)
        assert rt.stats()["tasks"] == 4          # every chunk was a job
    finally:
        inline.close()
        proc.close()


def test_process_lane_killed_mid_query_recovers_same_keys():
    """SIGKILL lane 0's child while a query's re-embeds are in flight:
    the job retries in a fresh child and the query returns the keys of a
    run that lost no worker."""
    xs = _pool(30, seed=9)
    keys_of = {}
    for kill in (False, True):
        srv = ALServer(config=_process_cfg("process"))
        try:
            keys = srv.push_data(list(xs[:24]))
            srv.label(keys[:4], [0, 1, 0, 1])
            srv.train_and_eval()
            srv.push_data(list(xs[24:]))
            rt = srv.shard_runtime()
            if kill:
                run_job = rt.run_job

                def killing(shard, name, payload, on_death=None):
                    if shard == 0 and rt.stats()["restarts"] == 0:
                        rt.kill(0)
                    return run_job(shard, name, payload, on_death)

                rt.run_job = killing
            keys_of[kill] = srv.query(5, strategy="coreset",
                                      rng_seed=4)["keys"]
            st = rt.stats()
            if kill:
                assert st["restarts"] >= 1 and st["generations"][0] >= 1
            else:
                assert st["restarts"] == 0
        finally:
            srv.close()
    assert keys_of[True] == keys_of[False]
