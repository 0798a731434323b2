"""The port's shard-worker runtime, thread lanes (``distributed.worker``):
supervision, failure injection, kill-recovery bit-identity against the AL
service, and the copied fault-tolerance helpers — twins of
tests/test_worker_runtime.py without the process lanes, which are not
ported (ROADMAP A7) and must say so.
"""
import time

import numpy as np
import pytest

from repro_torch.distributed.fault_tolerance import (SimulatedFailure,
                                                     StragglerMonitor,
                                                     supervise)
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
    with pytest.raises(NotImplementedError, match="A7: process lanes"):
        ShardWorkerPool(2, kind="process")
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
