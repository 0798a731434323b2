# Copied from repro/distributed/fault_tolerance.py (jax-free, unchanged).
"""Fault-tolerance runtime: straggler detection, failure injection, and a
checkpoint/restart supervisor for the train loop.

At 1000+ nodes the dominant failure modes are (a) whole-node loss (preempted
pod, dead host) and (b) stragglers (thermal throttling, flaky ICI link). The
supervisor treats (a) as restore-from-last-checkpoint — checkpoints are
atomic + elastic, so resume works even on a *different* device count — and
(b) as a detection + mitigation hook (swap data shard / flag for eviction),
since single-controller JAX can't preempt a lagging chip mid-step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration_s: float
    ema_s: float
    ratio: float


class StragglerMonitor:
    """EMA step-time watchdog. ``observe`` returns an event if step time
    exceeds ``threshold`` x EMA (after warmup)."""

    def __init__(self, threshold: float = 2.5, alpha: float = 0.2,
                 warmup: int = 5):
        self.threshold = threshold
        self.alpha = alpha
        self.warmup = warmup
        self.ema: Optional[float] = None
        self.n = 0
        self.events: List[StragglerEvent] = []

    def observe(self, step: int, duration_s: float) -> Optional[StragglerEvent]:
        self.n += 1
        if self.ema is None:
            self.ema = duration_s
            return None
        ratio = duration_s / max(self.ema, 1e-9)
        event = None
        is_outlier = ratio > self.threshold
        if is_outlier and self.n > self.warmup:
            event = StragglerEvent(step, duration_s, self.ema, ratio)
            self.events.append(event)
        if not is_outlier:
            # outlier samples never fold into the EMA — during warmup they
            # are merely unreported, not accepted as the new baseline
            self.ema = (1 - self.alpha) * self.ema + self.alpha * duration_s
        return event


class FailureInjector:
    """Deterministic failure schedule for resilience tests: raises
    SimulatedFailure at the given steps (once each)."""

    def __init__(self, fail_at_steps: List[int]):
        self.fail_at = set(fail_at_steps)
        self.fired = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(f"injected node failure at step {step}")


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class SupervisorReport:
    steps_done: int
    restarts: int
    straggler_events: int
    final_step: int


def supervise(train_round: Callable[[int], int], *, total_steps: int,
              latest_step: Callable[[], Optional[int]],
              max_restarts: int = 10,
              monitor: Optional[StragglerMonitor] = None) -> SupervisorReport:
    """Run ``train_round(start_step) -> steps_completed`` until
    ``total_steps``, restarting from the last checkpoint on failure.

    ``train_round`` must itself restore state from ``latest_step()``.
    Pass the ``StragglerMonitor`` the rounds feed their step times to and
    the report's ``straggler_events`` reflects it (0 without one)."""
    restarts = 0

    def report(final: int) -> SupervisorReport:
        events = len(monitor.events) if monitor is not None else 0
        return SupervisorReport(total_steps, restarts, events, final)

    while True:
        start = latest_step() or 0
        if start >= total_steps:
            return report(start)
        try:
            reached = train_round(start)
            if reached >= total_steps:
                return report(reached)
        except SimulatedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
