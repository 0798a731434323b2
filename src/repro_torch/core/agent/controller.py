# Copied from repro/core/agent/controller.py; imports renamed.
"""PSHEA — Predictive-based Successive Halving Early-stop (paper Alg. 1).

The loop controller launches all candidate strategies, advances each by one
AL round per iteration (select -> label -> update -> eval), fits the
negative-exponential forecaster on each history, and eliminates the strategy
with the lowest *predicted* next-round accuracy while more than one remains.
Stops on: target accuracy reached, budget exhausted, or convergence.

With ``max_workers > 1`` the surviving candidates advance concurrently on a
thread pool, so a round costs max(candidate) wall clock instead of
sum(candidate). All cross-strategy state (budget accounting, history,
forecasts, elimination) is aggregated AFTER the fan-out in the fixed
candidate order, so a parallel run is bit-identical to the serial schedule —
provided the task derives any randomness from (strategy, round) rather than
shared mutable state (the ALServer task does).

The controller is generic over an ``ALTask`` — anything that can select,
label and train/eval. Concrete tasks: synthetic CIFAR-like (benchmarks),
LLM-pool scoring (examples/al_train_loop.py).
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
from typing import Dict, List, Optional, Protocol, Sequence

import numpy as np

from repro_torch.core.agent.predictor import predict_next


class ALTask(Protocol):
    """One independent AL line per strategy (paper Alg. 1 keeps per-strategy
    labeled sets d^l)."""

    def select_and_label(self, strategy: str, round_budget: int) -> int:
        """Run one selection round for ``strategy``; returns budget spent."""
        ...

    def train_and_eval(self, strategy: str) -> float:
        """Update the model on the strategy's labeled set; returns accuracy."""
        ...

    def initial_accuracy(self) -> float:
        ...


@dataclasses.dataclass
class PSHEAResult:
    best_strategy: str
    best_accuracy: float
    stop_reason: str
    rounds: int
    budget_spent: int
    history: Dict[str, List[float]]
    predictions: Dict[str, List[float]]
    eliminated: List[str]          # elimination order (earliest first)


def run_pshea(task: ALTask, strategies: Sequence[str], *,
              target_accuracy: float, budget_max: int, round_budget: int,
              max_rounds: int = 32, converge_eps: float = 1e-3,
              converge_patience: int = 2,
              max_workers: Optional[int] = None) -> PSHEAResult:
    a0 = task.initial_accuracy()                      # line 5
    a_max = a0                                        # line 6
    live = list(strategies)
    history = {s: [a0] for s in live}                 # per-strategy a_l
    predictions: Dict[str, List[float]] = {s: [] for s in live}
    eliminated: List[str] = []
    b_total = 0                                       # line 9
    r = 0
    stall = 0
    stop = "max_rounds"

    def advance(s):
        spent = task.select_and_label(s, round_budget)
        return spent, task.train_and_eval(s)

    pool = None
    if max_workers and max_workers > 1 and len(live) > 1:
        pool = cf.ThreadPoolExecutor(
            max_workers=min(max_workers, len(live)),
            thread_name_prefix="pshea")
    try:
        while r < max_rounds:                         # line 10
            if a_max >= target_accuracy:              # line 11
                stop = "target_accuracy"
                break
            if b_total >= budget_max:                 # line 12
                stop = "budget_exhausted"
                break
            if stall >= converge_patience:            # line 13
                stop = "converged"
                break

            if pool is not None and len(live) > 1:    # lines 14-19
                results = list(pool.map(advance, live))
            else:
                results = [advance(s) for s in live]
            preds = {}
            for s, (spent, acc) in zip(live, results):
                b_total += spent
                history[s].append(acc)
                nxt = predict_next(range(len(history[s])), history[s],
                                   len(history[s]))   # line 17-18
                preds[s] = nxt
                predictions[s].append(nxt)

            r += 1                                    # line 21
            new_max = max(h[-1] for h in history.values())  # line 22
            stall = stall + 1 if new_max - a_max < converge_eps else 0
            a_max = max(a_max, new_max)

            if len(live) > 1:                         # lines 23-24
                worst = min(live, key=lambda s: preds[s])
                live.remove(worst)
                eliminated.append(worst)
    finally:
        if pool is not None:
            pool.shutdown(wait=True)

    best = max(history, key=lambda s: history[s][-1])
    return PSHEAResult(
        best_strategy=best,
        best_accuracy=history[best][-1],
        stop_reason=stop,
        rounds=r,
        budget_spent=b_total,
        history=history,
        predictions=predictions,
        eliminated=eliminated,
    )
