"""AL Strategy Zoo (port of repro/core/strategies/zoo.py).

Every strategy ships two implementations with bit-identical selections:
``select`` over one pool on one device, and ``select_sharded`` over the
serving layer's replica shards (core.selection's local-propose /
global-merge machinery), the contract ``SHARDED_COMPLETE`` asserts.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.strategies.base import Strategy
from repro_torch.core.strategies.diversity import (core_set, dbal, k_center,
                                                   random_sampling)
from repro_torch.core.strategies.hybrid import (badge, margin_density,
                                                weighted_kcenter)
from repro_torch.core.strategies.uncertainty import (entropy_sampling,
                                                     least_confidence,
                                                     margin_confidence,
                                                     ratio_confidence)

ZOO: Dict[str, Strategy] = {
    s.name: s for s in [
        least_confidence, margin_confidence, ratio_confidence,
        entropy_sampling, k_center, core_set, dbal, random_sampling,
        badge, margin_density, weighted_kcenter,
    ]
}

# the 7 candidates PSHEA launches (paper §4.3.3)
PAPER_SEVEN = ["lc", "mc", "rc", "es", "kcg", "coreset", "dbal"]

# the hybrids every agent may additionally race
HYBRIDS = ["badge", "margin_density", "weighted_kcenter"]

# replica sharding only works if NO strategy silently lacks a sharded path
SHARDED_COMPLETE = all(s.sharded_fn is not None for s in ZOO.values())
assert SHARDED_COMPLETE, sorted(
    n for n, s in ZOO.items() if s.sharded_fn is None)


def get_strategy(name: str) -> Strategy:
    if name not in ZOO:
        raise KeyError(f"unknown strategy {name!r}; zoo = {sorted(ZOO)}")
    return ZOO[name]
