"""AL Strategy Zoo (port of repro/core/strategies/zoo.py).

Every strategy's ``select`` runs over one pool on one device. The
replica-sharded paths (``select_sharded``) are not ported yet: they raise
``NotImplementedError`` (ROADMAP queue A5).
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


def get_strategy(name: str) -> Strategy:
    if name not in ZOO:
        raise KeyError(f"unknown strategy {name!r}; zoo = {sorted(ZOO)}")
    return ZOO[name]
