"""Staleness weighting of asynchronous aggregation (paper Alg. 4)."""
from __future__ import annotations


def staleness_weight(staleness: int, max_delay: int = 16,
                     alpha_power: float = 1.0) -> float:
    """Alg. 4's per-update weight: α = (staleness + 1)^-alpha_power, or 0
    when the update is older than the staleness cap D (line 13's skip)."""
    if staleness > max_delay:
        return 0.0
    return (1.0 / (staleness + 1.0)) ** alpha_power
