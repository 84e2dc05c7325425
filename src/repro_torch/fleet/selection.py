"""Contribution-balance metric (variance / CV / Gini of the per-device
counts the server consumed): a copy of the JAX package's
``fleet.selection.gini`` and ``balance_summary``.  The selection policies
come with the fleet plane (ROADMAP item A7)."""
from __future__ import annotations

import math

import numpy as np


def gini(counts) -> float:
    """Gini coefficient of a non-negative count vector (0 = perfectly
    balanced contributions, -> 1 = one device dominates)."""
    x = np.sort(np.asarray(counts, float))
    n = len(x)
    total = float(x.sum())
    if n == 0 or total <= 0.0:
        return 0.0
    cum = np.cumsum(x) / total
    return float((n + 1 - 2.0 * cum.sum()) / n)


def balance_summary(counts) -> dict:
    """JSON-able balance statistics over per-device contribution counts."""
    x = np.asarray(counts, float)
    mean = float(x.mean()) if len(x) else 0.0
    var = float(x.var()) if len(x) else 0.0
    return {"total": int(x.sum()), "mean": mean, "var": var,
            "cv": math.sqrt(var) / mean if mean > 0 else 0.0,
            "gini": gini(x),
            "participants": int((x > 0).sum())}
