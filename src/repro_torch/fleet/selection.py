"""Pluggable participant-selection policies (fleet emulation).

Each trace tick the server picks a cohort from the currently-available
devices; only cohort members run local rounds and ship activations.
Policies are fed the Task Scheduler's Alg. 3 consumption counters and the
control plane's staleness accounting, so selection composes with
FedOptima's balanced-contribution machinery instead of bypassing it:

``random``   uniform cohort (FedAvg-style client sampling; the control).
``refl``     availability/staleness-aware (REFL, Abdelmoniem et al.):
             prioritize devices whose local model is most stale — the
             ones whose scarce availability the round should exploit —
             tie-broken toward the least-consumed counters.
``score``    score-based (Apodotiko, Chadha et al.): rank by a weighted
             score of capability (fast devices finish rounds), balance
             (1 - consumption share: underserved devices catch up) and
             staleness, and take the top of the ranking.

All policies are deterministic under their seed: ``random`` consumes its
own RNG (and consumes nothing when the cohort is the whole fleet, so
full-participation runs stay bit-for-bit tracefree); ``refl``/``score``
are pure functions of the selection context.

Also home to the per-device contribution-balance metric
(:func:`balance_summary` — variance / CV / Gini of consumed counts),
reported by ``Metrics.contribution_balance``.

A copy of the JAX package's ``fleet/selection.py``: the same contexts
give the same cohorts, and ``random`` draws the same RNG stream.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping

import numpy as np


@dataclass
class SelectionContext:
    """What a policy may look at when picking the cohort."""
    t: float                               # simulated time / round index
    counters: Mapping[int, int]            # Alg. 3 consumption counters
    staleness: np.ndarray                  # (K,) global - local version
    capability: np.ndarray | None = None   # (K,) device FLOP/s (or None)


class SelectionPolicy:
    """Base: cohort sizing + seeded RNG; subclasses rank/draw members."""

    name = "base"

    def __init__(self, *, fraction: float = 1.0, cohort: int | None = None,
                 seed: int = 0):
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got {fraction}")
        if cohort is not None and cohort < 1:
            raise ValueError(f"cohort must be >= 1, got {cohort}")
        self.fraction = float(fraction)
        self.cohort = cohort
        self.seed = int(seed)
        self._rng = np.random.default_rng(seed)

    @property
    def trivial(self) -> bool:
        """True when the policy always selects every available device —
        the identity cohort, needing no re-selection ticks."""
        return self.cohort is None and self.fraction >= 1.0

    def cohort_size(self, n_available: int) -> int:
        if n_available <= 0:
            return 0
        if self.cohort is not None:
            return min(self.cohort, n_available)
        return max(1, int(math.ceil(self.fraction * n_available)))

    def select(self, available, ctx: SelectionContext) -> np.ndarray:
        raise NotImplementedError

    def describe(self) -> str:
        size = f"cohort={self.cohort}" if self.cohort is not None else \
            f"frac={self.fraction:g}"
        return f"{self.name}({size})"


class RandomSelection(SelectionPolicy):
    """Uniform cohort sampling without replacement."""

    name = "random"

    def select(self, available, ctx: SelectionContext = None) -> np.ndarray:
        available = np.asarray(available, int)
        n = self.cohort_size(len(available))
        if n >= len(available):
            return available          # select-all: no RNG consumed
        return np.sort(self._rng.choice(available, size=n, replace=False))


class StalenessSelection(SelectionPolicy):
    """REFL-style: most-stale first, least-consumed on ties.

    A device that has been absent (or rejected) for many rounds carries
    the highest staleness — selecting it while it happens to be available
    maximizes the fleet coverage of the aggregate, which is the REFL
    resource-efficiency argument; the counter tie-break folds in Alg. 3's
    balanced-contribution objective."""

    name = "refl"

    def select(self, available, ctx: SelectionContext) -> np.ndarray:
        available = [int(k) for k in available]
        n = self.cohort_size(len(available))
        ranked = sorted(available,
                        key=lambda k: (-int(ctx.staleness[k]),
                                       int(ctx.counters.get(k, 0)), k))
        return np.sort(np.asarray(ranked[:n], int))


class ScoreSelection(SelectionPolicy):
    """Apodotiko-style weighted scoring over capability/balance/staleness.

    score_k = w_cap * cap_k/max(cap) + w_bal * (1 - share_k)
              + w_stale * stale_k/max(stale)

    where share_k is device k's share of all consumed contributions.  The
    top-``n`` scores form the cohort (deterministic: ties break toward
    smaller ids).  Without capability data the capability term is uniform
    (every device scores 1 on it)."""

    name = "score"

    def __init__(self, *, w_capability: float = 0.5, w_balance: float = 0.3,
                 w_staleness: float = 0.2, **kw):
        super().__init__(**kw)
        self.w_capability = float(w_capability)
        self.w_balance = float(w_balance)
        self.w_staleness = float(w_staleness)

    def select(self, available, ctx: SelectionContext) -> np.ndarray:
        available = np.asarray(available, int)
        n = self.cohort_size(len(available))
        if n == 0:
            return available        # nobody on this tick (all devices off)
        if ctx.capability is not None:
            cap = np.asarray(ctx.capability, float)[available]
            cap = cap / max(float(cap.max()), 1e-12)
        else:
            cap = np.ones(len(available))
        total = max(sum(int(v) for v in ctx.counters.values()), 1)
        share = np.asarray([ctx.counters.get(int(k), 0) / total
                            for k in available], float)
        stale = np.asarray(ctx.staleness, float)[available]
        stale = stale / max(float(stale.max()), 1.0)
        score = (self.w_capability * cap + self.w_balance * (1.0 - share)
                 + self.w_staleness * stale)
        order = sorted(range(len(available)),
                       key=lambda i: (-score[i], int(available[i])))
        return np.sort(available[order[:n]])


POLICIES = {
    "random": RandomSelection,
    "refl": StalenessSelection,
    "score": ScoreSelection,
}


def make_selection_policy(spec, *, seed: int = 0) -> SelectionPolicy | None:
    """Resolve a policy spec: None passes through, a SelectionPolicy is
    used as-is, and a string is ``name`` or ``name:fraction`` (e.g.
    ``"refl:0.25"`` selects the most-stale quarter of the fleet)."""
    if spec is None or isinstance(spec, SelectionPolicy):
        return spec
    name, _, frac = str(spec).partition(":")
    if name not in POLICIES:
        raise ValueError(f"unknown selection policy {name!r}; "
                         f"choose from {sorted(POLICIES)}")
    kw = {"seed": seed}
    if frac:
        kw["fraction"] = float(frac)
    return POLICIES[name](**kw)


# ---------------------------------------------------------------------------
# Contribution-balance metric (variance / CV / Gini of consumed counts)
# ---------------------------------------------------------------------------

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
