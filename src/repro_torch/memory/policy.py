"""Eviction/admission policies for the tiered activation store.

When the ω-ring is full and a write wants a slot, the control plane evicts
(spills) one live slot to the host pool, and fills pooled entries back when
slots free up.  Which slot to evict and which entry to fill first is the
policy:

``lru``    evict the slot least recently written/filled; fill oldest-first.
``share``  (default) scheduler-aware: evict the slot whose best-priority
           contributor has the highest consumption share (the counter
           policy will schedule it last); fill the most-underserved first.

Pure functions of host bookkeeping, so plans stay deterministic.  A copy of
the JAX package's ``memory/policy.py``.
"""
from __future__ import annotations


def _min_share(groups, share) -> float:
    """Best (lowest) consumption share among a slot's contributors."""
    return min((share(g) for g in groups), default=float("inf"))


class LRUEviction:
    """Recency policy: evict least-recently-touched, fill oldest-first."""

    name = "lru"

    def victim(self, slots, *, groups_of, share, touch) -> int:
        return min(slots, key=lambda s: (touch[s], s))

    def fill_order(self, keys, *, groups_of, share) -> list:
        return sorted(keys)          # pool keys are monotone: FIFO

    def __repr__(self):
        return f"{type(self).__name__}()"


class ConsumptionShareEviction(LRUEviction):
    """Scheduler-aware policy driven by ``ControlPlane.consumption_share``,
    with LRU recency as the tie-break."""

    name = "share"

    def victim(self, slots, *, groups_of, share, touch) -> int:
        return max(slots,
                   key=lambda s: (_min_share(groups_of(s), share),
                                  -touch[s], -s))

    def fill_order(self, keys, *, groups_of, share) -> list:
        return sorted(keys, key=lambda k: (_min_share(groups_of(k), share), k))


POLICIES = {p.name: p for p in (LRUEviction, ConsumptionShareEviction)}


def make_eviction_policy(name: str):
    """Build an eviction policy by name ("lru" | "share")."""
    try:
        return POLICIES[name]()
    except KeyError:
        raise ValueError(
            f"unknown eviction policy {name!r}; choose from "
            f"{sorted(POLICIES)}") from None
