"""Server memory manager: tiered activation store + eviction policies.

The paper's third pillar ("an efficient memory management mechanism on
the server increases the scalability of the number of participating
devices"): the ω-ring on the card is tier 0 (a cache), a host spill pool
(optionally int8-quantised) is tier 1, and a swappable eviction policy
decides what lives where.  The control plane plans spill/fill moves
instead of refusing sends, and the flow controller admits against the
total tiered budget ω + pool_cap.
"""
from .policy import (ConsumptionShareEviction, LRUEviction, POLICIES,
                     make_eviction_policy)
from .store import ActivationStore

__all__ = ["ActivationStore", "ConsumptionShareEviction", "LRUEviction",
           "POLICIES", "make_eviction_policy"]
