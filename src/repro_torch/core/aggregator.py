"""Asynchronous staleness-weighted aggregation (paper Alg. 4, lines 12–19).

FedAsync-style: when a local device-side model (θ_dk, θ̃_dk, t_k) arrives,

    if t - t_k > D:  skip (too stale)
    α   = 1 / (t - t_k + 1)
    θ_d  ← α θ_dk + (1-α) θ_d
    θ̃_d  ← α θ̃_dk + (1-α) θ̃_d
    t   ← t + 1

A copy of the JAX package's ``core/aggregator.py``.  The update makes new
tensors (``tree_lerp``) and never writes into the trees it is given.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from repro_torch.models.common import tree_lerp


@dataclass
class AsyncAggregator:
    """Host-side aggregator holding the global device-side model."""
    theta_d: Any                     # global device-side params
    theta_aux: Any                   # global auxiliary params
    max_delay: int = 16              # D
    version: int = 0                 # t
    n_accepted: int = 0
    n_rejected: int = 0
    alpha_power: float = 1.0         # α = (t - t_k + 1)^-alpha_power

    def aggregate(self, theta_dk: Any, theta_aux_k: Any, t_k: int) -> bool:
        """Alg. 4 lines 12–19.  Returns True if the update was applied."""
        alpha = staleness_weight(self.version - t_k, self.max_delay,
                                 self.alpha_power)
        if alpha == 0.0:
            self.n_rejected += 1
            return False
        self.theta_d = tree_lerp(self.theta_d, theta_dk, alpha)
        self.theta_aux = tree_lerp(self.theta_aux, theta_aux_k, alpha)
        self.version += 1
        self.n_accepted += 1
        return True

    def snapshot(self):
        """(θ_d, θ̃_d, t) sent back to a device (Alg. 4 line 20).  The trees
        are the aggregator's own: a receiver that trains in place copies
        them first."""
        return self.theta_d, self.theta_aux, self.version


def staleness_weight(staleness: int, max_delay: int = 16,
                     alpha_power: float = 1.0) -> float:
    """Alg. 4's per-update weight: α = (staleness + 1)^-alpha_power, or 0
    when the update is older than the staleness cap D (line 13's skip)."""
    if staleness > max_delay:
        return 0.0
    return (1.0 / (staleness + 1.0)) ** alpha_power


def fedasync_update(global_tree, local_tree, staleness: int,
                    alpha_power: float = 1.0):
    """Pure functional form: new tensors, the inputs untouched."""
    alpha = (1.0 / (staleness + 1.0)) ** alpha_power
    return tree_lerp(global_tree, local_tree, alpha)
