"""Device churn: the paper's unstable-environment protocol (§6.4).

FL-native elasticity (paper §3.4.2): device groups joining or leaving
never block training; the simulator and the pod round both tolerate any
subset of devices being active.  :class:`ChurnModel` reproduces §6.4:
every ``interval`` simulated seconds each device drops with probability
p and rejoins at the next boundary; bandwidth is re-drawn uniformly from
[bw_lo, bw_hi].  The simulators take it as ``churn=``, materialised onto
a fleet trace (``repro_torch.fleet.FleetTrace.from_churn``).

A copy of ``ChurnModel`` from the JAX package's
``runtime/fault_tolerance.py``.  The module's other half, checkpoint and
restart (``CheckpointPolicy``, ``resume_or_init``), comes with ROADMAP
item A3, checkpoints.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass
class ChurnModel:
    n_devices: int
    p_drop: float = 0.0
    interval: float = 600.0          # re-draw every 10 simulated minutes (§6.4)
    bw_lo: float = 25e6 / 8          # bytes/s (25 Mbps)
    bw_hi: float = 50e6 / 8
    seed: int = 0

    def draw(self, t: float):
        """State for the interval containing time t: (active mask, bw).

        The draw is a pure function of ``(seed, interval_index)`` — NOT of
        how many times / in what order ``draw`` was called — so the
        availability at time t is the same whether a consumer replays the
        whole grid (``FleetTrace.from_churn``), queries one boundary, or
        re-queries mid-run.
        """
        idx = int(math.floor(t / self.interval + 1e-9))
        rng = np.random.default_rng([self.seed, idx])
        active = rng.random(self.n_devices) >= self.p_drop
        bw = rng.uniform(self.bw_lo, self.bw_hi, size=self.n_devices)
        return active, bw
