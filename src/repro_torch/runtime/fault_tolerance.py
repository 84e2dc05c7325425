"""Fault tolerance policy: checkpoint/restart + device churn handling.

Two layers of resilience:

1. **FL-native elasticity** (paper §3.4.2): device groups joining or
   leaving never block training; the simulator and the pod round both
   tolerate any subset of devices being active.  :class:`ChurnModel`
   reproduces §6.4: every ``interval`` simulated seconds each device
   drops with probability p and rejoins at the next boundary; bandwidth
   is re-drawn uniformly from [bw_lo, bw_hi].  The simulators take it as
   ``churn=``, materialised onto a fleet trace
   (``repro_torch.fleet.FleetTrace.from_churn``).

2. **Checkpoint/restart** for the server job itself:
   :class:`CheckpointPolicy` decides when to snapshot (step cadence +
   wall-clock cadence), and :func:`resume_or_init` restores the newest
   committed snapshot that passes integrity verification
   (``store.verify_snapshot``) after a crash — a snapshot torn after
   commit is skipped and reported, never half-loaded.

A copy of the JAX package's ``runtime/fault_tolerance.py`` on the port's
checkpoint store (``repro_torch.checkpoint.store``).
"""
from __future__ import annotations

import math
import sys
from dataclasses import dataclass, field

import numpy as np

from repro_torch.checkpoint import store
from repro_torch.obs.clock import now as _now


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


@dataclass
class CheckpointPolicy:
    directory: str
    every_steps: int = 100
    every_seconds: float = 600.0
    retain: int = 3
    _last_step: int = 0
    _last_time: float = field(default_factory=_now)

    def should_save(self, step: int) -> bool:
        now = _now()
        due = (step - self._last_step >= self.every_steps or
               now - self._last_time >= self.every_seconds)
        return due

    def note_resume(self, step: int):
        """Seed the cadence from a resumed step so the first
        ``should_save`` after restart measures from the restored snapshot,
        not from the dataclass defaults (``_last_step=0`` would otherwise
        make a resume at step 5000 save again immediately)."""
        self._last_step = int(step)
        self._last_time = _now()

    def save(self, step: int, tree, metadata=None, extras=None):
        path = store.save(self.directory, step, tree, metadata, self.retain,
                          extras=extras)
        self._last_step = step
        self._last_time = _now()
        return path


def resume_or_init(directory: str, init_fn, like=None, policy=None):
    """Restore the newest *verified* snapshot, else build fresh state.

    init_fn() -> state tree; `like` defaults to init_fn()'s structure.
    Snapshots that fail integrity verification (torn payload, checksum
    mismatch, unreadable manifest) are skipped with a warning — the next
    older retained snapshot is tried, so a tear can cost at most the
    retention window, never a half-loaded state.  When ``policy`` (a
    :class:`CheckpointPolicy`) is given, its save cadence is seeded from
    the resumed step.  Returns (state, start_step).
    """
    step, skipped = store.latest_verified_step(directory)
    for bad_step, reason in skipped:
        print(f"resume_or_init: skipping torn snapshot step {bad_step}: "
              f"{reason}", file=sys.stderr)
    template = like if like is not None else init_fn()
    if step is None:
        return template, 0
    state = store.restore(directory, step, template)
    if policy is not None:
        policy.note_resume(step)
    return state, step
