"""Poison-update quarantine: the validation gate in front of aggregation.

The gate sits between arrival and ``TaskScheduler.put`` / Alg. 4
aggregation.  Every device payload is checked for finiteness and an
absolute norm fence; a failing update is QUARANTINED — dropped before it
touches scheduler counters, the ω ring, or the global model — and the
device takes a strike.  Strikes drive exponential re-admission backoff
(``quarantined_until``), so a persistently-poisoning device is throttled
out of the send path without ever being hard-removed (it heals: each
accepted update forgives one strike).

The gate itself is pure policy — callers own the conservation side (in
the pod round, ``PodFaultInjector.mask_produce`` zeroes the quarantined
group's produce column, so its activations never reach the ring).

The torch port's copy of the JAX package's ``faults/quarantine.py``, on
the port's ``MetricsRegistry``; payloads are numpy stand-ins, as there.
"""
from __future__ import annotations

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry

#: fence on ||update||_inf — generous vs. real gradients (~O(1)) yet far
#: below the 1e12-scaled "huge" poison payload
DEFAULT_NORM_FENCE = 1e6


class UpdateGate:
    """Validation gate with registry-backed check/reject accounting (the
    legacy ``n_checked``/``n_rejected``/``reject_reasons`` attributes are
    read-only views over the instruments; strike state stays plain)."""

    def __init__(self, norm_fence: float = DEFAULT_NORM_FENCE,
                 strike_limit: int = 3, backoff: float = 30.0,
                 backoff_growth: float = 2.0, metrics=None):
        self.norm_fence = norm_fence
        self.strike_limit = strike_limit    # strikes at/after which backoff
        self.backoff = backoff              # base re-admission delay
        self.backoff_growth = backoff_growth
        self.strikes: dict = {}
        self.quarantined_until: dict = {}
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._c_checked = self.metrics.counter("gate.checked")
        self._c_rejected = self.metrics.counter("gate.rejected")
        self._g_struck = self.metrics.gauge("gate.devices_struck")

    # legacy counter names, read-only over the registry instruments
    @property
    def n_checked(self) -> int:
        return int(self._c_checked.value)

    @property
    def n_rejected(self) -> int:
        return int(self._c_rejected.value)

    @property
    def reject_reasons(self) -> dict:
        prefix = "gate.rejected."
        return {name[len(prefix):]: int(c.value)
                for name, c in self.metrics._counters.items()
                if name.startswith(prefix) and c.value}

    # -- payload validation ------------------------------------------------
    def validate(self, payload) -> tuple:
        """(ok, reason) for one update payload (any array-like)."""
        self._c_checked.inc()
        arr = np.asarray(payload, dtype=np.float64)
        if not np.all(np.isfinite(arr)):
            return self._reject("non_finite")
        if arr.size and float(np.max(np.abs(arr))) > self.norm_fence:
            return self._reject("norm_fence")
        return True, ""

    def _reject(self, reason: str) -> tuple:
        self._c_rejected.inc()
        self.metrics.counter(f"gate.rejected.{reason}").inc()
        return False, reason

    # -- per-device strike / backoff policy ---------------------------------
    def note_reject(self, k: int, t: float) -> float:
        """Record a strike for device ``k`` at time ``t``.

        Returns the re-admission delay: 0 while under ``strike_limit``,
        then ``backoff * growth**(strikes - strike_limit)``.
        """
        k = int(k)
        self.strikes[k] = self.strikes.get(k, 0) + 1
        self._g_struck.set(sum(1 for v in self.strikes.values() if v))
        over = self.strikes[k] - self.strike_limit
        if over < 0:
            return 0.0
        delay = self.backoff * self.backoff_growth ** over
        self.quarantined_until[k] = max(
            self.quarantined_until.get(k, 0.0), t + delay)
        return delay

    def note_accept(self, k: int) -> None:
        """A clean accepted update forgives one strike."""
        k = int(k)
        if self.strikes.get(k, 0) > 0:
            self.strikes[k] -= 1
            self._g_struck.set(sum(1 for v in self.strikes.values() if v))

    def may_send(self, k: int, t: float) -> bool:
        return t >= self.quarantined_until.get(int(k), 0.0)

    def summary(self) -> dict:
        return {"n_checked": int(self.n_checked),
                "n_rejected": int(self.n_rejected),
                "reject_reasons": dict(self.reject_reasons),
                "devices_struck": sum(1 for v in self.strikes.values() if v),
                "max_strikes": max(self.strikes.values(), default=0)}


def make_payload(kind: str, seed: int = 0, size: int = 8) -> np.ndarray:
    """Materialize a tiny update payload, optionally poisoned.

    ``kind``: "" (clean) | nan | inf | huge | bitflip.  The injectors carry
    these stand-in arrays through the gate instead of real tensors —
    validation cost stays negligible while exercising every reject path.
    """
    arr = np.random.default_rng(seed).standard_normal(size) * 0.1
    if kind == "nan":
        arr[0] = np.nan
    elif kind == "inf":
        arr[0] = np.inf
    elif kind == "huge":
        arr *= 1e12
    elif kind == "bitflip":
        bits = arr.view(np.uint64)
        bits[0] ^= np.uint64(1) << np.uint64(62)
    elif kind:
        raise ValueError(f"unknown corruption kind {kind!r}")
    return arr
