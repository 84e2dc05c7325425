"""Memory-bounded activation flow control (paper §3.4.1).

A global buffering cap ω bounds Σ_k |Q_k^act| ≤ ω.  Each device holds a
Sender Status token: after one send it deactivates until the server grants
a 'turn-on', and grants are issued only while everything buffered or
promised stays within ω — a strict invariant::

    buffered + inflight + active_tokens <= omega        (always)

Grants go round-robin.

Tiered budget: with ``pool_cap > 0`` admission is accounted against the
total budget ω + pool_cap, and ``omega`` stays the first tier's capacity;
admissions beyond it are counted by ``n_spilled``, and ``n_filled`` counts
the dequeues that bring such a unit back under it.  This is accounting
only (the event simulator's default budget); no store is involved.  With
``pool_cap == 0`` the controller is the strict Eq. 3 one, bit for bit.

A copy of the JAX package's controller, its sanitizer emits included.
``on_quarantined`` is the simulators' fault-plane seam: a poisoned
arrival that the update gate rejects gives back its in-flight unit.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from repro_torch.analysis import sanitize as _san


@dataclass
class FlowController:
    omega: int                              # first-tier activation cap ω
    pool_cap: int = 0                       # spill-tier budget (flow units)
    sender_active: dict = field(default_factory=dict)   # device -> bool
    buffered: int = 0                       # Σ_k |Q_k^act| (server view)
    inflight_by: dict = field(default_factory=dict)     # device -> sends
    n_spilled: int = 0                      # admissions beyond ω
    n_filled: int = 0                       # spilled units dequeued
    grants: deque = field(default_factory=lambda: deque(maxlen=256))
    _rr: list = field(default_factory=list)              # round-robin order

    # test-only mutation hook (no annotation -> NOT a dataclass field):
    # True re-introduces the leaked-token bug — on_device_left stops
    # reclaiming the departed device's token/in-flight budget, so the
    # sanitizer's flow-token-conservation invariant must fire.  Never set
    # outside tests.
    _test_skip_reclaim = False

    @property
    def cap(self) -> int:
        """Total admission budget: ω + pool_cap."""
        return self.omega + self.pool_cap

    def register(self, k: int):
        """New device: its sender starts inactive; a token is granted if
        the cap allows."""
        if k in self.sender_active:
            return
        self.sender_active[k] = False
        self._rr.append(k)
        self._maybe_grant()
        if _san.TRACING:
            _san.emit("flow.register", flow=self, device=k)

    def unregister(self, k: int):
        self.on_device_left(k)

    # -- device side --
    def can_send(self, k: int) -> bool:
        return self.sender_active.get(k, False)

    def mark_sent(self, k: int):
        """Device consumed its token -> becomes an in-flight send."""
        if not self.sender_active.get(k, False):
            raise RuntimeError(
                f"device {k} sent without a token (buffered={self.buffered}, "
                f"inflight={self.inflight}, tokens={self.active_tokens}, "
                f"cap={self.cap})")
        self.sender_active[k] = False
        self.inflight_by[k] = self.inflight_by.get(k, 0) + 1
        if _san.TRACING:
            _san.emit("flow.sent", flow=self, device=k)

    def inflight_of(self, k: int) -> int:
        return self.inflight_by.get(k, 0)

    # -- server side --
    def on_enqueue(self, k: int) -> bool:
        """Admit an arriving activation batch; False for an unaccounted
        arrival (its sender's budget was reclaimed), which must be dropped."""
        n = self.inflight_by.get(k, 0)
        accepted = n > 0
        if accepted:
            if n == 1:
                self.inflight_by.pop(k)
            else:
                self.inflight_by[k] = n - 1
            self.buffered += 1
            if self.buffered > self.omega:
                self.n_spilled += 1    # admitted into the spill tier
            self._maybe_grant()
        if _san.TRACING:
            _san.emit("flow.enqueue", flow=self, device=k, accepted=accepted,
                      registered=k in self.sender_active)
        return accepted

    def on_dequeue(self, k: int):
        if self.buffered > self.omega:
            self.n_filled += 1     # a spilled unit moves up a tier
        self.buffered = max(0, self.buffered - 1)
        self._maybe_grant()
        if _san.TRACING:
            _san.emit("flow.dequeue", flow=self, device=k)

    def on_quarantined(self, k: int):
        """An arriving batch failed validation (poison quarantine): the
        send happened — ``mark_sent`` moved a token into in-flight — but
        the payload must never be buffered.  Withdraw exactly one in-flight
        unit and re-grant, so Eq. 3 conservation holds with the quarantined
        unit simply returned to the budget (``buffered`` is untouched: a
        quarantined batch never entered a tier, so the spill/fill counters
        stay exact)."""
        n = self.inflight_by.get(k, 0)
        if n == 1:
            self.inflight_by.pop(k)
        elif n > 1:
            self.inflight_by[k] = n - 1
        self._maybe_grant()
        if _san.TRACING:
            _san.emit("flow.quarantine", flow=self, device=k,
                      withdrawn=n > 0)

    def on_device_left(self, k: int):
        """Reclaim a dropped device's token and in-flight sends."""
        if not self._test_skip_reclaim:
            self.sender_active.pop(k, None)
            self.inflight_by.pop(k, None)
            if k in self._rr:
                self._rr.remove(k)
        self._maybe_grant()
        if _san.TRACING:
            _san.emit("flow.device_left", flow=self, device=k)

    # -- invariant-preserving grant --
    @property
    def inflight(self) -> int:
        return sum(self.inflight_by.values())

    @property
    def active_tokens(self) -> int:
        return sum(1 for v in self.sender_active.values() if v)

    @property
    def promised(self) -> int:
        return self.buffered + self.inflight + self.active_tokens

    def _maybe_grant(self):
        if not self._rr:
            return
        n = len(self._rr)
        scanned = 0
        while self.promised < self.cap and scanned < n:
            k = self._rr.pop(0)      # a scanned device moves to the back
            self._rr.append(k)
            scanned += 1
            if not self.sender_active.get(k, False):
                self.sender_active[k] = True
                self.grants.append(k)
                scanned = 0          # re-scan: more room may remain
                if _san.TRACING:
                    _san.emit("flow.grant", flow=self, device=k)

    @property
    def within_cap(self) -> bool:
        """Buffered and promised units within ω + pool_cap."""
        return self.buffered <= self.cap and self.promised <= self.cap
