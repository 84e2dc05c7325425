"""Task Scheduler (paper Alg. 2 & 3): model/activation queues + counters.

put():  models -> Q_model; activations -> Q_act[k]   (Alg. 2)
get():  models first (priority); else the activation queue of the device
        with the smallest consumption counter c_k      (Alg. 3)

The counter-based policy prevents fast devices from dominating server-side
training (Challenge 3).  A FIFO policy is included for the §6.5.2 ablation.
A copy of the JAX package's scheduler, its sanitizer emits included.  The
pod path carries ring slots in ``content`` (the tiered store withdraws a
spilled slot's messages and puts them back on fill); the event simulator
also stamps each activation with its size and arrival time.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any

from repro_torch.analysis import sanitize as _san


@dataclass
class Message:
    kind: str              # "model" | "activation"
    origin: int            # device id
    content: Any = None
    size_bytes: float = 0.0
    enqueued_at: float = 0.0


class TaskScheduler:
    """Counter-based scheduler (default) or FIFO (ablation)."""

    def __init__(self, n_devices: int, policy: str = "counter"):
        if policy not in ("counter", "fifo"):
            raise ValueError(
                f"unknown scheduler policy {policy!r}; expected 'counter' "
                "or 'fifo'")
        self.policy = policy
        self.q_model: deque[Message] = deque()
        self.q_act: dict[int, deque[Message]] = {k: deque()
                                                 for k in range(n_devices)}
        self.counters: dict[int, int] = {k: 0 for k in range(n_devices)}
        self._arrival: deque[int] = deque()   # device order of arrivals
        self._removed: set[int] = set()       # departed, backlog draining

    # -- dynamic device membership (elastic) --
    def add_device(self, k: int):
        if k in self._removed:                # rejoin starts fresh
            self._removed.discard(k)
            self.counters[k] = 0
        self.q_act.setdefault(k, deque())
        self.counters.setdefault(k, 0)
        if _san.TRACING:
            _san.emit("sched.add", sched=self, device=k)

    def remove_device(self, k: int):
        """Departure (§3.4.2): buffered activations still drain through
        ``get`` under the device's accumulated counter; counter and queue
        are purged once drained."""
        drained = not self.q_act.get(k)
        if drained:
            self.q_act.pop(k, None)
            self.counters.pop(k, None)
            self._removed.discard(k)
        else:
            self._removed.add(k)
        if _san.TRACING:
            _san.emit("sched.remove", sched=self, device=k, drained=drained)

    # -- Alg. 2 --
    def put(self, m: Message):
        if m.kind == "model":
            self.q_model.append(m)
        else:
            self.add_device(m.origin)
            self.q_act[m.origin].append(m)
            if self.policy == "fifo":
                self._arrival.append(m.origin)

    def _serve(self, k: int) -> Message:
        msg = self.q_act[k].popleft()
        if k in self.counters:
            self.counters[k] += 1
        self._purge_if_drained(k)
        return msg

    def _purge_if_drained(self, k: int):
        if k in self._removed and not self.q_act.get(k):
            self.q_act.pop(k, None)
            self.counters.pop(k, None)
            self._removed.discard(k)
            if _san.TRACING:
                _san.emit("sched.purge", sched=self, device=k)

    # -- Alg. 3 --
    def get(self) -> Message | None:
        if self.q_model:
            return self.q_model.popleft()
        if self.policy == "fifo":
            while self._arrival:
                k = self._arrival.popleft()   # lazily drains stale entries
                if self.q_act.get(k):
                    return self._serve(k)
            return None
        pending = [k for k, q in self.q_act.items() if q]
        if not pending:
            return None
        k = min(pending, key=lambda d: (self.counters.get(d, 0), d))
        return self._serve(k)

    def drain_slot(self, s: Any, groups) -> None:
        """Slot-granular consumption: every listed group's buffered
        contribution to ring slot ``s`` is popped and counted."""
        for g in groups:
            q = self.q_act.get(g)
            if not q:
                continue
            for m in list(q):
                if m.content == s:
                    q.remove(m)
                    if g in self.counters:
                        self.counters[g] += 1
                    if self.policy == "fifo":
                        try:
                            self._arrival.remove(g)
                        except ValueError:
                            pass
                    break
            self._purge_if_drained(g)

    def withdraw_slot(self, s: Any, groups) -> None:
        """Spill-tier withdrawal: each listed group's buffered contribution
        to ring slot ``s`` leaves the queues WITHOUT being counted as
        consumed; the payload moves to the host spill pool and its messages
        are re-``put`` on fill.  Under FIFO the arrival-log entry retired is
        the one MATCHING the withdrawn message (a group's arrival entries
        appear in its queue order, and eviction, unlike consumption, may
        take a newer message than the group's oldest), so unspilled
        contributions keep their arrival position; the spill/fill round
        trip itself re-enqueues at the back of the arrival order."""
        for g in groups:
            q = self.q_act.get(g)
            if not q:
                continue
            for idx, m in enumerate(list(q)):
                if m.content == s:
                    q.remove(m)
                    if self.policy == "fifo":
                        self._drop_arrival(g, idx)
                    break
            self._purge_if_drained(g)

    def _drop_arrival(self, g: int, nth: int) -> None:
        """Delete the (nth+1)-th occurrence of ``g`` from the arrival log
        (the entry for g's queue position ``nth``)."""
        seen = 0
        for j, a in enumerate(self._arrival):
            if a == g:
                if seen == nth:
                    del self._arrival[j]
                    return
                seen += 1

    # -- introspection --
    @property
    def total_buffered(self) -> int:
        return sum(len(q) for q in self.q_act.values())

    def buffered(self, k: int) -> int:
        return len(self.q_act.get(k, ()))

    @property
    def has_model(self) -> bool:
        return bool(self.q_model)

    @property
    def has_activation(self) -> bool:
        return any(self.q_act.values())
