"""Fault injectors: play a :class:`FaultSchedule` into the named seams.

Two injector flavors share the schedule format and the accounting
contract:

* :class:`FaultInjector` — the event-simulator side (``simulate_fedoptima``
  and the six baselines).  The simulator calls ``tag_*_upload`` at send
  seams, ``act_dedupe``/``act_validate``/``model_validate`` at arrival
  seams, and schedules the injector's ``timeouts()``/``crashes()`` windows
  itself (:func:`install_timeouts` for the device timeouts).  Time axis:
  simulated seconds.
* :class:`PodFaultInjector` — the pod-mode
  :class:`~repro_torch.core.executor.RoundExecutor` side.
  ``on_round_start`` raises :class:`InjectedCrash` at a scheduled round
  boundary (the crash-consistent restart path), ``mask_active`` opens
  timeout windows (the timed-out group's slot is reclaimed and its state
  retained for α-rejoin through the retention path), ``mask_produce``
  quarantines poisoned groups, and ``on_checkpoint`` tears a
  just-committed snapshot (:func:`tear_snapshot`).  Time axis: round
  index.

Accounting contract (checked by the tests): every fault is counted as
**injected** at the seam where its effect lands (not when scheduled or
armed), and every injected fault must be matched by a **recovered** count
from the armor that absorbed it — quarantine, α-staleness weighting,
dedupe, timeout rejoin, crash restart, the verified-snapshot fallback.
Events a run never reaches are **unfired** (``scheduled - injected``).
With the gate disabled, poisoned updates flow through unrecovered
(disposition ``consumed_poisoned_*`` or ``admitted_poisoned_act``) and
``report()["matched"]`` is honestly False.

The torch port's copy of the JAX package's ``faults/inject.py``: host
arithmetic on numpy stand-in payloads (``quarantine.make_payload``), no
tensor.  Poison is a tag that rides the simulators' messages, never a
value written into a parameter.  With a tracer attached
(``repro_torch.obs.trace``) the quarantines and timeout windows emit the
reference's ``fault.*`` instants in the sim domain.
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch.obs import trace as _tr

from .quarantine import UpdateGate, make_payload
from .schedule import (BASELINE_CLASSES, POD_CLASSES, SIM_CLASSES,
                       FaultSchedule)

#: schedule classes that arm a device's NEXT upload (consumed one-shot,
#: per device, in time order)
_UPLOAD_CLASSES = ("corrupt_act", "corrupt_model", "duplicate", "delay")


class InjectedCrash(RuntimeError):
    """A scheduled server crash at a round boundary (pod path).  The
    driver persists the fired boundary, then dies; the resumed process
    passes it back via ``fired_crashes`` so the crash fires exactly once."""

    def __init__(self, round_index: int):
        super().__init__(
            f"injected server crash at round boundary {round_index}")
        self.round_index = int(round_index)


class _Accounting:
    """Shared injected/recovered/disposition bookkeeping."""

    def __init__(self, schedule: FaultSchedule, gate, supported):
        self.schedule = schedule
        self.gate = gate
        self.supported = frozenset(supported)
        self.injected: dict[str, int] = {}
        self.recovered: dict[str, int] = {}
        self.disposition: dict[str, int] = {}

    @staticmethod
    def _bump(d: dict, key: str, n: int = 1):
        d[key] = d.get(key, 0) + n

    def note_injected(self, cls: str):
        self._bump(self.injected, cls)

    def note_recovered(self, cls: str, disposition: str = ""):
        self._bump(self.recovered, cls)
        if disposition:
            self._bump(self.disposition, disposition)

    def note_disposition(self, key: str):
        self._bump(self.disposition, key)

    def report(self) -> dict:
        scheduled = {c: n for c, n in self.schedule.counts().items()
                     if c in self.supported}
        unfired = {c: scheduled.get(c, 0) - self.injected.get(c, 0)
                   for c in scheduled}
        classes = set(self.injected) | set(self.recovered)
        return {"scheduled": scheduled,
                "injected": dict(self.injected),
                "recovered": dict(self.recovered),
                "disposition": dict(self.disposition),
                "unfired": unfired,
                "matched": all(self.injected.get(c, 0) ==
                               self.recovered.get(c, 0) for c in classes),
                "gate": self.gate.summary() if self.gate else None}


# ---------------------------------------------------------------------------
# Event-simulator injector
# ---------------------------------------------------------------------------

class FaultInjector(_Accounting):
    """Schedule player for the event simulators (time axis: sim seconds).

    Upload-scoped classes (corrupt/duplicate/delay) arm a device's next
    upload at/after their ``t`` — consumed one-shot in time order.
    Window classes (timeout/server_crash) are exposed via ``timeouts()`` /
    ``crashes()`` for the simulator to schedule as begin/end events.
    """

    def __init__(self, schedule: FaultSchedule, gate: UpdateGate | None = None,
                 supported=SIM_CLASSES):
        super().__init__(schedule, gate, supported)
        self._pending: dict[str, dict[int, list]] = \
            {c: {} for c in _UPLOAD_CLASSES}
        for e in schedule.events:          # already sorted by t
            if e.cls in self._pending and e.cls in self.supported:
                self._pending[e.cls].setdefault(int(e.device), []).append(e)
        self._seq = 0
        self._delivered: set[int] = set()   # duplicate-tagged seqs seen once

    @classmethod
    def for_baseline(cls, schedule, gate=None) -> "FaultInjector":
        """Injector restricted to what full-model baselines can express
        (no activation stream / flow control; server cost is modeled)."""
        return cls(schedule, gate=gate, supported=BASELINE_CLASSES)

    # -- window events for the simulator to schedule ----------------------
    def timeouts(self) -> tuple:
        return self.schedule.by_class("timeout") \
            if "timeout" in self.supported else ()

    def crashes(self) -> tuple:
        return self.schedule.by_class("server_crash") \
            if "server_crash" in self.supported else ()

    # -- upload tagging (send seams) ---------------------------------------
    def _pop(self, cls: str, k: int, t: float):
        q = self._pending[cls].get(int(k))
        if q and q[0].t <= t:
            return q.pop(0)
        return None

    def may_send(self, k: int, t: float) -> bool:
        """Quarantine backoff: a struck device's sends stay paused."""
        return self.gate is None or self.gate.may_send(k, t)

    def tag_act_upload(self, k: int, t: float) -> dict | None:
        """Consume faults armed for device k's next activation upload."""
        e_c = self._pop("corrupt_act", k, t)
        e_d = self._pop("duplicate", k, t)
        if e_c is None and e_d is None:
            return None
        self._seq += 1
        return {"seq": self._seq,
                "kind": e_c.kind if e_c is not None else "",
                "dup_extra": e_d.param if e_d is not None else None}

    def tag_model_upload(self, k: int, t: float) -> tuple:
        """(extra_delay_s, corrupt_kind) for device k's next model upload."""
        e_d = self._pop("delay", k, t)
        e_c = self._pop("corrupt_model", k, t)
        return ((e_d.param if e_d is not None else 0.0),
                (e_c.kind if e_c is not None else ""))

    # -- arrival seams -------------------------------------------------------
    def act_dedupe(self, seq: int) -> bool:
        """True for the first delivery of a duplicate-tagged upload; the
        second delivery is the injected fault, recovered by the drop."""
        if seq in self._delivered:
            self.note_injected("duplicate")
            self.note_recovered("duplicate", "dedup_dropped")
            return False
        self._delivered.add(seq)
        return True

    def act_validate(self, k: int, tag: dict | None, t: float) -> bool:
        """Validation gate for one arriving activation batch.  True →
        admit (poisoned-if-unarmored); False → quarantined, and the CALLER
        must withdraw the flow token (``FlowController.on_quarantined``)
        and not enqueue."""
        kind = tag.get("kind", "") if tag else ""
        if not kind:
            return True
        self.note_injected("corrupt_act")
        if self.gate is None:
            self.note_disposition("admitted_poisoned_act")
            return True
        ok, _ = self.gate.validate(make_payload(kind, seed=tag["seq"]))
        if ok:
            self.note_disposition("gate_missed_act")
            return True
        self.gate.note_reject(k, t)
        self.note_recovered("corrupt_act", "quarantined_act")
        if _tr.TRACING:
            _tr.emit_instant(f"dev/{k}", "fault.quarantine_act", t,
                             kind=kind)
        return False

    def note_accept(self, k: int):
        """A clean admitted update forgives one strike (gate healing)."""
        if self.gate is not None:
            self.gate.note_accept(k)

    def model_validate(self, k: int, kind: str, t: float) -> tuple:
        """(admit, backoff) for one arriving model update.  On quarantine
        the caller skips aggregation and releases the device after
        ``backoff`` (re-sync without consuming the poisoned update)."""
        if not kind:
            return True, 0.0
        self.note_injected("corrupt_model")
        if self.gate is None:
            self.note_disposition("consumed_poisoned_model")
            return True, 0.0
        self._seq += 1
        ok, _ = self.gate.validate(make_payload(kind, seed=self._seq))
        if ok:
            self.note_disposition("gate_missed_model")
            return True, 0.0
        backoff = self.gate.note_reject(k, t)
        self.note_recovered("corrupt_model", "quarantined_model")
        if _tr.TRACING:
            _tr.emit_instant(f"dev/{k}", "fault.quarantine_model", t,
                             kind=kind, backoff=backoff)
        return False, backoff

    def note_delayed_arrival(self):
        """A delay-tagged model arrived: Alg. 4's staleness weighting is
        the armor (weight 0 past max_delay), applied by the control plane
        at aggregation — injected and recovered at the same seam."""
        self.note_injected("delay")
        self.note_recovered("delay", "late_arrival")

    # -- run end ---------------------------------------------------------
    def finalize(self, t_end: float):
        """Close outage windows still open when the run ends (an end event
        scheduled past ``duration`` never fires — the run finishing IS the
        recovery)."""
        del t_end
        for cls in ("timeout", "server_crash"):
            gap = self.injected.get(cls, 0) - self.recovered.get(cls, 0)
            for _ in range(gap):
                self.note_recovered(cls, f"{cls}_closed_at_end")


def install_timeouts(sim, inj: FaultInjector | None, active, trace, *,
                     on_leave=None, on_rejoin=None):
    """Schedule an injector's device-timeout windows into an event sim.

    A timeout is a mid-round blackout, NOT a trace event: the device goes
    dark at the scheduled instant (``on_leave`` fires the protocol's own
    departure handling — chain kill, token reclaim, counter purge) and
    comes back when the window closes, unless a trace tick already brought
    it back ("already_back") or still holds it down ("deferred_to_trace" —
    the trace's own rejoin tick recovers it later).  Shared by
    ``simulate_fedoptima`` and all six baselines so the window accounting
    is one code path."""
    if inj is None:
        return

    def timeout_begin(k, outage_s):
        if not active[k]:
            inj.note_disposition("timeout_noop")     # already away
            return
        inj.note_injected("timeout")
        if _tr.TRACING:
            _tr.emit_instant(f"dev/{k}", "fault.timeout_begin", sim.t,
                             outage_s=outage_s)
        active[k] = False
        if on_leave is not None:
            on_leave(k)
        sim.after(outage_s, timeout_end, k)

    def timeout_end(k):
        if active[k]:
            inj.note_recovered("timeout", "timeout_already_back")
            return
        if trace is not None and not bool(trace.state_at(sim.t)[0][k]):
            inj.note_recovered("timeout", "timeout_deferred_to_trace")
            return
        active[k] = True
        inj.note_recovered("timeout", "timeout_rejoined")
        if _tr.TRACING:
            _tr.emit_instant(f"dev/{k}", "fault.timeout_end", sim.t)
        if on_rejoin is not None:
            on_rejoin(k)

    for ev in inj.timeouts():
        sim.at(ev.t, timeout_begin, int(ev.device), float(ev.param))


# ---------------------------------------------------------------------------
# Pod-mode injector
# ---------------------------------------------------------------------------

class PodFaultInjector(_Accounting):
    """Schedule player for the pod executor (time axis: round index).

    ``fired_crashes`` carries the boundaries already crashed at across
    process restarts (run_pod persists them to ``FAULTS_FIRED.json``), so
    a resumed run counts them recovered instead of re-crashing forever.
    """

    def __init__(self, schedule: FaultSchedule, gate: UpdateGate | None = None,
                 fired_crashes=()):
        super().__init__(schedule, gate, supported=POD_CLASSES)
        self.fired_crashes = {int(x) for x in fired_crashes}
        self._crashes = []
        for e in schedule.by_class("server_crash"):
            if int(e.t) in self.fired_crashes:
                self.note_injected("server_crash")
                self.note_recovered("server_crash", "crash_resumed")
            else:
                self._crashes.append(e)
        self._timeouts = list(schedule.by_class("timeout"))
        self._corrupt = list(schedule.by_class("corrupt_act"))
        self._tears = list(schedule.by_class("torn_checkpoint"))
        self._down_until: dict[int, int] = {}

    # -- round boundary ----------------------------------------------------
    def on_round_start(self, r: int):
        """Raise at a scheduled crash boundary (exactly once per boundary
        across restarts).  The caller persists ``fired_crashes`` BEFORE
        letting the exception kill the process."""
        due = [e for e in self._crashes if int(e.t) <= r]
        if not due:
            return
        self._crashes = [e for e in self._crashes if int(e.t) > r]
        boundary = int(due[0].t)
        self.fired_crashes.add(boundary)
        self.note_injected("server_crash")
        for _ in due[1:]:       # boundaries merged into one restart
            self.note_injected("server_crash")
            self.note_recovered("server_crash", "crash_merged")
            self.fired_crashes.add(int(_.t))
        raise InjectedCrash(r)

    def mask_active(self, r: int, active: np.ndarray) -> np.ndarray:
        """Open/close timeout windows: a timed-out group reads as inactive,
        so the plan retires it (slot reclaimed, state retained) and its
        window end rejoins it through the α-rejoin restore path."""
        active = np.array(active, bool, copy=True)
        still = []
        for e in self._timeouts:
            k = int(e.device)
            if e.t <= r and active[k] and k not in self._down_until:
                self.note_injected("timeout")
                self._down_until[k] = r + max(1, int(round(e.param)))
            else:
                still.append(e)
        self._timeouts = still
        for k, until in list(self._down_until.items()):
            if r < until:
                active[k] = False
            else:
                self.note_recovered("timeout", "timeout_rejoined")
                del self._down_until[k]
        return active

    def mask_produce(self, r: int, produce: np.ndarray,
                     active: np.ndarray) -> np.ndarray:
        """Quarantine poisoned groups for round ``r``: with the gate on, a
        corrupt-upload group's produce column is zeroed (its activations
        never reach the ring — the slot does no-op work this round);
        without the gate the poison flows into server training."""
        due = [e for e in self._corrupt
               if e.t <= r and active[int(e.device)]]
        if not due:
            return produce
        self._corrupt = [e for e in self._corrupt
                         if not any(e is d for d in due)]
        produce = np.array(produce, bool, copy=True)
        for e in due:
            k = int(e.device)
            self.note_injected("corrupt_act")
            if self.gate is None:
                self.note_disposition("admitted_poisoned_act")
                continue
            ok, _ = self.gate.validate(make_payload(e.kind, seed=k + 1))
            if ok:
                self.note_disposition("gate_missed_act")
                continue
            self.gate.note_reject(k, float(r))
            produce[:, k] = False
            self.note_recovered("corrupt_act", "quarantined_act")
        return produce

    def on_checkpoint(self, r: int, directory: str, step: int):
        """Tear the snapshot just committed at round ``r`` (if scheduled).
        Recovery — resume falling back to the newest VERIFIED snapshot —
        is owned by ``checkpoint.store.latest_verified_step``; the tear is
        counted recovered here because the torn snapshot can never be
        half-loaded (checksums/commit markers make it detectable)."""
        due = [e for e in self._tears if int(e.t) <= r]
        if not due:
            return
        self._tears = [e for e in self._tears if int(e.t) > r]
        for e in due:
            tear_snapshot(directory, step, e.kind)
            self.note_injected("torn_checkpoint")
            self.note_recovered("torn_checkpoint", f"torn_{e.kind}")

    def finalize(self, r_end: int):
        del r_end
        for k in list(self._down_until):
            self.note_recovered("timeout", "timeout_closed_at_end")
            del self._down_until[k]


# ---------------------------------------------------------------------------
# Snapshot tearing (the torn_checkpoint fault body)
# ---------------------------------------------------------------------------

def tear_snapshot(directory: str, step: int, mode: str) -> str:
    """Damage a COMMITTED snapshot in place.

    ``truncate`` cuts ``arrays.npz`` in half (load fails), ``bitflip``
    flips one bit mid-file (loads fine — only the per-array checksums
    catch it), ``manifest`` mangles ``tree.json`` (parse fails).  Returns
    the snapshot directory."""
    snap = os.path.join(directory, f"step_{step:08d}")
    arrays = os.path.join(snap, "arrays.npz")
    if mode == "truncate":
        size = os.path.getsize(arrays)
        with open(arrays, "r+b") as fh:
            fh.truncate(max(1, size // 2))
    elif mode == "bitflip":
        size = os.path.getsize(arrays)
        with open(arrays, "r+b") as fh:
            fh.seek(size // 2)
            byte = fh.read(1)
            fh.seek(size // 2)
            fh.write(bytes([byte[0] ^ 0x40]))
    elif mode == "manifest":
        with open(os.path.join(snap, "tree.json"), "w") as fh:
            fh.write("{ torn")
    else:
        raise ValueError(f"unknown tear mode {mode!r}; "
                         "choose truncate | bitflip | manifest")
    return snap
