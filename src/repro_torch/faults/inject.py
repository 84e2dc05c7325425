"""Fault injection on the pod round: play a :class:`FaultSchedule` into the
executor's seams (time axis: round index).

:class:`PodFaultInjector` is the pod-mode
:class:`~repro_torch.core.executor.RoundExecutor` side.
``on_round_start`` raises :class:`InjectedCrash` at a scheduled round
boundary (the crash-consistent restart path), ``mask_active`` opens
timeout windows (the timed-out group's slot is reclaimed and its state
retained for α-rejoin through the retention path), ``mask_produce``
quarantines poisoned groups, and ``on_checkpoint`` tears a just-committed
snapshot (:func:`tear_snapshot`).

Accounting contract (checked by the tests): every fault is counted as
**injected** at the seam where its effect lands (not when scheduled or
armed), and every injected fault must be matched by a **recovered** count
from the armor that absorbed it — quarantine, timeout rejoin, crash
restart, the verified-snapshot fallback.  Events a run never reaches are
**unfired** (``scheduled - injected``).  With the gate disabled, poisoned
activations flow through unrecovered (disposition
``admitted_poisoned_act``) and ``report()["matched"]`` is honestly False.

The torch port's pod half of the JAX package's ``faults/inject.py``: the
simulators' half (``FaultInjector``, ``install_timeouts`` and their tracer
instants) comes with ROADMAP item A7.3a, the fault plane in the
simulators.
"""
from __future__ import annotations

import os

import numpy as np

from .quarantine import UpdateGate, make_payload
from .schedule import POD_CLASSES, FaultSchedule


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
