"""Protocol sanitizer: online invariant checking for the async control plane.

The control-plane modules (``FlowController``, ``TaskScheduler``,
``ControlPlane``, ``RoundExecutor``, ``ActivationStore``) and the
event-simulation loops emit lightweight events at their state
transitions, and an attached :class:`ProtocolSanitizer` checks a
declarative invariant catalogue online — a violation raises
:class:`InvariantViolation` carrying the invariant's name and a bounded
window of the preceding events, so the failure is diagnosable from the
traceback alone.  The catalogue, the events and their fields are the JAX
package's, name for name, so the two event streams can be compared.

Every check reads host state only (flow counters, the scheduler's queues,
the planner's numpy arrays, the store's keys); no event carries a tensor,
so a sanitized round adds no device synchronisation.

The instrumentation is OFF by default: call sites guard on the module
flag ``TRACING`` (one global read per event site), so un-sanitized runs
pay a branch, nothing more.  Attach a sanitizer explicitly::

    from repro_torch.analysis.sanitize import sanitized

    with sanitized() as san:
        simulate_fedoptima(...)
    assert san.n_violations == 0      # online mode raised already
    print(san.report())

or run the driver with ``--sanitize`` (``launch/train.py``, both modes).

Invariant catalogue:

================================  ==========================================
flow-token-conservation           buffered + inflight + granted tokens ≤
                                  ω + pool_cap at every flow transition, and
                                  ``on_device_left`` reclaims the departed
                                  device's token/in-flight budget (the
                                  leaked-token bug, stated as an invariant)
no-unregistered-arrival           an arrival is never *accepted* for a
                                  device the flow controller does not know
                                  (the zombie-arrival bug)
ring-pool-occupancy               live ring slots ≤ ω, occupied pool
                                  entries ≤ pool_cap, and the planner's
                                  pool bookkeeping matches the
                                  ActivationStore's held keys at every
                                  round boundary (the tiered budget)
single-live-chain                 at most one live round chain per device
                                  in the async sim loops; a chain event
                                  carrying a stale epoch means a dead
                                  chain acted on the device (the
                                  churn-flap forked-chain bug)
counter-purge                     a removed device's Alg. 3 consumption
                                  counter is purged once its backlog
                                  drains, and a rejoin starts with fresh
                                  history (§3.4.2; the unbounded
                                  arrival-log / counter leak class)
staleness-monotonicity            the global model version never
                                  decreases, and no per-device version is
                                  ahead of it (Alg. 4 bookkeeping)
retention-rejoin-alpha            a rejoining group aggregates at
                                  α = 1/(staleness+1) from its RETAINED
                                  version — retention metadata, staleness
                                  counters and the planned agg weight must
                                  agree (the retention contract)
================================  ==========================================

The sanitizer mirrors a tiny amount of state per *source object* (keyed
by the emitting scheduler/flow/sim instance, which it keeps alive), so
several runs may interleave under one attached sanitizer.  Not
thread-safe: attach/detach from the driving thread only (the executor
keeps all host bookkeeping on one thread).
"""
from __future__ import annotations

from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field

__all__ = [
    "ProtocolSanitizer", "InvariantViolation", "Invariant", "INVARIANTS",
    "TRACING", "emit", "attach", "detach", "sanitized", "suspended",
]

#: Fast-path guard read by every instrumented call site:
#: ``if _san.TRACING: _san.emit(...)``.  True iff a sanitizer is attached.
TRACING = False

_STACK: list["ProtocolSanitizer"] = []


class InvariantViolation(RuntimeError):
    """A protocol invariant failed.  ``invariant`` is the catalogue name;
    the message embeds the bounded window of events that led here."""

    def __init__(self, invariant: str, message: str, window=()):
        self.invariant = invariant
        self.window = tuple(window)
        tail = ""
        if self.window:
            lines = "\n".join(f"    {i:4d}  {k}  {f}"
                              for i, k, f in self.window)
            tail = f"\n  last {len(self.window)} events:\n{lines}"
        super().__init__(f"[{invariant}] {message}{tail}")


@dataclass(frozen=True)
class Invariant:
    """One declarative protocol invariant.

    ``events`` lists the event kinds the check fires on; ``check`` is
    ``check(san, kind, fields) -> str | None`` returning a violation
    message (None = holds).  ``caught`` names the historical bug class the
    invariant would have caught — the catalogue doubles as documentation.
    """
    name: str
    statement: str
    module: str
    caught: str
    events: tuple
    check: callable = field(compare=False)


# ---------------------------------------------------------------------------
# invariant checks
# ---------------------------------------------------------------------------

def _check_flow_conservation(san, kind, f):
    flow = f["flow"]
    if flow.buffered < 0:
        return f"negative buffered count ({flow.buffered})"
    promised = flow.promised
    if promised > flow.cap:
        return (f"promised={promised} exceeds cap={flow.cap} "
                f"(buffered={flow.buffered}, inflight={flow.inflight}, "
                f"tokens={flow.active_tokens})")
    if kind == "flow.device_left":
        k = f["device"]
        leaks = []
        if k in flow.sender_active:
            leaks.append("sender token")
        if k in flow.inflight_by:
            leaks.append(f"{flow.inflight_by[k]} in-flight send(s)")
        if k in flow._rr:
            leaks.append("round-robin slot")
        if leaks:
            return (f"device {k} left but its {' + '.join(leaks)} "
                    "was not reclaimed — departed devices would "
                    "permanently eat into the ω budget")
    return None


def _check_unregistered_arrival(san, kind, f):
    if f["accepted"] and not f["registered"]:
        return (f"arrival from device {f['device']} was ACCEPTED but the "
                "device is not registered with the flow controller — a "
                "zombie packet retroactively violates the ω cap")
    return None


def _check_ring_pool(san, kind, f):
    cp = f.get("cp")
    if cp is not None and cp.unit == "group":
        if cp.live_slots > cp.omega:
            return (f"{cp.live_slots} live ring slots exceed ω={cp.omega} "
                    f"(occupancy={cp.slot_occupancy})")
        if cp.pool_live > cp.pool_cap:
            return (f"{cp.pool_live} occupied pool entries exceed "
                    f"pool_cap={cp.pool_cap}")
    if cp is not None and not cp.flow.within_cap:
        return (f"flow budget outside the tiered cap: "
                f"buffered={cp.flow.buffered}, promised={cp.flow.promised} "
                f"of cap={cp.flow.cap}")
    store = f.get("store")
    if store is not None and len(store) > store.pool_cap:
        return (f"ActivationStore holds {len(store)} entries past "
                f"pool_cap={store.pool_cap}")
    if store is not None and cp is not None:
        plan_keys = sorted(cp.pool_occupancy)
        if plan_keys != store.keys:
            return (f"planner pool bookkeeping {plan_keys} disagrees with "
                    f"the ActivationStore's held keys {store.keys}")
    return None


def _check_single_chain(san, kind, f):
    st = san._mirror(f["sim"], "chain", lambda: {"epoch": {}, "live": {}})
    k = f["device"]
    if kind == "sim.device_left":
        st["epoch"][k] = st["epoch"].get(k, 0) + 1
        st["live"][k] = False
        return None
    if kind == "sim.device_join":
        if st["live"].get(k, False):
            return (f"device {k} rejoined while a chain from before its "
                    "departure is still live")
        return None
    e, cur = f["epoch"], st["epoch"].get(k, 0)
    if e != cur:
        return (f"{kind} for device {k} carries epoch {e} but the "
                f"device's live epoch is {cur} — a chain that should have "
                "died at departure acted on the device (two concurrent "
                "chains double-count busy time and samples)")
    if kind == "sim.chain_start":
        if st["live"].get(k, False):
            return (f"device {k} started a second concurrent chain "
                    f"(epoch {e})")
        st["live"][k] = True
    elif kind == "sim.chain_end":
        st["live"][k] = False
    return None


def _check_counter_purge(san, kind, f):
    sched = f["sched"]
    st = san._mirror(sched, "sched", lambda: {"removed": set()})
    k = f["device"]
    if kind == "sched.remove":
        if f["drained"]:
            st["removed"].discard(k)
            if k in sched.counters or sched.q_act.get(k):
                return (f"device {k} was removed with a drained backlog "
                        "but its counter/queue was not purged")
        else:
            st["removed"].add(k)
        return None
    if kind == "sched.purge":
        st["removed"].discard(k)
        if k in sched.counters or sched.q_act.get(k):
            return (f"device {k}'s backlog drained after removal but its "
                    "Alg. 3 counter/queue survives — the departed device "
                    "would keep competing under stale history")
        return None
    if kind == "sched.add":
        was_removed = k in st["removed"]
        st["removed"].discard(k)
        if was_removed and sched.counters.get(k, 0) != 0:
            return (f"device {k} rejoined with counter="
                    f"{sched.counters.get(k)} — §3.4.2 requires fresh "
                    "history on rejoin")
    return None


def _check_staleness(san, kind, f):
    cp = f["cp"]
    st = san._mirror(cp, "version", lambda: {"v": None})
    v = int(cp.version)
    if st["v"] is not None and v < st["v"]:
        return (f"global model version went backwards: {st['v']} -> {v}")
    st["v"] = v
    ahead = [int(g) for g in range(cp.G) if int(cp.versions[g]) > v]
    if ahead:
        return (f"device versions {ahead} are ahead of the global "
                f"version {v} (negative staleness)")
    return None


def _check_rejoin_alpha(san, kind, f):
    from repro_torch.core.aggregator import staleness_weight
    cp = f["cp"]
    if kind == "cp.arrival":
        want = staleness_weight(f["version_before"] - f["t_k"],
                                cp.max_delay, cp.alpha_power)
        if abs(f["weight"] - want) > 1e-9:
            return (f"device {f['device']} aggregated at α={f['weight']} "
                    f"but its staleness {f['version_before'] - f['t_k']} "
                    f"implies α={want}")
        return None
    plan = f["plan"]
    for g in plan.restore:
        held = cp.retention.version_of(g) if g in cp.retention else None
        if held is not None and held != int(cp.versions[g]):
            return (f"group {g} rejoins from retained version {held} but "
                    f"its staleness counter says {int(cp.versions[g])} — "
                    "the rejoin would not aggregate at α=1/(k+1)")
    import numpy as np
    active = np.asarray(plan.bcast_mask, float) > 0.5
    for g in range(cp.G):
        want = staleness_weight(cp.version - int(cp.versions[g]),
                                cp.max_delay, cp.alpha_power) \
            if active[g] else 0.0
        if abs(float(plan.agg_weight[g]) - want) > 1e-6:
            return (f"group {g}'s planned agg weight "
                    f"{float(plan.agg_weight[g]):.6f} disagrees with "
                    f"α=1/(staleness+1)={want:.6f} at staleness "
                    f"{cp.version - int(cp.versions[g])}")
    return None


INVARIANTS: tuple[Invariant, ...] = (
    Invariant(
        name="flow-token-conservation",
        statement="buffered + inflight + granted tokens <= omega + "
                  "pool_cap, and on_device_left reclaims the departed "
                  "device's token and in-flight budget",
        module="core/flow_control.py",
        caught="leaked in-flight tokens under churn",
        events=("flow.register", "flow.grant", "flow.sent", "flow.enqueue",
                "flow.dequeue", "flow.device_left", "flow.quarantine"),
        check=_check_flow_conservation),
    Invariant(
        name="no-unregistered-arrival",
        statement="an activation arrival is never accepted for a device "
                  "unknown to the flow controller",
        module="core/flow_control.py",
        caught="zombie arrivals after a drop/rejoin",
        events=("flow.enqueue",),
        check=_check_unregistered_arrival),
    Invariant(
        name="ring-pool-occupancy",
        statement="live ring slots <= omega and pool entries <= pool_cap "
                  "at every round boundary, with planner and "
                  "ActivationStore bookkeeping in agreement",
        module="core/control_plane.py + memory/store.py",
        caught="tiered-budget bookkeeping drift",
        events=("cp.plan", "exec.round"),
        check=_check_ring_pool),
    Invariant(
        name="single-live-chain",
        statement="at most one live round chain per device; chain events "
                  "must carry the device's current epoch",
        module="core/simulation.py + core/baselines.py",
        caught="churn flap forking two concurrent device chains",
        events=("sim.chain_start", "sim.chain_end", "sim.device_left",
                "sim.device_join"),
        check=_check_single_chain),
    Invariant(
        name="counter-purge",
        statement="a removed device's Alg. 3 counter is purged once its "
                  "backlog drains; a rejoin starts with fresh history",
        module="core/scheduler.py",
        caught="counter/arrival-log leak on departure",
        events=("sched.remove", "sched.purge", "sched.add"),
        check=_check_counter_purge),
    Invariant(
        name="staleness-monotonicity",
        statement="the global model version never decreases and no "
                  "per-device version is ahead of it",
        module="core/control_plane.py",
        caught="guards the Alg. 4 bookkeeping the weights derive from",
        events=("cp.plan", "cp.finish", "cp.arrival", "exec.round"),
        check=_check_staleness),
    Invariant(
        name="retention-rejoin-alpha",
        statement="a rejoining group aggregates at alpha=1/(staleness+1) "
                  "from its retained version; planned agg weights match "
                  "the Alg. 4 formula",
        module="core/control_plane.py",
        caught="retention/rejoin contract",
        events=("cp.plan", "cp.arrival"),
        check=_check_rejoin_alpha),
)

_BY_EVENT: dict[str, tuple] = {}
for _inv in INVARIANTS:
    for _ev in _inv.events:
        _BY_EVENT.setdefault(_ev, ())
        _BY_EVENT[_ev] = _BY_EVENT[_ev] + (_inv,)


# ---------------------------------------------------------------------------
# the sanitizer
# ---------------------------------------------------------------------------

_SCALARS = (bool, int, float, str, type(None))


class ProtocolSanitizer:
    """Receives instrumentation events and checks the invariant catalogue.

    window : bounded count of preceding events kept for violation reports
        (scalar fields only — object references are passed to checks but
        never retained in the window).
    raise_on_violation : online mode (default) raises
        :class:`InvariantViolation` at the offending event; post-hoc mode
        (False) collects violations on ``self.violations`` for later
        inspection — e.g. to survey ALL failures of a mutated build
        instead of the first.
    """

    def __init__(self, *, window: int = 64, raise_on_violation: bool = True):
        if window < 1:
            raise ValueError(f"need window >= 1, got {window}")
        self.window = deque(maxlen=window)
        self.raise_on_violation = raise_on_violation
        self.violations: list[InvariantViolation] = []
        self.n_events = 0
        self.counts: dict[str, int] = {}
        # per-source-object mirrors, keyed by id(); the entry holds the
        # object itself so a recycled id can never alias a dead source
        self._mirrors: dict[tuple, tuple] = {}

    # -- event intake ----------------------------------------------------
    def record(self, kind: str, fields: dict):
        self.n_events += 1
        self.counts[kind] = self.counts.get(kind, 0) + 1
        scalars = {k: v for k, v in fields.items()
                   if isinstance(v, _SCALARS)}
        self.window.append((self.n_events, kind, scalars))
        for inv in _BY_EVENT.get(kind, ()):
            msg = inv.check(self, kind, fields)
            if msg is not None:
                self._violate(inv, msg)

    def _violate(self, inv: Invariant, msg: str):
        v = InvariantViolation(inv.name, msg, tuple(self.window))
        self.violations.append(v)
        if self.raise_on_violation:
            raise v

    def _mirror(self, obj, tag: str, factory):
        """Per-source mirror state (see class docstring)."""
        key = (id(obj), tag)
        entry = self._mirrors.get(key)
        if entry is None or entry[0] is not obj:
            entry = (obj, factory())
            self._mirrors[key] = entry
        return entry[1]

    # -- reporting -------------------------------------------------------
    @property
    def n_violations(self) -> int:
        return len(self.violations)

    def report(self) -> dict:
        """JSON-able summary: event totals per kind + violations."""
        return {"events": self.n_events,
                "by_kind": dict(sorted(self.counts.items())),
                "violations": [
                    {"invariant": v.invariant, "message": str(v).split(
                        "\n  last ", 1)[0]}
                    for v in self.violations],
                "n_violations": self.n_violations}


# ---------------------------------------------------------------------------
# attach / emit plumbing
# ---------------------------------------------------------------------------

def emit(kind: str, **fields):
    """Deliver one event to every attached sanitizer.  Call sites guard on
    ``TRACING`` so detached runs never build the kwargs dict."""
    for s in _STACK:
        s.record(kind, fields)


def attach(san: ProtocolSanitizer):
    global TRACING
    _STACK.append(san)
    TRACING = True


def detach(san: ProtocolSanitizer):
    global TRACING
    _STACK.remove(san)
    TRACING = bool(_STACK)


@contextmanager
def sanitized(san: ProtocolSanitizer | None = None, **kw):
    """Attach a sanitizer for the duration of the block (building one from
    ``**kw`` if not supplied) and yield it."""
    s = san if san is not None else ProtocolSanitizer(**kw)
    attach(s)
    try:
        yield s
    finally:
        detach(s)


@contextmanager
def suspended():
    """Temporarily detach ALL sanitizers (overhead baselines: the
    un-sanitized leg of an A/B measurement must not see a globally
    attached sanitizer)."""
    global TRACING, _STACK
    saved, _STACK = _STACK, []
    TRACING = False
    try:
        yield
    finally:
        _STACK = saved
        TRACING = bool(_STACK)
