"""Deterministic event-driven FL cluster simulator.

Models a server + K heterogeneous devices with per-device compute rates
o_k (FLOP/s) and bandwidths b_k (bytes/s), full-duplex links, a serialized
server compute engine, and FedOptima's Task Scheduler + activation flow
control.  Produces the paper's system metrics — idle time (Fig. 8/9),
throughput (Fig. 10/11), communication volume (Fig. 2), resilience under
churn (Fig. 12/13) — and, when a ``hooks`` object is supplied, drives
real training in event order (``core/learning.FedOptimaLearner`` on the
card), so accuracy runs use genuine learning dynamics.

Simulated time is in seconds; nothing here sleeps.

A copy of the JAX package's ``core/simulation.py`` with its fleet plane
(``repro_torch.fleet``): churn, fleet traces, participant selection and
the elastic registry.  The same events are pushed in the same order
(``Sim`` breaks ties in time by push order, so one event more or fewer
would reorder every later tie), and the metrics are the same, bit for
bit.  With a tracer attached (``repro_torch.obs.trace``) the busy
intervals, uploads and roster changes become spans and instants in the
sim domain, in the reference's emission order, so the traces are equal
too.  With a protocol sanitizer attached
(``repro_torch.analysis.sanitize``) the device chains and the roster
changes emit the reference's ``sim.*`` events, field for field, so the
event streams are equal as well.  With a fault schedule
(``repro_torch.faults``) the injector's seams sit where the reference's
do: duplicated and delayed uploads push their extra arrivals in the same
order, quarantines and server crashes push the same re-syncs, and
``Metrics.faults`` is the reference's report.  Poison is a tag on the
message, never a value: a quarantined batch never reaches the hooks.  The
baselines (``core/baselines.py``) run on the same engine and ``Metrics``.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np

from repro_torch.analysis import sanitize as _san
from repro_torch.faults.inject import FaultInjector, install_timeouts
from repro_torch.faults.quarantine import UpdateGate
from repro_torch.fleet.devices import heterogeneous_cluster  # noqa: F401
from repro_torch.fleet.selection import (SelectionContext, balance_summary,
                                         make_selection_policy)
from repro_torch.fleet.traces import FleetTrace, install_fleet, resolve_fleet
from repro_torch.obs import trace as _tr

from .control_plane import ControlPlane
from .executor import StragglerProfiles
from .scheduler import Message

# test-only mutation hook: True re-introduces the churn-flap bug — the
# per-device epoch check in ``model_return`` is skipped, so a
# pre-departure round's return restarts the device on top of its rejoined
# chain and the sanitizer's single-live-chain invariant must fire.  Never
# set outside tests.
_TEST_SKIP_EPOCH_CHECK = False


# ---------------------------------------------------------------------------
# Workload + cluster description
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SimModel:
    """Per-iteration compute/communication costs (batch granularity)."""
    dev_fwd_flops: float        # device-side block forward, per batch
    dev_bwd_flops: float        # device-side backward (incl. aux for FedOptima)
    full_fwd_flops: float       # full model forward, per batch (classic FL)
    srv_flops_per_batch: float  # server-side fwd+bwd per activation batch
    act_bytes: float            # one activation batch
    dev_model_bytes: float      # device-side (+aux) model
    full_model_bytes: float
    batch_size: int
    agg_flops: float = 1e7      # aggregation cost on server per model


@dataclass
class SimCluster:
    dev_flops: np.ndarray       # (K,) FLOP/s
    dev_bw: np.ndarray          # (K,) bytes/s
    srv_flops: float

    @property
    def K(self) -> int:
        return len(self.dev_flops)


# ---------------------------------------------------------------------------
# Engine + metrics
# ---------------------------------------------------------------------------

class Sim:
    def __init__(self):
        self.t = 0.0
        self._heap: list = []
        self._seq = 0

    def at(self, t: float, fn, *args):
        heapq.heappush(self._heap, (t, self._seq, fn, args))
        self._seq += 1

    def after(self, dt: float, fn, *args):
        self.at(self.t + dt, fn, *args)

    def run(self, until: float):
        while self._heap and self._heap[0][0] <= until:
            self.t, _, fn, args = heapq.heappop(self._heap)
            fn(*args)
        self.t = until


@dataclass
class Metrics:
    """The run's accounting.  ``rounds`` counts the synchronous
    baselines' rounds; ``simulate_fedoptima`` never sets it."""
    K: int
    duration: float = 0.0
    dev_busy: np.ndarray = None
    srv_busy: float = 0.0
    bytes_up: float = 0.0
    bytes_down: float = 0.0
    dev_samples: int = 0          # samples trained on devices
    srv_batches: int = 0          # activation batches consumed by the server
    aggregations: int = 0
    rounds: int = 0
    max_buffered: int = 0         # peak Σ|Q_act| (memory check)
    profiles: StragglerProfiles = None   # measured per-device EMAs
    dev_consumed: np.ndarray = None      # (K,) per-device contributions the
                                         # server consumed
    registry: object = None              # ElasticRegistry mirroring trace
                                         # join/leave events (fleet runs)
    faults: dict = None                  # FaultInjector.report() for runs
                                         # under a fault schedule: per-class
                                         # injected/recovered/disposition
                                         # counters + gate summary
    # -- steady-state (warmup-excluded) accounting: warmup ends at the
    #    server's first dequeue (pipeline fill); see note_warmup_end
    warmup_t: float = None
    dev_busy_steady: np.ndarray = None
    srv_busy_steady: float = 0.0
    dev_samples_steady: int = 0

    def __post_init__(self):
        if self.dev_busy is None:
            self.dev_busy = np.zeros(self.K)
        if self.dev_consumed is None:
            self.dev_consumed = np.zeros(self.K, np.int64)
        if self.dev_busy_steady is None:
            self.dev_busy_steady = np.zeros(self.K)

    # -- derived --
    @property
    def dev_idle_frac(self) -> float:
        return float(np.mean(1.0 - self.dev_busy / max(self.duration, 1e-9)))

    @property
    def srv_idle_frac(self) -> float:
        return 1.0 - self.srv_busy / max(self.duration, 1e-9)

    @property
    def throughput(self) -> float:
        return self.dev_samples / max(self.duration, 1e-9)

    def comm_per_round(self, total_dataset: int) -> float:
        """Bytes up and down per pass over a dataset of ``total_dataset``
        samples (Fig. 2)."""
        if self.dev_samples == 0:
            return 0.0
        rounds = self.dev_samples / total_dataset
        return (self.bytes_up + self.bytes_down) / max(rounds, 1e-9)

    # -- per-device contribution balance (Alg. 3's fairness objective) --
    def note_contribution(self, k: int):
        """The server consumed one contribution of device k."""
        self.dev_consumed[k] += 1

    def contribution_balance(self) -> dict:
        """Variance / CV / Gini of per-device consumed counts (0-Gini =
        perfectly balanced contributions across the fleet)."""
        return balance_summary(self.dev_consumed)

    # -- busy-interval accounting (one mechanism for every protocol) ----
    #
    # Simulators call these instead of touching dev_busy/srv_busy
    # directly: the interval feeds (a) the totals, (b) the steady-state
    # accumulators, and (c) — only when a tracer is attached — a span on
    # the device/server lane.
    def note_warmup_end(self, t: float):
        """The server started real work: everything before is pipeline
        fill.  Idempotent; note_srv_busy calls it defensively."""
        if self.warmup_t is None:
            self.warmup_t = float(t)

    def note_dev_busy(self, k: int, start: float, end: float, *,
                      name: str = "step", lane: str | None = None,
                      samples: int = 0):
        self.dev_busy[k] += end - start
        if samples:
            self.dev_samples += samples
        if self.warmup_t is not None:
            self.dev_busy_steady[k] += max(0.0,
                                           end - max(start, self.warmup_t))
            if samples and end >= self.warmup_t:
                self.dev_samples_steady += samples
        if _tr.TRACING:
            _tr.emit_span(lane if lane is not None else f"dev/{k}",
                          name, start, end, clip=True)

    def note_srv_busy(self, start: float, end: float, *,
                      name: str = "train_batch", lane: str = "srv"):
        self.note_warmup_end(start)
        self.srv_busy += end - start
        self.srv_busy_steady += end - max(start, self.warmup_t)
        if _tr.TRACING:
            _tr.emit_span(lane, name, start, end, clip=True)

    def steady_summary(self) -> dict:
        """Warmup-excluded idle/throughput stats."""
        w = self.warmup_t if self.warmup_t is not None else self.duration
        steady = max(self.duration - w, 0.0)
        if steady <= 0.0:
            return {"warmup_s": w, "steady_s": 0.0,
                    "srv_idle_frac_steady": 0.0,
                    "dev_idle_frac_steady": 0.0,
                    "throughput_steady": 0.0}
        return {
            "warmup_s": w,
            "steady_s": steady,
            "srv_idle_frac_steady": 1.0 - self.srv_busy_steady / steady,
            "dev_idle_frac_steady":
                float(np.mean(1.0 - self.dev_busy_steady / steady)),
            "throughput_steady": self.dev_samples_steady / steady,
        }

    def to_registry(self, reg=None, at: float | None = None):
        """Mirror the run's accounting into a MetricsRegistry (fresh one
        by default).  ``at`` overrides the horizon for mid-run dumps."""
        from repro_torch.obs.metrics import MetricsRegistry
        if reg is None:
            reg = MetricsRegistry()
        horizon = max(self.duration if at is None else at, 1e-9)
        for name, v in (("sim.dev_busy_s", float(self.dev_busy.sum())),
                        ("sim.srv_busy_s", self.srv_busy),
                        ("sim.bytes_up", self.bytes_up),
                        ("sim.bytes_down", self.bytes_down),
                        ("sim.dev_samples", self.dev_samples),
                        ("sim.srv_batches", self.srv_batches),
                        ("sim.aggregations", self.aggregations)):
            inst = reg.counter(name)
            inst.inc(max(v - inst.value, 0.0))
        reg.gauge("sim.max_buffered").set(self.max_buffered)
        reg.gauge("sim.srv_idle_frac").set(
            1.0 - self.srv_busy / horizon)
        reg.gauge("sim.dev_idle_frac").set(
            float(np.mean(1.0 - self.dev_busy / horizon)))
        reg.gauge("sim.throughput").set(self.dev_samples / horizon)
        if self.warmup_t is not None and at is None:
            ss = self.steady_summary()
            for key in ("srv_idle_frac_steady", "dev_idle_frac_steady",
                        "throughput_steady", "warmup_s"):
                reg.gauge(f"sim.{key}").set(ss[key])
        return reg


# ---------------------------------------------------------------------------
# FedOptima simulation (paper §3.3, Alg. 1–4, Fig. 1(d))
# ---------------------------------------------------------------------------

def simulate_fedoptima(model: SimModel, cluster: SimCluster, *,
                       duration: float, omega: int = 8, H: int = 10,
                       max_delay: int = 16, policy: str = "counter",
                       pool_cap: int = 0,
                       hooks=None, churn=None, fleet=None, selection=None,
                       registry=None, seed: int = 0,
                       control: ControlPlane | None = None,
                       profiles: StragglerProfiles | None = None,
                       faults=None, fault_gate=None,
                       metrics_every: float = 0.0) -> Metrics:
    """Event simulation of FedOptima.

    hooks (optional): object with callbacks driving real training:
        device_iter(k, send: bool) -> None   (one local SGD iteration;
                                              if send, its activations ship)
        server_train(k) -> None              (server consumes one batch of k)
        aggregate(k) -> None                 (async aggregation of device k)
    control (optional): a ControlPlane supplying the scheduler, flow
        controller and staleness accounting; by default one is built with
        per-device flow units (Eq. 3: Σ_k |Q_k^act| ≤ ω strict).  Passing
        it in lets callers inspect peak buffers / counters afterwards.
    pool_cap: spill-tier budget in device activation batches: admission
        runs against ω + pool_cap, so up to pool_cap batches beyond ω may
        buffer (counted by the flow controller's n_spilled/n_filled).
        0 = the strict Eq. 3 cap.
    profiles (optional): a StragglerProfiles fed with the measured
        per-device iteration/transfer durations and server batch times as
        they complete (EMA); by default one is created.  It is returned on
        ``Metrics.profiles``.
    fleet (optional): a ``FleetTrace`` driving device availability and
        bandwidth, one tick per ``trace.interval``; ``churn`` (a
        ``ChurnModel``) is materialised onto the same grid
        (``FleetTrace.from_churn``).  Not both.
    selection (optional): a participant-selection policy or its spec
        (``"refl:0.5"``), seeded by ``seed``: each tick it picks the
        cohort from the available devices.  Without a trace it gets a
        static identity trace for its ticks.
    registry (optional): an ``ElasticRegistry`` mirroring the roster; a
        fleet run makes one.  Returned on ``Metrics.registry``.
    faults (optional): a ``repro_torch.faults.FaultSchedule`` (or a
        prebuilt ``FaultInjector``) played into the run's seams — upload
        corruption, duplicate/delayed arrivals, device timeouts, server
        crashes.  Every injected fault is matched by a recovery counter
        on ``Metrics.faults`` (quarantine, dedupe, α-weighting, rejoin,
        restart; see ``repro_torch.faults.inject``).
    fault_gate: the poison-update validation gate paired with
        ``faults``: None builds a default ``UpdateGate``, an instance is
        used as-is, and False disables the gate (poisoned updates flow
        into training unrecovered; ``Metrics.faults["matched"]`` is then
        False).
    metrics_every: simulated-seconds cadence for a one-line metrics dump
        (stdout); 0 disables.  Pure print — scheduling it perturbs no
        run state.
    """
    sim = Sim()
    K = cluster.K
    m = Metrics(K=K, duration=duration)
    if control is not None and \
            (control.G, control.omega, control.flow.omega,
             control.flow.pool_cap, control.scheduler.policy,
             control.max_delay) != \
            (K, omega, omega, pool_cap, policy, max_delay):
        raise ValueError(
            f"supplied ControlPlane (n={control.G}, omega={control.omega}, "
            f"flow budget={control.flow.omega}+{control.flow.pool_cap}, "
            f"policy={control.scheduler.policy!r}, "
            f"max_delay={control.max_delay}) disagrees with the run "
            f"(n={K}, omega={omega}, pool_cap={pool_cap}, "
            f"policy={policy!r}, max_delay={max_delay}); build it with "
            "ControlPlane.for_sim so the flow budget is the per-device "
            "Eq. 3 cap (tiered by pool_cap)")
    cp = control if control is not None else \
        ControlPlane.for_sim(K, omega, policy=policy, max_delay=max_delay,
                             pool_cap=pool_cap)
    prof = profiles if profiles is not None else StragglerProfiles(K)
    if prof.G != K:
        raise ValueError(f"profiles track {prof.G} groups, cluster has {K}")
    m.profiles = prof
    sched = cp.scheduler
    flow = cp.flow

    inj = None
    if faults is not None:
        if isinstance(faults, FaultInjector):
            inj = faults
        else:
            gate = UpdateGate() if fault_gate is None else \
                (fault_gate or None)
            inj = FaultInjector(faults, gate=gate)

    trace = resolve_fleet(fleet, churn, cluster, duration)
    sel = make_selection_policy(selection, seed=seed)
    if sel is not None and sel.trivial:
        sel = None        # select-all ≡ no selection (cohort = available)
    if sel is not None and trace is None:
        # selection needs a re-draw cadence even over an always-on fleet:
        # a static identity trace supplies the tick grid (no churn
        # events), at a duration-derived interval so short runs still
        # re-draw the cohort (>= 12 ticks; the §6.4 cadence for long runs)
        trace = FleetTrace.from_cluster(
            cluster, duration,
            interval=max(min(600.0, duration / 12.0), 1e-3))
    reg = registry
    if reg is None and trace is not None:
        from repro_torch.runtime.elastic import ElasticRegistry
        reg = ElasticRegistry()
    if reg is not None and not reg.devices:
        for k in range(K):
            reg.join(float(cluster.dev_flops[k]), float(cluster.dev_bw[k]))
    m.registry = reg

    active = np.ones(K, bool)
    bw = cluster.dev_bw.astype(float).copy()
    if trace is not None:
        trace.apply(active, bw)              # row 0: the initial roster
        for k in np.flatnonzero(~active):
            flow.on_device_left(int(k))      # reclaim the pre-granted token
            if reg is not None:
                reg.leave(int(k), t=0.0)
    selected = np.ones(K, bool)              # current selection cohort
    running = np.zeros(K, bool)              # device has a round in flight
    epoch = np.zeros(K, np.int64)            # bumped per departure: pending
                                             # callbacks of the pre-leave
                                             # chain see a stale epoch and
                                             # die, so a rejoin can never
                                             # run two chains concurrently
    versions = cp.versions            # local model version t_k
    srv_state = {"busy": False, "down": 0, "cur": None, "epoch": 0}

    t_iter = [(model.dev_fwd_flops + model.dev_bwd_flops) / cluster.dev_flops[k]
              for k in range(K)]

    # ---------------- device state machine ----------------
    def device_start_round(k, h_left):
        if not active[k] or not selected[k] or running[k]:
            return
        running[k] = True
        if _san.TRACING:
            _san.emit("sim.chain_start", sim=sim, device=int(k),
                      epoch=int(epoch[k]))
        device_iter(k, h_left, epoch[k])

    def device_iter(k, h_left, e):
        if not active[k] or epoch[k] != e:
            return
        start = sim.t
        sim.after(t_iter[k], device_iter_done, k, h_left, start, e)

    def device_iter_done(k, h_left, start, e):
        if not active[k] or epoch[k] != e:
            return
        m.note_dev_busy(k, start, sim.t, samples=model.batch_size)
        prof.observe_group(k, step_s=sim.t - start)
        send = flow.can_send(k) and \
            (inj is None or inj.may_send(k, sim.t))
        if send:
            flow.mark_sent(k)
            tx = model.act_bytes / bw[k]
            prof.observe_group(k, transfer_s=tx)
            m.bytes_up += model.act_bytes
            if _tr.TRACING:
                _tr.emit_span(f"net/{k}", "act_upload", sim.t, sim.t + tx,
                              clip=True)
            tag = inj.tag_act_upload(k, sim.t) if inj is not None else None
            sim.after(tx, act_arrive, k, tag)
            if tag is not None and tag["dup_extra"] is not None:
                # injected duplicate: the copy ships too, delayed — it may
                # land reordered past other devices' arrivals
                m.bytes_up += model.act_bytes
                sim.after(tx + tag["dup_extra"], act_arrive, k, tag)
        if hooks:
            hooks.device_iter(k, send)
        if h_left > 1:
            device_iter(k, h_left - 1, e)
        else:
            # end of round: ship device model for aggregation (Alg. 1 l.13)
            tx = model.dev_model_bytes / bw[k]
            m.bytes_up += model.dev_model_bytes
            if _tr.TRACING:
                _tr.emit_span(f"net/{k}", "model_upload", sim.t, sim.t + tx,
                              clip=True)
            extra, ckind = inj.tag_model_upload(k, sim.t) \
                if inj is not None else (0.0, "")
            sim.after(tx + extra, model_arrive, k, e, ckind, extra > 0.0)

    def act_arrive(k, tag=None):
        if tag is not None and tag["dup_extra"] is not None and \
                not inj.act_dedupe(tag["seq"]):
            return              # second delivery of a duplicated upload
        if not active[k]:
            flow.on_device_left(k)
            return
        poisoned = bool(tag and tag["kind"])
        if inj is not None and not inj.act_validate(k, tag, sim.t):
            # quarantined before it touches a queue: withdraw the in-flight
            # unit so Eq. 3 and the Alg. 3 counters stay conserved
            flow.on_quarantined(k)
            return
        if not flow.on_enqueue(k):
            # zombie packet: the sender dropped (its in-flight budget was
            # reclaimed) and rejoined before this arrival — reject it so
            # the ω cap stays strict
            return
        if inj is not None and not poisoned:
            inj.note_accept(k)          # clean update: forgive one strike
        sched.put(Message("activation", k,
                          content="poison" if poisoned else None,
                          size_bytes=model.act_bytes,
                          enqueued_at=sim.t))
        m.max_buffered = max(m.max_buffered, sched.total_buffered)
        cp.note_buffered(sched.total_buffered)
        if not flow.within_cap:
            raise RuntimeError(
                f"flow-control cap violated in simulation at t={sim.t}: "
                f"device {k} admitted with buffered={flow.buffered}, "
                f"promised={flow.promised} of cap={flow.cap}")
        kick_server()

    def model_arrive(k, e, ckind="", delayed=False):
        if inj is not None and delayed:
            # late arrival (possibly past max_delay): Alg. 4's staleness
            # weighting at aggregation is the armor — nothing to drop here
            inj.note_delayed_arrival()
        if inj is not None and ckind:
            ok, backoff = inj.model_validate(k, ckind, sim.t)
            if not ok:
                # quarantined: the poisoned update never reaches Q_model;
                # re-sync the device after its strike backoff so the chain
                # survives without consuming the update
                tx = model.dev_model_bytes / bw[k] if active[k] else 0.0
                m.bytes_down += model.dev_model_bytes if active[k] else 0.0
                sim.after(backoff + tx, model_return, k, e)
                return
        # the shipping chain's epoch rides the message so the eventual
        # model_return can tell a pre-departure upload from a live one
        sched.put(Message("model", k, content=(int(versions[k]), int(e))))
        kick_server()

    # ---------------- server engine ----------------
    def kick_server():
        if srv_state["busy"] or srv_state["down"]:
            return
        msg = sched.get()
        if msg is None:
            return
        m.note_warmup_end(sim.t)
        srv_state["busy"] = True
        srv_state["cur"] = msg
        if msg.kind == "model":
            dt = model.agg_flops / cluster.srv_flops
            sim.after(dt, server_agg_done, msg.origin, sim.t,
                      msg.content[1], srv_state["epoch"])
        else:
            flow.on_dequeue(msg.origin)
            dt = model.srv_flops_per_batch / cluster.srv_flops
            sim.after(dt, server_train_done, msg.origin, sim.t,
                      msg.content == "poison", srv_state["epoch"])

    def server_agg_done(k, start, e, se=0):
        if se != srv_state["epoch"]:
            return                      # in-service work lost to a crash
        srv_state["cur"] = None
        m.note_srv_busy(start, sim.t, name="aggregate")
        m.aggregations += 1
        if cp.aggregate_arrival(k, versions[k]) > 0.0 and hooks:
            hooks.aggregate(k)
        # return global model to device (Alg. 4 l.20)
        tx = model.dev_model_bytes / bw[k] if active[k] else 0.0
        m.bytes_down += model.dev_model_bytes if active[k] else 0.0
        sim.after(tx, model_return, k, e)
        srv_state["busy"] = False
        kick_server()

    def model_return(k, e):
        cp.device_synced(k)
        if epoch[k] != e and not _TEST_SKIP_EPOCH_CHECK:
            # a pre-departure round's model came back after the device
            # left: syncing is fine, but this return must not restart it
            return
        if _san.TRACING:
            _san.emit("sim.chain_end", sim=sim, device=int(k), epoch=int(e))
        running[k] = False
        device_start_round(k, H)

    def server_train_done(k, start, poisoned=False, se=0):
        if se != srv_state["epoch"]:
            return                      # in-service work lost to a crash
        srv_state["cur"] = None
        m.note_srv_busy(start, sim.t, name="train_batch")
        m.srv_batches += 1
        m.note_contribution(k)
        prof.observe_server(sim.t - start)
        if poisoned:
            # no-gate leg: the poison reached server training (badput —
            # the faults benchmark subtracts these from goodput)
            inj.note_disposition("consumed_poisoned_act")
        if hooks:
            hooks.server_train(k)
        srv_state["busy"] = False
        kick_server()

    # ---------------- fleet membership (trace ticks) ----------------
    def on_leave(k):
        running[k] = False
        epoch[k] += 1                 # kill the chain's pending callbacks
        if _san.TRACING:
            _san.emit("sim.device_left", sim=sim, device=int(k),
                      epoch=int(epoch[k]))
        if _tr.TRACING:
            _tr.emit_instant(f"dev/{k}", "leave", sim.t)
        flow.on_device_left(k)
        # purge the consumption counter (§3.4.2: a rejoin starts with
        # fresh history); buffered activations still train
        sched.remove_device(k)
        if reg is not None:
            reg.leave(k, t=sim.t)

    def on_rejoin(k):
        flow.register(k)
        if reg is not None:
            reg.rejoin(k, t=sim.t)
            reg.set_bandwidth(k, float(bw[k]))
        if _san.TRACING:
            _san.emit("sim.device_join", sim=sim, device=int(k),
                      epoch=int(epoch[k]))
        if _tr.TRACING:
            _tr.emit_instant(f"dev/{k}", "join", sim.t)
        device_start_round(k, H)

    # ---------------- injected fault windows ----------------
    def crash_begin(outage_s):
        inj.note_injected("server_crash")
        if _tr.TRACING:
            _tr.emit_instant("srv", "fault.crash_begin", sim.t,
                             outage_s=outage_s)
        srv_state["down"] += 1
        srv_state["epoch"] += 1         # pending completions die stale
        cur = srv_state["cur"]
        if srv_state["busy"] and cur is not None:
            if cur.kind == "model":
                # a lost model update would strand its device (model_return
                # never fires): requeue it — durable Q_model survives the
                # outage, only in-service compute is lost
                sched.put(cur)
                inj.note_disposition("lost_model_requeued")
            else:
                # the batch's flow token was released at dequeue: dropping
                # it keeps Eq. 3 conserved, the work is simply lost
                inj.note_disposition("lost_act_batch")
        srv_state["cur"] = None
        srv_state["busy"] = False
        sim.after(outage_s, crash_end)

    def crash_end():
        srv_state["down"] -= 1
        inj.note_recovered("server_crash", "crash_restart")
        if _tr.TRACING:
            _tr.emit_instant("srv", "fault.crash_end", sim.t)
        if not srv_state["down"]:
            kick_server()

    def reselect():
        """Re-draw the participation cohort from the available devices
        (fed the live Alg. 3 counters + staleness accounting).  Devices
        leaving the cohort finish their in-flight round, then idle; new
        cohort members start immediately."""
        ctx = SelectionContext(t=sim.t, counters=sched.counters,
                               staleness=cp.version - versions,
                               capability=cluster.dev_flops)
        chosen = sel.select(np.flatnonzero(active), ctx)
        selected[:] = False
        selected[np.asarray(chosen, int)] = True
        for k in np.flatnonzero(selected & active & ~running):
            device_start_round(int(k), H)

    # ---------------- go ----------------
    if sel is not None:
        reselect()
    else:
        for k in range(K):
            device_start_round(k, H)
    install_fleet(sim, trace, active, bw, on_leave=on_leave,
                  on_rejoin=on_rejoin,
                  after_tick=reselect if sel is not None else None)
    if inj is not None:
        install_timeouts(sim, inj, active, trace,
                         on_leave=on_leave, on_rejoin=on_rejoin)
        for ev in inj.crashes():
            sim.at(ev.t, crash_begin, float(ev.param))
    if metrics_every and metrics_every > 0.0:
        def _dump_metrics():
            print(m.to_registry(at=sim.t).dump_line(
                prefix=f"[sim t={sim.t:.1f}s]"))
            sim.after(metrics_every, _dump_metrics)
        sim.after(metrics_every, _dump_metrics)
    sim.run(duration)
    m.duration = duration
    if inj is not None:
        inj.finalize(duration)
        m.faults = inj.report()
    return m
