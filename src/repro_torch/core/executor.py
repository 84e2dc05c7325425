"""Pipelined round executor: overlap host planning with the card's work.

A naive driver plans round r, builds its batch, dispatches it, then waits
for its metrics before planning round r+1: the host and the card strictly
alternate.  :class:`RoundExecutor` keeps up to ``window`` dispatched rounds
in flight and reads each round's metrics one drain behind the dispatch
frontier, so the host plans round r+1 and builds its batch while round r
runs on the card.

* ``step(state, batch)`` enqueues the round's kernels and returns.  At
  dispatch the executor copies the round's metrics into pinned host memory
  with ``non_blocking=True`` and records an event after the copy.  The
  drain waits on that event alone: ``float()`` or ``.item()`` on a tensor
  on the card would wait for the whole stream, round r+1 included.
* ``window=1`` drains right after every dispatch: the synchronous loop,
  with the same plans, batches and metrics, bit for bit.  Planning reads
  only host state (the ``ControlPlane`` and the driver's RNG), never the
  card's values, and the profile patterns are pure functions of the
  profile seeds, so metric values do not depend on the window; only wall
  time does.

It also owns the host-card consistency duties of the round loop:

* **measured straggler profiles** — each drained round updates a
  :class:`StragglerProfiles` EMA from its measured wall time; its
  ``produce``/``reads`` patterns feed the next ``plan_round``.
* **per-group state retention** — when a plan retires a dropped group,
  its dev/aux rows go to the ``ControlPlane``'s retention store before
  dispatch; a rejoining group's rows are scattered back.  Both read and
  write the live state: at a boundary the next round is not dispatched
  yet, so its values ARE the previous round's output at any window (the
  gather waits for that round, as the reference's handle copy does).  An
  ``ElasticRegistry`` (``registry=``) mirrors each retirement as a leave
  and each restore as a rejoin, with the round index as the timestamp.
* **the tiered activation store** — a plan's ``fill`` and ``spill`` moves
  run at the boundary, after retention and before the batch is built:
  pooled slots go back into free ring slots, then victim slots go to the
  host pool (``repro_torch.memory.ActivationStore``).  The copies are
  enqueued on the stream between round r-1's kernels and round r's, so a
  spill reads the ring as round r-1 left it (the reference slices a
  handle there only because its step donates the ring) and neither move
  makes a host sync.

The cap invariant (ω ring slots, ω + pool_cap in flow units) raises
``RuntimeError`` with the ring-slot and pool occupancy.

With a tracer attached (``repro_torch.obs.trace``, wall domain) the loop
emits the reference's lanes: ``host/plan``, ``host/build``,
``host/memory``, ``host/capture``, ``host/ckpt``, ``host/drain``, and the
``mesh`` and ``dev/<g>`` round spans.  Off the card a round's span runs
from dispatch to its observed completion, as in the reference.  On the
card it runs between two CUDA events, ``start`` recorded before the
step's kernels and ``done`` after its metrics copy, placed on the wall
clock through one anchor event that the first traced dispatch of a run
records and waits for.  Tracing reads no tensor and changes no value.

With a protocol sanitizer attached (``repro_torch.analysis.sanitize``)
each dispatch emits ``exec.round`` after the round's ``finish_round``,
which checks the planner's ring and pool against the store's held keys;
the event carries host objects only, so it reads no tensor.

The torch form of the JAX package's ``core/executor.py``.  Still to come:
the fault plane (``faults``); the store's advisory prefetch and the light
per-round handles are not ported.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.analysis import sanitize as _san
from repro_torch.obs import trace as _tr
from repro_torch.obs.clock import now as _now
from repro_torch.obs.metrics import MetricsRegistry

from .handles import RoundHandle


# ---------------------------------------------------------------------------
# Measured straggler profiles
# ---------------------------------------------------------------------------

class StragglerProfiles:
    """EMA over *measured* per-group step/transfer times + server batch time.

    The profile is observed, never assumed: the event simulator feeds it
    per-device iteration/transfer durations as they complete, and the pod
    executor feeds it each drained round's wall time (SimModel-style cost
    accounting sets the relative per-group speeds; the measurement sets
    the absolute scale — in a lockstep round the slowest group binds the
    micro-iteration).  From the EMAs it derives the two patterns
    ``ControlPlane.plan_round`` consumes:

    ``produce(H)`` — (H, G) bool: group g emits at micro-iteration h when
    its cumulative progress at its measured speed crosses a new whole
    batch (the fastest group emits every iteration; a group at half speed
    every other one).

    ``reads(H)`` — (H,) bool: the server consumes a new scheduled batch at
    iteration h when its measured per-batch time keeps up with the
    micro-iteration cadence; a slower server consumes on a strided
    subset (the skipped iterations replay the last slot — Fig. 1(d)'s
    never-idle server, without phantom consumption events).

    Unseeded profiles yield all-true patterns — identical to the
    placeholder defaults, so homogeneous runs are bit-for-bit unchanged.
    """

    def __init__(self, n_groups: int, *, beta: float = 0.25,
                 step_s=None, transfer_s=None, server_s: float | None = None):
        if n_groups < 1:
            raise ValueError(f"need n_groups >= 1, got {n_groups}")
        self.G = n_groups
        self.beta = beta
        self.step_s = None if step_s is None else \
            np.asarray(step_s, float).copy()        # (G,) s / micro-iter
        self.transfer_s = None if transfer_s is None else \
            np.asarray(transfer_s, float).copy()    # (G,) s / act batch
        self.server_s = server_s                    # s / scheduled batch
        self.n_obs = 0

    @classmethod
    def from_sim_model(cls, model, cluster, **kw) -> "StragglerProfiles":
        """Seed from SimModel-style cost accounting (FLOPs / rates); the
        measured observations then correct the seeds in place."""
        step = (model.dev_fwd_flops + model.dev_bwd_flops) / \
            np.asarray(cluster.dev_flops, float)
        transfer = model.act_bytes / np.asarray(cluster.dev_bw, float)
        server = model.srv_flops_per_batch / float(cluster.srv_flops)
        return cls(cluster.K, step_s=step, transfer_s=transfer,
                   server_s=server, **kw)

    # -- observations ---------------------------------------------------
    def _ema(self, old, new):
        return new if old is None else (1.0 - self.beta) * old + \
            self.beta * new

    def observe_group(self, g: int, *, step_s: float | None = None,
                      transfer_s: float | None = None):
        """One measured device event (simulator path): an iteration took
        ``step_s`` and/or an activation upload took ``transfer_s``."""
        if step_s is not None:
            if self.step_s is None:
                self.step_s = np.full(self.G, float(step_s))
            else:
                self.step_s[g] = self._ema(self.step_s[g], float(step_s))
        if transfer_s is not None:
            if self.transfer_s is None:
                self.transfer_s = np.full(self.G, float(transfer_s))
            else:
                self.transfer_s[g] = self._ema(self.transfer_s[g],
                                               float(transfer_s))
        self.n_obs += 1

    def observe_server(self, batch_s: float):
        self.server_s = self._ema(self.server_s, float(batch_s))
        self.n_obs += 1

    def observe_round(self, wall_s: float, H: int):
        """Pod path: one lockstep round of H micro-iterations measured at
        ``wall_s``.  The slowest group binds the lockstep cadence, so the
        measurement rescales the profile to put the slowest group at
        ``wall_s/H`` while preserving the relative speeds already
        observed/seeded (uniform when unseeded).

        ``step_s`` and ``server_s`` are rescaled by the SAME cadence
        factor, so every ratio the derived patterns depend on is an exact
        invariant of the seeds — ``produce``/``reads`` are pure functions
        of the profile's relative speeds, never of wall-clock noise.
        That is what makes pod plans deterministic and window-invariant
        even for heterogeneously seeded profiles."""
        per_iter = max(wall_s / max(H, 1), 1e-12)
        if self.step_s is None:
            self.step_s = np.full(self.G, per_iter)
        else:
            cadence = max(float(self.step_s.max()), 1e-12)
            self.step_s = self._ema(self.step_s,
                                    self.step_s / cadence * per_iter)
            if self.server_s is not None:
                self.server_s = self._ema(self.server_s,
                                          self.server_s / cadence * per_iter)
        if self.server_s is None:
            # the fused step trains the server every micro-iteration: its
            # per-batch time IS the (post-update) cadence, keeping rho=1
            # exactly for any seeding combination
            self.server_s = float(self.step_s.max())
        self.n_obs += 1

    # -- derived patterns ------------------------------------------------
    @staticmethod
    def _stride(rate: np.ndarray, H: int) -> np.ndarray:
        """(H, ...) bool: True at h when cumulative progress at ``rate``
        (batches per micro-iteration, in (0, 1]) crosses a whole batch."""
        h = np.arange(H, dtype=float)[:, None] if rate.ndim else \
            np.arange(H, dtype=float)
        return np.floor((h + 1.0) * rate) > np.floor(h * rate)

    def produce(self, H: int) -> np.ndarray:
        """(H, G) bool straggler emission pattern for plan_round."""
        if self.step_s is None:
            return np.ones((H, self.G), bool)
        t = np.maximum(self.step_s, 1e-12)
        speed = t.min() / t                       # (G,) relative, in (0, 1]
        return self._stride(speed[None, :], H)

    def reads(self, H: int) -> np.ndarray:
        """(H,) bool server-consumption pattern for plan_round."""
        if self.server_s is None or self.step_s is None:
            return np.ones(H, bool)
        cadence = max(float(self.step_s.max()), 1e-12)
        rho = np.asarray(min(1.0, cadence / max(self.server_s, 1e-12)))
        return self._stride(rho, H)

    def summary(self) -> dict:
        """JSON-able snapshot for logs / benchmark records."""
        out = {"n_obs": int(self.n_obs), "beta": self.beta}
        if self.step_s is not None:
            out["step_s"] = [float(v) for v in self.step_s]
        if self.transfer_s is not None:
            out["transfer_s"] = [float(v) for v in self.transfer_s]
        if self.server_s is not None:
            out["server_s"] = float(self.server_s)
        return out


# ---------------------------------------------------------------------------
# The executor
# ---------------------------------------------------------------------------

@dataclass
class RoundStats:
    """Per-round host/card accounting (times in seconds)."""
    round: int
    plan_s: float = 0.0          # plan_round + retention transfers
    memory_s: float = 0.0        # host time enqueueing the plan's fills and
                                 # spills (the copies run on the card)
    build_s: float = 0.0         # host batch assembly
    dispatch_s: float = 0.0      # host time inside step(): enqueueing the
                                 # round's kernels (eager torch runs Python
                                 # for every op)
    in_flight_at_dispatch: int = 0
    hidden_host_s: float = 0.0   # host work done while the card was busy
                                 # (set at drain: clamped by the in-flight
                                 # round's observed completion)
    round_wall_s: float = 0.0    # measured round wall (set at drain)
    done: object = None          # CUDA event after the round's metrics
                                 # copy (None off the card): its completion
    start: object = None         # CUDA event before the round's kernels
                                 # (recorded only while tracing on the card)
    plan: object = None          # the RoundPlan this round ran under —
                                 # available in the on_metrics drain hook,
                                 # dropped afterwards (memory)
    _host_t0: float = field(default=0.0, repr=False)
    _dispatch_t: float = field(default=0.0, repr=False)


def completion_gap_s(a: RoundStats, b: RoundStats) -> float:
    """Seconds from round ``a``'s completion to round ``b``'s: on the card
    between the events recorded after each round's metrics copy, off it
    between the ends of the two step calls, which there run the round
    synchronously.  A drain's host time lags its round's completion by up
    to ``window - 1`` dispatches, so drain times misstate round times at
    window > 1."""
    if b.done is not None:
        return a.done.elapsed_time(b.done) / 1e3
    return (b._dispatch_t + b.dispatch_s) - (a._dispatch_t + a.dispatch_s)


def _stage_metrics(metrics: dict):
    """The round's metrics, copied into pinned host memory behind its
    kernels; returns (values, event after the copies, or None when no
    metric is on the card)."""
    card = [v for v in metrics.values()
            if isinstance(v, torch.Tensor) and v.is_cuda]
    if not card:
        return dict(metrics), None
    values = {}
    for k, v in metrics.items():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            values[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            values[k].copy_(v.detach(), non_blocking=True)
        else:
            values[k] = v
    done = torch.cuda.Event(enable_timing=True)
    done.record(torch.cuda.current_stream(card[0].device))
    return values, done


def _card_of(state):
    """The CUDA device of the first tensor in ``state`` (a nest of dicts,
    lists and tuples), or None when it holds none on the card."""
    todo = [state]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            return x.device if x.is_cuda else None
        if isinstance(x, dict):
            todo.extend(reversed(list(x.values())))
        elif isinstance(x, (list, tuple)):
            todo.extend(reversed(x))
    return None


class RoundExecutor:
    """Bounded-window pipelined driver for ``step(state, batch)`` programs.

    Parameters
    ----------
    step : callable(state, batch) -> (state, metrics)
        The hybrid round (or any stand-in whose metric values are tensors,
        numpy values or floats).
    cplane : ControlPlane
        Host planner; its ``plan_round``/``finish_round`` bookkeeping is
        committed at DISPATCH time (host order), never at drain time.
    window : int
        Max dispatched-but-undrained rounds.  1 = synchronous (bit for bit
        the old loop), 2 = double buffering.
    profiles : StragglerProfiles | None
        Measured straggler profiles; when given, every plan uses
        ``profiles.produce/reads`` and every drained round feeds the EMA.
    gather / scatter : callables for per-group retention
        ``gather(state, g) -> params`` (host copies) and
        ``scatter(state, g, params) -> state``; see
        ``fedopt_step.gather_group_state`` / ``scatter_group_state``.
    registry : ElasticRegistry | None
        Optional roster mirror (``repro_torch.runtime.ElasticRegistry``):
        drops and rejoins are recorded with the round index as the
        timestamp.
    store / gather_slot / scatter_slot : tiered activation store wiring
        ``store`` is a ``repro_torch.memory.ActivationStore`` (the host
        spill pool); ``gather_slot(state, s) -> payload`` and
        ``scatter_slot(state, s, payload) -> state`` move one ring slot
        (``fedopt_step.gather_act_slot`` / ``scatter_act_slot``).  Fills
        run before spills, so the pool never transiently exceeds its cap;
        a slot filled and spilled at the same boundary spills the fill
        payload itself.
    metrics : MetricsRegistry | None
        The registry behind the executor's instruments (shared with the
        store by the driver); a fresh one by default.
    """

    def __init__(self, step, cplane, *, window: int = 1, profiles=None,
                 gather=None, scatter=None, registry=None, store=None,
                 gather_slot=None, scatter_slot=None, metrics=None):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.step = step
        self.cplane = cplane
        self.window = window
        self.profiles = profiles
        self.gather = gather
        self.scatter = scatter
        self.registry = registry
        self.store = store
        self.gather_slot = gather_slot
        self.scatter_slot = scatter_slot
        self.stats: list[RoundStats] = []
        # -- instruments (pure bookkeeping; legacy names are properties) --
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._g_in_flight = self.metrics.gauge("exec.in_flight")
        self._c_host_s = self.metrics.counter("exec.host_s")
        self._c_hidden_s = self.metrics.counter("exec.hidden_host_s")
        self._c_ckpt_flush = self.metrics.counter("exec.ckpt_flush")
        self._c_ckpt_noflush = self.metrics.counter("exec.ckpt_noflush")
        self._g_handle_bytes = self.metrics.gauge("exec.handle_bytes")
        self._h_plan = self.metrics.histogram("exec.plan_s")
        self._h_build = self.metrics.histogram("exec.build_s")
        self._h_wall = self.metrics.histogram("exec.round_wall_s")
        self._pending: deque = deque()   # (RoundStats, staged metrics)
        self._last_drain_t: float | None = None
        self._last_completion_t: float | None = None
        self.n_retired = 0               # groups gathered into retention
        self.n_restored = 0              # groups scattered back
        self._deferred: deque[RoundHandle] = deque()   # no-flush saves
        # the traced card clock: (anchor event, its wall time) per run
        self._anchor: tuple | None = None

    # legacy counter names, read-only over the registry instruments
    @property
    def peak_in_flight(self) -> int:
        return int(self._g_in_flight.peak)

    @property
    def total_host_s(self) -> float:
        return self._c_host_s.value

    @property
    def hidden_host_s(self) -> float:
        return self._c_hidden_s.value

    @property
    def n_ckpt_flush(self) -> int:
        return int(self._c_ckpt_flush.value)

    @property
    def n_ckpt_noflush(self) -> int:
        return int(self._c_ckpt_noflush.value)

    @property
    def handle_bytes_peak(self) -> int:
        return int(self._g_handle_bytes.peak)

    # ------------------------------------------------------------------
    def run(self, state, start_round: int, end_round: int, *, active_fn,
            batch_fn, on_metrics=None, checkpoint_every: int = 0,
            checkpoint_fn=None, capture_fn=None, checkpoint_flush=None):
        """Drive rounds [start_round, end_round).

        active_fn(r) -> (G,) bool roster for round r (host RNG lives with
        the caller, consumed in dispatch order — window-invariant).
        batch_fn(r, plan) -> the step's batch for round r.
        on_metrics(r, metrics, stats) fires at drain, in round order.

        Checkpointing comes in two shapes (the saver is the caller's):

        * **flush** (``capture_fn=None``): the pipeline is fully drained at
          the due boundary and ``checkpoint_fn(r, state)`` is called with
          the live post-round-r state — the synchronous loop's save point.
        * **without flush** (``capture_fn`` given): at the due boundary a
          :class:`RoundHandle` of the full state is captured at DISPATCH
          (clones + staged copy to the host), with ``capture_fn(r)``
          providing the dispatch-time host metadata.
          ``checkpoint_fn(r, handle)`` then runs once the handle's copies
          are ready; rounds r+1..r+window stay in flight, and the save never
          lags more than ``window`` rounds behind (forced at the end of the
          run).  ``checkpoint_flush=True`` keeps the drain while still
          passing handles (the flush-vs-no-flush A/B).
        """
        flush = (capture_fn is None) if checkpoint_flush is None \
            else bool(checkpoint_flush)
        history: list[dict] = []
        self._anchor = None
        for r in range(start_round, end_round):
            t0 = _now()
            active = np.asarray(active_fn(r), bool)
            H = self.cplane.H
            produce = self.profiles.produce(H) if self.profiles is not None \
                else None
            reads = self.profiles.reads(H) if self.profiles is not None \
                else None
            plan = self.cplane.plan_round(active=active, produce=produce,
                                          reads=reads)
            state = self._apply_retention(state, plan, r)
            tm = _now()
            state = self._apply_memory(state, plan, r)
            t1 = _now()
            batch = batch_fn(r, plan)
            t2 = _now()
            if _tr.TRACING:
                _tr.emit_span("host/plan", "plan_round", t0, t1, round=int(r))
                _tr.emit_span("host/build", "build_batch", t1, t2,
                              round=int(r))
            st = RoundStats(round=r, plan_s=tm - t0, memory_s=t1 - tm,
                            build_s=t2 - t1,
                            in_flight_at_dispatch=len(self._pending),
                            plan=plan, _host_t0=t0, _dispatch_t=t2)
            if _tr.TRACING:
                st.start = self._record_start(state)
            state, metrics = self.step(state, batch)
            values, st.done = _stage_metrics(metrics)
            st.dispatch_s = _now() - t2
            self.cplane.finish_round(active=active)
            self._check_cap(r)
            if _san.TRACING:
                _san.emit("exec.round", cp=self.cplane, store=self.store,
                          round=int(r), in_flight=len(self._pending))
            self._pending.append((st, values))
            self._g_in_flight.set(len(self._pending))
            due = checkpoint_fn is not None and checkpoint_every and \
                (r + 1) % checkpoint_every == 0
            if due and not flush:
                self._capture_round(r, state, capture_fn)
            while len(self._pending) >= self.window:
                self._drain_one(history, on_metrics)
            if due and flush:
                while self._pending:          # flush: state == round r
                    self._drain_one(history, on_metrics)
                tc0 = _now() if _tr.TRACING else 0.0
                if capture_fn is None:
                    checkpoint_fn(r, state)   # the (r, state) contract
                else:
                    # drained pipe: the live tree is stable until the next
                    # dispatch, so the handle wraps it without copying
                    checkpoint_fn(r, RoundHandle.capture(
                        r, state, meta=capture_fn(r), copy=False))
                if _tr.TRACING:
                    _tr.emit_span("host/ckpt", "ckpt_flush", tc0, _now(),
                                  round=int(r))
                self._c_ckpt_flush.inc()
            self._service_deferred(checkpoint_fn, now=r)
        while self._pending:
            self._drain_one(history, on_metrics)
        self._service_deferred(checkpoint_fn, force=True)
        return state, history

    # ------------------------------------------------------------------
    def _record_start(self, state):
        """A traced dispatch on the card: a timing event on the step's
        stream before its kernels (None off the card).  The run's first
        one also records the anchor and waits for it, pinning the card's
        event clock to the wall clock once."""
        dev = _card_of(state)
        if dev is None:
            return None
        stream = torch.cuda.current_stream(dev)
        if self._anchor is None:
            anchor = torch.cuda.Event(enable_timing=True)
            anchor.record(stream)
            anchor.synchronize()
            self._anchor = (anchor, _now())
        start = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        return start

    def _card_wall(self, event) -> float:
        """Wall-clock seconds of a completed card event (anchor-based)."""
        anchor, anchor_wall = self._anchor
        return anchor_wall + anchor.elapsed_time(event) / 1e3

    # ------------------------------------------------------------------
    def _capture_round(self, r: int, state, capture_fn):
        """Dispatch-time capture for a due no-flush checkpoint: a
        full-state handle (clones in stream order, so round r+1's in-place
        updates cannot reach it) with its copy to the host staged for the
        deferred saver."""
        tc0 = _now() if _tr.TRACING else 0.0
        meta = capture_fn(r) if capture_fn is not None else None
        self._deferred.append(RoundHandle.capture(r, state, meta=meta,
                                                  to_host=True))
        if _tr.TRACING:
            _tr.emit_span("host/capture", "capture_handle", tc0, _now(),
                          round=int(r))
        self._g_handle_bytes.set(sum(h.nbytes for h in self._deferred))

    def _service_deferred(self, checkpoint_fn, *, now=None,
                          force: bool = False):
        """Run deferred no-flush saves whose copies completed.  A save is
        forced once its round falls a full window behind (or at the end of
        the run), bounding checkpoint lag; stream order means its copies
        are all but certainly done by then."""
        while self._deferred:
            h = self._deferred[0]
            if not (force or h.ready()
                    or (now is not None and now - h.round >= self.window)):
                break
            self._deferred.popleft()
            tc0 = _now() if _tr.TRACING else 0.0
            checkpoint_fn(h.round, h)
            if _tr.TRACING:
                _tr.emit_span("host/ckpt", "ckpt_deferred", tc0, _now(),
                              round=int(h.round))
            self._c_ckpt_noflush.inc()

    # ------------------------------------------------------------------
    def _apply_retention(self, state, plan, r: int):
        # the plan's bcast_mask already excludes dropped groups from the
        # aggregation broadcast, so running churn WITHOUT retention wiring
        # would hand a rejoining group phantom-trained params — refuse
        # loudly rather than silently skip the transfers
        cp = self.cplane
        if plan.retire and self.gather is None:
            raise RuntimeError(
                f"round {r} drops groups {plan.retire} but this executor "
                "has no gather fn — per-group retention must be wired "
                "(fedopt_step.gather_group_state/scatter_group_state) for "
                "runs with churn")
        if plan.restore and self.scatter is None:
            raise RuntimeError(
                f"round {r} restores groups {plan.restore} but this "
                "executor has no scatter fn — per-group retention must be "
                "wired for runs with churn")
        # round r is not dispatched yet: the live state holds round r-1's
        # output, which is what a dropped group retains (the JAX reference
        # reads a handle here only because its step donates its state)
        for g in plan.retire:
            cp.retain_group(g, self.gather(state, g))
            self.n_retired += 1
            if self.registry is not None:
                self.registry.leave(g, t=float(r))
        for g in plan.restore:
            # validate before popping: the error path must not destroy the
            # retained metadata (a fixed-up rerun still needs the entry)
            if cp.retention.params_of(g) is None:
                raise RuntimeError(
                    f"group {g} rejoins but its retained params are "
                    "missing — a resumed run must restore the checkpoint's "
                    "extras into ControlPlane.retention first")
            entry = cp.release_group(g)
            state = self.scatter(state, g, entry["params"])
            self.n_restored += 1
            if self.registry is not None:
                self.registry.rejoin(g, t=float(r))
        return state

    def _apply_memory(self, state, plan, r: int):
        """Perform the plan's tiered-store moves before dispatch.  Fills
        first (a fill frees the pool entry a same-boundary spill may
        need), then spills of pre-round ring content into the host pool.
        Round r is not dispatched yet, so the live ring holds round r-1's
        output in stream order at any window."""
        if not (plan.fill or plan.spill):
            return state
        tm0 = _now() if _tr.TRACING else 0.0
        if self.store is None or self.gather_slot is None or \
                self.scatter_slot is None:
            raise RuntimeError(
                f"round {r} plans spill/fill moves "
                f"(fill={plan.fill}, spill={plan.spill}) but this executor "
                "has no ActivationStore wiring — pass store=/gather_slot=/"
                "scatter_slot= (fedopt_step.gather_act_slot/"
                "scatter_act_slot) for runs with pool_cap > 0")
        filled: dict[int, dict] = {}
        for key, s in plan.fill:
            payload = self.store.fill(key)
            filled[s] = payload
            state = self.scatter_slot(state, s, payload)
        for s, key in plan.spill:
            # fill-then-spill of one slot at one boundary spills the fill
            # payload itself (the ring slot holds the same values)
            self.store.spill(key, filled[s] if s in filled
                             else self.gather_slot(state, s))
        if _tr.TRACING:
            _tr.emit_span("host/memory", "fill_spill", tm0, _now(),
                          round=int(r), fills=len(plan.fill),
                          spills=len(plan.spill))
        return state

    def _check_cap(self, r: int):
        cp = self.cplane
        if not cp.within_cap:
            raise RuntimeError(
                f"activation cap ω={cp.omega}+pool={cp.pool_cap} violated "
                f"after round {r}: {cp.live_slots}/{cp.omega} live ring "
                f"slots (occupancy={cp.slot_occupancy}), "
                f"{cp.pool_live}/{cp.pool_cap} pool entries, flow "
                f"promised={cp.flow.promised} of cap={cp.flow.cap} "
                f"(buffered={cp.flow.buffered}, "
                f"inflight={cp.flow.inflight}, "
                f"tokens={cp.flow.active_tokens})")

    def _drain_one(self, history, on_metrics):
        st, values = self._pending.popleft()
        t_fetch = _now()
        if st.done is not None:
            st.done.synchronize()       # this round's copies only
        m = {k: float(v) for k, v in values.items()}   # host values now
        t = _now()
        # completion estimate: a blocking fetch pins the completion at its
        # return; a non-blocking fetch means the round finished at some
        # unobservable earlier point — fall back to its dispatch time so
        # overlap is only ever credited on evidence (a lower bound: hidden
        # time is never overstated)
        completion = t if (t - t_fetch) > 1e-4 else st._dispatch_t
        # hidden host time for THIS round's plan+build: it overlapped the
        # card only while the previously-dispatched round was still
        # running — clamp by that round's observed completion (a host
        # interval outlasting the card's work is exposed, not hidden)
        if st.in_flight_at_dispatch and self._last_completion_t is not None:
            st.hidden_host_s = max(
                0.0, min(st._dispatch_t, self._last_completion_t)
                - st._host_t0)
        self._last_completion_t = completion
        # round wall estimate: dispatch→done is exact when nothing was
        # queued ahead; under pipelining the completion-to-completion gap
        # is the steady-state round time — take the tighter of the two
        wall = t - st._dispatch_t
        if self._last_drain_t is not None:
            wall = min(wall, max(t - self._last_drain_t, 1e-9))
        self._last_drain_t = t
        st.round_wall_s = wall
        if self.profiles is not None:
            self.profiles.observe_round(wall, self.cplane.H)
        self._c_host_s.inc(st.plan_s + st.memory_s + st.build_s)
        self._c_hidden_s.inc(st.hidden_host_s)
        self._h_plan.observe(st.plan_s)
        self._h_build.observe(st.build_s)
        self._h_wall.observe(wall)
        if _tr.TRACING:
            self._emit_round(st, t_fetch, t, completion, wall)
        self.stats.append(st)
        history.append(m)
        if on_metrics is not None:
            on_metrics(st.round, m, st)
        # the full RoundPlan (H×G schedule arrays) is only needed through
        # the drain hook; keep the per-round stats list O(scalars)
        st.plan = None

    def _emit_round(self, st, t_fetch, t, completion, wall):
        """The drain's spans: ``host/drain``, then the round on ``mesh``
        (clipped so pipelined rounds tile the lane) mirrored on the lanes
        of the groups the plan broadcast to.  Off the card the round runs
        from dispatch to observed completion; on it, between its start and
        done events (both complete once ``done`` has been waited for)."""
        _tr.emit_span("host/drain", "drain", t_fetch, t,
                      round=int(st.round))
        if st.start is not None and st.done is not None:
            begin, end = self._card_wall(st.start), self._card_wall(st.done)
        else:
            begin = st._dispatch_t
            end = completion if completion > st._dispatch_t \
                else st._dispatch_t + wall
        _tr.emit_span("mesh", "round", begin, end, clip=True,
                      round=int(st.round))
        if st.plan is not None and st.plan.bcast_mask is not None:
            for g in np.nonzero(np.asarray(st.plan.bcast_mask) > 0.5)[0]:
                _tr.emit_span(f"dev/{int(g)}", "round", begin, end,
                              clip=True, round=int(st.round))

    # ------------------------------------------------------------------
    def summary(self) -> dict:
        """JSON-able overlap accounting for logs / benchmarks.

        Besides whole-run totals, reports STEADY-STATE exposure excluding
        the first ``window`` dispatches: those warmup rounds have no (or
        a partial) in-flight round to hide behind, so including them
        biases deep-window comparisons against exactly the windows they
        are meant to evaluate."""
        n = len(self.stats)
        warmup = min(n, self.window)
        steady = self.stats[warmup:]
        host_steady = sum(s.plan_s + s.memory_s + s.build_s for s in steady)
        hidden_steady = sum(s.hidden_host_s for s in steady)
        out = {
            "rounds": n,
            "window": self.window,
            "peak_in_flight": self.peak_in_flight,
            "host_s_total": self.total_host_s,
            "host_s_hidden": self.hidden_host_s,
            "host_s_exposed": self.total_host_s - self.hidden_host_s,
            "host_ms_hidden_per_round":
                1e3 * self.hidden_host_s / max(n, 1),
            "device_s_per_round":
                float(np.mean([s.round_wall_s for s in self.stats]))
                if n else 0.0,
            "warmup_rounds_excluded": warmup,
            "host_s_exposed_steady": host_steady - hidden_steady,
            "hidden_host_frac_steady":
                hidden_steady / host_steady if host_steady > 0 else 0.0,
            "retention": {"retired": self.n_retired,
                          "restored": self.n_restored},
            "handle_bytes_peak": int(self.handle_bytes_peak),
            "checkpoints": {"flush_saves": self.n_ckpt_flush,
                            "noflush_saves": self.n_ckpt_noflush},
        }
        if self.profiles is not None:
            out["profiles"] = self.profiles.summary()
        if self.store is not None:
            out["memory"] = {**self.cplane.memory_summary(),
                             **self.store.summary()}
        return out
