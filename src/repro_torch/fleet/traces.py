"""Seeded, deterministic device-availability traces (fleet emulation).

A :class:`FleetTrace` is a reusable scenario artifact: a (T, K) grid of
per-device availability + bandwidth, sampled every ``interval`` simulated
seconds.  The same trace drives FedOptima and every baseline protocol, so
scenario comparisons are identical-population by construction (REFL-style
availability realism; see PAPERS.md).  Traces are:

* **deterministic** — every generator is seeded; the same (kind, params,
  seed) always yields the same grid, and the grid itself (not the
  generator) is what the simulators consume;
* **serializable** — ``save``/``load`` round-trip the grid through JSON,
  so a trace is a shareable experiment input, not a code path;
* **periodic** — reading past the horizon wraps (tick ``i`` maps to row
  ``i % T``), so a day-long trace drives a week-long run.

Generators: :func:`uniform_trace` (always-on control), :func:`diurnal_trace`
(phase-shifted on/off day windows), :func:`weibull_sessions_trace`
(alternating Weibull-length up/down sessions — heavy-tailed device
attendance), :func:`flaky_trace` (memoryless per-tick drop/rejoin with
bandwidth re-draws — the §6.4 unstable-environment protocol as a trace).
Legacy ``churn=`` callers are materialized onto the same grid by
:meth:`FleetTrace.from_churn`, which replays the ChurnModel's RNG in tick
order — bit-for-bit the draws the old per-protocol closures consumed.

:func:`install_fleet` is the single trace-event API the event simulators
drive membership from: one tick per interval, per-device ``on_leave`` /
``on_rejoin`` transition callbacks, and an ``after_tick`` hook (participant
re-selection).  A static trace with no ``after_tick`` schedules nothing —
an always-on trace is event-free, keeping uniform runs bit-for-bit
identical to tracefree ones.

A copy of the JAX package's ``fleet/traces.py`` (numpy only): the same
generator makes the same grid for the same seed, bit for bit, and a trace
file written by either package loads in the other.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field

import numpy as np

TRACE_FORMAT = "fleet-trace-v1"

#: default sampling interval: the paper's §6.4 re-draw cadence (10 sim-min)
DEFAULT_INTERVAL = 600.0


@dataclass
class FleetTrace:
    interval: float              # seconds between consecutive rows
    active: np.ndarray           # (T, K) bool availability grid
    bw: np.ndarray               # (T, K) bytes/s link bandwidth
    meta: dict = field(default_factory=dict)   # generator provenance

    def __post_init__(self):
        self.active = np.asarray(self.active, bool)
        self.bw = np.asarray(self.bw, float)
        if self.active.ndim != 2 or self.active.shape != self.bw.shape:
            raise ValueError(
                f"active/bw must be matching (T, K) grids, got "
                f"{self.active.shape} vs {self.bw.shape}")
        if self.active.shape[0] < 1:
            raise ValueError("a trace needs at least one row")
        if self.interval <= 0:
            raise ValueError(f"interval must be > 0, got {self.interval}")

    # -- geometry --------------------------------------------------------
    @property
    def K(self) -> int:
        return self.active.shape[1]

    @property
    def T(self) -> int:
        return self.active.shape[0]

    @property
    def horizon(self) -> float:
        return self.T * self.interval

    @property
    def is_static(self) -> bool:
        """True when every row equals row 0 — the trace fires no events."""
        return bool(np.all(self.active == self.active[0]) and
                    np.all(self.bw == self.bw[0]))

    def row(self, tick: int):
        """(active, bw) rows for tick ``tick`` (periodic past the horizon)."""
        i = int(tick) % self.T
        return self.active[i], self.bw[i]

    def roster(self, tick: int) -> np.ndarray:
        """Availability mask at tick ``tick`` (a copy; periodic)."""
        return self.active[int(tick) % self.T].copy()

    def state_at(self, t: float):
        """(active, bw) rows in effect at simulated time ``t``."""
        return self.row(int(t // self.interval))

    def apply(self, active: np.ndarray, bw: np.ndarray, tick: int = 0):
        """Write row ``tick`` into live (active, bw) views in place."""
        a, b = self.row(tick)
        active[:] = a
        bw[:] = b

    # -- uptime accounting ----------------------------------------------
    def availability(self) -> np.ndarray:
        """(K,) fraction of ticks each device is on."""
        return self.active.mean(axis=0)

    # -- JSON artifact ---------------------------------------------------
    def to_json(self) -> dict:
        return {"format": TRACE_FORMAT,
                "interval": float(self.interval),
                "active": self.active.astype(int).tolist(),
                "bw": self.bw.tolist(),
                "meta": self.meta}

    @classmethod
    def from_json(cls, d: dict) -> "FleetTrace":
        if d.get("format") != TRACE_FORMAT:
            raise ValueError(
                f"not a fleet trace: format={d.get('format')!r} "
                f"(expected {TRACE_FORMAT!r})")
        return cls(interval=float(d["interval"]),
                   active=np.asarray(d["active"], bool),
                   bw=np.asarray(d["bw"], float),
                   meta=dict(d.get("meta", {})))

    def save(self, path: str) -> str:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh)
        return path

    @classmethod
    def load(cls, path: str) -> "FleetTrace":
        with open(path) as fh:
            return cls.from_json(json.load(fh))

    # -- constructors ----------------------------------------------------
    @classmethod
    def always_on(cls, K: int, horizon: float, *,
                  interval: float = DEFAULT_INTERVAL,
                  bw=100e6 / 8) -> "FleetTrace":
        """``bw`` is a scalar or a (K,) per-device base bandwidth."""
        T = _n_rows(horizon, interval)
        base = np.broadcast_to(np.asarray(bw, float), (K,))
        return cls(interval=interval, active=np.ones((T, K), bool),
                   bw=np.tile(base, (T, 1)),
                   meta={"kind": "uniform", "bw": _bw_meta(bw)})

    @classmethod
    def from_cluster(cls, cluster, horizon: float, *,
                     interval: float = DEFAULT_INTERVAL) -> "FleetTrace":
        """Always-on trace carrying the cluster's own per-device bandwidth
        (the identity scenario: trace-driven ≡ tracefree)."""
        T = _n_rows(horizon, interval)
        bw = np.tile(np.asarray(cluster.dev_bw, float), (T, 1))
        return cls(interval=interval,
                   active=np.ones((T, cluster.K), bool), bw=bw,
                   meta={"kind": "uniform", "bw": "cluster"})

    @classmethod
    def from_churn(cls, churn, horizon: float, *, bw0) -> "FleetTrace":
        """Materialize a legacy ``ChurnModel`` onto the trace grid.

        Row 0 is the pre-first-tick state (all devices on, at the caller's
        ``bw0`` — the cluster bandwidth); rows 1.. replay ``churn.draw`` in
        tick order, consuming the SAME RNG sequence the old per-protocol
        churn closures did — a converted run is bit-for-bit the legacy
        ``churn=`` run."""
        K = churn.n_devices
        n_ticks = int(math.ceil(horizon / churn.interval))
        rows_a = [np.ones(K, bool)]
        rows_b = [np.asarray(bw0, float).copy()]
        for i in range(n_ticks):
            a, b = churn.draw((i + 1) * churn.interval)
            rows_a.append(np.asarray(a, bool).copy())
            rows_b.append(np.asarray(b, float).copy())
        return cls(interval=float(churn.interval),
                   active=np.stack(rows_a), bw=np.stack(rows_b),
                   meta={"kind": "churn", "p_drop": float(churn.p_drop),
                         "seed": int(churn.seed)})


def _n_rows(horizon: float, interval: float) -> int:
    if horizon <= 0 or interval <= 0:
        raise ValueError(f"need horizon > 0 and interval > 0, got "
                         f"horizon={horizon}, interval={interval}")
    return max(1, int(math.ceil(horizon / interval)))


# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------

def uniform_trace(K: int, horizon: float, *,
                  interval: float = DEFAULT_INTERVAL,
                  bw: float = 100e6 / 8, seed: int = 0) -> "FleetTrace":
    """Always-on fleet at constant bandwidth (the control scenario)."""
    del seed  # deterministic by construction; kept for a uniform signature
    return FleetTrace.always_on(K, horizon, interval=interval, bw=bw)


def diurnal_trace(K: int, horizon: float, *,
                  interval: float = DEFAULT_INTERVAL, day: float = 86400.0,
                  on_frac: float = 0.5, bw: float = 100e6 / 8,
                  bw_jitter: float = 0.0, seed: int = 0) -> "FleetTrace":
    """Phase-shifted diurnal windows: device k is on while its local time
    of day falls inside an ``on_frac`` window (phase ~ U[0, 1) per device,
    so the fleet's aggregate availability stays near ``on_frac`` while
    individual devices churn on a daily rhythm)."""
    if not 0.0 < on_frac <= 1.0:
        raise ValueError(f"on_frac must be in (0, 1], got {on_frac}")
    rng = np.random.default_rng(seed)
    T = _n_rows(horizon, interval)
    t = np.arange(T, dtype=float)[:, None] * interval
    phase = rng.uniform(0.0, 1.0, size=K)[None, :]
    active = ((t / day + phase) % 1.0) < on_frac
    bw_grid = _bw_grid(rng, T, K, bw, bw_jitter)
    return FleetTrace(interval=interval, active=active, bw=bw_grid,
                      meta={"kind": "diurnal", "day": float(day),
                            "on_frac": float(on_frac), "bw": _bw_meta(bw),
                            "bw_jitter": float(bw_jitter), "seed": int(seed)})


def weibull_sessions_trace(K: int, horizon: float, *,
                           interval: float = DEFAULT_INTERVAL,
                           shape: float = 0.9, on_scale: float = 3600.0,
                           off_scale: float = 1800.0, p_start: float = 0.7,
                           bw: float = 100e6 / 8, bw_jitter: float = 0.0,
                           seed: int = 0) -> "FleetTrace":
    """Alternating up/down sessions with Weibull-distributed lengths
    (shape < 1 = heavy-tailed attendance: many short sessions, a few very
    long ones — the REFL availability picture)."""
    rng = np.random.default_rng(seed)
    T = _n_rows(horizon, interval)
    active = np.zeros((T, K), bool)
    for k in range(K):
        t, on = 0.0, bool(rng.random() < p_start)
        while t < T * interval:
            scale = on_scale if on else off_scale
            length = max(interval, scale * float(rng.weibull(shape)))
            i0 = int(t // interval)
            i1 = min(T, int(math.ceil((t + length) / interval)))
            active[i0:i1, k] = on
            t += length
            on = not on
    bw_grid = _bw_grid(rng, T, K, bw, bw_jitter)
    return FleetTrace(interval=interval, active=active, bw=bw_grid,
                      meta={"kind": "weibull", "shape": float(shape),
                            "on_scale": float(on_scale),
                            "off_scale": float(off_scale),
                            "p_start": float(p_start), "bw": _bw_meta(bw),
                            "bw_jitter": float(bw_jitter), "seed": int(seed)})


def flaky_trace(K: int, horizon: float, *,
                interval: float = DEFAULT_INTERVAL, p_drop: float = 0.1,
                bw_lo: float = 25e6 / 8, bw_hi: float = 50e6 / 8,
                seed: int = 0) -> "FleetTrace":
    """Memoryless per-tick drop/rejoin with per-tick bandwidth re-draws —
    the paper's §6.4 unstable-environment protocol, materialized."""
    rng = np.random.default_rng(seed)
    T = _n_rows(horizon, interval)
    active = rng.random((T, K)) >= p_drop
    bw_grid = rng.uniform(bw_lo, bw_hi, size=(T, K))
    return FleetTrace(interval=interval, active=active, bw=bw_grid,
                      meta={"kind": "flaky", "p_drop": float(p_drop),
                            "bw_lo": float(bw_lo), "bw_hi": float(bw_hi),
                            "seed": int(seed)})


def _bw_grid(rng, T, K, bw, bw_jitter):
    """``bw`` is a scalar or a (K,) per-device base (e.g. a tier-sampled
    cluster's ``dev_bw``, so capability bandwidth heterogeneity survives
    trace generation); jitter multiplies per tick around that base."""
    base = np.broadcast_to(np.asarray(bw, float), (K,))
    if bw_jitter:
        return base[None, :] * rng.uniform(1.0 - bw_jitter, 1.0 + bw_jitter,
                                           size=(T, K))
    return np.tile(base, (T, 1))


def _bw_meta(bw):
    arr = np.asarray(bw, float)
    return float(arr) if arr.ndim == 0 else [float(v) for v in arr]


GENERATORS = {
    "uniform": uniform_trace,
    "diurnal": diurnal_trace,
    "weibull": weibull_sessions_trace,
    "flaky": flaky_trace,
}


def make_trace(kind: str, K: int, horizon: float, *,
               interval: float = DEFAULT_INTERVAL, seed: int = 0,
               **kw) -> FleetTrace:
    """Build a trace by generator name (the CLI entry point)."""
    if kind not in GENERATORS:
        raise ValueError(f"unknown trace kind {kind!r}; "
                         f"choose from {sorted(GENERATORS)}")
    return GENERATORS[kind](K, horizon, interval=interval, seed=seed, **kw)


# ---------------------------------------------------------------------------
# The single trace-event API the event simulators drive membership from
# ---------------------------------------------------------------------------

def resolve_fleet(fleet, churn, cluster, duration) -> FleetTrace | None:
    """Normalize a protocol's (fleet=, churn=) pair onto one trace.

    ``fleet=`` wins; a legacy ``churn=`` ChurnModel is materialized onto
    the trace grid (same draws, bit-for-bit).  Returns None when neither
    is given — the tracefree fast path."""
    if fleet is not None and churn is not None:
        raise ValueError("pass fleet= or churn=, not both — convert the "
                         "ChurnModel with FleetTrace.from_churn")
    if fleet is not None:
        if fleet.K != cluster.K:
            raise ValueError(f"trace describes {fleet.K} devices, "
                             f"cluster has {cluster.K}")
        return fleet
    if churn is not None:
        return FleetTrace.from_churn(churn, duration,
                                     bw0=np.asarray(cluster.dev_bw, float))
    return None


def install_fleet(sim, trace: FleetTrace | None, active: np.ndarray,
                  bw: np.ndarray, *, on_leave=None, on_rejoin=None,
                  after_tick=None) -> None:
    """Drive live (active, bw) views from the trace inside an event sim.

    Schedules one tick per ``trace.interval`` (the first at t=interval —
    row 0 is the initial state, applied by the caller via ``trace.apply``
    before starting its devices).  Each tick writes the row in per-device
    order, firing ``on_leave(k)`` / ``on_rejoin(k)`` on transitions, then
    ``after_tick()`` (participant re-selection).  A static trace with no
    ``after_tick`` schedules nothing at all — an always-on trace leaves
    the event heap untouched (bit-for-bit the tracefree run)."""
    if trace is None or (trace.is_static and after_tick is None):
        return
    if trace.K != len(active):
        raise ValueError(f"trace describes {trace.K} devices, the live "
                         f"views hold {len(active)}")

    def tick(i):
        row_a, row_b = trace.row(i)
        for k in range(trace.K):
            was = bool(active[k])
            active[k] = bool(row_a[k])
            bw[k] = float(row_b[k])
            if was and not row_a[k] and on_leave is not None:
                on_leave(k)
            if not was and row_a[k] and on_rejoin is not None:
                on_rejoin(k)
        if after_tick is not None:
            after_tick()
        sim.after(trace.interval, tick, i + 1)

    sim.after(trace.interval, tick, 1)
