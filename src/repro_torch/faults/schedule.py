"""Seeded, deterministic fault schedules (the chaos plane's scenario input).

A :class:`FaultSchedule` is the fault-injection analogue of a
``repro_torch.fleet.FleetTrace``: a reusable, JSON-serializable scenario
artifact — a list of timed :class:`FaultEvent`\\ s a run injects at named
seams — so the SAME adversarial scenario drives FedOptima, every baseline
protocol, and the pod executor.  Schedules are:

* **deterministic** — :func:`make_fault_schedule` is seeded; the same
  (classes, params, seed) always yields the same event list, and the list
  (not the generator) is what the injectors consume;
* **serializable** — ``save``/``load`` round-trip through JSON
  (``fault-schedule-v1``), so a chaos scenario is a shareable experiment
  input, not a code path;
* **path-agnostic** — the time axis is simulated seconds for the event
  simulators and the round index for the pod executor; the schema is the
  same either way.

Fault classes (the taxonomy; see EXPERIMENTS.md §Fault injection):

================  ===========================================================
corrupt_act       the device's next ACTIVATION upload carries a poisoned
                  payload (``kind``: nan | inf | huge | bitflip)
corrupt_model     the device's next MODEL upload is poisoned (same kinds)
duplicate         the device's next activation upload arrives twice — the
                  copy delayed by ``param`` seconds (reordered arrivals)
delay             the device's next model upload is delayed by ``param``
                  seconds (stale arrivals, possibly past ``max_delay``)
timeout           the device goes dark at ``t`` for ``param`` seconds
                  (sim) / rounds (pod) — mid-round, without a trace event
server_crash      the server crashes at ``t`` and is down for ``param``
                  seconds (sim); in the pod the executor aborts at the
                  round-``t`` boundary (the crash-consistent restart path)
torn_checkpoint   the snapshot committed at round ``t`` is torn afterwards
                  (``kind``: truncate | bitflip | manifest) — resume must
                  fall back to the newest VERIFIED snapshot
================  ===========================================================

A copy of the JAX package's ``faults/schedule.py`` (pure numpy; the port
imports nothing of that package): the same seed gives the same events,
and each package loads the other's JSON.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field

import numpy as np

FAULT_FORMAT = "fault-schedule-v1"

#: the full taxonomy, in canonical order
CLASSES = ("corrupt_act", "corrupt_model", "duplicate", "delay",
           "timeout", "server_crash", "torn_checkpoint")

#: corruption payload kinds (corrupt_act / corrupt_model)
CORRUPT_KINDS = ("nan", "inf", "huge", "bitflip")

#: torn-checkpoint damage modes
TEAR_MODES = ("truncate", "bitflip", "manifest")

#: classes the event simulators inject (sim time axis = seconds)
SIM_CLASSES = ("corrupt_act", "corrupt_model", "duplicate", "delay",
               "timeout", "server_crash")

#: classes the baseline protocols inject (full-model methods have no
#: activation stream / flow control; the server is a modeled cost only)
BASELINE_CLASSES = ("corrupt_model", "delay", "timeout")

#: classes the pod executor injects (time axis = round index)
POD_CLASSES = ("corrupt_act", "timeout", "server_crash", "torn_checkpoint")


@dataclass(frozen=True, order=True)
class FaultEvent:
    t: float                 # sim seconds (sim path) / round index (pod)
    cls: str                 # one of CLASSES
    device: int = -1         # target device/group; -1 = server-scoped
    kind: str = ""           # corruption payload / tear mode
    param: float = 0.0       # class-specific: extra delay / outage length

    def __post_init__(self):
        if self.cls not in CLASSES:
            raise ValueError(f"unknown fault class {self.cls!r}; "
                             f"choose from {CLASSES}")
        if self.cls.startswith("corrupt") and self.kind not in CORRUPT_KINDS:
            raise ValueError(f"{self.cls} needs kind in {CORRUPT_KINDS}, "
                             f"got {self.kind!r}")
        if self.cls == "torn_checkpoint" and self.kind not in TEAR_MODES:
            raise ValueError(f"torn_checkpoint needs kind in {TEAR_MODES}, "
                             f"got {self.kind!r}")


@dataclass
class FaultSchedule:
    horizon: float                        # run length the schedule targets
    events: tuple = ()                    # FaultEvents, sorted by t
    meta: dict = field(default_factory=dict)

    def __post_init__(self):
        self.events = tuple(sorted(self.events))
        if self.horizon <= 0:
            raise ValueError(f"horizon must be > 0, got {self.horizon}")
        late = [e for e in self.events if e.t >= self.horizon]
        if late:
            raise ValueError(
                f"{len(late)} event(s) at/after the horizon "
                f"{self.horizon} (first: {late[0]}) would never fire")

    def __len__(self) -> int:
        return len(self.events)

    def by_class(self, cls: str) -> tuple:
        return tuple(e for e in self.events if e.cls == cls)

    def counts(self) -> dict:
        out: dict[str, int] = {}
        for e in self.events:
            out[e.cls] = out.get(e.cls, 0) + 1
        return out

    # -- JSON artifact ----------------------------------------------------
    def to_json(self) -> dict:
        return {"format": FAULT_FORMAT,
                "horizon": float(self.horizon),
                "events": [[float(e.t), e.cls, int(e.device), e.kind,
                            float(e.param)] for e in self.events],
                "meta": self.meta}

    @classmethod
    def from_json(cls, d: dict) -> "FaultSchedule":
        if d.get("format") != FAULT_FORMAT:
            raise ValueError(
                f"not a fault schedule: format={d.get('format')!r} "
                f"(expected {FAULT_FORMAT!r})")
        events = tuple(FaultEvent(t=float(t), cls=c, device=int(k),
                                  kind=kind, param=float(p))
                       for t, c, k, kind, p in d["events"])
        return cls(horizon=float(d["horizon"]), events=events,
                   meta=dict(d.get("meta", {})))

    def save(self, path: str) -> str:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh)
        return path

    @classmethod
    def load(cls, path: str) -> "FaultSchedule":
        with open(path) as fh:
            return cls.from_json(json.load(fh))


def make_fault_schedule(K: int, horizon: float, *, seed: int = 0,
                        classes=SIM_CLASSES, density: float = 1.0,
                        n_per_class: int | None = None) -> FaultSchedule:
    """Seeded fault-schedule generator.

    Per class, ``n_per_class`` events (default: ``ceil(density * K / 4)``,
    so ``density=1`` stresses ~a quarter of the fleet per class and the
    benchmark's "dense" scenario uses ``density=4`` — every device hit)
    are drawn at uniform times over the first 80% of the horizon (outage
    durations always END inside the run, so every injected fault can be
    matched to its recovery counter).  Targets, payload kinds and
    class-specific params all come from one seeded Generator — the same
    (K, horizon, classes, density, seed) is bit-for-bit the same schedule.
    """
    if K < 1:
        raise ValueError(f"need K >= 1, got {K}")
    if horizon <= 0:
        raise ValueError(f"need horizon > 0, got {horizon}")
    unknown = [c for c in classes if c not in CLASSES]
    if unknown:
        raise ValueError(f"unknown fault class(es) {unknown}; "
                         f"choose from {CLASSES}")
    rng = np.random.default_rng(seed)
    n = n_per_class if n_per_class is not None \
        else max(1, int(math.ceil(density * K / 4.0)))
    events = []
    for cls in classes:
        times = rng.uniform(0.0, 0.8 * horizon, size=n)
        for t in times:
            t = float(t)
            device = int(rng.integers(0, K)) \
                if cls not in ("server_crash", "torn_checkpoint") else -1
            kind, param = "", 0.0
            if cls.startswith("corrupt"):
                kind = CORRUPT_KINDS[int(rng.integers(len(CORRUPT_KINDS)))]
            elif cls == "torn_checkpoint":
                kind = TEAR_MODES[int(rng.integers(len(TEAR_MODES)))]
            if cls == "duplicate":
                param = float(rng.uniform(0.0, horizon / 50.0))
            elif cls == "delay":
                param = float(rng.uniform(horizon / 50.0, horizon / 8.0))
            elif cls in ("timeout", "server_crash"):
                hi = min(horizon / 10.0, 0.95 * horizon - t)
                param = float(rng.uniform(horizon / 100.0,
                                          max(hi, horizon / 50.0)))
            events.append(FaultEvent(t=t, cls=cls, device=device,
                                     kind=kind, param=param))
    return FaultSchedule(
        horizon=horizon, events=tuple(events),
        meta={"K": int(K), "seed": int(seed), "density": float(density),
              "n_per_class": int(n), "classes": list(classes)})
