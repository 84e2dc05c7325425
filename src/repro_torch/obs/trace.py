"""Span tracing on a detached seam.

Instrumented call sites guard on the module flag — ``if _obs.TRACING:
_obs.emit_span(...)`` — so a run with no tracer attached pays one global
read per site and is bit-identical to an uninstrumented build.  Attach
explicitly::

    from repro_torch.obs.trace import Tracer, traced

    with traced(Tracer(domain="sim")) as tr:
        simulate_fedoptima(...)
    tr.export_chrome("out.json")       # Perfetto / chrome://tracing

or run the drivers with ``--trace out.json``.

Lanes and time domains
----------------------

A *lane* is a string naming one timeline: ``dev/<k>`` (device compute),
``net/<k>`` (device uplink), ``srv`` (server compute), ``mesh`` (the pod
mesh), ``host/<phase>`` (pod host loop: plan, build, drain, memory,
capture, ckpt, control).  Chrome export maps lanes onto pid/tid rows:
pid 1 = server/host lanes, pid 2 = devices, pid 3 = network.

Every span carries explicit ``t0``/``t1`` in the tracer's ``domain``:
``"wall"`` (``repro_torch.obs.clock.now()`` seconds — pod runs) or ``"sim"``
(simulated seconds — event-sim runs).  One trace must stay in one
domain; the drivers pick it by mode.  ``clip=True`` spans are clamped to
start at-or-after the lane's previous end (busy lanes stay physically
non-overlapping even when a simulator's cost accounting double-books).
On the card the pod executor's ``mesh`` and ``dev/<g>`` round spans come
from CUDA events, placed on the wall clock through one anchor event
(:mod:`repro_torch.core.executor`).

``python -m repro_torch.obs.trace out.json [...]`` validates exported
files against the schema.

A copy of the JAX package's ``obs/trace.py`` (the port imports nothing
of that package); the exported document differs from the reference's
only in ``otherData.tool``.
"""
from __future__ import annotations

import json
from contextlib import contextmanager

from .clock import now as _now

__all__ = [
    "TRACING", "Tracer", "attach", "detach", "traced", "span",
    "emit_span", "emit_instant", "validate_chrome_trace",
]

#: Fast-path guard read by every instrumented call site.
TRACING = False

_STACK: list["Tracer"] = []


def attach(tracer: "Tracer") -> None:
    global TRACING
    _STACK.append(tracer)
    TRACING = True


def detach(tracer: "Tracer") -> None:
    global TRACING
    if tracer in _STACK:
        _STACK.remove(tracer)
    TRACING = bool(_STACK)


@contextmanager
def traced(tracer: "Tracer | None" = None, domain: str = "wall"):
    """Attach ``tracer`` (or a fresh one) for the block; yields it."""
    tr = tracer if tracer is not None else Tracer(domain=domain)
    attach(tr)
    try:
        yield tr
    finally:
        detach(tr)


def emit_span(lane: str, name: str, t0: float, t1: float,
              clip: bool = False, **args) -> None:
    for tr in _STACK:
        tr.add_span(lane, name, t0, t1, clip=clip, **args)


def emit_instant(lane: str, name: str, t: float, **args) -> None:
    for tr in _STACK:
        tr.add_instant(lane, name, t, **args)


@contextmanager
def span(lane: str, name: str, **args):
    """Wall-clock span context for host code (reads the obs clock).
    Near-free when detached, but hot per-round sites should prefer the
    guarded ``if TRACING: emit_span(...)`` form with explicit times."""
    if not TRACING:
        yield
        return
    t0 = _now()
    try:
        yield
    finally:
        emit_span(lane, name, t0, _now(), **args)


class Tracer:
    """Span/instant collector for one run.

    ``spans`` holds ``(lane, name, t0, t1, args|None)`` tuples and
    ``instants`` holds ``(lane, name, t, args|None)`` — both in emission
    order, times in the tracer's ``domain`` seconds.
    """

    def __init__(self, domain: str = "wall"):
        if domain not in ("wall", "sim"):
            raise ValueError(f"domain must be 'wall' or 'sim', got {domain!r}")
        self.domain = domain
        self.spans: list[tuple] = []
        self.instants: list[tuple] = []
        self._lane_end: dict[str, float] = {}

    # -- recording --------------------------------------------------------
    def add_span(self, lane: str, name: str, t0: float, t1: float,
                 clip: bool = False, **args) -> None:
        t0, t1 = float(t0), float(t1)
        if clip:
            t0 = max(t0, self._lane_end.get(lane, t0))
            if t1 <= t0:
                return          # fully shadowed by the lane's previous span
        end = self._lane_end.get(lane)
        self._lane_end[lane] = t1 if end is None else max(end, t1)
        self.spans.append((lane, name, t0, max(t1, t0), args or None))

    def add_instant(self, lane: str, name: str, t: float, **args) -> None:
        self.instants.append((lane, name, float(t), args or None))

    def lanes(self) -> list:
        return sorted({s[0] for s in self.spans} |
                      {i[0] for i in self.instants}, key=_lane_sort_key)

    # -- Chrome trace-event export ----------------------------------------
    def to_chrome(self) -> dict:
        lanes = self.lanes()
        pid_tid = {}
        next_tid = {1: 0, 2: 0, 3: 0}
        for lane in lanes:
            pid = _lane_pid(lane)
            pid_tid[lane] = (pid, next_tid[pid])
            next_tid[pid] += 1
        times = [s[2] for s in self.spans] + [i[2] for i in self.instants]
        t_origin = min(times) if times else 0.0

        def us(t: float) -> float:
            return round((t - t_origin) * 1e6, 3)

        events = []
        for pid, pname in ((1, "server"), (2, "devices"), (3, "network")):
            if any(p == pid for p, _ in pid_tid.values()):
                events.append({"name": "process_name", "ph": "M", "pid": pid,
                               "tid": 0, "args": {"name": pname}})
        for lane, (pid, tid) in pid_tid.items():
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": _lane_label(lane)}})
        for lane, name, t0, t1, args in self.spans:
            pid, tid = pid_tid[lane]
            u0, u1 = us(t0), us(t1)
            # dur from the ROUNDED endpoints: ts+dur lands exactly on the
            # next span's rounded start, so clip-tight spans stay
            # non-overlapping after µs quantization
            ev = {"name": name, "ph": "X", "ts": u0,
                  "dur": max(round(u1 - u0, 3), 0.0),
                  "pid": pid, "tid": tid}
            if args:
                ev["args"] = args
            events.append(ev)
        for lane, name, t, args in self.instants:
            pid, tid = pid_tid[lane]
            ev = {"name": name, "ph": "i", "ts": us(t), "s": "t",
                  "pid": pid, "tid": tid}
            if args:
                ev["args"] = args
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"domain": self.domain,
                              "time_unit": "sim-seconds"
                              if self.domain == "sim" else "wall-seconds",
                              "tool": "repro_torch.obs.trace"}}

    def export_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


# ---------------------------------------------------------------------------
# lane → pid/tid mapping helpers
# ---------------------------------------------------------------------------

def _lane_pid(lane: str) -> int:
    if lane.startswith("dev/"):
        return 2
    if lane.startswith("net/"):
        return 3
    return 1


def _lane_sort_key(lane: str):
    parts = lane.split("/")
    num = int(parts[1]) if len(parts) > 1 and parts[1].isdigit() else -1
    return (_lane_pid(lane), parts[0], num, lane)


def _lane_label(lane: str) -> str:
    parts = lane.split("/")
    if lane.startswith("dev/") and len(parts) >= 2:
        tail = " ".join(parts[2:])
        return f"device {parts[1]}" + (f" ({tail})" if tail else "")
    if lane.startswith("net/") and len(parts) >= 2:
        return f"uplink {parts[1]}"
    return lane


# ---------------------------------------------------------------------------
# schema validation (chip_smoke.py + tests)
# ---------------------------------------------------------------------------

#: tolerance for float-rounding overlap between adjacent spans (µs)
_OVERLAP_EPS_US = 1e-3


def validate_chrome_trace(doc: dict) -> list:
    """Check a Chrome trace-event document.  Returns a list of problem
    strings (empty = valid): required top-level shape, required per-phase
    fields, non-negative timestamps/durations, and — per (pid, tid) lane —
    monotonically ordered, non-overlapping complete ('X') spans."""
    problems: list[str] = []
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        return ["top level must be an object with a 'traceEvents' list"]
    by_lane: dict[tuple, list] = {}
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "M"):
            problems.append(f"event {i}: unsupported ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str):
            problems.append(f"event {i}: missing/non-string 'name'")
        if not isinstance(ev.get("pid"), int):
            problems.append(f"event {i}: missing/non-int 'pid'")
        if ph == "M":
            continue
        if not isinstance(ev.get("tid"), int):
            problems.append(f"event {i}: missing/non-int 'tid'")
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i}: 'ts' must be a number >= 0")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: 'X' event needs 'dur' >= 0")
                continue
            by_lane.setdefault((ev["pid"], ev["tid"]), []).append(
                (float(ts), float(dur), ev.get("name", ""), i))
    for (pid, tid), evs in sorted(by_lane.items()):
        evs.sort()
        end = -1.0
        for ts, dur, name, i in evs:
            if ts < end - _OVERLAP_EPS_US:
                problems.append(
                    f"lane pid={pid} tid={tid}: span {name!r} (event {i}) "
                    f"starts at {ts} before the previous span ended at "
                    f"{end} — overlapping spans on one lane")
            end = max(end, ts + dur)
    return problems


def _main(argv) -> int:
    if not argv:
        print("usage: python -m repro_torch.obs.trace TRACE.json [...]")
        return 2
    rc = 0
    for path in argv:
        with open(path) as f:
            doc = json.load(f)
        problems = validate_chrome_trace(doc)
        evs = doc.get("traceEvents", []) if isinstance(doc, dict) else []
        n_x = sum(1 for e in evs if isinstance(e, dict)
                  and e.get("ph") == "X")
        lanes = {(e.get("pid"), e.get("tid")) for e in evs
                 if isinstance(e, dict) and e.get("ph") == "X"}
        if problems:
            rc = 1
            for p in problems:
                print(f"{path}: {p}")
        else:
            dom = (doc.get("otherData") or {}).get("domain", "?")
            print(f"{path}: OK — {n_x} spans on {len(lanes)} lanes "
                  f"(domain={dom})")
    return rc


if __name__ == "__main__":
    import sys
    raise SystemExit(_main(sys.argv[1:]))
