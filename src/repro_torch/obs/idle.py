"""Idle-time attribution: classify every gap on every trace lane.

FedOptima's Table 3 reports idle-time *reductions*; this module makes the
underlying quantity first-class.  Given a captured :class:`~repro_torch
.obs.trace.Tracer`, every non-busy second on each entity's timeline is
assigned to exactly one class:

``warmup``
    before the entity's first busy span — pipeline fill for the server,
    pre-selection wait for a device.  Kept separate so steady-state idle
    fractions are not diluted by startup.
``offline``
    (devices only) between a ``leave`` and the matching ``join`` instant
    — the device does not exist, so the time is excluded from its idle
    denominator rather than blamed on the protocol.
``task_dependency``
    idle forced by the protocol's dependency structure: a device waiting
    while the server aggregates/trains, or the server waiting with no
    device mid-task (nothing outstanding to wait *for*).
``straggler``
    idle forced by load imbalance: a device done while a peer is still
    computing, or the server blocked on outstanding slow devices while
    other finished devices sit idle.

Entities aggregate lanes: device *k* is every ``dev/<k>`` and
``dev/<k>/...`` lane (PiPar's overlapped-forward sub-lane counts as the
same device being busy); the server is ``srv``, ``srv/...`` and ``mesh``.
``net/`` and ``host/`` lanes are timeline detail, not compute, and are
ignored here.

The classifier is a single sweep over the union of interval boundaries,
so classes partition each entity's [0, duration] exactly — the output
rows sum back to the wall (asserted by the tests, not trusted).

A copy of the JAX package's ``obs/idle.py``, unchanged in behaviour.
"""
from __future__ import annotations

__all__ = ["attribute_idle"]


def _merge(intervals: list) -> list:
    """Sort + coalesce [t0, t1) intervals."""
    out: list = []
    for t0, t1 in sorted(intervals):
        if t1 <= t0:
            continue
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def _clamp(intervals: list, duration: float) -> list:
    return [[max(0.0, a), min(duration, b)] for a, b in intervals
            if min(duration, b) > max(0.0, a)]


def _covered(intervals: list, a: float, b: float) -> bool:
    """True if [a, b) lies inside one of the (merged, sorted) intervals."""
    for t0, t1 in intervals:
        if t0 <= a and b <= t1:
            return True
        if t0 >= b:
            break
    return False


def _device_of(lane: str):
    if lane.startswith("dev/"):
        parts = lane.split("/")
        if len(parts) >= 2 and parts[1]:
            return parts[1]
    return None


def _is_server(lane: str) -> bool:
    return lane == "srv" or lane.startswith("srv/") or lane == "mesh"


def attribute_idle(tracer, duration: float | None = None) -> dict:
    """Classify idle time on a captured trace.

    ``duration`` is the run's horizon in the tracer's time domain;
    defaults to the last span end.  Returns a dict with ``server``,
    ``devices`` (fleet aggregate) and ``per_device`` sections; each
    carries ``busy_s`` / ``warmup_s`` / ``task_dependency_s`` /
    ``straggler_s`` (devices add ``offline_s``) plus fractions.  Server
    fractions are over ``duration``; device fractions are over the
    fleet's *online* time ``n_devices * duration - offline_s``.
    """
    dev_busy: dict = {}
    srv_busy: list = []
    for lane, _name, t0, t1, _args in tracer.spans:
        k = _device_of(lane)
        if k is not None:
            dev_busy.setdefault(k, []).append((t0, t1))
        elif _is_server(lane):
            srv_busy.append((t0, t1))

    if duration is None:
        ends = [s[3] for s in tracer.spans]
        duration = max(ends) if ends else 0.0
    duration = float(duration)
    if duration <= 0.0:
        raise ValueError("attribute_idle needs a positive duration "
                         "(or at least one recorded span)")

    # offline windows from leave/join instants, paired per device
    dev_offline: dict = {k: [] for k in dev_busy}
    pending_leave: dict = {}
    for lane, name, t, _args in sorted(tracer.instants, key=lambda i: i[2]):
        k = _device_of(lane)
        if k is None:
            continue
        if name == "leave":
            pending_leave.setdefault(k, t)
        elif name == "join" and k in pending_leave:
            dev_offline.setdefault(k, []).append(
                (pending_leave.pop(k), t))
    for k, t in pending_leave.items():     # left and never came back
        dev_offline.setdefault(k, []).append((t, duration))

    srv_busy = _clamp(_merge(srv_busy), duration)
    dev_busy = {k: _clamp(_merge(v), duration) for k, v in dev_busy.items()}
    dev_offline = {k: _clamp(_merge(v), duration)
                   for k, v in dev_offline.items()}
    devices = sorted(dev_busy, key=lambda k: (len(k), k))

    srv_start = srv_busy[0][0] if srv_busy else duration
    dev_start = {k: (dev_busy[k][0][0] if dev_busy[k] else duration)
                 for k in devices}

    # one sweep over the union of all interval boundaries
    cuts = {0.0, duration}
    for t0, t1 in srv_busy:
        cuts.update((t0, t1))
    for k in devices:
        for t0, t1 in dev_busy[k]:
            cuts.update((t0, t1))
        for t0, t1 in dev_offline.get(k, []):
            cuts.update((t0, t1))
    cuts = sorted(c for c in cuts if 0.0 <= c <= duration)

    srv = {"busy_s": 0.0, "warmup_s": 0.0,
           "task_dependency_s": 0.0, "straggler_s": 0.0}
    per_dev = {k: {"busy_s": 0.0, "warmup_s": 0.0, "offline_s": 0.0,
                   "task_dependency_s": 0.0, "straggler_s": 0.0}
               for k in devices}

    for a, b in zip(cuts, cuts[1:]):
        seg = b - a
        if seg <= 0.0:
            continue
        s_busy = _covered(srv_busy, a, b)
        d_busy = {k: _covered(dev_busy[k], a, b) for k in devices}
        d_off = {k: _covered(dev_offline.get(k, []), a, b) for k in devices}

        if s_busy:
            srv["busy_s"] += seg
        elif a < srv_start:
            srv["warmup_s"] += seg
        else:
            any_busy = any(d_busy[k] and not d_off[k] for k in devices)
            finished_waiting = any(
                (not d_busy[k]) and (not d_off[k]) and a >= dev_start[k]
                for k in devices)
            if any_busy and finished_waiting:
                srv["straggler_s"] += seg
            else:
                srv["task_dependency_s"] += seg

        for k in devices:
            row = per_dev[k]
            if d_off[k]:
                row["offline_s"] += seg
            elif d_busy[k]:
                row["busy_s"] += seg
            elif a < dev_start[k]:
                row["warmup_s"] += seg
            elif s_busy:
                row["task_dependency_s"] += seg
            elif any(d_busy[j] and not d_off[j]
                     for j in devices if j != k):
                row["straggler_s"] += seg
            else:
                row["task_dependency_s"] += seg

    def _fracs(row: dict, denom: float) -> dict:
        idle = row["task_dependency_s"] + row["straggler_s"]
        out = dict(row)
        out["idle_frac"] = idle / denom if denom > 0 else 0.0
        for cls in ("task_dependency", "straggler"):
            out[f"{cls}_frac"] = (row[f"{cls}_s"] / denom
                                  if denom > 0 else 0.0)
        return out

    fleet = {"busy_s": 0.0, "warmup_s": 0.0, "offline_s": 0.0,
             "task_dependency_s": 0.0, "straggler_s": 0.0}
    for row in per_dev.values():
        for key in fleet:
            fleet[key] += row[key]
    online = len(devices) * duration - fleet["offline_s"]

    return {
        "duration": duration,
        "warmup_end_s": srv_start,
        "server": _fracs(srv, duration),
        "devices": {"n": len(devices), **_fracs(fleet, online)},
        "per_device": {
            k: _fracs(row, duration - row["offline_s"])
            for k, row in per_dev.items()},
    }
