"""The port's pod round under the fleet plane against the JAX package's: smoke
smollm-135m, G=4, three rounds of ``run_pod`` under ``--fleet-trace
weibull --fleet-tiers high:3,premium:1 --selection refl:0.5 --seed 3``,
the kernel op on and off.  At H=2 a group at under half the fastest
group's speed emits nothing, so under the card's ``low:3,high:1`` only
the high group would send, and in three rounds it joins one cohort at
most; this mix and seed send data to the server from round 0 on, with
five roster events.

The JAX ``run_pod`` does not build on the CPU (its debug mesh has
Explicit axes under jax 0.9), so the reference's rosters and plans are
built from the JAX package's own objects, as its ``run_pod`` builds
them: its ``_fleet_trace``, ``sample_cluster``, ``make_selection_policy``
and a ``ControlPlane`` with ``StragglerProfiles(G, step_s=1/caps)``, run
in lockstep with the port's run (the profiles observe the port's measured
round walls in the port's order).  The port's rosters, cohorts, plans and
elastic registry must equal them exactly; then those rosters and patterns
go through ``tests/test_torch_round.py``'s harness, which runs both
packages' steps from the JAX init: both losses and every state leaf at
1e-4 (the reference's GTOL) after each round.
"""
import dataclasses

import numpy as np
import pytest

from repro import fleet as jfleet
from repro.core import control_plane as jcp
from repro.core import executor as jex
from repro.launch import train as jtrain
from repro.runtime import elastic as jelastic
from repro_torch.core import control_plane as tcp
from repro_torch.core import executor as tex
from repro_torch.launch import train as ttrain

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_round import _assert_plans_equal, _close, _rounds

G, H, OMEGA, ROUNDS = 4, 2, 2, 3
ARGV = ["--device", "cpu", "--batch", "4", "--H", str(H), "--seq-len", "16",
        "--groups-per-shard", str(G), "--omega", str(OMEGA), "--l-split",
        "1", "--rounds", str(ROUNDS), "--fleet-trace", "weibull",
        "--fleet-tiers", "high:3,premium:1", "--selection", "refl:0.5",
        "--seed", "3"]


def _port_run(monkeypatch, argv):
    """``train.main(argv)`` with the port's plans and profile observations
    recorded in the order they happen."""
    log = []
    plan_round = tcp.ControlPlane.plan_round
    observe_round = tex.StragglerProfiles.observe_round

    def spy_plan(self, **kw):
        plan = plan_round(self, **kw)
        log.append(("plan", plan))
        return plan

    def spy_observe(self, wall_s, H):
        log.append(("observe", wall_s, H))
        return observe_round(self, wall_s, H)
    monkeypatch.setattr(tcp.ControlPlane, "plan_round", spy_plan)
    monkeypatch.setattr(tex.StragglerProfiles, "observe_round", spy_observe)
    out = ttrain.main(argv)
    monkeypatch.undo()
    return out, log


def _jax_lockstep(args, log):
    """The reference's rosters, cohorts, patterns, plans and registry for
    the port's run, from the JAX package's fleet objects, replaying the
    port's profile observations in order."""
    trace = jtrain._fleet_trace(args, G, horizon=float(max(args.rounds, 1)),
                                interval=1.0)
    sel = jfleet.make_selection_policy(args.selection, seed=args.seed)
    caps = np.asarray(jfleet.sample_cluster(G, args.fleet_tiers,
                                            seed=args.seed).dev_flops, float)
    plane = jcp.ControlPlane(G, OMEGA, H)
    profiles = jex.StragglerProfiles(G, step_s=1.0 / caps)
    registry = jelastic.ElasticRegistry()
    for g in range(G):
        registry.join(flops_per_s=float(caps[g]), bandwidth=1.0)
    out = {"available": [], "cohorts": [], "patterns": [], "plans": []}
    for event in log:
        if event[0] == "observe":
            profiles.observe_round(*event[1:])
            continue
        r = len(out["plans"])
        roster = trace.roster(r)
        out["available"].append(np.flatnonzero(roster).tolist())
        if roster.any():
            ctx = jfleet.SelectionContext(
                t=float(r), counters=plane.scheduler.counters,
                staleness=plane.version - plane.versions, capability=caps)
            chosen = sel.select(np.flatnonzero(roster), ctx)
            roster = np.zeros(G, bool)
            roster[np.asarray(chosen, int)] = True
        out["cohorts"].append(np.flatnonzero(roster).tolist())
        produce, reads = profiles.produce(H), profiles.reads(H)
        plan = plane.plan_round(active=roster, produce=produce, reads=reads)
        for g in plan.retire:
            plane.retain_group(g, None)
            registry.leave(g, t=float(r))
        for g in plan.restore:
            plane.release_group(g)
            registry.rejoin(g, t=float(r))
        plane.finish_round(active=roster)
        out["patterns"].append((produce, reads))
        out["plans"].append(plan)
    out["registry"] = registry
    return out


def _roster(reg):
    return (reg._next_id, [dataclasses.asdict(i)
                           for i in reg.devices.values()])


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["fleet-plain", "fleet-kernel"])
def test_pod_round_under_fleet_matches_jax(monkeypatch, use_kernel):
    argv = ARGV + (["--use-kernel"] if use_kernel else [])
    out, log = _port_run(monkeypatch, argv)
    want = _jax_lockstep(ttrain.build_parser().parse_args(argv), log)
    fleet = out["fleet"]
    # the port's rosters, cohorts, plans and registry are the reference's
    assert fleet["available"] == want["available"]
    assert fleet["cohorts"] == want["cohorts"]
    got_plans = [e[1] for e in log if e[0] == "plan"]
    assert len(got_plans) == len(want["plans"]) == ROUNDS
    for pt, pj in zip(got_plans, want["plans"]):
        _assert_plans_equal(pt, pj)
    assert _roster(fleet["registry"]) == _roster(want["registry"])
    # the scenario exercises what it claims: cohorts of at most half the
    # available groups, roster events, tier-seeded (non-uniform) plans
    assert all(len(c) <= -(-len(a) // 2)
               for a, c in zip(fleet["available"], fleet["cohorts"]))
    assert fleet["roster_events"] > 0
    assert any(not p.all() for p, _ in want["patterns"])
    assert fleet["produce_per_round"] != [H] * G
    assert sum(out["consumed"]) > 0
    assert all(np.isfinite(m[k]) for m in out["history"]
               for k in ("d_loss", "s_loss"))
    # the same rosters and patterns through both packages' steps
    rosters = [np.isin(np.arange(G), c) for c in want["cohorts"]]
    n = 0
    for r, tm, jm, tstate, jstate in _rounds(
            "smollm-135m", use_kernel, {}, rosters=rosters,
            patterns=want["patterns"]):
        _close(tm, jm, f"round {r} metrics")
        _close(tstate, jstate, f"round {r} state")
        n += 1
    assert n == ROUNDS
