"""The port's protocol sanitizer (``repro_torch.analysis.sanitize``),
mirroring ``tests/test_sanitize.py`` case for case on the port's
simulator and baselines, and holding its event stream against the JAX
package's.

* A correct protocol is silent: churn runs, the K=32 diurnal acceptance
  run, the six baselines under churn and a seeded property test raise
  nothing.
* The two historical bug classes, reintroduced behind the port's
  test-only hooks (``FlowController._test_skip_reclaim``,
  ``simulation._TEST_SKIP_EPOCH_CHECK``), are caught online under the
  right invariant name; post-hoc mode collects instead of raising.
* The checks fire on hand-built violations (five unit triggers and one
  pod-side trigger: the planner's pool keys disagree with the port's
  ``ActivationStore``).
* Event-stream parity: each package gets its own recording
  ``ProtocolSanitizer`` subclass that keeps ``(kind, scalar fields)``.
  ``simulate_fedoptima`` under a diurnal trace (K=16) and each of the six
  baselines under churn emit the JAX package's sequence exactly.  The
  pod executor at windows 1 and 2 (the real smoke step, ``--pool-cap``,
  ``--p-drop`` and a stalled profile, so slots spill and fill and groups
  drop and rejoin) emits the JAX executor's sequence on the same rosters
  and profile; the JAX executor runs a stub step, since no event reads a
  value the step computes.  ROADMAP §C's deliberate differences (the
  advisory prefetch, the light handles) emit no sanitizer event, so
  ``POD_ONLY_IN_JAX`` is empty.
* The driver: ``--sanitize`` in both modes prints the ``sanitizer:`` line
  with 0 violations, composes with ``--trace``, and changes no value.
"""
import numpy as np
import pytest
import torch

from _propcheck import given, settings, strategies as st
from repro.analysis import sanitize as jsan
from repro.core import control_plane as jcp
from repro.core import executor as jex
from repro.core.baselines import REGISTRY as JREG
from repro.core.simulation import SimModel as JSimModel
from repro.core.simulation import heterogeneous_cluster as jcluster
from repro.core.simulation import simulate_fedoptima as jsimulate
from repro.fleet import diurnal_trace as jdiurnal
from repro.fleet import flaky_trace as jflaky
from repro.memory import store as jstore
from repro_torch.analysis import sanitize as san_mod
from repro_torch.analysis.sanitize import (INVARIANTS, InvariantViolation,
                                           ProtocolSanitizer, sanitized,
                                           suspended)
from repro_torch.core import control_plane as tcp
from repro_torch.core import executor as tex
from repro_torch.core import simulation
from repro_torch.core.baselines import REGISTRY
from repro_torch.core.flow_control import FlowController
from repro_torch.core.scheduler import TaskScheduler
from repro_torch.core.simulation import (SimModel, heterogeneous_cluster,
                                         simulate_fedoptima)
from repro_torch.fleet import diurnal_trace, flaky_trace, sample_cluster
from repro_torch.launch import train as ttrain
from repro_torch.memory import ActivationStore
from repro_torch.models.common import tree_leaves

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_memory import _JaxStalledProfiles, _StalledProfiles, _slot_ops
from test_torch_round import SMOKE_ARGS

COSTS = dict(dev_fwd_flops=1e9, dev_bwd_flops=2e9, full_fwd_flops=5e9,
             srv_flops_per_batch=8e9, act_bytes=1e6, dev_model_bytes=4e6,
             full_model_bytes=2e7, batch_size=32)
MODEL, JMODEL = SimModel(**COSTS), JSimModel(**COSTS)


def _churn_trace(K, dur, seed=7, cluster=None, make=diurnal_trace):
    bw = cluster.dev_bw if cluster is not None else 12.5e6
    return make(K, horizon=dur, interval=dur / 24.0, day=dur / 2.0,
                on_frac=0.6, bw=bw, bw_jitter=0.3, seed=seed)


# ---------------------------------------------------------------------------
# a correct protocol is silent
# ---------------------------------------------------------------------------

def test_clean_churn_run_zero_violations():
    cluster = heterogeneous_cluster(16)
    trace = _churn_trace(16, 600.0, cluster=cluster)
    with sanitized() as san:
        m = simulate_fedoptima(MODEL, cluster, duration=600.0, omega=8,
                               fleet=trace, seed=5)
    assert san.n_violations == 0
    assert san.n_events > 1000          # the run was actually instrumented
    assert san.counts.get("sim.device_left", 0) > 0   # churn really happened
    assert m.throughput > 0


def test_acceptance_scenario_k32_diurnal():
    """The K=32 diurnal-trace scenario over four capability tiers
    completes under the sanitizer with zero violations."""
    cluster = sample_cluster(32, "low:2,mid:3,high:2,premium:1", seed=11)
    trace = _churn_trace(32, 120.0, cluster=cluster)
    with sanitized() as san:
        m = simulate_fedoptima(MODEL, cluster, duration=120.0, omega=8,
                               fleet=trace, seed=11)
    assert san.n_violations == 0
    assert san.counts.get("cp.arrival", 0) > 0
    assert m.srv_batches > 0


def test_baselines_clean_under_churn():
    cluster = heterogeneous_cluster(8)
    trace = flaky_trace(8, 300.0, interval=15.0, p_drop=0.2,
                        bw_lo=8e6, bw_hi=16e6, seed=3)
    with sanitized() as san:
        for name, fn in REGISTRY.items():
            fn(MODEL, cluster, duration=300.0, fleet=trace)
    assert san.n_violations == 0
    assert san.n_events > 0
    assert san.counts.get("sim.chain_start", 0) > 0
    assert san.counts.get("sim.device_left", 0) > 0


@settings(max_examples=6, deadline=None)
@given(st.integers(0, 10_000), st.sampled_from(["diurnal", "flaky"]),
       st.sampled_from([4, 8, 16]))
def test_property_seeded_churn_is_clean(seed, kind, omega):
    """No (seed, trace kind, omega) combination produces a violation."""
    cluster = heterogeneous_cluster(12)
    if kind == "diurnal":
        trace = _churn_trace(12, 300.0, seed=seed, cluster=cluster)
    else:
        trace = flaky_trace(12, 300.0, interval=12.0, p_drop=0.15,
                            bw_lo=8e6, bw_hi=16e6, seed=seed)
    with sanitized() as san:
        simulate_fedoptima(MODEL, cluster, duration=300.0, omega=omega,
                           fleet=trace, seed=seed)
    assert san.n_violations == 0


# ---------------------------------------------------------------------------
# mutation tests: the two historical bugs, reintroduced behind hooks
# ---------------------------------------------------------------------------

def test_mutation_skipped_token_reclaim_is_caught():
    """``on_device_left`` forgets to reclaim the departed device's
    token/in-flight budget: flow-token-conservation fires at the first
    leaking departure."""
    cluster = heterogeneous_cluster(16)
    trace = _churn_trace(16, 600.0, cluster=cluster)
    FlowController._test_skip_reclaim = True
    try:
        with pytest.raises(InvariantViolation) as ei:
            with sanitized():
                simulate_fedoptima(MODEL, cluster, duration=600.0, omega=8,
                                   fleet=trace, seed=5)
    finally:
        FlowController._test_skip_reclaim = False
    assert ei.value.invariant == "flow-token-conservation"
    assert "not reclaimed" in str(ei.value)
    assert ei.value.window                     # diagnosis window attached


def test_mutation_skipped_epoch_check_is_caught(monkeypatch):
    """A model return from before a departure re-arms the device's chain,
    forking two concurrent chains after the rejoin: single-live-chain
    fires."""
    monkeypatch.setattr(simulation, "_TEST_SKIP_EPOCH_CHECK", True)
    cluster = heterogeneous_cluster(16)
    trace = _churn_trace(16, 600.0, cluster=cluster)
    with pytest.raises(InvariantViolation) as ei:
        with sanitized():
            simulate_fedoptima(MODEL, cluster, duration=600.0, omega=8,
                               fleet=trace, seed=5)
    assert ei.value.invariant == "single-live-chain"


def test_posthoc_mode_collects_instead_of_raising():
    cluster = heterogeneous_cluster(16)
    trace = _churn_trace(16, 600.0, cluster=cluster)
    FlowController._test_skip_reclaim = True
    try:
        san = ProtocolSanitizer(raise_on_violation=False)
        with sanitized(san):
            simulate_fedoptima(MODEL, cluster, duration=600.0, omega=8,
                               fleet=trace, seed=5)
    finally:
        FlowController._test_skip_reclaim = False
    assert san.n_violations >= 1
    assert all(v.invariant == "flow-token-conservation"
               for v in san.violations)
    rep = san.report()
    assert rep["n_violations"] == san.n_violations
    assert rep["violations"][0]["invariant"] == "flow-token-conservation"


# ---------------------------------------------------------------------------
# per-invariant unit triggers (hand-built violating event streams)
# ---------------------------------------------------------------------------

def test_unit_unregistered_arrival():
    flow = FlowController(omega=2)
    for k in range(4):
        flow.register(k)
    with sanitized() as san, pytest.raises(InvariantViolation) as ei:
        san.record("flow.enqueue", {"flow": flow, "device": 99,
                                    "accepted": True, "registered": False})
    assert ei.value.invariant == "no-unregistered-arrival"


def test_unit_counter_purge_on_rejoin():
    sched = TaskScheduler(n_devices=4)
    with sanitized() as san, pytest.raises(InvariantViolation) as ei:
        sched.q_act[1].append("act")      # backlog pending -> not drained
        sched.remove_device(1)
        sched.counters[1] = 3             # forge surviving stale history
        san.record("sched.add", {"sched": sched, "device": 1})
    assert ei.value.invariant == "counter-purge"


def test_unit_staleness_monotonicity():
    cp = tcp.ControlPlane.for_sim(4, 2)
    with sanitized() as san, pytest.raises(InvariantViolation) as ei:
        san.record("cp.finish", {"cp": cp})
        cp.version += 5
        san.record("cp.finish", {"cp": cp})
        cp.version -= 3                   # forge a version rollback
        san.record("cp.finish", {"cp": cp})
    assert ei.value.invariant == "staleness-monotonicity"


def test_unit_single_chain_double_start():
    sim_obj = object()
    with sanitized() as san, pytest.raises(InvariantViolation) as ei:
        san.record("sim.chain_start", {"sim": sim_obj, "device": 0,
                                       "epoch": 0})
        san.record("sim.chain_start", {"sim": sim_obj, "device": 0,
                                       "epoch": 0})
    assert ei.value.invariant == "single-live-chain"
    assert "second concurrent chain" in str(ei.value)


def test_unit_violation_window_is_bounded():
    sim_obj = object()
    san = ProtocolSanitizer(window=8, raise_on_violation=False)
    with sanitized(san):
        for i in range(50):
            san.record("sim.chain_end", {"sim": sim_obj, "device": i % 4,
                                         "epoch": 0})
        san.record("sim.chain_start", {"sim": sim_obj, "device": 0,
                                       "epoch": 3})   # stale epoch
    assert san.n_violations == 1
    assert len(san.violations[0].window) <= 8


def test_pod_trigger_store_keys_disagree_with_the_planner():
    """The executor's ``exec.round`` holds the planner's pool keys against
    the port's ``ActivationStore``: an entry that the planner never
    spilled is named by ring-pool-occupancy at the first round."""
    cp = tcp.ControlPlane(2, 2, 2, pool_cap=2)
    store = ActivationStore(2)
    store.spill(7, {"acts": torch.zeros(4)})      # an orphan pool entry
    gather, scatter = _slot_ops()
    ex = tex.RoundExecutor(lambda s, b: (s, {"d_loss": 0.0}), cp, window=2,
                           store=store, gather_slot=gather,
                           scatter_slot=scatter)
    with sanitized() as san, pytest.raises(InvariantViolation) as ei:
        ex.run({"ring": [{"acts": torch.zeros(4)}] * 2}, 0, 2,
               active_fn=lambda r: np.ones(2, bool),
               batch_fn=lambda r, plan: plan)
    assert ei.value.invariant == "ring-pool-occupancy"
    assert "disagrees with the ActivationStore's held keys [7]" in \
        str(ei.value)
    assert san.counts["exec.round"] == 1 and san.counts["cp.plan"] == 1


# ---------------------------------------------------------------------------
# plumbing
# ---------------------------------------------------------------------------

def test_suspended_detaches_globally():
    with sanitized() as san:
        assert san_mod.TRACING
        with suspended():
            assert not san_mod.TRACING
            san_mod.emit("flow.register", flow=None, device=0)  # nowhere
        assert san_mod.TRACING
    assert san.counts.get("flow.register", 0) == 0
    assert san_mod.TRACING is False and san_mod._STACK == []


def test_catalogue_names_are_unique_and_match_jax():
    names = [inv.name for inv in INVARIANTS]
    assert len(names) == len(set(names)) == 7
    for inv in INVARIANTS:
        assert inv.events, inv.name
        assert inv.statement and inv.module and inv.caught
    assert [(i.name, i.statement, i.module, i.events) for i in INVARIANTS] \
        == [(i.name, i.statement, i.module, i.events)
            for i in jsan.INVARIANTS]


def test_sanitizer_does_not_perturb_the_run():
    """Read-only contract: same seed, same metrics with and without."""
    cluster = heterogeneous_cluster(8)
    trace = _churn_trace(8, 300.0, cluster=cluster)
    kw = dict(duration=300.0, omega=4, fleet=trace, seed=9)
    with suspended():
        plain = simulate_fedoptima(MODEL, cluster, **kw)
        with sanitized():
            checked = simulate_fedoptima(MODEL, cluster, **kw)
    assert plain.srv_idle_frac == checked.srv_idle_frac
    assert plain.dev_idle_frac == checked.dev_idle_frac
    assert plain.throughput == checked.throughput


# ---------------------------------------------------------------------------
# event-stream parity with the JAX package
# ---------------------------------------------------------------------------

_SCALARS = (bool, int, float, str, type(None))


def _scalars(fields):
    return {k: v for k, v in fields.items() if isinstance(v, _SCALARS)}


def _recording(base):
    """A sanitizer of ``base``'s package that also keeps every event as
    (kind, scalar fields)."""
    class Recorder(base):
        def __init__(self):
            super().__init__()
            self.events = []

        def record(self, kind, fields):
            self.events.append((kind, _scalars(fields)))
            super().record(kind, fields)
    return Recorder()


def _port_events(fn):
    with sanitized(_recording(ProtocolSanitizer)) as rec:
        fn()
    assert rec.n_violations == 0
    return rec


def _jax_events(fn):
    with jsan.sanitized(_recording(jsan.ProtocolSanitizer)) as rec:
        fn()
    assert rec.n_violations == 0
    return rec


@pytest.mark.parametrize("srv_flops", [8e9, 8e10], ids=["fast", "slow"])
def test_fedoptima_event_stream_matches_jax(srv_flops):
    """``simulate_fedoptima`` under a diurnal trace (K=16): the port's
    events equal the JAX package's.  With the slow server a departed
    device's backlog drains after it left, so ``sched.purge`` is reached."""
    K, dur = 16, 300.0
    kw = dict(duration=dur, omega=4, seed=3)
    costs = {**COSTS, "srv_flops_per_batch": srv_flops}
    t = _port_events(lambda: simulate_fedoptima(
        SimModel(**costs), heterogeneous_cluster(K), **kw,
        fleet=_churn_trace(K, dur, cluster=heterogeneous_cluster(K))))
    j = _jax_events(lambda: jsimulate(
        JSimModel(**costs), jcluster(K), **kw,
        fleet=_churn_trace(K, dur, cluster=jcluster(K), make=jdiurnal)))
    assert t.events == j.events
    assert t.counts == j.counts
    assert {"sim.chain_start", "sim.chain_end", "sim.device_left",
            "sim.device_join", "flow.register", "flow.grant", "flow.sent",
            "flow.enqueue", "flow.dequeue", "flow.device_left",
            "sched.add", "sched.remove", "cp.arrival",
            "cp.synced"} <= set(t.counts)
    if srv_flops > COSTS["srv_flops_per_batch"]:
        assert t.counts["sched.purge"] > 0


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_baseline_event_stream_matches_jax(name):
    K, dur = 8, 300.0
    kw = dict(interval=15.0, p_drop=0.2, bw_lo=8e6, bw_hi=16e6, seed=3)
    t = _port_events(lambda: REGISTRY[name](
        MODEL, heterogeneous_cluster(K), duration=dur,
        fleet=flaky_trace(K, dur, **kw)))
    j = _jax_events(lambda: JREG[name](
        JMODEL, jcluster(K), duration=dur, fleet=jflaky(K, dur, **kw)))
    assert t.events == j.events
    if name in ("fedasync", "fedbuff", "oafl"):     # the churn seams
        assert t.counts["sim.chain_end"] > 0
        assert t.counts["sim.device_left"] > 0
        assert t.counts["sim.device_join"] > 0


#: pod events that only the JAX executor emits, each a deliberate
#: difference of ROADMAP §C.  The advisory prefetch and the light handles
#: emit no sanitizer event, so nothing is taken out.
POD_ONLY_IN_JAX: frozenset = frozenset()

POD_FLAGS = ["--rounds", "6", "--omega", "2", "--pool-cap", "2",
             "--p-drop", "0.5"]


def _pod_args(window, seed=1):
    args = ttrain.build_parser().parse_args(
        SMOKE_ARGS + POD_FLAGS + ["--window", str(window), "--seed",
                                  str(seed)])
    args.profiles = _StalledProfiles(2, stall_rounds=3)
    return args


def _jax_pod_events(cohorts, window):
    """The JAX executor on the same rosters and stalled profile, with a
    stub step over a host ring (no sanitizer event reads the step).  The
    control plane is built inside the sanitized block, as ``run_pod``
    builds the port's."""
    G = 2
    gather, scatter = _slot_ops()

    def active_fn(r):
        roster = np.zeros(G, bool)
        roster[cohorts[r]] = True
        return roster

    def run():
        cp = jcp.ControlPlane(G, 2, 2, pool_cap=2)
        ex = jex.RoundExecutor(
            lambda state, batch: (state, {"d_loss": 0.0, "s_loss": 0.0}),
            cp, window=window,
            profiles=_JaxStalledProfiles(G, stall_rounds=3),
            gather=lambda state, g: {"g": np.zeros(1)},
            scatter=lambda state, g, p: state,
            store=jstore.ActivationStore(2), gather_slot=gather,
            scatter_slot=scatter)
        ex.run({"ring": [{"acts": np.zeros(4, np.float32)}] * 2}, 0,
               len(cohorts), active_fn=active_fn,
               batch_fn=lambda r, plan: {})
    return _jax_events(run)


@pytest.mark.parametrize("window", [1, 2])
def test_pod_event_stream_matches_jax(window):
    """The port's ``run_pod`` (smoke smollm, ω=2, pool 2, --p-drop 0.5,
    a stalled profile) emits the JAX executor's event sequence; the run
    spills and fills, and groups drop and rejoin."""
    out = {}
    t = _port_events(lambda: out.update(ttrain.run_pod(_pod_args(window))))
    cohorts = out["fleet"]["cohorts"]
    j = _jax_pod_events(cohorts, window)
    want = [e for e in j.events if e[0] not in POD_ONLY_IN_JAX]
    assert t.events == want
    assert out["memory"]["spills"] > 0 and out["memory"]["fills"] > 0
    assert out["executor"]["retention"]["restored"] > 0
    assert {"cp.plan", "cp.finish", "exec.round", "store.spill",
            "store.fill", "flow.grant", "flow.sent", "flow.enqueue",
            "flow.dequeue", "sched.add"} <= set(t.counts)
    assert t.counts["exec.round"] == 6


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def _sanitizer_line(text):
    lines = [l for l in text.splitlines() if l.startswith("sanitizer: ")]
    assert len(lines) == 1, text
    return lines[0]


def test_driver_pod_sanitize_composes_with_trace(tmp_path, capsys):
    """``--sanitize`` in pod mode: 0 violations, the same history and
    final state as the unsanitized run, and with ``--trace`` both lines
    print and the trace is written."""
    base = SMOKE_ARGS + ["--rounds", "3", "--p-drop", "0.5", "--omega", "2",
                         "--pool-cap", "2"]
    plain = ttrain.main(base)
    assert "sanitizer:" not in capsys.readouterr().out
    path = tmp_path / "pod.json"
    out = ttrain.main(base + ["--sanitize", "--trace", str(path)])
    text = capsys.readouterr().out
    rep = out["sanitizer"]
    assert _sanitizer_line(text) == \
        f"sanitizer: {rep['events']} events checked, 0 violations"
    assert rep["n_violations"] == 0 and rep["by_kind"]["exec.round"] == 3
    assert f"lanes -> {path}" in text and path.exists()
    assert out["history"] == plain["history"]
    for x, y in zip(tree_leaves(out["state"]), tree_leaves(plain["state"])):
        assert torch.equal(x, y)
    assert san_mod.TRACING is False


def test_driver_sim_sanitize(tmp_path, capsys):
    """``--sanitize`` in sim mode under a flaky trace: 0 violations,
    departures seen, the same results as without, composing with
    ``--trace``."""
    base = ["--mode", "sim", "--device", "cpu", "--devices", "3",
            "--duration", "10", "--fleet-trace", "flaky"]
    plain = ttrain.main(base)
    path = tmp_path / "sim.json"
    out = ttrain.main(base + ["--sanitize", "--trace", str(path)])
    text = capsys.readouterr().out
    rep = out.pop("sanitizer")
    assert _sanitizer_line(text) == \
        f"sanitizer: {rep['events']} events checked, 0 violations"
    assert rep["by_kind"]["sim.chain_start"] > 0
    assert f"lanes -> {path}" in text and path.exists()
    assert set(out) == set(plain)
    for key in plain:
        assert out[key] == plain[key], key
