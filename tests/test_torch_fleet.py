"""The torch port's fleet plane (``repro_torch.fleet``, ``repro_torch.runtime``)
against the JAX package's, on the CPU, mirroring ``tests/test_fleet.py``
test for test: trace determinism and JSON artifacts (a file written by
either package loads in the other), legacy ``churn=`` equivalence, the
always-on/random-selection bit-for-bit pin, selection policies, tier
sampling, contribution balance and trace-driven churn through the
executor's retention store (property).  Each port result is held against
the JAX package's on the same inputs: grids, clusters and cohorts equal,
and ``Metrics`` bit for bit, the elastic registry's contents included.
Then ``tests/test_simulation.py::test_churn_degrades_gracefully`` on the
port, the simulator and the six baselines under every trace kind, and
``run_sim`` under the fleet flags.

Everything here is host arithmetic in float64 and integers, so every
comparison is exact.
"""
import argparse
import dataclasses

import numpy as np
import pytest

from repro import fleet as jfleet
from repro.core import baselines as jbase
from repro.core import control_plane as jcp
from repro.core import executor as jex
from repro.core import simulation as jsim
from repro.launch import train as jtrain
from repro.runtime import elastic as jelastic
from repro.runtime.fault_tolerance import ChurnModel as JChurn
from repro_torch import fleet as tfleet
from repro_torch.core import baselines as tbase
from repro_torch.core import control_plane as tcp
from repro_torch.core import executor as tex
from repro_torch.core import simulation as tsim
from repro_torch.fleet import (FleetTrace, balance_summary,
                               diurnal_trace, flaky_trace, gini,
                               make_selection_policy, make_trace,
                               parse_tiers, sample_cluster, tier_counts,
                               uniform_trace, weibull_sessions_trace)
from repro_torch.launch import train as ttrain
from repro_torch.runtime import ChurnModel, ElasticRegistry

from _propcheck import given, settings, strategies as st
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

COSTS = dict(dev_fwd_flops=1e9, dev_bwd_flops=2e9, full_fwd_flops=5e9,
             srv_flops_per_batch=8e9, act_bytes=1e6, dev_model_bytes=4e6,
             full_model_bytes=2e7, batch_size=32)
MODEL = tsim.SimModel(**COSTS)
JMODEL = jsim.SimModel(**COSTS)
CLUSTER = tsim.heterogeneous_cluster(8)
JCLUSTER = jsim.heterogeneous_cluster(8)
DUR = 400.0


def _nums(m):
    """Every numeric Metrics field (the bit-for-bit comparison surface)."""
    return (m.duration, m.dev_busy.tolist(), m.srv_busy, m.bytes_up,
            m.bytes_down, m.dev_samples, m.srv_batches, m.aggregations,
            m.rounds, m.max_buffered, m.dev_consumed.tolist())


def _roster(reg):
    """An ElasticRegistry's contents, package-neutral."""
    if reg is None:
        return None
    return (reg._next_id, [dataclasses.asdict(i)
                           for i in reg.devices.values()])


def _assert_metrics_equal(tm, jm):
    """Every field of the port's Metrics equals the reference's, bit for
    bit (the registry by its contents), and so do the derived figures."""
    for f in dataclasses.fields(tm):
        got, want = getattr(tm, f.name), getattr(jm, f.name)
        if f.name == "profiles" and want is not None:
            assert got.summary() == want.summary()
        elif f.name == "registry":
            assert _roster(got) == _roster(want)
        elif isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and np.array_equal(got, want), \
                f.name
        else:
            assert got == want, f.name
    for prop in ("dev_idle_frac", "srv_idle_frac", "throughput"):
        assert getattr(tm, prop) == getattr(jm, prop), prop
    assert tm.steady_summary() == jm.steady_summary()
    assert tm.contribution_balance() == jm.contribution_balance()
    assert tm.to_registry().snapshot() == jm.to_registry().snapshot()


def _jtrace(t):
    """The port's trace as the JAX package's (the same grids)."""
    return jfleet.FleetTrace(interval=t.interval, active=t.active.copy(),
                             bw=t.bw.copy(), meta=dict(t.meta))


def _assert_traces_equal(t, j):
    assert t.interval == j.interval and t.meta == j.meta
    assert t.active.dtype == j.active.dtype and \
        np.array_equal(t.active, j.active)
    assert t.bw.dtype == j.bw.dtype and np.array_equal(t.bw, j.bw)


def _both_sims(cluster_k=8, **kw):
    """simulate_fedoptima in both packages on the same inputs; a FleetTrace
    ``fleet`` and a ChurnModel ``churn`` are given to each package as its
    own object."""
    out = []
    for sim, conv in ((tsim, lambda x: x), (jsim, _to_jax)):
        args = {k: conv(v) for k, v in kw.items()}
        out.append(sim.simulate_fedoptima(
            sim.SimModel(**COSTS), sim.heterogeneous_cluster(cluster_k),
            **args))
    return out


def _to_jax(x):
    if isinstance(x, FleetTrace):
        return _jtrace(x)
    if isinstance(x, ChurnModel):
        return JChurn(**dataclasses.asdict(x))
    return x


# ---------------------------------------------------------------------------
# traces: determinism, structure, JSON artifact round-trip
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["diurnal", "weibull", "flaky"])
def test_generators_deterministic_under_seed(kind):
    a = make_trace(kind, 6, 4000.0, interval=200.0, seed=3)
    b = make_trace(kind, 6, 4000.0, interval=200.0, seed=3)
    np.testing.assert_array_equal(a.active, b.active)
    np.testing.assert_array_equal(a.bw, b.bw)
    c = make_trace(kind, 6, 4000.0, interval=200.0, seed=4)
    assert not (np.array_equal(a.active, c.active) and
                np.array_equal(a.bw, c.bw))
    # the JAX package's generator draws the same grids
    for t, seed in ((a, 3), (c, 4)):
        _assert_traces_equal(t, jfleet.make_trace(kind, 6, 4000.0,
                                                  interval=200.0, seed=seed))


def test_trace_json_roundtrip(tmp_path):
    t = diurnal_trace(5, 6000.0, interval=300.0, day=2000.0, on_frac=0.4,
                      bw_jitter=0.2, seed=9)
    path = t.save(str(tmp_path / "trace.json"))
    t2 = FleetTrace.load(path)
    np.testing.assert_array_equal(t.active, t2.active)
    np.testing.assert_array_equal(t.bw, t2.bw)
    assert t2.meta == t.meta and t2.interval == t.interval
    with pytest.raises(ValueError, match="format"):
        FleetTrace.from_json({"format": "nope"})
    # a file written by either package loads in the other, unchanged
    j = jfleet.diurnal_trace(5, 6000.0, interval=300.0, day=2000.0,
                             on_frac=0.4, bw_jitter=0.2, seed=9)
    _assert_traces_equal(t, j)
    _assert_traces_equal(t, jfleet.FleetTrace.load(path))
    jpath = j.save(str(tmp_path / "jax.json"))
    _assert_traces_equal(FleetTrace.load(jpath), j)
    assert open(jpath).read() == open(path).read()


def test_diurnal_windows_are_periodic_and_sized():
    day, interval = 2400.0, 100.0
    t = diurnal_trace(16, 2 * day, interval=interval, day=day, on_frac=0.5,
                      seed=0)
    per_day = int(day / interval)
    # each device is on for on_frac of every day, same phase every day
    np.testing.assert_array_equal(t.active[:per_day], t.active[per_day:])
    np.testing.assert_allclose(t.active.mean(axis=0), 0.5, atol=1e-9)
    assert not t.is_static
    _assert_traces_equal(t, jfleet.diurnal_trace(
        16, 2 * day, interval=interval, day=day, on_frac=0.5, seed=0))


def test_weibull_sessions_alternate_and_flaky_drops():
    w = weibull_sessions_trace(8, 40000.0, interval=400.0, seed=1)
    up = w.availability()
    assert (up > 0).all() and (up < 1).any()     # sessions, not constants
    f = flaky_trace(8, 10000.0, interval=500.0, p_drop=0.3, seed=2)
    assert 0.4 < f.availability().mean() < 0.95
    assert f.bw.min() >= 25e6 / 8 and f.bw.max() <= 50e6 / 8
    with pytest.raises(ValueError, match="unknown trace kind"):
        make_trace("lunar", 4, 100.0)
    _assert_traces_equal(w, jfleet.weibull_sessions_trace(
        8, 40000.0, interval=400.0, seed=1))
    _assert_traces_equal(f, jfleet.flaky_trace(8, 10000.0, interval=500.0,
                                               p_drop=0.3, seed=2))
    np.testing.assert_array_equal(up, w.availability())


def test_trace_wraps_past_horizon_and_validates():
    t = uniform_trace(3, 1000.0, interval=250.0)
    assert t.T == 4 and t.is_static
    np.testing.assert_array_equal(t.roster(7), t.roster(3))
    with pytest.raises(ValueError, match="matching"):
        FleetTrace(interval=1.0, active=np.ones((2, 3), bool),
                   bw=np.ones((2, 2)))
    # geometry, rows and in-place application as the JAX trace's
    f = flaky_trace(3, 1000.0, interval=250.0, p_drop=0.5, seed=1)
    j = _jtrace(f)
    assert (f.K, f.T, f.horizon, f.is_static) == \
        (j.K, j.T, j.horizon, j.is_static)
    for tick in range(9):
        np.testing.assert_array_equal(f.roster(tick), j.roster(tick))
        for a, b in zip(f.state_at(130.0 * tick), j.state_at(130.0 * tick)):
            np.testing.assert_array_equal(a, b)
        live = [(np.zeros(3, bool), np.zeros(3)) for _ in range(2)]
        f.apply(*live[0], tick=tick)
        j.apply(*live[1], tick=tick)
        for a, b in zip(*live):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# compat pins: always-on trace ≡ tracefree, churn= ≡ materialized trace
# ---------------------------------------------------------------------------

def test_always_on_uniform_fleet_random_selection_bitforbit():
    """An always-on trace over a uniform fleet with selection="random"
    reproduces the tracefree metrics bit for bit (the trace schedules no
    events, select-all draws no RNG), in the port as in the reference."""
    plain = tsim.simulate_fedoptima(MODEL, CLUSTER, duration=DUR)
    trace = FleetTrace.from_cluster(CLUSTER, DUR)
    tm, jm = _both_sims(duration=DUR, fleet=trace, selection="random")
    assert _nums(plain) == _nums(tm)
    assert tm.registry is not None          # roster mirrored regardless
    _assert_metrics_equal(tm, jm)


def test_churn_arg_equals_materialized_fleet_trace():
    """Legacy churn= is the same run as its FleetTrace.from_churn
    materialization — identical draws, identical events — and both equal
    the reference's churn= run."""
    mk = lambda: ChurnModel(n_devices=8, p_drop=0.3, interval=50.0, seed=4)
    for t in (0.0, 49.0, 50.0, 125.0, 1e4):
        for a, b in zip(mk().draw(t), _to_jax(mk()).draw(t)):
            np.testing.assert_array_equal(a, b)
    via_churn, jm = _both_sims(duration=DUR, churn=mk())
    trace = FleetTrace.from_churn(mk(), DUR, bw0=CLUSTER.dev_bw)
    _assert_traces_equal(trace, jfleet.FleetTrace.from_churn(
        _to_jax(mk()), DUR, bw0=JCLUSTER.dev_bw))
    via_fleet = tsim.simulate_fedoptima(MODEL, CLUSTER, duration=DUR,
                                        fleet=trace)
    assert _nums(via_churn) == _nums(via_fleet)
    _assert_metrics_equal(via_churn, jm)


@pytest.mark.parametrize("name", list(tbase.REGISTRY))
def test_baselines_churn_equals_fleet_and_reject_both(name):
    mk = lambda: ChurnModel(n_devices=8, p_drop=0.4, interval=60.0, seed=7)
    trace = FleetTrace.from_churn(mk(), DUR, bw0=CLUSTER.dev_bw)
    fn, jfn = tbase.REGISTRY[name], jbase.REGISTRY[name]
    a = fn(MODEL, CLUSTER, duration=DUR, churn=mk())
    b = fn(MODEL, CLUSTER, duration=DUR, fleet=trace)
    assert _nums(a) == _nums(b)
    _assert_metrics_equal(a, jfn(JMODEL, JCLUSTER, duration=DUR,
                                 churn=_to_jax(mk())))
    with pytest.raises(ValueError, match="not both"):
        fn(MODEL, CLUSTER, duration=DUR, churn=mk(), fleet=trace)
    with pytest.raises(ValueError, match="devices"):
        fn(MODEL, CLUSTER, duration=DUR, fleet=uniform_trace(4, DUR))


# ---------------------------------------------------------------------------
# trace-driven membership in the FedOptima simulation
# ---------------------------------------------------------------------------

def test_trace_churn_keeps_caps_and_mirrors_registry():
    trace = flaky_trace(8, DUR, interval=40.0, p_drop=0.4, seed=5)
    cp, jcp_ = tcp.ControlPlane.for_sim(8, 4), jcp.ControlPlane.for_sim(8, 4)
    m = tsim.simulate_fedoptima(MODEL, CLUSTER, duration=DUR, omega=4,
                                fleet=trace, control=cp)
    assert cp.flow.within_cap and m.max_buffered <= 4
    assert m.dev_consumed.sum() == m.srv_batches
    reg = m.registry
    assert reg is not None
    assert sum(i.absences for i in reg.devices.values()) > 0
    final = trace.state_at(DUR)[0]
    assert [d for d in reg.active_ids] == list(np.flatnonzero(final))
    jm = jsim.simulate_fedoptima(JMODEL, JCLUSTER, duration=DUR, omega=4,
                                 fleet=_jtrace(trace), control=jcp_)
    _assert_metrics_equal(m, jm)
    assert cp.memory_summary() == jcp_.memory_summary()
    assert cp.scheduler.counters == jcp_.scheduler.counters
    assert (cp.version, list(cp.versions)) == \
        (jcp_.version, list(jcp_.versions))


def test_straddled_model_upload_cannot_fork_concurrent_chains():
    """A model upload still in flight across a leave+rejoin must not
    restart the device when it finally returns (the rejoined chain owns
    the device): dev_busy can never exceed wall-clock."""
    costs = dict(COSTS, act_bytes=1e4, dev_model_bytes=6e4)
    active = np.ones((120, 2), bool)
    active[1, 0] = False            # off for one tick, rejoins the next —
    bw = np.full((120, 2), 1e9)     # — while its 600s first-round upload
    bw[0, 0] = 100.0                # (6e4 B / 100 B/s) is still in flight
    trace = FleetTrace(interval=12.0, active=active, bw=bw)
    out = [sim.simulate_fedoptima(
        sim.SimModel(**costs),
        sim.SimCluster(dev_flops=np.full(2, 3e9), dev_bw=np.full(2, 1e9),
                       srv_flops=1e12),
        duration=1400.0, fleet=tr)
        for sim, tr in ((tsim, trace), (jsim, _jtrace(trace)))]
    m = out[0]
    assert m.dev_busy[0] <= m.duration + 1e-6
    assert m.dev_busy[0] > 0.9 * m.duration    # ...but the live chain runs
    _assert_metrics_equal(*out)


@pytest.mark.parametrize("name", ["fedasync", "oafl"])
def test_async_baseline_flap_does_not_fork_chains(name):
    """A device flapping off->on INSIDE one iteration must not revive the
    pre-leave chain next to the rejoin-started one (fedasync and OAFL
    restart devices on rejoin): dev_busy can never exceed wall-clock."""
    active = np.ones((360, 1), bool)
    active[5, 0] = False                     # off at t=5, back at t=6
    trace = FleetTrace(interval=1.0, active=active, bw=np.full((360, 1), 1e9))
    out = [base.REGISTRY[name](
        sim.SimModel(**COSTS),
        sim.SimCluster(dev_flops=np.array([8.3e8]), dev_bw=np.array([1e9]),
                       srv_flops=1e12),      # one slow device, ~18s/iter
        duration=360.0, fleet=tr)
        for base, sim, tr in ((tbase, tsim, trace),
                              (jbase, jsim, _jtrace(trace)))]
    m = out[0]
    assert m.dev_busy[0] <= m.duration + 1e-6
    _assert_metrics_equal(*out)


def test_offline_at_start_device_stays_idle_until_joined():
    active = np.zeros((4, 4), bool)
    active[:, :3] = True          # device 3 off for the whole run
    trace = FleetTrace(interval=DUR / 4, active=active,
                       bw=np.full((4, 4), 12.5e6))
    m, jm = _both_sims(4, duration=DUR, fleet=trace)
    assert m.dev_busy[3] == 0.0 and m.dev_consumed[3] == 0
    assert (m.dev_busy[:3] > 0).all()
    assert m.registry.devices[3].absences == 1 and \
        m.registry.devices[3].left_at == 0.0
    _assert_metrics_equal(m, jm)


def test_selection_restricts_cohort_in_sim():
    # horizon shorter than one tick: a single cohort for the whole run
    trace = FleetTrace.from_cluster(CLUSTER, 30.0, interval=600.0)
    m, jm = _both_sims(duration=30.0, fleet=trace, selection="random:0.25")
    assert int((m.dev_busy > 0).sum()) == 2    # ceil(0.25 * 8)
    _assert_metrics_equal(m, jm)
    # over many re-selection ticks the cohort rotates through the fleet
    m2, jm2 = _both_sims(duration=DUR,
                         fleet=FleetTrace.from_cluster(CLUSTER, DUR,
                                                       interval=40.0),
                         selection="random:0.25")
    assert int((m2.dev_busy > 0).sum()) > 2
    _assert_metrics_equal(m2, jm2)


# ---------------------------------------------------------------------------
# selection policies
# ---------------------------------------------------------------------------

def _ctx(counters=None, staleness=None, capability=None, K=6, t=0.0,
         pkg=tfleet):
    return pkg.SelectionContext(
        t=t, counters=counters or {},
        staleness=np.zeros(K) if staleness is None else
        np.asarray(staleness),
        capability=capability)


def test_make_selection_policy_specs():
    assert make_selection_policy(None) is None
    p = make_selection_policy("refl:0.5", seed=3)
    assert p.name == "refl" and p.fraction == 0.5 and not p.trivial
    assert make_selection_policy("random").trivial
    assert make_selection_policy(p) is p
    with pytest.raises(ValueError, match="unknown selection"):
        make_selection_policy("greedy")
    with pytest.raises(ValueError, match="fraction"):
        make_selection_policy("random:0")
    for spec in ("random", "refl:0.5", "score:0.25", "random:1"):
        p, j = make_selection_policy(spec), \
            jfleet.make_selection_policy(spec)
        assert (p.name, p.fraction, p.cohort, p.trivial, p.describe()) == \
            (j.name, j.fraction, j.cohort, j.trivial, j.describe())
        assert [p.cohort_size(n) for n in range(9)] == \
            [j.cohort_size(n) for n in range(9)]


def test_random_selection_sizes_and_determinism():
    p = make_selection_policy("random:0.5", seed=0)
    avail = np.arange(6)
    picks = p.select(avail, _ctx())
    assert len(picks) == 3 and set(picks) <= set(range(6))
    q = make_selection_policy("random:0.5", seed=0)
    np.testing.assert_array_equal(picks, q.select(avail, _ctx()))
    # select-all consumes no RNG: the next draw is seed-fresh
    r = make_selection_policy("random", seed=0)
    np.testing.assert_array_equal(r.select(avail, _ctx()), avail)
    # the JAX policy draws the same stream
    p, j = make_selection_policy("random:0.5", seed=5), \
        jfleet.make_selection_policy("random:0.5", seed=5)
    for n in (6, 5, 2, 6, 1, 4):
        np.testing.assert_array_equal(p.select(np.arange(n), _ctx()),
                                      j.select(np.arange(n), None))


def test_refl_selection_prefers_stale_then_underserved():
    p = make_selection_policy("refl:0.5")
    ctx = _ctx(counters={0: 9, 1: 0, 2: 2, 3: 2, 4: 5, 5: 5},
               staleness=[0, 0, 4, 4, 0, 0])
    picks = p.select([0, 1, 2, 3, 4, 5], ctx)
    # most-stale (2, 3) first; third slot goes to the least-consumed (1)
    np.testing.assert_array_equal(picks, [1, 2, 3])
    jctx = _ctx(counters={0: 9, 1: 0, 2: 2, 3: 2, 4: 5, 5: 5},
                staleness=[0, 0, 4, 4, 0, 0], pkg=jfleet)
    np.testing.assert_array_equal(
        picks, jfleet.make_selection_policy("refl:0.5").select(
            [0, 1, 2, 3, 4, 5], jctx))


def test_selection_survives_all_devices_off():
    for spec in ("random:0.5", "refl:0.5", "score:0.5"):
        p = make_selection_policy(spec)
        assert len(p.select([], _ctx(K=4, capability=np.ones(4)))) == 0
    # an all-off tick mid-run must not abort the simulation
    active = np.ones((4, 4), bool)
    active[1] = False
    trace = FleetTrace(interval=DUR / 4, active=active,
                       bw=np.full((4, 4), 12.5e6))
    m, jm = _both_sims(4, duration=DUR, fleet=trace, selection="score:0.5")
    assert m.dev_samples > 0
    _assert_metrics_equal(m, jm)


def test_generators_accept_per_device_bandwidth(tmp_path):
    """Tier-sampled clusters keep their bandwidth heterogeneity through
    trace generation: bw= takes a (K,) base, jitter multiplies it."""
    cl = sample_cluster(6, "low:1,premium:1", seed=0)
    t = diurnal_trace(6, 4000.0, interval=500.0, day=2000.0,
                      bw=cl.dev_bw, seed=1)
    np.testing.assert_allclose(t.bw, np.tile(cl.dev_bw, (t.T, 1)))
    j = diurnal_trace(6, 4000.0, interval=500.0, day=2000.0,
                      bw=cl.dev_bw, bw_jitter=0.2, seed=1)
    ratio = j.bw / cl.dev_bw[None, :]
    assert (ratio >= 0.8).all() and (ratio <= 1.2).all()
    # per-device bw meta stays a JSON-able artifact
    j2 = FleetTrace.load(j.save(str(tmp_path / "t.json")))
    np.testing.assert_array_equal(j.bw, j2.bw)
    assert j2.meta["bw"] == [float(v) for v in cl.dev_bw]
    jcl = jfleet.sample_cluster(6, "low:1,premium:1", seed=0)
    _assert_traces_equal(j, jfleet.diurnal_trace(
        6, 4000.0, interval=500.0, day=2000.0, bw=jcl.dev_bw,
        bw_jitter=0.2, seed=1))


def test_score_selection_weighs_capability_and_balance():
    p, jp = make_selection_policy("score:0.5"), \
        jfleet.make_selection_policy("score:0.5")
    # equal staleness: fast + underserved devices outrank slow + served
    kw = dict(counters={0: 10, 1: 0, 2: 10, 3: 0},
              capability=np.array([1e9, 4e9, 4e9, 1e9]), K=4)
    picks = p.select([0, 1, 2, 3], _ctx(**kw))
    np.testing.assert_array_equal(picks, [1, 2])   # fast+fresh, fast
    np.testing.assert_array_equal(
        picks, jp.select([0, 1, 2, 3], _ctx(**kw, pkg=jfleet)))
    # without capability data the balance/staleness terms decide
    kw = dict(counters={0: 10, 1: 0, 2: 10, 3: 0}, K=4)
    picks = p.select([0, 1, 2, 3], _ctx(**kw))
    assert set(picks) == {1, 3}
    np.testing.assert_array_equal(
        picks, jp.select([0, 1, 2, 3], _ctx(**kw, pkg=jfleet)))


@pytest.mark.parametrize("spec", ["random:0.5", "refl:0.5", "score:0.5",
                                  "refl:0.25", "score:0.75"])
def test_selection_cohorts_match_jax(spec):
    """The same cohorts from each policy on the same random contexts (the
    random policy over one RNG stream in each package)."""
    rng = np.random.default_rng(11)
    p, j = make_selection_policy(spec, seed=2), \
        jfleet.make_selection_policy(spec, seed=2)
    for _ in range(40):
        K = int(rng.integers(1, 10))
        avail = np.flatnonzero(rng.random(K) < 0.7)
        counters = {k: int(rng.integers(0, 5)) for k in range(K)
                    if rng.random() < 0.8}
        kw = dict(counters=counters, K=K,
                  staleness=rng.integers(0, 4, K),
                  capability=rng.uniform(1e9, 2e10, K)
                  if rng.random() < 0.5 else None, t=float(rng.random()))
        np.testing.assert_array_equal(
            p.select(avail, _ctx(**kw)),
            j.select(avail, _ctx(**kw, pkg=jfleet)))


# ---------------------------------------------------------------------------
# capability tiers
# ---------------------------------------------------------------------------

def test_parse_tiers_and_counts():
    pairs = parse_tiers("low:3,premium:1")
    assert [p.name for p, _ in pairs] == ["low", "premium"]
    assert tier_counts(8, "low:3,premium:1") == [6, 2]
    assert sum(tier_counts(7, "low,mid,high")) == 7
    with pytest.raises(ValueError, match="unknown device tier"):
        parse_tiers("low,ultra")
    for spec in ("low:3,premium:1", "low,mid,high", "low,mid,high,premium",
                 "mid:2,high:0.5", "low:3,high:1"):
        assert [(dataclasses.asdict(p), w) for p, w in parse_tiers(spec)] \
            == [(dataclasses.asdict(p), w)
                for p, w in jfleet.parse_tiers(spec)]
        for K in range(1, 13):
            assert tier_counts(K, spec) == jfleet.tier_counts(K, spec)


def test_sample_cluster_deterministic_and_tiered():
    a = sample_cluster(12, "low:1,premium:1", seed=0)
    b = sample_cluster(12, "low:1,premium:1", seed=0)
    np.testing.assert_array_equal(a.dev_flops, b.dev_flops)
    np.testing.assert_array_equal(a.dev_bw, b.dev_bw)
    assert a.K == 12 and isinstance(a, tsim.SimCluster)
    # tier layout: first half low, second half premium — ~13x flops apart
    assert a.dev_flops[6:].mean() > 4 * a.dev_flops[:6].mean()
    assert a.srv_flops == a.dev_flops.max() * 50.0
    c = sample_cluster(12, "low:1,premium:1", seed=1)
    assert not np.array_equal(a.dev_flops, c.dev_flops)
    for K, spec, seed in ((12, "low:1,premium:1", 0), (4, "low:3,high:1", 0),
                          (4, "low,mid,high,premium", 0), (7, "mid", 3)):
        t, j = sample_cluster(K, spec, seed=seed), \
            jfleet.sample_cluster(K, spec, seed=seed)
        np.testing.assert_array_equal(t.dev_flops, j.dev_flops)
        np.testing.assert_array_equal(t.dev_bw, j.dev_bw)
        assert t.srv_flops == j.srv_flops


def test_heterogeneous_cluster_pinned_values():
    """The helper stays bit-identical to the paper Table 3 layout."""
    cl = tfleet.heterogeneous_cluster(8)
    np.testing.assert_allclose(
        cl.dev_flops,
        5e9 * np.array([1.0, 1.0, 1.33, 1.33, 2.67, 2.67, 3.84, 3.84]))
    np.testing.assert_allclose(cl.dev_bw, np.full(8, 100e6 / 8))
    np.testing.assert_allclose(cl.srv_flops, 5e9 * 3.84 * 50.0)
    j = jfleet.heterogeneous_cluster(8)
    np.testing.assert_array_equal(cl.dev_flops, j.dev_flops)
    np.testing.assert_array_equal(cl.dev_bw, j.dev_bw)
    assert cl.srv_flops == j.srv_flops


# ---------------------------------------------------------------------------
# contribution balance metric
# ---------------------------------------------------------------------------

def test_balance_summary_and_gini():
    assert gini([5, 5, 5, 5]) == pytest.approx(0.0)
    assert gini([0, 0, 0, 12]) == pytest.approx(0.75)
    assert gini([]) == 0.0 and gini([0, 0]) == 0.0
    bal = balance_summary([2, 2, 2, 10])
    assert bal["total"] == 16 and bal["participants"] == 4
    assert bal["gini"] > 0.2 and bal["cv"] > 0.5
    assert bal == jfleet.balance_summary([2, 2, 2, 10])
    skew, jskew = _both_sims(duration=200.0)
    assert 0.0 <= skew.contribution_balance()["gini"] <= 1.0
    assert skew.contribution_balance() == jskew.contribution_balance()


# ---------------------------------------------------------------------------
# trace-driven churn hits ControlPlane.RetentionStore (pod path)
# ---------------------------------------------------------------------------

def _retention_run(pkg_cp, pkg_ex, registry, trace, G, rounds):
    """tests/test_fleet.py's retention property on one package's
    executor: a numpy step, spy gather/scatter, rosters from the trace."""
    cp = pkg_cp.ControlPlane(G, 1, 2)
    state = {"dev": 10.0 * np.arange(G, dtype=float)}

    def step(s, batch):
        # per-group "training": participants advance by 1 each round; the
        # masked broadcast means a dropped group's row must NOT matter —
        # its rejoin value comes from the retention scatter
        return {"dev": s["dev"] + np.asarray(batch["bcast"])}, {"l": 0.0}

    gathered, scattered, plans = {}, {}, {}

    def spy_gather(s, g):
        out = {"dev": np.array(s["dev"][g])}
        gathered.setdefault(g, out)
        return out

    def spy_scatter(s, g, p):
        scattered.setdefault(g, p)
        out = s["dev"].copy()
        out[g] = p["dev"]
        return {"dev": out}

    ex = pkg_ex.RoundExecutor(step, cp, window=1, gather=spy_gather,
                              scatter=spy_scatter, registry=registry)
    state, _ = ex.run(state, 0, rounds, active_fn=lambda r: trace.roster(r),
                      batch_fn=lambda r, plan: {"bcast": plan.bcast_mask},
                      on_metrics=lambda r, m, stats: plans.update(
                          {r: stats.plan}))
    return cp, state, gathered, scattered, plans


@settings(max_examples=10)
@given(st.integers(1, 4), st.integers(1, 3))
def test_trace_driven_retention_rejoins_at_recorded_staleness(k_gone, start):
    """Property: a group that leaves for k rounds VIA THE TRACE is retained
    at departure, its retained params survive the absence unchanged, and
    it rejoins from exactly those params with α = 1/(k+1) — the port's
    executor driving active_fn from trace rosters, in lockstep with the
    JAX executor (the same plans, values and registry)."""
    G, rounds = 3, start + k_gone + 2
    masks = np.ones((rounds, G), bool)
    masks[start:start + k_gone, 1] = False
    trace = FleetTrace(interval=1.0, active=masks, bw=np.ones((rounds, G)))
    regs = []
    for reg_cls in (ElasticRegistry, jelastic.ElasticRegistry):
        regs.append(reg_cls())
        for _ in range(G):
            regs[-1].join(1.0, 1.0)
    cp, state, gathered, scattered, plans = _retention_run(
        tcp, tex, regs[0], trace, G, rounds)
    jcp_, jstate, jgathered, jscattered, jplans = _retention_run(
        jcp, jex, regs[1], _jtrace(trace), G, rounds)

    rejoin = start + k_gone
    # retained at departure with the pre-drop value, scattered back intact
    assert list(gathered) == [1] and list(scattered) == [1]
    assert gathered[1]["dev"] == pytest.approx(10.0 + start)
    assert scattered[1]["dev"] == pytest.approx(10.0 + start)
    assert 1 not in cp.retention               # released on rejoin
    # α at rejoin reflects the recorded absence: staleness k -> 1/(k+1)
    np.testing.assert_allclose(
        plans[rejoin].agg_weight,
        [1.0, 1.0 / (k_gone + 1), 1.0], rtol=1e-6)
    # the registry saw one leave at the departure round, one rejoin
    info = regs[0].devices[1]
    assert (info.active, info.absences, info.joined_at) == \
        (True, 1, float(rejoin))
    # ...and the JAX executor, in lockstep, did and planned the same
    for r in range(rounds):
        for f in dataclasses.fields(plans[r]):
            np.testing.assert_array_equal(
                np.asarray(getattr(plans[r], f.name)),
                np.asarray(getattr(jplans[r], f.name)), err_msg=f.name)
    assert gathered == jgathered and scattered == jscattered
    np.testing.assert_array_equal(state["dev"], jstate["dev"])
    assert _roster(regs[0]) == _roster(regs[1])
    assert cp.consumption == jcp_.consumption


# ---------------------------------------------------------------------------
# the elastic registry and the churn model
# ---------------------------------------------------------------------------

def test_elastic_registry_matches_jax():
    """The same joins, leaves (a repeated leave keeps the first
    timestamp), rejoins and bandwidth updates leave the same registry."""
    rng = np.random.default_rng(3)
    t_reg, j_reg = ElasticRegistry(), jelastic.ElasticRegistry()
    for step in range(200):
        op, t = int(rng.integers(0, 5)), float(step)
        k = int(rng.integers(0, max(len(t_reg.devices), 1) + 1))
        if op == 0 or not t_reg.devices:
            flops, bw = float(rng.uniform(1e9, 1e10)), float(rng.random())
            assert t_reg.join(flops, bw, t=t) == j_reg.join(flops, bw, t=t)
        elif op == 1:
            t_reg.leave(k, t=t)
            j_reg.leave(k, t=t)
        elif op == 2:
            t_reg.rejoin(k, t=t)
            j_reg.rejoin(k, t=t)
        elif op == 3 and k in t_reg.devices:
            t_reg.set_bandwidth(k, t)
            j_reg.set_bandwidth(k, t)
        elif k in t_reg.devices:
            assert t_reg.absence(k, t) == j_reg.absence(k, t)
        assert t_reg.active_ids == j_reg.active_ids
    assert _roster(t_reg) == _roster(j_reg)
    assert sum(i.absences for i in t_reg.devices.values()) > 0


def test_churn_degrades_gracefully():
    """Fig. 12/13 (tests/test_simulation.py): retention ratio stays high
    under dropout for FedOptima and collapses for barrier-based SplitFed;
    every run equal to the reference's."""
    base = tsim.simulate_fedoptima(MODEL, CLUSTER, duration=DUR).throughput
    mk = lambda: ChurnModel(n_devices=8, p_drop=0.3, interval=50.0, seed=1)
    t, jt = _both_sims(duration=DUR, churn=mk())
    retention = t.throughput / base
    assert retention > 0.4
    _assert_metrics_equal(t, jt)

    sf_base = tbase.simulate_splitfed(MODEL, CLUSTER,
                                      duration=DUR).throughput
    sf = tbase.simulate_splitfed(MODEL, CLUSTER, duration=DUR, churn=mk())
    assert sf.throughput / max(sf_base, 1e-9) <= retention + 0.05
    _assert_metrics_equal(sf, jbase.simulate_splitfed(
        JMODEL, JCLUSTER, duration=DUR, churn=_to_jax(mk())))


# ---------------------------------------------------------------------------
# every trace kind through the simulator and the six baselines
# ---------------------------------------------------------------------------

def _trace(kind, K, duration):
    if kind == "churn":
        return FleetTrace.from_churn(
            ChurnModel(n_devices=K, p_drop=0.3, interval=duration / 10,
                       seed=2), duration, bw0=CLUSTER.dev_bw[:K])
    kw = {"weibull": dict(on_scale=duration / 4, off_scale=duration / 8),
          "diurnal": dict(day=duration / 2, on_frac=0.6)}.get(kind, {})
    return make_trace(kind, K, duration, interval=duration / 12, seed=1,
                      **kw)


SIM_FLEETS = [("flaky", None), ("weibull", "refl:0.5"),
              ("diurnal", "score:0.5"), ("uniform", "random:0.5"),
              ("churn", "refl:0.25"), (None, "score:0.25"),
              (None, "random:0.5")]


@pytest.mark.parametrize("kind,selection", SIM_FLEETS,
                         ids=[f"{k}-{s}" for k, s in SIM_FLEETS])
def test_simulator_under_fleet_matches_jax(kind, selection):
    """simulate_fedoptima under each trace kind and policy (and under a
    selection alone, on the identity trace): Metrics bit for bit, the
    control plane's state and the registry included."""
    fleet = _trace(kind, 8, DUR) if kind else None
    planes = [tcp.ControlPlane.for_sim(8, 4, pool_cap=2),
              jcp.ControlPlane.for_sim(8, 4, pool_cap=2)]
    tm, jm = [sim.simulate_fedoptima(
        sim.SimModel(**COSTS), sim.heterogeneous_cluster(8), duration=DUR,
        omega=4, pool_cap=2, control=cp, seed=3, selection=selection,
        fleet=fl) for sim, cp, fl in ((tsim, planes[0], fleet),
                                      (jsim, planes[1], _to_jax(fleet)))]
    _assert_metrics_equal(tm, jm)
    assert tm.registry is not None and tm.dev_samples > 0
    assert planes[0].memory_summary() == planes[1].memory_summary()
    assert (planes[0].version, list(planes[0].versions)) == \
        (planes[1].version, list(planes[1].versions))


def test_simulator_mirrors_into_a_given_registry():
    """registry=: an empty registry is filled with the cluster's devices
    and mirrors the roster; one already holding devices is used as it
    stands (its ids, flops and bandwidths), as in the reference."""
    trace = flaky_trace(4, DUR, interval=40.0, p_drop=0.4, seed=3)
    for prefill in (False, True):
        regs = []
        for pkg in (tfleet, jfleet):
            reg = (ElasticRegistry if pkg is tfleet
                   else jelastic.ElasticRegistry)()
            if prefill:
                for k in range(4):
                    reg.join(1e9 * (k + 1), 5.0, t=-1.0)
            regs.append(reg)
        tm, jm = _both_sims(4, duration=DUR, fleet=trace, registry=None)
        out = [sim.simulate_fedoptima(
            sim.SimModel(**COSTS), sim.heterogeneous_cluster(4),
            duration=DUR, fleet=tr, registry=reg)
            for sim, tr, reg in ((tsim, trace, regs[0]),
                                 (jsim, _jtrace(trace), regs[1]))]
        assert out[0].registry is regs[0]
        _assert_metrics_equal(*out)
        # the registry mirrors, it does not steer: the events are the same
        assert _nums(out[0]) == _nums(tm) and _nums(jm) == _nums(tm)
        assert (regs[0].devices[0].flops_per_s == 1e9) == prefill


class _Recorder:
    """Hooks that record every call the simulator makes, in order."""

    def __init__(self):
        self.calls = []

    def device_iter(self, k, send):
        self.calls.append(("device_iter", int(k), bool(send)))

    def server_train(self, k):
        self.calls.append(("server_train", int(k)))

    def aggregate(self, k):
        self.calls.append(("aggregate", int(k)))

    def sync_aggregate(self):
        self.calls.append(("sync_aggregate",))


@pytest.mark.parametrize("name", list(tbase.REGISTRY))
@pytest.mark.parametrize("kind", ["flaky", "weibull"])
def test_baseline_under_fleet_matches_jax(name, kind):
    """Each baseline under a trace: Metrics bit for bit and the same hook
    calls in the same order as the reference's."""
    fleet = _trace(kind, 8, DUR)
    recs = _Recorder(), _Recorder()
    tm = tbase.REGISTRY[name](MODEL, CLUSTER, duration=DUR, fleet=fleet,
                              hooks=recs[0])
    jm = jbase.REGISTRY[name](JMODEL, JCLUSTER, duration=DUR,
                              fleet=_jtrace(fleet), hooks=recs[1])
    _assert_metrics_equal(tm, jm)
    assert recs[0].calls == recs[1].calls and tm.dev_samples > 0


# ---------------------------------------------------------------------------
# the driver's fleet flags
# ---------------------------------------------------------------------------

def _sim_args(**kw):
    base = dict(mode="sim", devices=4, duration=20.0, seed=0, omega=None,
                H=None, policy="counter", max_delay=16, pool_cap=None,
                fleet_trace=None, fleet_tiers=None, selection=None,
                faults=None, trace=None, sanitize=False, metrics_every=0,
                metrics_out=None, ckpt_dir=None)
    return argparse.Namespace(**{**base, **kw})


def test_run_sim_fleet_flags_match_jax(capsys):
    """run_sim under --fleet-trace flaky, --fleet-tiers and --selection:
    everything but the accuracy equal to the JAX run_sim's, and the same
    lines (the ``fleet:`` line included) up to the accuracy."""
    kw = dict(fleet_trace="flaky", fleet_tiers="low,mid,high,premium",
              selection="score:0.5")
    want = jtrain.run_sim(_sim_args(**kw))
    jlines = capsys.readouterr().out.splitlines()
    got = ttrain.run_sim(_sim_args(device="cpu", **kw))
    tlines = capsys.readouterr().out.splitlines()
    assert set(got) == set(want)
    for key in set(want) - {"accuracy"}:
        assert got[key] == want[key], key
    strip = lambda line: line.split("train-set acc")[0]
    assert [strip(l) for l in tlines] == [strip(l) for l in jlines]
    assert tlines[-1].startswith("fleet: trace=flaky  roster events=")


def test_fleet_trace_flag_takes_a_json_artifact(tmp_path):
    """--fleet-trace takes a saved trace (either package's) and refuses one
    of another fleet size, in both modes."""
    path = jfleet.flaky_trace(4, 20.0, interval=2.0, p_drop=0.3,
                              seed=1).save(str(tmp_path / "fleet.json"))
    trace = ttrain._fleet_trace(_sim_args(fleet_trace=path), 4, 20.0, 2.0)
    _assert_traces_equal(trace, jfleet.FleetTrace.load(path))
    with pytest.raises(ValueError, match="describes 4 devices"):
        ttrain.main(["--device", "cpu", "--rounds", "1", "--batch", "4",
                     "--H", "2", "--seq-len", "16", "--groups-per-shard",
                     "2", "--fleet-trace", path])
    with pytest.raises(ValueError, match="describes 4 devices"):
        ttrain.main(["--mode", "sim", "--device", "cpu", "--devices", "2",
                     "--duration", "1", "--fleet-trace", path])
