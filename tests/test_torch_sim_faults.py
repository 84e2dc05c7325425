"""The simulators' half of the port's fault plane (``repro_torch.faults``'s
``FaultInjector`` and ``install_timeouts``, the seams of
``simulate_fedoptima`` and the six baselines, ``run_sim --faults``) held
against the JAX package's, on the CPU, mirroring the simulator cases of
``tests/test_faults.py``:

* ``FaultInjector`` call for call against the JAX one: the same schedule
  and a scripted sequence of seam calls drawn from a numpy seed, every
  return value and ``report()`` equal, with the update gate and without;
  ``for_baseline``;
* ``install_timeouts`` under a fleet trace that holds devices down: the
  four timeout dispositions, the leave/rejoin callbacks and the
  ``fault.timeout_*`` instants equal;
* ``FlowController.on_quarantined`` withdraws exactly one in-flight unit,
  its sanitizer events equal to the JAX controller's;
* ``simulate_fedoptima`` under faults over a grid of policies, ω, spill
  budgets, densities and gates: every ``Metrics`` field bit-identical,
  ``faults`` included, and the hooks called in the same order; the
  reference's dense K=32 diurnal case (matched, sanitizer clean, the same
  event stream) and its gate-off case (badput, ``matched`` False);
* each of the six baselines under ``BASELINE_CLASSES`` with the gate on
  and off, bit-identical, and the reference's all-baselines-match case;
* the sim-domain Chrome traces with their ``fault.*`` instants;
* the VGG-5 learner through a faulted run, at ``test_torch_sim.py``'s
  tolerance;
* ``run_sim --faults`` (``random:2`` and a ``fault-schedule-v1`` JSON)
  printing the JAX driver's lines up to the accuracy, and an unknown spec
  refused with the JAX driver's ``ValueError``.
"""
import dataclasses

import numpy as np
import pytest

from repro import faults as jf
from repro.faults import inject as jinject
from repro.analysis import sanitize as jsan
from repro.core import baselines as jbase
from repro.core import flow_control as jflow
from repro.core import learning as jlearn
from repro.core import simulation as jsim
from repro.data import partitioner as jpart
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.fleet import traces as jtraces
from repro.launch import train as jtrain
from repro.models import cnn as jcnn
from repro.obs import idle as jidle
from repro.obs import trace as jtrace
from repro_torch import faults as tf
from repro_torch.faults import inject as tinject
from repro_torch.analysis import sanitize as tsan
from repro_torch.core import baselines as tbase
from repro_torch.core import flow_control as tflow
from repro_torch.core import learning as tlearn
from repro_torch.core import simulation as tsim
from repro_torch.data import partitioner as tpart
from repro_torch.data import pipeline as tpipe
from repro_torch.data import synthetic as tsyn
from repro_torch.fleet import traces as ttraces
from repro_torch.launch import train as ttrain
from repro_torch.models import cnn as tcnn
from repro_torch.obs import idle as tidle
from repro_torch.obs import trace as ttrace

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_baselines import Recorder
from test_torch_fleet import _assert_metrics_equal
from test_torch_sanitize import _recording
from test_torch_sim import RUN_SIM_MODEL, _close, _datasets, _port, _sim_args

# tests/test_faults.py's costs
COSTS = dict(dev_fwd_flops=1e9, dev_bwd_flops=2e9, full_fwd_flops=5e9,
             srv_flops_per_batch=8e9, act_bytes=1e6, dev_model_bytes=4e6,
             full_model_bytes=2e7, batch_size=32)
PKGS = {"jax": (jsim, jbase, jf, jtraces), "port": (tsim, tbase, tf, ttraces)}


# ---------------------------------------------------------------------------
# FaultInjector, call for call
# ---------------------------------------------------------------------------

def _events_of(evs):
    return [dataclasses.astuple(e) for e in evs]


def _lockstep(a, b, name, *args):
    got, want = getattr(a, name)(*args), getattr(b, name)(*args)
    assert got == want, (name, args, got, want)
    return got


@pytest.mark.parametrize("gate", ["gate", "nogate"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fault_injector_matches_jax(seed, gate):
    """400 seam calls drawn from a numpy seed, on both injectors at once:
    every return value, and the report every 50 calls and after
    ``finalize``, equal."""
    K, horizon = 4, 200.0
    tsched = tf.make_fault_schedule(K, horizon, seed=seed, density=4.0)
    jsched = jf.make_fault_schedule(K, horizon, seed=seed, density=4.0)
    ti = tf.FaultInjector(tsched, gate=tf.UpdateGate() if gate == "gate"
                          else None)
    ji = jf.FaultInjector(jsched, gate=jf.UpdateGate() if gate == "gate"
                          else None)
    assert _events_of(ti.timeouts()) == _events_of(ji.timeouts())
    assert _events_of(ti.crashes()) == _events_of(ji.crashes())
    rng = np.random.default_rng(seed)
    t, tags, kinds = 0.0, [], []
    for step in range(400):
        t += float(rng.exponential(0.5))
        k = int(rng.integers(K))
        op = int(rng.integers(8))
        if op == 0:
            _lockstep(ti, ji, "may_send", k, t)
        elif op == 1:
            tag = _lockstep(ti, ji, "tag_act_upload", k, t)
            if tag is not None:
                tags.append(tag)
        elif op == 2:
            extra, kind = _lockstep(ti, ji, "tag_model_upload", k, t)
            kinds.append(kind)
        elif op == 3 and tags:
            seq = tags[int(rng.integers(len(tags)))]["seq"]
            _lockstep(ti, ji, "act_dedupe", seq)
        elif op == 4:
            tag = tags[int(rng.integers(len(tags)))] \
                if tags and rng.random() < 0.7 else None
            _lockstep(ti, ji, "act_validate", k, tag, t)
        elif op == 5:
            _lockstep(ti, ji, "note_accept", k)
        elif op == 6:
            kind = kinds.pop(0) if kinds else \
                str(rng.choice(("",) + tf.CORRUPT_KINDS))
            _lockstep(ti, ji, "model_validate", k, kind, t)
        elif op == 7:
            _lockstep(ti, ji, "note_delayed_arrival")
        if step % 50 == 49:
            assert ti.report() == ji.report()
    _lockstep(ti, ji, "finalize", t)
    rep = ti.report()
    assert rep == ji.report()
    assert sum(rep["injected"].values()) > 0
    assert (rep["gate"] is None) == (gate == "nogate")


def test_for_baseline_matches_jax():
    """The baseline injector plays only ``BASELINE_CLASSES``: no act
    tagging, no crashes, and a report over those classes alone."""
    tsched = tf.make_fault_schedule(8, 400.0, seed=9, density=2.0)
    jsched = jf.make_fault_schedule(8, 400.0, seed=9, density=2.0)
    ti = tf.FaultInjector.for_baseline(tsched, gate=tf.UpdateGate())
    ji = jf.FaultInjector.for_baseline(jsched, gate=jf.UpdateGate())
    assert ti.supported == ji.supported == frozenset(tf.BASELINE_CLASSES)
    assert _events_of(ti.timeouts()) == _events_of(ji.timeouts())
    assert len(ti.timeouts()) > 0
    assert ti.crashes() == ji.crashes() == ()
    for k in range(8):
        for t in (100.0, 399.0):
            _lockstep(ti, ji, "tag_act_upload", k, t)
            _lockstep(ti, ji, "tag_model_upload", k, t)
    assert ti.report() == ji.report()
    assert set(ti.report()["scheduled"]) == set(tf.BASELINE_CLASSES)


# ---------------------------------------------------------------------------
# install_timeouts under a fleet trace
# ---------------------------------------------------------------------------

def _scripted_timeouts(pkg_f, pkg_tr):
    """Three devices, ticks every 10 s.  Device 0 (always on by the trace)
    times out at 11 s for 5 s (no tick inside: rejoined) and at 21 s for
    15 s (the 30 s tick brings it back first: already back); device 1 is
    held down by the trace over [50, 60) while its 45 s window closes at
    55 s (deferred to the trace); device 2 is away over [70, 80) when its
    72 s timeout begins (a no-op)."""
    active = np.ones((10, 3), bool)
    active[5, 1] = False
    active[7, 2] = False
    trace = pkg_tr.FleetTrace(interval=10.0, active=active,
                              bw=np.full((10, 3), 1e6))
    E = pkg_f.FaultEvent
    sched = pkg_f.FaultSchedule(horizon=100.0, events=(
        E(11.0, "timeout", 0, param=5.0), E(21.0, "timeout", 0, param=15.0),
        E(45.0, "timeout", 1, param=10.0), E(72.0, "timeout", 2,
                                              param=5.0)))
    return trace, sched


def _random_timeouts(seed):
    def make(pkg_f, pkg_tr):
        trace = pkg_tr.flaky_trace(6, 300.0, interval=15.0, p_drop=0.3,
                                   seed=seed)
        sched = pkg_f.make_fault_schedule(6, 300.0, seed=seed, density=4.0,
                                          classes=("timeout",))
        return trace, sched
    return make


def _drive_timeouts(pkgs, make):
    sim_mod, _, pkg_f, pkg_tr = pkgs
    trace, sched = make(pkg_f, pkg_tr)
    sim, inj = sim_mod.Sim(), pkg_f.FaultInjector(sched)
    K = trace.K
    active, bw = np.ones(K, bool), np.zeros(K)
    trace.apply(active, bw)
    log = []
    leave = lambda k: log.append(("leave", int(k), sim.t))
    rejoin = lambda k: log.append(("rejoin", int(k), sim.t))
    tmod = jtrace if pkg_f is jf else ttrace
    with tmod.traced(tmod.Tracer(domain="sim")) as tr:
        pkg_tr.install_fleet(sim, trace, active, bw, on_leave=leave,
                             on_rejoin=rejoin)
        (jinject if pkg_f is jf else tinject).install_timeouts(
            sim, inj, active, trace, on_leave=leave, on_rejoin=rejoin)
        sim.run(trace.horizon)
    inj.finalize(sim.t)
    return log, inj.report(), tr.instants, active.tolist()


@pytest.mark.parametrize("make", [_scripted_timeouts, _random_timeouts(0),
                                  _random_timeouts(3)],
                         ids=["scripted", "flaky-0", "flaky-3"])
def test_install_timeouts_matches_jax(make):
    got = _drive_timeouts(PKGS["port"], make)
    want = _drive_timeouts(PKGS["jax"], make)
    assert got == want
    log, rep, instants, _ = got
    assert rep["matched"] is True
    if make is _scripted_timeouts:
        assert rep["disposition"] == {
            "timeout_rejoined": 1, "timeout_already_back": 1,
            "timeout_deferred_to_trace": 1, "timeout_noop": 1}
        # only a window that closes on a device still away emits its end
        assert [(lane, name, t) for lane, name, t, _ in instants] == [
            ("dev/0", "fault.timeout_begin", 11.0),
            ("dev/0", "fault.timeout_end", 16.0),
            ("dev/0", "fault.timeout_begin", 21.0),
            ("dev/1", "fault.timeout_begin", 45.0)]
        assert ("rejoin", 0, 30.0) in log and ("rejoin", 1, 60.0) in log


# ---------------------------------------------------------------------------
# flow-token conservation under quarantine, and the sanitizer's events
# ---------------------------------------------------------------------------

def _events(san_mod, fn):
    """(the (kind, scalar fields) events of ``fn``'s run under a recording
    sanitizer of ``san_mod``'s package, what ``fn`` returned)."""
    with san_mod.sanitized(_recording(san_mod.ProtocolSanitizer)) as rec:
        out = fn()
    assert rec.n_violations == 0
    return rec.events, out


def _quarantine_script(flow_mod):
    flow = flow_mod.FlowController(omega=2)
    flow.register(0)
    flow.register(1)
    assert flow.can_send(0)
    flow.mark_sent(0)
    assert flow.inflight_of(0) == 1
    flow.on_quarantined(0)                 # poisoned arrival withdrawn
    assert flow.inflight_of(0) == 0
    assert flow.buffered == 0              # never buffered
    assert flow.n_spilled == 0 and flow.n_filled == 0
    assert flow.can_send(0) or flow.can_send(1)  # budget re-granted
    # the freed budget is usable end-to-end: a clean send still admits
    k = 0 if flow.can_send(0) else 1
    flow.mark_sent(k)
    assert flow.on_enqueue(k)
    flow.on_dequeue(k)
    flow.on_quarantined(1)                 # nothing in flight: no-op
    return flow.promised, flow.buffered


def test_flow_quarantine_withdraws_exactly_one_inflight_unit():
    got = _events(tsan, lambda: _quarantine_script(tflow))
    want = _events(jsan, lambda: _quarantine_script(jflow))
    assert got == want
    kinds = [k for k, _ in got[0]]
    assert kinds.count("flow.quarantine") == 2
    assert [f["withdrawn"] for k, f in got[0]
            if k == "flow.quarantine"] == [True, False]


# ---------------------------------------------------------------------------
# simulate_fedoptima under faults: bit-identical
# ---------------------------------------------------------------------------

GRID = [(policy, omega, pool, density, gate)
        for policy in ("counter", "fifo") for omega, pool in ((2, 0), (4, 4))
        for density in (1.0, 4.0) for gate in ("default", "off")]


def _fedoptima(pkgs, K, dur, sched_kw, *, hooks=None, **kw):
    sim_mod, _, pkg_f, _ = pkgs
    sched = pkg_f.make_fault_schedule(K, dur, **sched_kw)
    return sim_mod.simulate_fedoptima(
        sim_mod.SimModel(**kw.pop("costs", COSTS)),
        sim_mod.heterogeneous_cluster(K), duration=dur, faults=sched,
        hooks=hooks, **kw)


@pytest.mark.parametrize(
    "policy,omega,pool,density,gate", GRID,
    ids=[f"{p}-w{o}-pool{c}-d{int(d)}-{g}" for p, o, c, d, g in GRID])
def test_fedoptima_faulted_bit_identical(policy, omega, pool, density, gate):
    K, dur = 8, 300.0
    kw = dict(omega=omega, pool_cap=pool, policy=policy, H=10, seed=0,
              fault_gate=None if gate == "default" else False)
    sk = dict(seed=4, density=density)
    jrec, trec = Recorder(), Recorder()
    jm = _fedoptima(PKGS["jax"], K, dur, sk, hooks=jrec, **kw)
    tm = _fedoptima(PKGS["port"], K, dur, sk, hooks=trec, **kw)
    _assert_metrics_equal(tm, jm)
    assert trec.calls == jrec.calls
    fr = tm.faults
    assert fr is not None and sum(fr["injected"].values()) > 0
    assert (fr["gate"] is None) == (gate == "off")
    if gate == "default":
        assert fr["matched"] is True
    assert tm.max_buffered <= omega + pool


def _dense(pkgs):
    sim_mod, _, pkg_f, pkg_tr = pkgs
    K, dur = 32, 900.0
    cluster = sim_mod.heterogeneous_cluster(K)
    trace = pkg_tr.make_trace("diurnal", K, dur, interval=dur / 24.0,
                              seed=7, day=dur / 2.0, on_frac=0.6)
    sched = pkg_f.make_fault_schedule(K, dur, seed=5, density=1.0)
    return sim_mod.simulate_fedoptima(sim_mod.SimModel(**COSTS), cluster,
                                      duration=dur, fleet=trace,
                                      faults=sched, seed=0)


def test_sim_dense_faults_all_matched_and_sanitizer_clean():
    tev, tm = _events(tsan, lambda: _dense(PKGS["port"]))
    jev, jm = _events(jsan, lambda: _dense(PKGS["jax"]))
    assert tev == jev
    _assert_metrics_equal(tm, jm)
    fr = tm.faults
    assert fr["matched"] is True and sum(fr["injected"].values()) > 0
    for cls in tf.SIM_CLASSES:
        assert fr["injected"].get(cls, 0) == fr["recovered"].get(cls, 0)
        assert fr["unfired"][cls] == \
            fr["scheduled"][cls] - fr["injected"].get(cls, 0)
    assert fr["gate"]["n_rejected"] > 0
    assert tm.srv_batches > 0
    assert any(k == "flow.quarantine" for k, _ in tev)


def test_sim_gate_off_consumes_poison_honestly():
    K, dur = 8, 600.0
    sk = dict(seed=2, density=2.0, classes=("corrupt_act", "corrupt_model"))
    tm = _fedoptima(PKGS["port"], K, dur, sk, fault_gate=False, seed=0)
    jm = _fedoptima(PKGS["jax"], K, dur, sk, fault_gate=False, seed=0)
    _assert_metrics_equal(tm, jm)
    fr = tm.faults
    assert fr == jm.faults
    assert fr["matched"] is False and fr["gate"] is None
    badput = fr["disposition"].get("consumed_poisoned_act", 0) + \
        fr["disposition"].get("consumed_poisoned_model", 0) + \
        fr["disposition"].get("admitted_poisoned_act", 0)
    assert badput > 0


def test_prebuilt_injector_and_gate_instance():
    """``faults=`` takes a prebuilt injector and ``fault_gate=`` an
    ``UpdateGate``, as in the reference."""
    K, dur = 8, 300.0
    out = []
    for sim_mod, _, pkg_f, _ in (PKGS["port"], PKGS["jax"]):
        sched = pkg_f.make_fault_schedule(K, dur, seed=1, density=2.0)
        gate = pkg_f.UpdateGate(strike_limit=1, backoff=5.0)
        a = sim_mod.simulate_fedoptima(
            sim_mod.SimModel(**COSTS), sim_mod.heterogeneous_cluster(K),
            duration=dur, faults=pkg_f.FaultInjector(sched, gate=gate))
        b = sim_mod.simulate_fedoptima(
            sim_mod.SimModel(**COSTS), sim_mod.heterogeneous_cluster(K),
            duration=dur, faults=sched,
            fault_gate=pkg_f.UpdateGate(strike_limit=1, backoff=5.0))
        _assert_metrics_equal(a, b)
        out.append(a)
    _assert_metrics_equal(*out)
    assert out[0].faults["gate"]["n_rejected"] > 0


# ---------------------------------------------------------------------------
# the six baselines under faults
# ---------------------------------------------------------------------------

BASE_GRID = [(name, gate) for name in tbase.REGISTRY
             for gate in ("default", "off")]


def _baseline(pkgs, name, K, dur, gate, hooks=None):
    sim_mod, base_mod, pkg_f, _ = pkgs
    sched = pkg_f.make_fault_schedule(K, dur, seed=9, density=2.0,
                                      classes=pkg_f.BASELINE_CLASSES)
    return base_mod.REGISTRY[name](
        sim_mod.SimModel(**COSTS), sim_mod.heterogeneous_cluster(K),
        duration=dur, faults=sched, hooks=hooks,
        fault_gate=None if gate == "default" else False)


@pytest.mark.parametrize("name,gate", BASE_GRID,
                         ids=[f"{n}-{g}" for n, g in BASE_GRID])
def test_baseline_faulted_bit_identical(name, gate):
    jrec, trec = Recorder(), Recorder()
    jm = _baseline(PKGS["jax"], name, 8, 400.0, gate, hooks=jrec)
    tm = _baseline(PKGS["port"], name, 8, 400.0, gate, hooks=trec)
    _assert_metrics_equal(tm, jm)
    assert trec.calls == jrec.calls and len(trec.calls) > 0
    fr = tm.faults
    assert sum(fr["injected"].values()) > 0
    assert set(fr["scheduled"]) == set(tf.BASELINE_CLASSES)
    assert fr["matched"] is (gate == "default")


STRICT = ["fedoptima"] + list(tbase.REGISTRY)


@pytest.mark.parametrize("name", STRICT)
def test_strict_gate_backoff_bit_identical(name):
    """A gate that backs off from the first strike (``strike_limit=1``):
    the quarantined devices' re-syncs wait out their backoff, and the
    paused sends stay paused, as in the reference."""
    K, dur = 8, 400.0
    out = []
    for sim_mod, base_mod, pkg_f, _ in (PKGS["port"], PKGS["jax"]):
        sched = pkg_f.make_fault_schedule(
            K, dur, seed=6, density=4.0,
            classes=("corrupt_act", "corrupt_model"))
        gate = pkg_f.UpdateGate(strike_limit=1, backoff=5.0)
        fn = sim_mod.simulate_fedoptima if name == "fedoptima" \
            else base_mod.REGISTRY[name]
        rec = Recorder()
        m = fn(sim_mod.SimModel(**COSTS), sim_mod.heterogeneous_cluster(K),
               duration=dur, faults=sched, fault_gate=gate, hooks=rec)
        out.append((m, rec.calls, gate.quarantined_until, gate.strikes))
    (tm, tcalls, tq, ts), (jm, jcalls, jq, js) = out
    _assert_metrics_equal(tm, jm)
    assert tcalls == jcalls
    assert (tq, ts) == (jq, js) and len(tq) > 0
    assert tm.faults["matched"] is True


def test_all_baselines_inject_and_match():
    K, dur = 8, 400.0
    cluster = tsim.heterogeneous_cluster(K)
    sched = tf.make_fault_schedule(K, dur, seed=9, density=2.0,
                                   classes=tf.BASELINE_CLASSES)
    for name, fn in tbase.REGISTRY.items():
        m = fn(tsim.SimModel(**COSTS), cluster, duration=dur, faults=sched)
        fr = m.faults
        assert fr is not None and fr["matched"] is True, (name, fr)
        assert sum(fr["injected"].values()) > 0, name


# ---------------------------------------------------------------------------
# sim-domain traces with the fault.* instants
# ---------------------------------------------------------------------------

def _traced(pkgs, name, K=6, dur=300.0):
    sim_mod, base_mod, pkg_f, pkg_tr = pkgs
    tmod = jtrace if pkg_f is jf else ttrace
    classes = pkg_f.SIM_CLASSES if name == "fedoptima" \
        else pkg_f.BASELINE_CLASSES
    sched = pkg_f.make_fault_schedule(K, dur, seed=3, density=4.0,
                                      classes=classes)
    trace = pkg_tr.diurnal_trace(K, horizon=dur, interval=dur / 24.0,
                                 day=dur / 2.0, on_frac=0.6, bw=12.5e6,
                                 bw_jitter=0.3, seed=7)
    fn = sim_mod.simulate_fedoptima if name == "fedoptima" \
        else base_mod.REGISTRY[name]
    with tmod.traced(tmod.Tracer(domain="sim")) as tr:
        fn(sim_mod.SimModel(**COSTS), sim_mod.heterogeneous_cluster(K),
           duration=dur, fleet=trace, faults=sched)
    return tr


@pytest.mark.parametrize("name", ["fedoptima", "fedasync", "splitfed"])
def test_faulted_trace_matches_jax(name):
    tt, jt = _traced(PKGS["port"], name), _traced(PKGS["jax"], name)
    assert tt.spans == jt.spans
    assert tt.instants == jt.instants
    got, want = tt.to_chrome(), jt.to_chrome()
    assert got["otherData"].pop("tool") == "repro_torch.obs.trace"
    assert want["otherData"].pop("tool") == "repro.obs.trace"
    assert got == want
    assert tidle.attribute_idle(tt, duration=300.0) == \
        jidle.attribute_idle(jt, duration=300.0)
    faults = {i[1] for i in tt.instants if i[1].startswith("fault.")}
    assert "fault.timeout_begin" in faults
    if name == "fedoptima":
        assert {"fault.crash_begin", "fault.crash_end",
                "fault.quarantine_act"} <= faults
    else:
        assert "fault.quarantine_model" in faults


# ---------------------------------------------------------------------------
# the VGG-5 learner through a faulted run
# ---------------------------------------------------------------------------

def test_learner_through_faulted_simulator_matches_jax():
    """VGG-5 at 8x8, K=4, 40 simulated s under a density-4 schedule of
    every simulator class, from the JAX learner's init: Metrics (faults
    included) and hook counts exact, params at 1e-4."""
    K, img, dur = 4, 8, 40.0
    jcfg, tcfg = jcnn.vgg5_config(img_size=img), tcnn.vgg5_config(img_size=img)
    _, jds = _datasets(jsyn, jpart, jpipe, K, img)
    _, tds = _datasets(tsyn, tpart, tpipe, K, img)
    jl = jlearn.FedOptimaLearner(jlearn.ModelAdapter(jcnn, jcfg), jds, 1)
    init = (_port(jl.dev[0]), _port(jl.srv), _port(jl.aux[0]))
    tl = tlearn.FedOptimaLearner(tlearn.ModelAdapter(tcnn, tcfg), tds, 1,
                                 device="cpu", init=init)
    kw = dict(omega=8, pool_cap=8, H=10, costs=RUN_SIM_MODEL)
    sk = dict(seed=1, density=4.0)
    jm = _fedoptima(PKGS["jax"], K, dur, sk, hooks=jl, **dict(kw))
    tm = _fedoptima(PKGS["port"], K, dur, sk, hooks=tl, **dict(kw))
    _assert_metrics_equal(tm, jm)
    assert sum(tm.faults["injected"].values()) > 0
    assert (tl.dev_steps, tl.srv_steps, tl.consumed, tl.versions) == \
        (jl.dev_steps, jl.srv_steps, jl.consumed, jl.versions)
    assert tl.srv_steps == tm.srv_batches > 0
    for k in range(K):
        _close(tl.dev[k], jl.dev[k])
        _close(tl.aux[k], jl.aux[k])
    _close(tl.agg.theta_d, jl.agg.theta_d)
    _close(tl.srv, jl.srv)


# ---------------------------------------------------------------------------
# run_sim --faults
# ---------------------------------------------------------------------------

def _schedule_json(tmp_path):
    path = str(tmp_path / "faults.json")
    jf.make_fault_schedule(4, 20.0, seed=3, density=2.0).save(path)
    return path


@pytest.mark.parametrize("spec", ["random:2", "json"])
def test_run_sim_faults_matches_jax(spec, tmp_path, capsys):
    faults = _schedule_json(tmp_path) if spec == "json" else spec
    want = jtrain.run_sim(_sim_args(faults=faults))
    jlines = capsys.readouterr().out.splitlines()
    got = ttrain.run_sim(_sim_args(faults=faults, device="cpu"))
    tlines = capsys.readouterr().out.splitlines()
    assert set(got) == set(want)
    for key in set(want) - {"accuracy"}:
        assert got[key] == want[key], key
    strip = lambda line: line.split("train-set acc")[0]
    assert [strip(l) for l in tlines] == [strip(l) for l in jlines]
    assert tlines[-1].startswith("faults: ") and len(tlines) == 6
    assert sum(got["faults"]["injected"].values()) > 0
    assert got["faults"]["matched"] is True


def test_run_sim_unknown_faults_spec_raises():
    with pytest.raises(ValueError, match="unknown --faults spec"):
        jtrain.run_sim(_sim_args(devices=2, duration=1.0, faults="bogus"))
    with pytest.raises(ValueError, match="unknown --faults spec"):
        ttrain.main(["--mode", "sim", "--device", "cpu", "--devices", "2",
                     "--duration", "1", "--faults", "bogus"])
