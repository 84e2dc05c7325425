"""The port's telemetry plane (``repro_torch.obs``) against the JAX
package's (``repro.obs``), mirroring ``tests/test_obs.py`` (its lint
class aside).

* Bit identity: with a tracer attached the simulator, the six baselines
  and the pod round give the same metrics (and params) as without.
* Sim-domain parity: ``simulate_fedoptima`` under a diurnal churn trace
  (6 devices, 120 simulated s) and each of the six baselines under the
  same trace record the JAX package's spans and instants exactly
  (``(lane, name, t0, t1, args)``, in emission order), export the same
  Chrome document but for ``otherData.tool``, and ``attribute_idle``
  returns the JAX one's dict.
* The Chrome export validates; the lane -> pid/tid mapping and the
  overlap validator give the reference's answers.
* Wall-domain parity: the executor at window 4 with a stub step emits the
  JAX ``RoundExecutor``'s ``(lane, name, args)`` sequence; a second pair
  of cases runs a stalled store with a stub ``checkpoint_fn`` (flush and
  deferred) so ``host/memory``, ``host/capture`` and ``host/ckpt``
  appear.  The reference's light per-round handles and advisory
  prefetch are not in the port (ROADMAP §C): their spans and the
  ``prefetch`` count are taken out of the JAX sequence before comparing.
* The drivers: ``--trace``, ``--metrics-every`` and ``--metrics-out`` in
  both modes; the sim dumps equal the JAX driver's.
"""
import argparse
import json
import time
from contextlib import ExitStack

import numpy as np
import pytest
import torch

from repro.core import control_plane as jcp
from repro.core import executor as jex
from repro.core.baselines import REGISTRY as JREG
from repro.core.simulation import SimModel as JSimModel
from repro.core.simulation import heterogeneous_cluster as jcluster
from repro.core.simulation import simulate_fedoptima as jsimulate
from repro.fleet import diurnal_trace as jdiurnal
from repro.launch import train as jtrain
from repro.memory import store as jstore
from repro.obs import idle as jidle
from repro.obs import trace as jtrace
from repro_torch.core import control_plane as tcp
from repro_torch.core import executor as tex
from repro_torch.core.baselines import REGISTRY
from repro_torch.core.simulation import (SimModel, heterogeneous_cluster,
                                         simulate_fedoptima)
from repro_torch.fleet import diurnal_trace
from repro_torch.launch import train as ttrain
from repro_torch.memory import ActivationStore
from repro_torch.models.common import tree_leaves
from repro_torch.obs import trace as trace_mod
from repro_torch.obs.idle import attribute_idle
from repro_torch.obs.trace import Tracer, traced, validate_chrome_trace

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_memory import (_JaxStalledProfiles, _StalledProfiles,
                               _StubRing, _slot_ops)
from test_torch_round import SMOKE_ARGS

COSTS = dict(dev_fwd_flops=1e9, dev_bwd_flops=2e9, full_fwd_flops=5e9,
             srv_flops_per_batch=8e9, act_bytes=1e6, dev_model_bytes=4e6,
             full_model_bytes=2e7, batch_size=32)
MODEL, JMODEL = SimModel(**COSTS), JSimModel(**COSTS)
K, DUR = 6, 120.0


def _metric_tuple(m):
    return (tuple(np.asarray(m.dev_busy).tolist()), m.srv_busy,
            m.bytes_up, m.bytes_down, m.dev_samples, m.srv_batches,
            m.aggregations, m.max_buffered)


def _churn_trace(make, k, dur, seed=7):
    return make(k, horizon=dur, interval=dur / 24.0, day=dur / 2.0,
                on_frac=0.6, bw=12.5e6, bw_jitter=0.3, seed=seed)


def _port_sim(fn, **kw):
    with traced(Tracer(domain="sim")) as tr:
        m = fn(MODEL, heterogeneous_cluster(K), duration=DUR,
               fleet=_churn_trace(diurnal_trace, K, DUR), **kw)
    return tr, m


def _jax_sim(fn, **kw):
    with jtrace.traced(jtrace.Tracer(domain="sim")) as tr:
        fn(JMODEL, jcluster(K), duration=DUR,
           fleet=_churn_trace(jdiurnal, K, DUR), **kw)
    return tr


def _assert_traces_equal(tt, jt):
    assert tt.spans == jt.spans
    assert tt.instants == jt.instants
    got, want = tt.to_chrome(), jt.to_chrome()
    assert got["otherData"].pop("tool") == "repro_torch.obs.trace"
    assert want["otherData"].pop("tool") == "repro.obs.trace"
    assert got == want
    assert attribute_idle(tt, duration=DUR) == \
        jidle.attribute_idle(jt, duration=DUR)


# ---------------------------------------------------------------------------
# bit identity: the tracer only records
# ---------------------------------------------------------------------------

def test_detached_flag_off():
    assert trace_mod.TRACING is False and trace_mod._STACK == []


def test_fedoptima_traced_equals_plain():
    kw = dict(duration=DUR, omega=4, seed=3,
              fleet=_churn_trace(diurnal_trace, K, DUR))
    plain = simulate_fedoptima(MODEL, heterogeneous_cluster(K), **kw)
    with traced(Tracer(domain="sim")) as tr:
        traced_m = simulate_fedoptima(MODEL, heterogeneous_cluster(K), **kw)
    assert _metric_tuple(plain) == _metric_tuple(traced_m)
    assert len(tr.spans) > 0 and trace_mod.TRACING is False


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_baselines_traced_equal_plain(name):
    cluster = heterogeneous_cluster(4)
    plain = REGISTRY[name](MODEL, cluster, duration=90.0)
    with traced(Tracer(domain="sim")):
        tm = REGISTRY[name](MODEL, cluster, duration=90.0)
    assert _metric_tuple(plain) == _metric_tuple(tm)


# ---------------------------------------------------------------------------
# sim-domain parity with the JAX package
# ---------------------------------------------------------------------------

def test_fedoptima_trace_matches_jax():
    tt, _ = _port_sim(simulate_fedoptima, omega=4, seed=3)
    jt = _jax_sim(jsimulate, omega=4, seed=3)
    _assert_traces_equal(tt, jt)
    names = {(s[0].split("/")[0], s[1]) for s in tt.spans}
    assert {("srv", "aggregate"), ("srv", "train_batch"), ("dev", "step"),
            ("net", "act_upload"), ("net", "model_upload")} <= names
    assert {i[1] for i in tt.instants} == {"leave", "join"}


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_baseline_trace_matches_jax(name):
    tt, _ = _port_sim(REGISTRY[name])
    jt = _jax_sim(JREG[name])
    _assert_traces_equal(tt, jt)
    assert len(tt.spans) > 0
    if name == "pipar":
        assert any(s[0].endswith("/pipe") and s[1] == "fwd_overlap"
                   for s in tt.spans)
    if name in ("fedasync", "fedbuff", "oafl"):     # the churn seams
        assert {i[1] for i in tt.instants} == {"leave", "join"}


def test_sim_run_attribution_sums_to_horizon():
    tr, _ = _port_sim(simulate_fedoptima, omega=4, seed=5)
    attr = attribute_idle(tr, duration=DUR)
    srv = attr["server"]
    assert srv["busy_s"] + srv["warmup_s"] + srv["task_dependency_s"] + \
        srv["straggler_s"] == pytest.approx(DUR, rel=1e-9)
    for row in attr["per_device"].values():
        assert sum(row[k] for k in ("busy_s", "warmup_s", "offline_s",
                                    "task_dependency_s", "straggler_s")) \
            == pytest.approx(DUR, rel=1e-9)
    assert attr["devices"]["offline_s"] > 0.0       # the churn shows


# ---------------------------------------------------------------------------
# Chrome export and the validator
# ---------------------------------------------------------------------------

def test_valid_schema_lanes_and_cli(tmp_path, capsys):
    tr, _ = _port_sim(simulate_fedoptima, omega=4, seed=5)
    assert validate_chrome_trace(tr.to_chrome()) == []
    lanes = tr.lanes()
    assert "srv" in lanes
    assert any(ln.startswith("dev/") for ln in lanes)
    assert any(ln.startswith("net/") for ln in lanes)
    path = tmp_path / "t.json"
    tr.export_chrome(str(path))
    assert trace_mod._main([str(path)]) == 0
    assert "OK" in capsys.readouterr().out
    doc = json.loads(path.read_text())
    doc["traceEvents"].append({"name": "x", "ph": "Q", "pid": 1})
    path.write_text(json.dumps(doc))
    assert trace_mod._main([str(path)]) == 1
    assert trace_mod._main([]) == 2


LANES = ["srv", "mesh", "host/plan", "host/build", "host/drain",
         "host/memory", "host/control", "dev/0", "dev/10", "dev/2",
         "dev/2/pipe", "net/1", "net/11", "srv/x", "dev/", "net/"]


def test_pid_mapping_matches_jax():
    for lane in LANES:
        assert trace_mod._lane_pid(lane) == jtrace._lane_pid(lane), lane
        assert trace_mod._lane_label(lane) == jtrace._lane_label(lane), lane
        assert trace_mod._lane_sort_key(lane) == \
            jtrace._lane_sort_key(lane), lane
    tt, jt = Tracer(domain="sim"), jtrace.Tracer(domain="sim")
    for i, lane in enumerate(LANES):
        for tr in (tt, jt):
            tr.add_span(lane, "s", float(i), i + 0.5)
            tr.add_instant(lane, "i", i + 0.25, k=i)
    assert tt.lanes() == jt.lanes()
    got, want = tt.to_chrome(), jt.to_chrome()
    got["otherData"].pop("tool"), want["otherData"].pop("tool")
    assert got == want
    by_name = {(e["pid"], e["args"]["name"]) for e in got["traceEvents"]
               if e["ph"] == "M" and e["name"] == "thread_name"}
    assert (1, "srv") in by_name and (2, "device 2 (pipe)") in by_name
    assert (3, "uplink 11") in by_name


BAD_DOCS = [
    [],
    {"traceEvents": 3},
    {"traceEvents": ["x", {"ph": "B", "name": "a", "pid": 1}]},
    {"traceEvents": [{"ph": "X", "name": 1, "pid": "1", "tid": 0,
                      "ts": 0.0, "dur": 1.0}]},
    {"traceEvents": [{"ph": "X", "name": "a", "pid": 1, "ts": 0.0}]},
    {"traceEvents": [{"ph": "i", "name": "a", "pid": 1, "tid": 0,
                      "ts": -1.0}]},
    {"traceEvents": [{"ph": "X", "name": "a", "pid": 1, "tid": 0,
                      "ts": 0.0, "dur": -2.0}]},
    {"traceEvents": [
        {"name": "a", "ph": "X", "ts": 0.0, "dur": 10.0, "pid": 1, "tid": 0},
        {"name": "b", "ph": "X", "ts": 5.0, "dur": 10.0, "pid": 1, "tid": 0},
        {"name": "c", "ph": "X", "ts": 9.9995, "dur": 1.0, "pid": 1,
         "tid": 1},
        {"name": "d", "ph": "X", "ts": 10.0, "dur": 1.0, "pid": 1,
         "tid": 1}]},
]


@pytest.mark.parametrize("doc", BAD_DOCS,
                         ids=[f"doc{i}" for i in range(len(BAD_DOCS))])
def test_validator_matches_jax(doc):
    got = validate_chrome_trace(doc)
    assert got == jtrace.validate_chrome_trace(doc)
    assert got            # every one of these documents has a problem


def test_clip_spans_never_overlap():
    tr = Tracer(domain="sim")
    tr.add_span("srv", "a", 0.0, 10.0, clip=True)
    tr.add_span("srv", "b", 5.0, 15.0, clip=True)   # clips to [10, 15]
    tr.add_span("srv", "c", 6.0, 9.0, clip=True)    # fully shadowed
    assert [(s[2], s[3]) for s in tr.spans] == [(0.0, 10.0), (10.0, 15.0)]
    assert validate_chrome_trace(tr.to_chrome()) == []
    with pytest.raises(ValueError, match="domain"):
        Tracer(domain="card")


# ---------------------------------------------------------------------------
# idle attribution
# ---------------------------------------------------------------------------

def test_idle_two_device_exact():
    tr = Tracer(domain="sim")
    tr.add_span("dev/0", "train", 0.0, 1.0)
    tr.add_span("dev/0", "train", 3.0, 4.0)
    tr.add_span("dev/1", "train", 0.0, 2.0)
    tr.add_span("srv", "aggregate", 2.0, 3.0)
    attr = attribute_idle(tr, duration=4.0)
    srv, dev = attr["server"], attr["devices"]
    assert (srv["busy_s"], srv["warmup_s"], srv["straggler_s"],
            srv["task_dependency_s"]) == (1.0, 2.0, 1.0, 0.0)
    assert (dev["busy_s"], dev["task_dependency_s"], dev["straggler_s"],
            dev["warmup_s"]) == (4.0, 2.0, 2.0, 0.0)
    assert dev["task_dependency_frac"] == pytest.approx(0.25)
    with pytest.raises(ValueError):
        attribute_idle(Tracer(domain="sim"), duration=0.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_idle_random_timelines_match_jax(seed):
    """Random spans on device, sub-lane, server, mesh, net and host lanes
    with leave/join instants (one device never returns): the same dict as
    the JAX attributor, default horizon and a cut one."""
    rng = np.random.default_rng(seed)
    tt, jt = Tracer(domain="sim"), jtrace.Tracer(domain="sim")
    lanes = ["dev/0", "dev/1", "dev/2", "dev/1/pipe", "srv", "mesh",
             "net/0", "host/plan"]
    for _ in range(60):
        lane = lanes[rng.integers(len(lanes))]
        t0 = float(rng.uniform(0.0, 50.0))
        t1 = t0 + float(rng.exponential(2.0))
        clip = bool(rng.integers(2))
        for tr in (tt, jt):
            tr.add_span(lane, "s", t0, t1, clip=clip)
    for k, name, t in ((0, "leave", 10.0), (0, "join", 20.0),
                       (2, "leave", 35.0), (1, "join", 5.0)):
        for tr in (tt, jt):
            tr.add_instant(f"dev/{k}", name, t)
    assert attribute_idle(tt) == jidle.attribute_idle(jt)
    assert attribute_idle(tt, duration=30.0) == \
        jidle.attribute_idle(jt, duration=30.0)


# ---------------------------------------------------------------------------
# the executor's wall-domain lanes
# ---------------------------------------------------------------------------

class _Blocking:
    """A metric whose fetch blocks 0.2 ms, so each drain observes its
    round's completion (the reference's rule) and every ``mesh`` span
    ends after the one before it: both executors emit every span."""

    def __init__(self, value):
        self.value = value

    def __float__(self):
        time.sleep(2e-4)
        return float(self.value)


def _blocking(step):
    def run(state, batch):
        state, metrics = step(state, batch)
        return state, {k: _Blocking(v) for k, v in metrics.items()}
    return run


def _constant_step(state, batch):
    return state, {"d_loss": 1.0, "s_loss": 2.0}


def _sequence(tr):
    return [(s[0], s[1], s[4]) for s in tr.spans], \
        [(i[0], i[1], i[3]) for i in tr.instants]


def _jax_view(tr, captured):
    """The JAX sequence without what the port leaves out: the light
    per-round handles (a ``capture_handle`` at a round whose checkpoint
    handle was not captured at dispatch), prefetch-only ``fill_spill``
    spans, and the ``prefetch`` count."""
    spans, instants = _sequence(tr)
    out = []
    for lane, name, args in spans:
        if name == "capture_handle" and args["round"] not in captured:
            continue
        if name == "fill_spill":
            if not (args["fills"] or args["spills"]):
                continue
            args = {k: v for k, v in args.items() if k != "prefetch"}
        out.append((lane, name, args))
    return out, instants


def _run_executor(pkg, step, *, G, rounds, store=False, ckpt=None):
    """One traced run of ``pkg``'s executor at window 4; returns the
    tracer and the checkpointed rounds."""
    cpm, exm, storem, tracem, prof = (
        (jcp, jex, jstore, jtrace, _JaxStalledProfiles) if pkg == "jax"
        else (tcp, tex, None, trace_mod, _StalledProfiles))
    kw, state = {}, 0
    saved = []
    if store:
        cp = cpm.ControlPlane(G, 2, 2, pool_cap=2)
        gather, scatter = _slot_ops()
        kw = dict(profiles=prof(G, stall_rounds=3), gather_slot=gather,
                  scatter_slot=scatter,
                  store=jstore.ActivationStore(2) if pkg == "jax"
                  else ActivationStore(2))
        state = {"ring": [{"acts": torch.zeros(4)}] * 2}
    else:
        cp = cpm.ControlPlane(G, 2, 4)
    ex = exm.RoundExecutor(step, cp, window=4, **kw)
    run_kw = {}
    if ckpt is not None:
        run_kw = dict(checkpoint_every=2,
                      checkpoint_fn=lambda r, h: saved.append(r),
                      capture_fn=None if ckpt == "flush" else
                      (lambda r: {"round": r}))
    tr = tracem.Tracer(domain="wall")
    with ExitStack() as stack:
        stack.enter_context(tracem.traced(tr))
        ex.run(state, 0, rounds, active_fn=lambda r: np.ones(G, bool),
               batch_fn=lambda r, plan: plan if store else {}, **run_kw)
    return tr, saved, ex


def test_executor_window4_trace_matches_jax():
    tt, _, tex_ = _run_executor("torch", _blocking(_constant_step), G=4,
                                rounds=6)
    jt, _, jex_ = _run_executor("jax", _blocking(_constant_step), G=4,
                                rounds=6)
    assert _sequence(tt) == _jax_view(jt, ())
    lanes = tt.lanes()
    assert {"mesh", "dev/0", "dev/3", "host/plan", "host/build",
            "host/drain", "host/control"} <= set(lanes)
    assert sum(s[0] == "mesh" for s in tt.spans) == 6
    assert validate_chrome_trace(tt.to_chrome()) == []
    assert tex_.peak_in_flight == jex_.peak_in_flight == 4
    # on the CPU the round spans run from dispatch to observed completion
    for st, s in zip(tex_.stats, [s for s in tt.spans if s[0] == "mesh"]):
        assert s[2] >= st._dispatch_t and s[3] > s[2]
    assert tex_.metrics.counter("exec.host_s").value == tex_.total_host_s


@pytest.mark.parametrize("ckpt", ["flush", "deferred"])
def test_executor_store_and_ckpt_trace_matches_jax(ckpt):
    tt, tsaved, _ = _run_executor("torch", _blocking(_StubRing().step),
                                  G=4, rounds=7, store=True, ckpt=ckpt)
    jt, jsaved, _ = _run_executor("jax", _blocking(_StubRing().step),
                                  G=4, rounds=7, store=True, ckpt=ckpt)
    assert tsaved == jsaved == [1, 3, 5]
    # a flush saves the drained live state: no handle is captured
    assert _sequence(tt) == _jax_view(jt, tsaved if ckpt == "deferred"
                                      else ())
    lanes = set(tt.lanes())
    assert {"host/memory", "host/ckpt"} <= lanes
    names = {s[1] for s in tt.spans} | {i[1] for i in tt.instants}
    assert {"fill_spill", "spill", "fill"} <= names
    if ckpt == "flush":
        assert "ckpt_flush" in names and "host/capture" not in lanes
    else:
        assert {"ckpt_deferred", "capture_handle"} <= names
    assert validate_chrome_trace(tt.to_chrome()) == []


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------

def test_pod_traced_is_bit_identical(tmp_path, capsys):
    """smollm at the small size, two rounds under --p-drop 0.5: traced (and
    writing --metrics-out) at windows 1 and 2, the history and final state
    equal the untraced run's bit for bit, the trace validates and holds
    the pod lanes."""
    base = SMOKE_ARGS + ["--rounds", "3", "--p-drop", "0.5", "--use-kernel"]
    plain = ttrain.main(base)
    for window in ("1", "2"):
        path = tmp_path / f"w{window}.json"
        mpath = tmp_path / f"w{window}.jsonl"
        out = ttrain.main(base + ["--window", window, "--trace", str(path),
                                  "--metrics-out", str(mpath)])
        assert out["history"] == plain["history"]
        for x, y in zip(tree_leaves(out["state"]),
                        tree_leaves(plain["state"])):
            assert torch.equal(x, y)
        doc = json.loads(path.read_text())
        assert doc["otherData"]["domain"] == "wall"
        assert validate_chrome_trace(doc) == []
        names = {e["args"]["name"] for e in doc["traceEvents"]
                 if e["ph"] == "M" and e["name"] == "thread_name"}
        assert {"mesh", "host/plan", "host/build", "host/drain",
                "host/control"} <= names
        assert any(n.startswith("device ") for n in names)
        rec = json.loads(mpath.read_text().splitlines()[0])
        assert (rec["mode"], rec["rounds"]) == ("pod", 3)
        assert rec["metrics"]["counters"] == out["registry"]["counters"]
        assert f"lanes -> {path}" in capsys.readouterr().out
    assert trace_mod.TRACING is False


def test_pod_metrics_every_dumps(capsys):
    out = ttrain.main(SMOKE_ARGS + ["--rounds", "2", "--metrics-every", "1"])
    lines = capsys.readouterr().out.splitlines()
    dumps = [l for l in lines if l.startswith("[")]
    assert [l.split("]")[0] for l in dumps] == ["[round 1", "[round 2",
                                                "[final"]
    assert "exec.in_flight" in dumps[-1]
    assert out["registry"]["counters"]["exec.host_s"] > 0.0


def _sim_args(**kw):
    base = dict(mode="sim", devices=4, duration=20.0, seed=0, omega=None,
                H=None, policy="counter", max_delay=16, pool_cap=None,
                fleet_trace=None, fleet_tiers=None, selection=None,
                faults=None, trace=None, sanitize=False, metrics_every=0,
                metrics_out=None, ckpt_dir=None)
    return argparse.Namespace(**{**base, **kw})


def test_sim_metrics_every_and_out_match_jax(tmp_path, capsys):
    """run_sim with --metrics-every 5 and --metrics-out: the same dump
    lines and the same JSON record as the JAX driver's."""
    jpath, tpath = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    jtrain.run_sim(_sim_args(metrics_every=5.0, metrics_out=str(jpath)))
    jlines = [l for l in capsys.readouterr().out.splitlines()
              if l.startswith("[")]
    ttrain.run_sim(_sim_args(metrics_every=5.0, metrics_out=str(tpath),
                             device="cpu"))
    tlines = [l for l in capsys.readouterr().out.splitlines()
              if l.startswith("[")]
    assert len(tlines) == 4 + 1 and tlines[-1].startswith("[final]")
    assert tlines == jlines
    assert json.loads(tpath.read_text()) == json.loads(jpath.read_text())


def test_sim_traced_through_main(tmp_path, capsys):
    """``--mode sim --trace``: a sim-domain trace that validates, and the
    same run's summary as untraced."""
    argv = ["--mode", "sim", "--device", "cpu", "--devices", "3",
            "--duration", "10"]
    plain = ttrain.main(argv)
    path = tmp_path / "sim.json"
    out = ttrain.main(argv + ["--trace", str(path)])
    for key in ("srv_idle", "dev_idle", "throughput", "consumed",
                "registry", "memory"):
        assert out[key] == plain[key], key
    doc = json.loads(path.read_text())
    assert doc["otherData"]["domain"] == "sim"
    assert validate_chrome_trace(doc) == []
    assert trace_mod._main([str(path)]) == 0
    assert "sim-seconds" == doc["otherData"]["time_unit"]
    assert "trace: " in capsys.readouterr().out
