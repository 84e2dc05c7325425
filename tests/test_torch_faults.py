"""The pod half of the fault plane (``repro_torch.faults``), mirroring the
JAX package's ``tests/test_faults.py`` and held against it:

* schedules: the port's ``make_fault_schedule`` gives the JAX package's
  events for the same seed, classes and density, and each package loads
  the other's ``fault-schedule-v1`` JSON;
* the update gate: every poison kind is rejected with the JAX gate's
  reason, and strikes back off exactly as there;
* ``PodFaultInjector`` against the JAX one, call for call, on a dense
  schedule (with the gate and without it);
* the pod round in lockstep with the JAX executor (``_jax_step``'s Auto
  mesh axes), each side with its own injector on the same schedule: a
  timeout retires a group and its window's end rejoins it; an injected
  crash is resumed from each package's own snapshot, the torn one skipped
  on both sides.  Plans, rosters and reports are equal, and the params
  agree at 1e-4;
* ``run_pod``'s ``--faults``: a crash and the rerun that resumes past a
  torn snapshot, and schedules that need no ``--ckpt-dir``;
* the SIGKILL crash sweep (``faults/crash_harness.py``, slow): the
  reference's two cases on the CPU.

Tiny smollm on the CPU (G=2, H=2, batch 4, seq 16, ω=1).
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro import faults as jf
from repro.checkpoint import store as jckpt
from repro.configs import registry as jreg
from repro.core import control_plane as jcp
from repro.core import executor as jex
from repro.core import fedopt_step as JF
from repro_torch import faults as tf
from repro_torch.checkpoint import store as tckpt
from repro_torch.configs import registry as treg
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import control_plane as tcp
from repro_torch.core import executor as tex
from repro_torch.core import fedopt_step as TF
from repro_torch.launch import train
from repro_torch.models.common import tree_map

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_round import _assert_plans_equal, _close, _jax_step


# ---------------------------------------------------------------------------
# schedules: deterministic, serializable, validated, the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,horizon,seed,density,classes", [
    (16, 600.0, 3, 2.0, tf.SIM_CLASSES),
    (8, 300.0, 1, 1.0, tf.SIM_CLASSES),
    (4, 6.0, 0, 4.0, tf.POD_CLASSES),
    (8, 400.0, 9, 2.0, tf.BASELINE_CLASSES)])
def test_schedule_matches_jax(K, horizon, seed, density, classes):
    a = tf.make_fault_schedule(K, horizon, seed=seed, density=density,
                               classes=classes)
    b = jf.make_fault_schedule(K, horizon, seed=seed, density=density,
                               classes=classes)
    assert a.to_json() == b.to_json()
    assert a.counts() == b.counts()


def test_schedule_seeded_determinism():
    a = tf.make_fault_schedule(16, 600.0, seed=3, density=2.0)
    b = tf.make_fault_schedule(16, 600.0, seed=3, density=2.0)
    c = tf.make_fault_schedule(16, 600.0, seed=4, density=2.0)
    assert a.events == b.events
    assert a.events != c.events
    assert all(a.events[i].t <= a.events[i + 1].t
               for i in range(len(a) - 1))
    assert set(a.counts()) == set(tf.SIM_CLASSES)


def test_schedule_json_crosses_packages(tmp_path):
    ours = tf.make_fault_schedule(8, 300.0, seed=1)
    theirs = jf.make_fault_schedule(8, 300.0, seed=1)
    ours.save(str(tmp_path / "port.json"))
    theirs.save(str(tmp_path / "jax.json"))
    with open(tmp_path / "port.json") as f:
        assert json.load(f)["format"] == "fault-schedule-v1"
    back = jf.FaultSchedule.load(str(tmp_path / "port.json"))
    assert back.to_json() == theirs.to_json()
    back = tf.FaultSchedule.load(str(tmp_path / "jax.json"))
    assert back.events == ours.events and back.horizon == ours.horizon


def test_schedule_validation():
    with pytest.raises(ValueError):
        tf.FaultEvent(1.0, "meteor_strike")
    with pytest.raises(ValueError):
        tf.FaultEvent(1.0, "corrupt_act", device=0, kind="soggy")
    with pytest.raises(ValueError):
        tf.FaultEvent(1.0, "torn_checkpoint", kind="nan")
    with pytest.raises(ValueError):      # event at the horizon never fires
        tf.FaultSchedule(horizon=5.0,
                         events=(tf.FaultEvent(5.0, "delay", device=0),))
    with pytest.raises(ValueError, match="not a fault schedule"):
        tf.FaultSchedule.from_json({"format": "fleet-trace-v1"})


# ---------------------------------------------------------------------------
# quarantine gate: finite-check + norm fence, strikes, backoff
# ---------------------------------------------------------------------------

def test_gate_rejects_every_poison_kind_as_jax_does():
    gate, ref = tf.UpdateGate(), jf.UpdateGate()
    for kind in tf.CORRUPT_KINDS + ("",):
        p = tf.make_payload(kind, seed=2)
        np.testing.assert_array_equal(p, jf.make_payload(kind, seed=2))
        ok, reason = gate.validate(p)
        assert (ok, reason) == ref.validate(p), kind
        assert ok == (kind == ""), kind
        assert reason in (("",) if ok else ("non_finite", "norm_fence"))
    assert gate.summary() == ref.summary()
    assert gate.metrics.snapshot() == ref.metrics.snapshot()


def test_gate_strikes_backoff_and_readmission():
    gates = [tf.UpdateGate(strike_limit=2, backoff=10.0, backoff_growth=2.0),
             jf.UpdateGate(strike_limit=2, backoff=10.0, backoff_growth=2.0)]
    for gate in gates:
        assert gate.may_send(0, t=0.0)
        assert gate.note_reject(0, t=0.0) == 0.0   # strike 1: under the limit
        assert gate.note_reject(0, t=1.0) == pytest.approx(10.0)
        d = gate.note_reject(0, t=2.0)              # strike 3: one over
        assert d == pytest.approx(20.0)             # backoff * growth^(3-2)
        assert not gate.may_send(0, t=2.0 + d - 1e-6)
        assert gate.may_send(0, t=2.0 + d + 1e-6)   # re-admitted
        gate.note_accept(0)                         # a good update heals
        assert gate.strikes[0] == 2
        assert gate.may_send(1, t=0.0)              # others unaffected
        s = gate.summary()
        assert s["devices_struck"] == 1 and s["max_strikes"] == 2
    assert gates[0].quarantined_until == gates[1].quarantined_until
    assert gates[0].summary() == gates[1].summary()


# ---------------------------------------------------------------------------
# the pod injector against the JAX one, call for call
# ---------------------------------------------------------------------------

def _boundary(inj, r, G, H):
    """One round boundary's hooks, as the executor calls them; a crash
    comes back as its round index."""
    try:
        inj.on_round_start(r)
    except (tf.InjectedCrash, jf.InjectedCrash) as crash:
        return ("crash", crash.round_index)
    active = inj.mask_active(r, np.ones(G, bool))
    produce = inj.mask_produce(r, np.ones((H, G), bool), active)
    return (active.tolist(), produce.tolist())


@pytest.mark.parametrize("gate", [True, False], ids=["gate", "no-gate"])
def test_pod_injector_matches_jax_call_for_call(tmp_path, gate):
    G, H, R = 4, 2, 12
    sched = tf.make_fault_schedule(G, float(R), seed=3, density=4.0,
                                   classes=tf.POD_CLASSES)
    jsched = jf.FaultSchedule.from_json(sched.to_json())
    ours = tf.PodFaultInjector(sched, gate=tf.UpdateGate() if gate else None)
    theirs = jf.PodFaultInjector(jsched,
                                 gate=jf.UpdateGate() if gate else None)
    tree = {"w": np.arange(64.0)}
    for r in range(R):
        assert _boundary(ours, r, G, H) == _boundary(theirs, r, G, H), r
        for mod, inj, side in ((tckpt, ours, "port"), (jckpt, theirs, "jax")):
            mod.save(str(tmp_path / side), r + 1, tree)
            inj.on_checkpoint(r, str(tmp_path / side), r + 1)
        assert [s for s in tckpt.committed_steps(str(tmp_path / "port"))
                if not tckpt.verify_snapshot(str(tmp_path / "port"), s)[0]] \
            == [s for s in jckpt.committed_steps(str(tmp_path / "jax"))
                if not jckpt.verify_snapshot(str(tmp_path / "jax"), s)[0]]
    ours.finalize(R)
    theirs.finalize(R)
    assert ours.report() == theirs.report()
    assert sorted(ours.fired_crashes) == sorted(theirs.fired_crashes)
    fr = ours.report()
    # a fired crash is recovered only by the restarted run
    assert fr["injected"]["server_crash"] > \
        fr["recovered"].get("server_crash", 0)
    for cls in ("timeout", "torn_checkpoint"):
        assert fr["injected"][cls] == fr["recovered"][cls] > 0, cls
    if gate:
        assert fr["injected"]["corrupt_act"] == \
            fr["recovered"]["corrupt_act"] > 0
    else:
        assert "corrupt_act" not in fr["recovered"]
        assert fr["disposition"]["admitted_poisoned_act"] == \
            fr["injected"]["corrupt_act"] > 0


# ---------------------------------------------------------------------------
# the pod round: timeout -> retention -> rejoin, injected crash -> resume,
# in lockstep with the JAX executor
# ---------------------------------------------------------------------------

KW = dict(l_split=1, n_groups=2, seq_len=16, per_group_batch=4, H=2, omega=1)
G, H, B, S = 2, 2, 2, 16


def _configs():
    return (JF.FedStepConfig(arch=jreg.smoke_config("smollm-135m"), **KW),
            TF.FedStepConfig(arch=treg.smoke_config("smollm-135m"), **KW))


def _data(r, vocab):
    rng = np.random.default_rng(200 + r)
    return rng.integers(0, vocab, (G, H, B, S)), \
        rng.integers(0, vocab, (G, H, B, S))


class _Side:
    """One package's pod round: its executor (window 1, uniform profiles,
    retention wired), its plane and its injector; ``plans``/``rosters``
    record each drained round."""

    def __init__(self, jax_side, injector):
        jcfg, tcfg = _configs()
        self.jax_side = jax_side
        self.plans, self.rosters = [], []
        if jax_side:
            jitted, _, s_spec = _jax_step(jcfg)
            self.cp = jcp.ControlPlane(G, jcfg.omega, jcfg.H)
            self.ex = jex.RoundExecutor(
                jitted, self.cp, window=1,
                profiles=jex.StragglerProfiles(G),
                gather=JF.gather_group_state,
                scatter=lambda st, g, p: JF.scatter_group_state(
                    st, g, p, state_shardings=s_spec),
                faults=injector)
        else:
            self.cp = tcp.ControlPlane(G, tcfg.omega, tcfg.H)
            self.ex = tex.RoundExecutor(
                TF.make_train_step(tcfg), self.cp, window=1,
                profiles=tex.StragglerProfiles(G),
                gather=TF.gather_group_state, scatter=TF.scatter_group_state,
                faults=injector)
        self.vocab = tcfg.arch.vocab

    def batch_fn(self, r, plan):
        tokens, labels = _data(r, self.vocab)
        if self.jax_side:
            return {"tokens": tokens.astype(np.int32),
                    "labels": labels.astype(np.int32),
                    **plan.batch_fields()}
        return {"tokens": torch.from_numpy(tokens),
                "labels": torch.from_numpy(labels),
                **plan.batch_fields("cpu")}

    def on_metrics(self, r, m, st):
        self.plans.append(st.plan)
        self.rosters.append((np.asarray(st.plan.bcast_mask) > 0.5).tolist())

    def run(self, state, start, end, **kw):
        return self.ex.run(state, start, end,
                           active_fn=lambda r: np.ones(G, bool),
                           batch_fn=self.batch_fn,
                           on_metrics=self.on_metrics, **kw)


def _inits():
    jcfg, _ = _configs()
    jstate = _jax_step(jcfg)[1]
    return jstate, state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")


def _assert_lockstep(port, ref, hist, jhist):
    assert port.rosters == ref.rosters
    assert len(port.plans) == len(ref.plans)
    for pt, pj in zip(port.plans, ref.plans):
        _assert_plans_equal(pt, pj)
    _close([{k: m[k] for k in ("d_loss", "s_loss")} for m in hist],
           [{k: m[k] for k in ("d_loss", "s_loss")} for m in jhist],
           "losses")


def test_pod_timeout_reclaims_slot_and_rejoins_in_lockstep():
    events = (tf.FaultEvent(1.0, "timeout", device=0, param=2.0),)
    jstate, tstate = _inits()
    port = _Side(False, tf.PodFaultInjector(
        tf.FaultSchedule(horizon=6.0, events=events), gate=tf.UpdateGate()))
    ref = _Side(True, jf.PodFaultInjector(
        jf.FaultSchedule.from_json(
            tf.FaultSchedule(horizon=6.0, events=events).to_json()),
        gate=jf.UpdateGate()))
    tstate, hist = port.run(tstate, 0, 6)
    jstate, jhist = ref.run(jstate, 0, 6)
    assert len(hist) == len(jhist) == 6
    _assert_lockstep(port, ref, hist, jhist)
    fr = port.ex.summary()["faults"]
    assert fr == ref.ex.summary()["faults"]
    assert fr["matched"] is True and fr["injected"]["timeout"] == 1
    assert fr["disposition"].get("timeout_rejoined") == 1
    # rounds 1..2 ran without group 0 (slot retired), round 3 rejoined it
    rosters = port.rosters
    assert not rosters[1][0] and not rosters[2][0]
    assert rosters[3][0] and rosters[0][0]
    assert 0 not in port.cp.retention.groups         # restored, not leaked
    _close(state_to_numpy(tstate), jax.tree.map(np.asarray, jstate),
           "final state")


def test_pod_injected_crash_resumes_from_snapshot_in_lockstep(tmp_path):
    events = (tf.FaultEvent(1.0, "server_crash", param=1.0),
              tf.FaultEvent(2.0, "timeout", device=0, param=1.0),
              tf.FaultEvent(3.0, "corrupt_act", device=1, kind="inf"),
              tf.FaultEvent(3.0, "torn_checkpoint", kind="bitflip"))
    sched = tf.FaultSchedule(horizon=6.0, events=events)
    jsched = jf.FaultSchedule.from_json(sched.to_json())
    dirs = {"port": str(tmp_path / "port"), "jax": str(tmp_path / "jax")}
    jstate0, tstate0 = _inits()
    t_like = tree_map(lambda x: x.to("meta"), tstate0)
    j_like = jax.eval_shape(lambda: jstate0)

    def ckpt_fn(side, d, mod, injector):
        def ckpt(r, st):
            tree = st if mod is tckpt else jax.tree.map(np.asarray, st)
            mod.save(d, r + 1, tree,
                     metadata={"control_plane": side.cp.state_dict()})
            injector.on_checkpoint(r, d, r + 1)
        return ckpt

    def leg(state, start, fired):
        inj = tf.PodFaultInjector(sched, gate=tf.UpdateGate(),
                                  fired_crashes=fired)
        jinj = jf.PodFaultInjector(jsched, gate=jf.UpdateGate(),
                                   fired_crashes=fired)
        port, ref = _Side(False, inj), _Side(True, jinj)
        if start:
            for side, mod, d in ((port, tckpt, dirs["port"]),
                                 (ref, jckpt, dirs["jax"])):
                side.cp.load_state_dict(
                    mod.restore_metadata(d, start)["control_plane"])
        out = {}
        for name, side, mod, st, injector in (
                ("port", port, tckpt, state[0], inj),
                ("jax", ref, jckpt, state[1], jinj)):
            try:
                out[name] = side.run(st, start, 6, checkpoint_every=1,
                                     checkpoint_fn=ckpt_fn(
                                         side, dirs[name], mod, injector))
            except (tf.InjectedCrash, jf.InjectedCrash) as crash:
                out[name] = crash
        return port, ref, inj, jinj, out

    port, ref, inj, jinj, out = leg((tstate0, jstate0), 0, ())
    assert isinstance(out["port"], tf.InjectedCrash)
    assert isinstance(out["jax"], jf.InjectedCrash)
    assert out["port"].round_index == out["jax"].round_index == 1
    assert sorted(inj.fired_crashes) == sorted(jinj.fired_crashes) == [1]
    assert port.rosters == ref.rosters

    # "process restart": each side resumes from its own newest verified
    # snapshot with the fired boundary carried over — no re-fire
    starts = {k: tckpt.latest_verified_step(d) if k == "port"
              else jckpt.latest_verified_step(d) for k, d in dirs.items()}
    assert starts["port"] == starts["jax"] == (1, [])
    state = (tckpt.restore(dirs["port"], 1, t_like),
             jckpt.restore(dirs["jax"], 1, j_like))
    port, ref, inj, jinj, out = leg(state, 1, sorted(inj.fired_crashes))
    (tstate, hist), (jstate, jhist) = out["port"], out["jax"]
    assert len(hist) == len(jhist) == 5                 # rounds 1..5
    _assert_lockstep(port, ref, hist, jhist)
    fr = inj.report()
    assert fr == jinj.report()
    assert fr["matched"] is True, fr
    assert fr["recovered"]["server_crash"] == 1         # crash_resumed
    for cls in ("timeout", "corrupt_act", "torn_checkpoint"):
        assert fr["injected"][cls] == 1, cls
    # the torn snapshot is detectable on both sides, and a later resume
    # skips it
    torn = {k: [s for s in mod.committed_steps(d)
                if not mod.verify_snapshot(d, s)[0]]
            for (k, d), mod in zip(dirs.items(), (tckpt, jckpt))}
    assert torn == {"port": [4], "jax": [4]}
    _close(state_to_numpy(tstate), jax.tree.map(np.asarray, jstate),
           "final state")


# ---------------------------------------------------------------------------
# the driver: --faults through train.main
# ---------------------------------------------------------------------------

DRIVER_ARGS = ["--device", "cpu", "--batch", "4", "--H", "2", "--seq-len",
               "16", "--groups-per-shard", "4", "--omega", "2",
               "--pool-cap", "2", "--rounds", "3"]


def test_driver_faults_crash_then_resume(tmp_path, capsys):
    """A dense pod schedule as JSON: at round 1 a timeout, an ``inf``
    upload and a torn snapshot (step 2); the crash at round 2's boundary
    kills the run after writing ``FAULTS_FIRED.json``.  The rerun of the
    command skips the torn snapshot, resumes from step 1, does not crash
    again and ends matched, each class injected once."""
    sched = tf.FaultSchedule(horizon=3.0, events=(
        tf.FaultEvent(1.0, "timeout", device=1, param=1.0),
        tf.FaultEvent(1.0, "corrupt_act", device=2, kind="inf"),
        tf.FaultEvent(1.0, "torn_checkpoint", kind="bitflip"),
        tf.FaultEvent(2.0, "server_crash", param=1.0)))
    path = sched.save(str(tmp_path / "faults.json"))
    d = tmp_path / "ckpt"
    argv = DRIVER_ARGS + ["--ckpt-dir", str(d), "--ckpt-every", "1",
                          "--ckpt-flush", "--faults", path, "--sanitize"]
    with pytest.raises(tf.InjectedCrash, match="round boundary 2"):
        train.main(argv)
    with open(d / "FAULTS_FIRED.json") as f:
        assert json.load(f) == [2]
    assert "restart to resume" in capsys.readouterr().out
    out = train.main(argv)
    printed = capsys.readouterr().out
    assert "resume: skipping torn snapshot step 2: " in printed
    assert "resumed from round 1" in printed
    assert "matched=True" in printed
    fr = out["faults"]
    once = {cls: 1 for cls in tf.POD_CLASSES}
    assert fr["matched"] is True
    assert fr["injected"] == fr["recovered"] == once
    assert fr["gate"]["reject_reasons"] == {"non_finite": 1}
    assert len(out["history"]) == 2                    # rounds 1 and 2
    assert out["sanitizer"]["n_violations"] == 0
    assert out["registry"]["counters"]["gate.rejected"] == 1


def test_driver_faults_without_crashes_need_no_ckpt_dir(tmp_path):
    """Timeouts and poisoned uploads alone need no store; the random
    spec draws over all four pod classes and does."""
    sched = tf.FaultSchedule(horizon=3.0, events=(
        tf.FaultEvent(0.0, "corrupt_act", device=0, kind="nan"),
        tf.FaultEvent(1.0, "timeout", device=3, param=1.0)))
    path = sched.save(str(tmp_path / "faults.json"))
    out = train.main(DRIVER_ARGS + ["--faults", path])
    assert out["faults"]["matched"] is True
    assert out["faults"]["injected"] == {"corrupt_act": 1, "timeout": 1}
    assert out["executor"]["faults"] == out["faults"]
    with pytest.raises(ValueError, match="--ckpt-dir is required"):
        train.main(DRIVER_ARGS + ["--faults", "random:2"])


# ---------------------------------------------------------------------------
# SIGKILL crash sweep (subprocesses on the CPU; the reference's two cases)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_crash_sweep_sigkill_bit_exact_smoke(monkeypatch):
    from repro_torch.faults.crash_harness import sweep
    monkeypatch.setenv("OMP_NUM_THREADS", "1")    # one thread per child
    out = sweep(boundaries=[1], rounds=2, ckpt_every=1,
                kill_modes=("after", "mid"), device="cpu")
    assert out["cases"] == {"after@1": "bit-exact", "mid@1": "bit-exact"}


@pytest.mark.slow
def test_crash_sweep_window4_checkpoint_without_flush(monkeypatch):
    """The deep pipeline: SIGKILL sweep at window=4 with
    checkpoint-without-flush — children save from dispatch-time handles
    while rounds stay in flight (the sweep asserts flush_saves=0 on the
    reference and every resumed run), and resume is still bit-exact."""
    from repro_torch.faults.crash_harness import sweep
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = sweep(boundaries=[1], rounds=2, ckpt_every=1,
                kill_modes=("after", "mid"), window=4, device="cpu")
    assert out["window"] == 4 and out["ckpt_flush"] is False
    assert out["cases"] == {"after@1": "bit-exact", "mid@1": "bit-exact"}
