"""The port's pipelined round executor (``repro_torch/core/executor.py``)
against the JAX package's, and its own invariants, mirroring
``tests/test_executor.py``.

At window 2, under a drop and a rejoin of each group, the port's
``RoundExecutor`` and the JAX ``RoundExecutor`` start from the same
converted init, take the same batches and must agree on both losses of
every round and on every final state leaf at 1e-4 (the reference's GTOL),
with each round's plan equal exactly.  The JAX step is built on a (1, 1)
mesh with Auto axes and ``donate=False``, as in ``tests/test_torch_round.py``.
Window 1 must equal the port's former synchronous loop bit for bit, and
window 2 must equal window 1 bit for bit: planning never reads the card.
"""
import argparse
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import registry as jreg
from repro.core import control_plane as jcp
from repro.core import executor as jex
from repro.core import fedopt_step as JF
from repro_torch.configs import registry as treg
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import control_plane as tcp
from repro_torch.core import executor as tex
from repro_torch.core import fedopt_step as TF
from repro_torch.launch import train as ttrain
from repro_torch.models.common import tree_leaves, tree_map

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-4
G, H, B, S = 2, 2, 2, 16          # groups, micro-iterations, rows, seq
KW = dict(l_split=1, n_groups=G, seq_len=S, per_group_batch=B * H, H=H,
          omega=2)
# each group drops once and rejoins; at window 2 each drop is gathered
# from the live state while the previous round is still in flight
ROSTERS = [np.array([True, True]), np.array([True, False]),
           np.array([True, True]), np.array([False, True]),
           np.array([True, True])]


def _tokens(n_rounds, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, (G, H, B, S)),
             rng.integers(0, vocab, (G, H, B, S))) for _ in range(n_rounds)]


def _torch_setup(arch="smollm-135m", init=None):
    cfg = TF.FedStepConfig(arch=treg.smoke_config(arch), **KW)
    state = init if init is not None else TF.init_train_state(
        torch.Generator().manual_seed(0), cfg)
    data = _tokens(len(ROSTERS), cfg.arch.vocab)

    def batch_fn(r, plan):
        tokens, labels = data[r]
        return {"tokens": torch.from_numpy(tokens),
                "labels": torch.from_numpy(labels),
                **plan.batch_fields("cpu")}
    return cfg, TF.make_train_step(cfg), state, batch_fn


def _torch_executor(cfg, step, window):
    cp = tcp.ControlPlane(cfg.n_groups, cfg.omega, cfg.H)
    return cp, tex.RoundExecutor(
        step, cp, window=window,
        profiles=tex.StragglerProfiles(cfg.n_groups),
        gather=TF.gather_group_state, scatter=TF.scatter_group_state)


def _copy(state):
    return tree_map(torch.clone, state)


def _assert_plans_equal(pt, pj):
    for f in dataclasses.fields(pt):
        np.testing.assert_array_equal(np.asarray(getattr(pt, f.name)),
                                      np.asarray(getattr(pj, f.name)),
                                      err_msg=f.name)


def _assert_states_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# against the JAX RoundExecutor
# ---------------------------------------------------------------------------

def test_window2_matches_jax_executor_under_churn():
    jcfg = JF.FedStepConfig(arch=jreg.smoke_config("smollm-135m"), **KW)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    jitted, _, s_spec, _ = JF.jit_train_step(jcfg, mesh, donate=False)
    jstate = jax.jit(lambda: JF.init_train_state(jax.random.PRNGKey(0),
                                                 jcfg),
                     out_shardings=s_spec)()
    tinit = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    tcfg, tstep, tstate, tbatch_fn = _torch_setup(init=tinit)
    data = _tokens(len(ROSTERS), jcfg.arch.vocab)

    def jbatch_fn(r, plan):
        tokens, labels = data[r]
        return {"tokens": tokens.astype(np.int32),
                "labels": labels.astype(np.int32), **plan.batch_fields()}

    jplane = jcp.ControlPlane(G, jcfg.omega, jcfg.H)
    jexec = jex.RoundExecutor(
        jitted, jplane, window=2, profiles=jex.StragglerProfiles(G),
        gather=JF.gather_group_state,
        scatter=lambda st, g, p: JF.scatter_group_state(st, g, p, s_spec))
    tplane, texec = _torch_executor(tcfg, tstep, window=2)
    plans = {"jax": {}, "torch": {}}
    runs = {}
    for name, ex, state, batch_fn in (("jax", jexec, jstate, jbatch_fn),
                                      ("torch", texec, tstate, tbatch_fn)):
        runs[name] = ex.run(
            state, 0, len(ROSTERS), active_fn=lambda r: ROSTERS[r],
            batch_fn=batch_fn,
            on_metrics=lambda r, m, st, p=plans[name]: p.update({r: st.plan}))
    for r in range(len(ROSTERS)):
        _assert_plans_equal(plans["torch"][r], plans["jax"][r])
    assert [p.retire for p in plans["torch"].values()] == \
        [(), (1,), (), (0,), ()]
    assert [p.restore for p in plans["torch"].values()] == \
        [(), (), (1,), (), (0,)]
    (js, jh), (ts, th) = runs["jax"], runs["torch"]
    for r, (mt, mj) in enumerate(zip(th, jh)):
        for k in ("d_loss", "s_loss"):
            np.testing.assert_allclose(mt[k], mj[k], atol=TOL, rtol=TOL,
                                       err_msg=f"round {r} {k}")
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, np.asarray(w), atol=TOL, rtol=TOL), state_to_numpy(ts),
        jax.tree.map(np.asarray, js))
    # both drops were gathered from the live state and both rejoins
    # scattered back, with no round copied aside
    assert texec.summary()["retention"] == {"retired": 2, "restored": 2}
    assert texec.handle_bytes_peak == 0
    assert texec.peak_in_flight == jexec.peak_in_flight == 2
    assert tplane.consumption == jplane.consumption


# ---------------------------------------------------------------------------
# determinism: the window must not change values
# ---------------------------------------------------------------------------

def _former_sync_loop(cfg, step, state, batch_fn):
    """The port's round loop before the executor (``run_pod`` at window 1):
    plan, gather/scatter the churned groups from the live state, step,
    close the round, read the metrics."""
    cp = tcp.ControlPlane(cfg.n_groups, cfg.omega, cfg.H)
    history = []
    for r, active in enumerate(ROSTERS):
        plan = cp.plan_round(active=active)
        for g in plan.retire:
            cp.retain_group(g, TF.gather_group_state(state, g))
        for g in plan.restore:
            state = TF.scatter_group_state(state, g,
                                           cp.release_group(g)["params"])
        state, metrics = step(state, batch_fn(r, plan))
        cp.finish_round(active=active)
        history.append({k: float(v) for k, v in metrics.items()})
    return state, history


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-780m"])
def test_window1_equals_former_loop_and_window2_equals_window1(arch):
    cfg, step, state0, batch_fn = _torch_setup(arch)
    ref_state, ref_hist = _former_sync_loop(cfg, step, _copy(state0),
                                            batch_fn)
    results = {}
    for window in (1, 2):
        _, ex = _torch_executor(cfg, step, window)
        results[window] = ex.run(_copy(state0), 0, len(ROSTERS),
                                 active_fn=lambda r: ROSTERS[r],
                                 batch_fn=batch_fn)
        assert ex.peak_in_flight == window
    (s1, h1), (s2, h2) = results[1], results[2]
    assert h1 == ref_hist              # exact float equality, round order
    _assert_states_equal(s1, ref_state)
    assert h2 == h1
    _assert_states_equal(s2, s1)


def test_no_churn_captures_nothing():
    cfg, step, state0, batch_fn = _torch_setup()
    _, ex = _torch_executor(cfg, step, window=2)
    ex.run(state0, 0, 3, active_fn=lambda r: np.ones(G, bool),
           batch_fn=batch_fn)
    assert ex.handle_bytes_peak == 0 and not ex._deferred
    assert ex.summary()["retention"] == {"retired": 0, "restored": 0}


def test_driver_window2_equals_window1():
    args = ["--device", "cpu", "--batch", "4", "--H", "2", "--seq-len", "16",
            "--groups-per-shard", "3", "--rounds", "5", "--p-drop", "0.4"]
    out = {w: ttrain.main(args + ["--window", str(w)]) for w in (1, 2)}
    assert out[1]["history"] == out[2]["history"]
    assert out[1]["executor"]["window"] == 1
    assert out[2]["executor"]["peak_in_flight"] == 2
    assert out[2]["executor"]["retention"]["retired"] > 0
    assert out[2]["executor"]["retention"] == out[1]["executor"]["retention"]
    assert out[2]["executor"]["handle_bytes_peak"] == 0
    _assert_states_equal(out[1]["state"], out[2]["state"])
    assert ttrain.build_parser().parse_args([]).window == 2


# ---------------------------------------------------------------------------
# the executor's checks
# ---------------------------------------------------------------------------

def test_cap_violation_raises_runtime_error_with_occupancy():
    class BrokenPlane(tcp.ControlPlane):
        @property
        def within_cap(self):
            return False

    ex = tex.RoundExecutor(lambda s, b: (s, {"d_loss": 0.0, "s_loss": 0.0}),
                           BrokenPlane(2, 1, 2), window=1)
    with pytest.raises(RuntimeError, match=r"ring slots.*occupancy"):
        ex.run(0, 0, 1, active_fn=lambda r: np.ones(2, bool),
               batch_fn=lambda r, plan: {})


def test_executor_rejects_bad_window():
    with pytest.raises(ValueError, match="window"):
        tex.RoundExecutor(lambda s, b: (s, {}), tcp.ControlPlane(2, 1, 2),
                          window=0)
    assert ttrain._pipeline_window(argparse.Namespace()) == 2
    assert ttrain._pipeline_window(argparse.Namespace(window=None)) == 2
    assert ttrain._pipeline_window(argparse.Namespace(window=1)) == 1
    assert ttrain._pipeline_window(argparse.Namespace(window=4)) == 4
    for bad in (0, -3):
        with pytest.raises(ValueError, match="window must be >= 1"):
            ttrain._pipeline_window(argparse.Namespace(window=bad))


def test_churn_without_retention_wiring_raises():
    ex = tex.RoundExecutor(lambda s, b: (s, {"d_loss": 0.0}),
                           tcp.ControlPlane(2, 1, 2), window=1)
    rosters = [np.ones(2, bool), np.array([True, False])]
    with pytest.raises(RuntimeError, match="gather"):
        ex.run(0, 0, 2, active_fn=lambda r: rosters[r],
               batch_fn=lambda r, plan: {})


def test_rejoin_without_retained_params_raises():
    cp = tcp.ControlPlane(2, 1, 2)
    cp.plan_round(active=np.array([True, False]))
    cp.retain_group(1, None)           # metadata only, no params
    ex = tex.RoundExecutor(lambda s, b: (s, {"d_loss": 0.0}), cp, window=1,
                           gather=lambda s, g: None,
                           scatter=lambda s, g, p: s)
    with pytest.raises(RuntimeError, match="retained params are missing"):
        ex.run(0, 0, 1, active_fn=lambda r: np.ones(2, bool),
               batch_fn=lambda r, plan: {})
    # the error path must not destroy the retained entry
    assert 1 in cp.retention and cp.retention.groups == [1]


def test_summary_reports_steady_state_exposure_excluding_warmup():
    ex = tex.RoundExecutor(lambda s, b: (s, {"d_loss": 0.0}),
                           tcp.ControlPlane(2, 1, 2), window=3)
    ex.run(0, 0, 7, active_fn=lambda r: np.ones(2, bool),
           batch_fn=lambda r, plan: {})
    s = ex.summary()
    assert s["warmup_rounds_excluded"] == 3
    assert s["rounds"] == 7
    assert 0.0 <= s["host_s_exposed_steady"] <= s["host_s_exposed"] + 1e-9
    assert 0.0 <= s["hidden_host_frac_steady"] <= 1.0
    assert s["peak_in_flight"] == 3
    ex2 = tex.RoundExecutor(lambda s, b: (s, {"d_loss": 0.0}),
                            tcp.ControlPlane(2, 1, 2), window=4)
    ex2.run(0, 0, 2, active_fn=lambda r: np.ones(2, bool),
            batch_fn=lambda r, plan: {})
    s2 = ex2.summary()
    assert s2["warmup_rounds_excluded"] == 2
    assert s2["host_s_exposed_steady"] == 0.0


# ---------------------------------------------------------------------------
# checkpoint hooks (the saver is the caller's; run_pod's: test_torch_resume.py)
# ---------------------------------------------------------------------------

def _run_with_saver(flush, saves, window=2, rounds=8):
    cfg, step, state0, _ = _torch_setup()
    data = _tokens(rounds, cfg.arch.vocab)

    def batch_fn(r, plan):
        return {"tokens": torch.from_numpy(data[r][0]),
                "labels": torch.from_numpy(data[r][1]),
                **plan.batch_fields("cpu")}
    _, ex = _torch_executor(cfg, step, window)

    def checkpoint_fn(r, handle):
        saves[r] = {"tree": tree_map(torch.clone, handle.host_tree()),
                    "meta": handle.meta, "in_flight": len(ex._pending)}
    state, hist = ex.run(state0, 0, rounds,
                         active_fn=lambda r: np.ones(G, bool),
                         batch_fn=batch_fn, checkpoint_every=2,
                         checkpoint_fn=checkpoint_fn,
                         capture_fn=lambda r: {"round": r},
                         checkpoint_flush=flush)
    return hist, state, ex


def test_checkpoint_without_flush_saves_what_the_flush_saver_saves():
    saves_f, saves_n = {}, {}
    hf, sf, exf = _run_with_saver(True, saves_f)
    hn, sn, exn = _run_with_saver(False, saves_n)
    assert hf == hn
    _assert_states_equal(sf, sn)
    assert sorted(saves_f) == sorted(saves_n) == [1, 3, 5, 7]
    for r in saves_f:
        assert saves_f[r]["meta"] == saves_n[r]["meta"] == {"round": r}
        _assert_states_equal(saves_f[r]["tree"], saves_n[r]["tree"])
    assert exf.n_ckpt_flush == 4 and exf.n_ckpt_noflush == 0
    assert exn.n_ckpt_flush == 0 and exn.n_ckpt_noflush == 4
    assert all(s["in_flight"] == 0 for s in saves_f.values())
    assert any(s["in_flight"] > 0 for s in saves_n.values())
    assert exn.summary()["checkpoints"] == {"flush_saves": 0,
                                            "noflush_saves": 4}


def test_flush_checkpoint_without_capture_fn_gets_the_live_state():
    ex = tex.RoundExecutor(lambda s, b: (s, {"d_loss": 0.0}),
                           tcp.ControlPlane(2, 1, 2), window=2)
    seen = []
    live = {"x": torch.zeros(2)}
    ex.run(live, 0, 4, active_fn=lambda r: np.ones(2, bool),
           batch_fn=lambda r, plan: {}, checkpoint_every=2,
           checkpoint_fn=lambda r, st: seen.append(st))
    assert [s is live for s in seen] == [True, True]
    assert ex.n_ckpt_flush == 2 and ex.n_ckpt_noflush == 0


# ---------------------------------------------------------------------------
# measured straggler profiles
# ---------------------------------------------------------------------------

def _observe(p, rng, cluster_g):
    p.observe_round(float(rng.uniform(0.1, 2.0)), H=8)
    g = int(rng.integers(0, cluster_g))
    p.observe_group(g, step_s=float(rng.uniform(0.01, 0.1)),
                    transfer_s=float(rng.uniform(0.001, 0.01)))
    p.observe_server(float(rng.uniform(0.02, 0.2)))


@pytest.mark.parametrize("seeds", [
    {}, dict(step_s=[0.01, 0.02, 0.04], server_s=0.08),
    dict(step_s=[0.03, 0.01, 0.02], transfer_s=[0.1, 0.2, 0.3])],
    ids=["unseeded", "seeded", "seeded-transfer"])
def test_straggler_profiles_match_jax(seeds):
    jp = jex.StragglerProfiles(3, **seeds)
    tp = tex.StragglerProfiles(3, **seeds)
    rj, rt = np.random.default_rng(1), np.random.default_rng(1)
    for _ in range(12):
        np.testing.assert_array_equal(tp.produce(8), jp.produce(8))
        np.testing.assert_array_equal(tp.reads(8), jp.reads(8))
        assert tp.summary() == jp.summary()
        _observe(jp, rj, 3)
        _observe(tp, rt, 3)
    model = argparse.Namespace(dev_fwd_flops=1e9, dev_bwd_flops=2e9,
                               act_bytes=1e6, srv_flops_per_batch=8e9)
    cluster = argparse.Namespace(K=3, dev_flops=[1e12, 2e12, 4e12],
                                 dev_bw=[1e9, 1e9, 2e9], srv_flops=1e14)
    assert tex.StragglerProfiles.from_sim_model(model, cluster).summary() == \
        jex.StragglerProfiles.from_sim_model(model, cluster).summary()
