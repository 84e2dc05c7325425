"""The port's tiered activation store (``repro_torch.memory``) against the
JAX package's (``repro.memory``).

Mirrors the tests of ``tests/test_memory.py`` that do not touch the
advisory prefetch or checkpoints, which the port leaves out: the spill
round trips (float32 bit-exact, int8 within max|x|/254), the cap, counts
and bytes, the eviction victims, FIFO withdrawal, ``pool_cap=0`` as the
hard-ω plans, K = 4ω admitted past the ring, the executor's spills and
fills and its refusal without store wiring, and the real step under a
stall.  Then the lockstep parity run: both packages' executors, each with
its store, on the same stalled profile (2 rounds with no reads, then 2
that drain) from the JAX init (smoke smollm, l_split 1, G=2, seq 16,
batch 4, H=2, ω=2, pool 2, window 2), with the
``share`` and ``lru`` policies, in float32 and int8: every plan field,
count and pool key equal, losses within 1e-4 every round, every final
state leaf within 1e-4.  The plan-only parity extends
``test_control_plane_plans_match_jax`` to pools of 1 and 2 slots.
"""
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import control_plane as jcp
from repro.core import executor as jex
from repro.core import fedopt_step as JF
from repro.core import scheduler as jsc
from repro.memory import store as jstore
from repro_torch.configs import registry as treg
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import control_plane as tcp
from repro_torch.core import executor as tex
from repro_torch.core import fedopt_step as TF
from repro_torch.core import scheduler as tsc
from repro_torch.launch import train as ttrain
from repro_torch.memory import ActivationStore, make_eviction_policy
from repro_torch.memory import store as tstore

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_round import (SMOKE_ARGS, TOL, _assert_plans_equal, _close,
                              _jax_step)

OMEGA, G4 = 2, 8        # K = 4ω acceptance scale (host-level tests)
# the lockstep run: the real step of test_memory.py's jit_setup
KW = dict(l_split=1, n_groups=2, seq_len=16, per_group_batch=4, H=2,
          omega=OMEGA)
G, H, B, S = 2, 2, 2, 16     # groups, micro-iterations, micro-batch, seq


# ---------------------------------------------------------------------------
# spill → fill round trips (the store itself)
# ---------------------------------------------------------------------------

def _payload(rng, n, scale):
    return {"acts": torch.from_numpy(
                (scale * rng.standard_normal((3, n))).astype(np.float32)),
            "labels": torch.from_numpy(
                rng.integers(0, 1000, (3, 4)).astype(np.int32))}


ROUND_TRIPS = [(1, 1e-3), (7, 0.5), (16, 1.0), (33, 37.0), (64, 1e3)]


@pytest.mark.parametrize("n,scale", ROUND_TRIPS)
def test_spill_fill_roundtrip_fp32_bitexact(n, scale):
    """fp32 spill is lossless: fill returns the gathered slot bit for bit,
    in its dtypes."""
    rng = np.random.default_rng(n)
    store = ActivationStore(2, quant=False)
    p = _payload(rng, n, scale)
    store.spill(0, p)
    out = store.fill(0)
    assert torch.equal(out["acts"], p["acts"])
    assert torch.equal(out["labels"], p["labels"])
    assert out["acts"].dtype == torch.float32
    assert out["labels"].dtype == torch.int32


@pytest.mark.parametrize("n,scale", ROUND_TRIPS)
def test_spill_fill_roundtrip_int8_tolerance(n, scale):
    """int8 spill: float leaves within the per-tensor quantisation bound
    (max|x|/254 per element); integer leaves stay exact; and the stored
    int8 form is the JAX store's, bit for bit."""
    rng = np.random.default_rng(1000 + n)
    store = ActivationStore(2, quant=True)
    p = _payload(rng, n, scale)
    store.spill(5, p)
    want = jstore._encode({k: v.numpy() for k, v in p.items()}, True)
    got = store._pool[5]["payload"]
    assert np.array_equal(got["acts"]["q"].numpy(), want["acts"]["q"])
    assert got["acts"]["scale"].item() == float(want["acts"]["scale"])
    out = store.fill(5)
    bound = float(p["acts"].abs().max()) / 254.0 + 1e-7
    assert float((out["acts"] - p["acts"]).abs().max()) <= bound
    assert torch.equal(out["labels"], p["labels"])


def test_store_cap_counts_and_bytes():
    rng = np.random.default_rng(0)
    store = ActivationStore(1, quant=False)
    store.spill(0, _payload(rng, 8, 1.0))
    assert len(store) == 1 and store.n_spills == 1 and 0 in store
    assert store.pool_bytes == store.peak_pool_bytes > 0
    with pytest.raises(RuntimeError, match="pool full"):
        store.spill(1, _payload(rng, 8, 1.0))
    with pytest.raises(KeyError):
        store.spill(0, _payload(rng, 8, 1.0))   # key already held
    store.fill(0)
    assert len(store) == 0 and store.n_fills == 1 and store.pool_bytes == 0
    # int8 spill shrinks the float payload ~4x
    big = {"acts": torch.randn(64, 64, generator=torch.Generator()
                               .manual_seed(0))}
    fp = ActivationStore(1, quant=False)
    q8 = ActivationStore(1, quant=True)
    fp.spill(0, big)
    q8.spill(0, big)
    assert fp.pool_bytes > 3.5 * q8.pool_bytes
    with pytest.raises(ValueError, match="pool_cap must be >= 0"):
        ActivationStore(-1)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_store_accounting_matches_jax(quant):
    """The same spills and fills through both stores: equal keys, counts,
    bytes and summaries (the JAX one's prefetch keys aside), and equal
    fills."""
    rng = np.random.default_rng(11)
    a, b = ActivationStore(3, quant=quant), jstore.ActivationStore(
        3, quant=quant)
    payloads = [_payload(rng, n, 2.0) for n in (5, 9, 13, 17)]
    ops = [("spill", 0), ("spill", 1), ("fill", 0), ("spill", 2),
           ("spill", 3), ("fill", 2), ("fill", 1), ("fill", 3)]
    for op, k in ops:
        if op == "spill":
            a.spill(k, payloads[k])
            b.spill(k, {n: v.numpy() for n, v in payloads[k].items()})
        else:
            fa, fb = a.fill(k), b.fill(k)
            for n in fa:
                np.testing.assert_array_equal(fa[n].numpy(), fb[n])
        assert (a.keys, len(a), a.pool_bytes) == (b.keys, len(b),
                                                  b.pool_bytes)
    want = {k: v for k, v in b.summary().items()
            if k not in ("n_prefetched", "prefetch_hits",
                         "peak_staged_bytes")}
    assert a.summary() == want


def test_eviction_policies_pick_expected_victims():
    """share: evict the slot whose contributors are best-served; lru:
    evict the least-recently-touched slot — over the same candidates."""
    share_of = {0: 0.7, 1: 0.1, 2: 0.4}.get
    groups_of = {10: {0}, 11: {1}, 12: {2}}.get     # slot -> contributors
    touch = {10: 5, 11: 9, 12: 1}
    lru = make_eviction_policy("lru")
    sh = make_eviction_policy("share")
    assert lru.victim([10, 11, 12], groups_of=groups_of, share=share_of,
                      touch=touch) == 12          # oldest touch
    assert sh.victim([10, 11, 12], groups_of=groups_of, share=share_of,
                     touch=touch) == 10           # best-served contributor
    assert sh.fill_order([10, 11, 12], groups_of=groups_of,
                         share=share_of) == [11, 12, 10]
    assert lru.fill_order([12, 10, 11], groups_of=groups_of,
                          share=share_of) == [10, 11, 12]
    with pytest.raises(ValueError, match="unknown eviction"):
        make_eviction_policy("mru")


def test_fifo_withdraw_preserves_unspilled_arrival_order():
    """Evicting a NEWER contribution must not demote the group's older,
    unspilled one: withdraw_slot retires the arrival entry matching the
    withdrawn message, not the group's oldest."""
    sched = tsc.TaskScheduler(3, policy="fifo")
    sched.put(tsc.Message("activation", 0, content="A"))   # g0 slot A
    sched.put(tsc.Message("activation", 1, content="A"))
    sched.put(tsc.Message("activation", 2, content="B"))
    sched.put(tsc.Message("activation", 0, content="B"))   # g0 slot B
    sched.withdraw_slot("B", [0, 2])                       # evict slot B
    served = [sched.get().origin for _ in range(2)]
    assert served == [0, 1]
    assert sched.total_buffered == 0
    # the withdrawn messages re-enter at the back on fill
    sched.put(tsc.Message("activation", 2, content="C"))
    sched.put(tsc.Message("activation", 0, content="C"))
    assert [sched.get().origin, sched.get().origin] == [2, 0]


@pytest.mark.parametrize("policy", ["counter", "fifo"])
def test_withdraw_slot_matches_jax(policy):
    """Random put/get/drain/withdraw sequences: the same picks, counters
    and arrival log in both packages."""
    rng = np.random.default_rng(5)
    js, ts = jsc.TaskScheduler(4, policy), tsc.TaskScheduler(4, policy)
    for _ in range(400):
        op, k, s = rng.integers(0, 4), int(rng.integers(0, 4)), \
            int(rng.integers(0, 3))
        if op == 0:
            js.put(jsc.Message("activation", k, content=s))
            ts.put(tsc.Message("activation", k, content=s))
        elif op == 1:
            a, b = js.get(), ts.get()
            assert (a is None) == (b is None)
            if a is not None:
                assert (a.origin, a.content) == (b.origin, b.content)
        elif op == 2:
            js.drain_slot(s, [k])
            ts.drain_slot(s, [k])
        else:
            groups = sorted({k, int(rng.integers(0, 4))})
            js.withdraw_slot(s, groups)
            ts.withdraw_slot(s, groups)
        assert js.counters == ts.counters
        assert list(js._arrival) == list(ts._arrival)
        assert {g: [m.content for m in q] for g, q in js.q_act.items()} == \
            {g: [m.content for m in q] for g, q in ts.q_act.items()}


# ---------------------------------------------------------------------------
# control-plane planning: pool_cap=0 pin + K >= 4ω admission
# ---------------------------------------------------------------------------

def _stress(cp, rounds, stalled):
    """Two-phase workload: while ``stalled(r)`` the groups produce but the
    server never reads; afterwards production stops and the server drains
    the backlog.  Returns the plan trace."""
    plans = []
    for r in range(rounds):
        if stalled(r):
            produce, reads = None, np.zeros(cp.H, bool)
        else:
            produce, reads = np.zeros((cp.H, cp.G), bool), np.ones(cp.H, bool)
        plans.append(cp.plan_round(produce=produce, reads=reads))
        assert cp.within_cap
        cp.finish_round()
    return plans


@pytest.mark.parametrize("eviction", ["share", "lru"])
def test_pool_cap_zero_plans_are_hard_omega_behavior(eviction):
    """pool_cap=0 (the pod default): no spill or fill is ever planned, the
    flow budget is exactly ω·G and a full ring gates sends, whatever the
    eviction policy; every plan equals the JAX plane's."""
    cp = tcp.ControlPlane(G4, OMEGA, 4, pool_cap=0, eviction=eviction)
    ref = jcp.ControlPlane(G4, OMEGA, 4, pool_cap=0, eviction=eviction)
    assert cp.flow.cap == cp.flow.omega == OMEGA * G4
    plans = _stress(cp, 6, stalled=lambda r: r < 3)
    for pt, pj in zip(plans, _stress(ref, 6, stalled=lambda r: r < 3)):
        _assert_plans_equal(pt, pj)
    assert all(p.spill == () and p.fill == () for p in plans)
    stalled_sends = sum(int(p.send_mask.sum()) for p in plans[:3])
    assert stalled_sends == OMEGA * G4
    assert cp.n_spills == cp.n_fills == 0 and cp.pool_live == 0
    assert cp.peak_buffered <= OMEGA * G4


def test_k_4omega_admits_past_the_omega_ring():
    """K = 4ω groups with a stalled server: the tiered plane admits ω +
    pool slots of contributions (4x the old ceiling) while ``within_cap``
    holds on the tiered budget; the same buffering under the ω-only cap is
    what the executor's RuntimeError refuses."""
    pool = 3 * OMEGA
    cp = tcp.ControlPlane(G4, OMEGA, 2, pool_cap=pool)
    _stress(cp, 4, stalled=lambda r: True)
    assert cp.peak_buffered == (OMEGA + pool) * G4    # 4x the old budget
    assert cp.peak_buffered > cp.flow.omega           # past the ω ring
    assert cp.pool_live == pool and cp.within_cap
    ex = tex.RoundExecutor(lambda s, b: (s, {}), cp)
    cp.flow.pool_cap, cp.pool_cap = 0, 0              # the un-tiered budget
    with pytest.raises(RuntimeError, match="activation cap"):
        ex._check_cap(3)
    cp.flow.pool_cap, cp.pool_cap = pool * G4, pool   # the tiered budget
    assert cp.within_cap
    # the server catches up: the pool drains back through fills
    _stress(cp, 12, stalled=lambda r: False)
    assert cp.n_fills == cp.n_spills > 0
    assert cp.pool_live == 0 and cp.flow.buffered == 0


@pytest.mark.parametrize("pool_cap,eviction", [(1, "share"), (1, "lru"),
                                               (2, "share"), (2, "lru")])
def test_control_plane_pool_plans_match_jax(pool_cap, eviction):
    """``test_control_plane_plans_match_jax`` with a spill pool: random
    rosters, emissions and reads (the server reads at half the rate, so
    the ring fills and spills), under both schedulers' policies in turn."""
    for policy, omega in (("counter", 2), ("fifo", 1)):
        Gp, Hp = 4, 3
        jplane = jcp.ControlPlane(Gp, omega, Hp, policy=policy,
                                  pool_cap=pool_cap, eviction=eviction)
        tplane = tcp.ControlPlane(Gp, omega, Hp, policy=policy,
                                  pool_cap=pool_cap, eviction=eviction)
        rng = np.random.default_rng(pool_cap)
        for _ in range(16):
            active = rng.random(Gp) >= 0.2
            active[rng.integers(0, Gp)] = True
            produce = rng.random((Hp, Gp)) < 0.8
            reads = rng.random(Hp) < 0.5
            pj = jplane.plan_round(active=active, produce=produce,
                                   reads=reads)
            pt = tplane.plan_round(active=active, produce=produce,
                                   reads=reads)
            _assert_plans_equal(pt, pj)
            for g in pt.retire:
                jplane.retain_group(g, None)
                tplane.retain_group(g, None)
            for g in pt.restore:
                jplane.release_group(g)
                tplane.release_group(g)
            jplane.finish_round(active=active)
            tplane.finish_round(active=active)
            assert tplane.within_cap and jplane.within_cap
            assert tplane.pool_occupancy == jplane.pool_occupancy
        assert tplane.n_spills > 0
        assert tplane.consumption == jplane.consumption
        assert tplane.memory_summary() == jplane.memory_summary()
        for attr in ("peak_buffered", "peak_live_slots", "n_accepted",
                     "n_rejected", "n_spills", "n_fills", "peak_pool"):
            assert getattr(tplane, attr) == getattr(jplane, attr), attr


# ---------------------------------------------------------------------------
# executor wiring (host-level stub ring)
# ---------------------------------------------------------------------------

class _Stall:
    """Deterministic two-phase pattern: for the first ``stall_rounds``
    plans every group emits and the server never reads (the backlog
    builds, slots spill); afterwards emission stops and the server drains
    (the pool fills back)."""

    def __init__(self, n_groups, stall_rounds):
        super().__init__(n_groups)
        self.stall_rounds = stall_rounds
        self._planned = 0

    def produce(self, H):
        self._planned += 1          # produce() is called first each round
        stalled = self._planned <= self.stall_rounds
        return np.full((H, self.G), stalled, bool)

    def reads(self, H):
        return np.full(H, self._planned > self.stall_rounds, bool)


class _StalledProfiles(_Stall, tex.StragglerProfiles):
    pass


class _JaxStalledProfiles(_Stall, jex.StragglerProfiles):
    pass


class _StubRing:
    """A host ring standing in for the step: applies the plan's writes,
    stamping each written slot with (round, h)."""

    def __init__(self):
        self.t = 0

    def step(self, state, plan):
        ring = list(state["ring"])
        for h in range(len(plan.write_slot)):
            if plan.send_mask[h].any():
                ring[int(plan.write_slot[h])] = {
                    "acts": torch.full((4,), 100.0 * self.t + h)}
        self.t += 1
        return {"ring": ring}, {"d_loss": float(self.t)}


def _slot_ops():
    def gather(state, s):
        return state["ring"][s]

    def scatter(state, s, payload):
        ring = list(state["ring"])
        ring[s] = payload
        return {"ring": ring}
    return gather, scatter


def test_executor_runs_k_4omega_spills_and_fills():
    pool = 3 * OMEGA
    cp = tcp.ControlPlane(G4, OMEGA, 2, pool_cap=pool)
    store = ActivationStore(pool)
    gather, scatter = _slot_ops()
    ex = tex.RoundExecutor(_StubRing().step, cp, window=2,
                           profiles=_StalledProfiles(G4, stall_rounds=5),
                           store=store, gather_slot=gather,
                           scatter_slot=scatter)

    def on_metrics(r, m, stats):
        assert cp.within_cap
        # store payloads and control-plane bookkeeping track each other
        assert store.keys == sorted(cp.pool_occupancy)

    state = {"ring": [{"acts": torch.zeros(4)}] * OMEGA}
    state, hist = ex.run(state, 0, 14,
                         active_fn=lambda r: np.ones(G4, bool),
                         batch_fn=lambda r, plan: plan,
                         on_metrics=on_metrics)
    assert len(hist) == 14
    mem = ex.summary()["memory"]
    assert mem["spills"] == mem["store_spills"] > 0
    assert mem["fills"] == mem["store_fills"] == mem["spills"]
    assert mem["peak_pool"] > 0 and len(store) == 0
    assert cp.peak_buffered > OMEGA * G4      # admitted past the old cap
    assert all(s.memory_s >= 0.0 for s in ex.stats)


def test_executor_refuses_spills_without_store_wiring():
    cp = tcp.ControlPlane(G4, OMEGA, 2, pool_cap=2)
    ex = tex.RoundExecutor(_StubRing().step, cp,
                           profiles=_StalledProfiles(G4, stall_rounds=10))
    with pytest.raises(RuntimeError, match="ActivationStore"):
        ex.run({"ring": [None] * OMEGA}, 0, 3,
               active_fn=lambda r: np.ones(G4, bool),
               batch_fn=lambda r, plan: plan)


# ---------------------------------------------------------------------------
# the port's real step: spill rounds train, pool_cap=0 parity
# ---------------------------------------------------------------------------

def _data(r, vocab):
    rng = np.random.default_rng(100 + r)
    return rng.integers(0, vocab, (G, H, B, S)), \
        rng.integers(0, vocab, (G, H, B, S))


def _run_port(state, *, pool_cap, quant=False, eviction="share", rounds=4,
              wire_store=True, window=2, trace=None):
    cfg = TF.FedStepConfig(arch=treg.smoke_config("smollm-135m"), **KW)
    cp = tcp.ControlPlane(G, OMEGA, H, pool_cap=pool_cap, eviction=eviction)
    store = ActivationStore(pool_cap, quant=quant)
    kw = dict(store=store, gather_slot=TF.gather_act_slot,
              scatter_slot=TF.scatter_act_slot) if wire_store else {}
    ex = tex.RoundExecutor(TF.make_train_step(cfg), cp, window=window,
                           profiles=_StalledProfiles(G, stall_rounds=2),
                           **kw)

    def batch_fn(r, plan):
        if trace is not None:
            trace.append(_snapshot(plan, cp, store, tstore._decode))
        tokens, labels = _data(r, cfg.arch.vocab)
        return {"tokens": torch.from_numpy(tokens),
                "labels": torch.from_numpy(labels),
                **plan.batch_fields("cpu")}

    state, hist = ex.run(state, 0, rounds,
                         active_fn=lambda r: np.ones(G, bool),
                         batch_fn=batch_fn)
    return cp, store, state, hist, ex


def _port_init():
    cfg = TF.FedStepConfig(arch=treg.smoke_config("smollm-135m"), **KW)
    return TF.init_train_state(torch.Generator().manual_seed(0), cfg)


def test_real_step_spill_rounds_train_and_drain():
    """ω=2 + pool_cap=2 on the port's step: a stalled server forces real
    ring-slot moves; training stays finite, the tiered cap holds, and the
    pool drains once reads resume."""
    cp, store, state, hist, ex = _run_port(_port_init(), pool_cap=2)
    assert len(hist) == 4
    assert all(np.isfinite(m["d_loss"]) and np.isfinite(m["s_loss"])
               for m in hist)
    assert cp.n_spills > 0 and cp.n_fills == cp.n_spills
    assert store.n_spills == cp.n_spills and len(store) == 0
    assert cp.within_cap
    assert cp.peak_buffered > OMEGA * G                # past the ring


def test_real_step_pool_cap_zero_is_bitforbit_storeless():
    """pool_cap=0 with the store wired is bit for bit the storeless run:
    same metric history, same final state."""
    _, store, st_a, hist_a, _ = _run_port(_port_init(), pool_cap=0)
    _, _, st_b, hist_b, _ = _run_port(_port_init(), pool_cap=0,
                                      wire_store=False)
    assert store.n_spills == store.n_fills == 0
    assert hist_a == hist_b
    for a, b in zip(jax.tree.leaves(state_to_numpy(st_a)),
                    jax.tree.leaves(state_to_numpy(st_b))):
        np.testing.assert_array_equal(a, b)


def test_real_step_windows_agree_with_the_pool_active():
    """Windows 1 and 2 give bit-identical histories and states with slots
    spilling and filling."""
    runs = {w: _run_port(_port_init(), pool_cap=2, quant=True, window=w)
            for w in (1, 2)}
    assert runs[1][0].n_spills == runs[2][0].n_spills > 0
    assert runs[1][3] == runs[2][3]
    for a, b in zip(jax.tree.leaves(state_to_numpy(runs[1][2])),
                    jax.tree.leaves(state_to_numpy(runs[2][2]))):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# lockstep parity: both packages' executors and stores on one stall
# ---------------------------------------------------------------------------

def _snapshot(plan, cp, store, decode):
    """What the boundary left behind, taken as the batch is built (after
    the moves, before dispatch)."""
    return {"plan": plan, "n_spills": cp.n_spills, "n_fills": cp.n_fills,
            "pool": cp.pool_occupancy, "keys": store.keys,
            "store_counts": (store.n_spills, store.n_fills),
            "bytes": store.pool_bytes, "peak_buffered": cp.peak_buffered,
            "contents": {k: decode(e["payload"], e["dtypes"])
                         for k, e in sorted(store._pool.items())}}


def _run_jax(pool_cap, quant, eviction, rounds=4):
    jcfg = JF.FedStepConfig(arch=jreg.smoke_config("smollm-135m"), **KW)
    jitted, state, s_spec = _jax_step(jcfg)
    cp = jcp.ControlPlane(G, OMEGA, H, pool_cap=pool_cap, eviction=eviction)
    store = jstore.ActivationStore(pool_cap, quant=quant)
    ex = jex.RoundExecutor(
        jitted, cp, window=2, profiles=_JaxStalledProfiles(G, 2),
        store=store, gather_slot=JF.gather_act_slot,
        scatter_slot=lambda st, s, p: JF.scatter_act_slot(
            st, s, p, state_shardings=s_spec))
    trace = []

    def batch_fn(r, plan):
        trace.append(_snapshot(plan, cp, store, jstore._decode))
        tokens, labels = _data(r, jcfg.arch.vocab)
        return {"tokens": tokens.astype(np.int32),
                "labels": labels.astype(np.int32), **plan.batch_fields()}

    state, hist = ex.run(state, 0, rounds,
                         active_fn=lambda r: np.ones(G, bool),
                         batch_fn=batch_fn)
    return state, hist, trace, ex.summary()["memory"]


@pytest.mark.parametrize("eviction", ["share", "lru"])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_executor_store_lockstep_matches_jax(quant, eviction):
    jstate, jhist, jtrace, jmem = _run_jax(2, quant, eviction)
    jcfg = JF.FedStepConfig(arch=jreg.smoke_config("smollm-135m"), **KW)
    init = state_from_numpy(jax.tree.map(np.asarray, _jax_step(jcfg)[1]),
                            "cpu")
    ttrace = []
    cp, store, tstate, thist, ex = _run_port(init, pool_cap=2, quant=quant,
                                             eviction=eviction, trace=ttrace)
    assert len(ttrace) == len(jtrace) == 4
    for r, (t, j) in enumerate(zip(ttrace, jtrace)):
        _assert_plans_equal(t["plan"], j["plan"])
        for key in ("n_spills", "n_fills", "pool", "keys", "store_counts",
                    "peak_buffered"):
            assert t[key] == j[key], (r, key)
        # equal bytes once the port's int64 labels (int32 in JAX, ROADMAP
        # §C) are taken at the JAX width
        wide = sum(v.numel() * 4 for c in t["contents"].values()
                   for v in c.values() if not v.is_floating_point())
        assert t["bytes"] - wide == j["bytes"], r
        for k, c in t["contents"].items():
            acts, want = c["acts"].numpy(), j["contents"][k]["acts"]
            # int8: a value on a rounding edge may land one quantum over
            step = np.abs(want).max() / 127.0 if quant else 0.0
            np.testing.assert_allclose(acts, want, rtol=TOL,
                                       atol=TOL + step, err_msg=f"r{r} k{k}")
            np.testing.assert_array_equal(c["labels"].numpy(),
                                          j["contents"][k]["labels"])
        _close({k: thist[r][k] for k in ("d_loss", "s_loss")},
               {k: jhist[r][k] for k in ("d_loss", "s_loss")},
               f"round {r} metrics")
    assert sum(len(t["plan"].spill) for t in ttrace) > 0
    tmem = ex.summary()["memory"]
    assert {k: tmem[k] for k in jmem if k in tmem and k not in (
        "pool_bytes", "peak_pool_bytes")} == \
        {k: jmem[k] for k in jmem if k in tmem and k not in (
            "pool_bytes", "peak_pool_bytes")}
    assert tmem["spills"] == tmem["fills"] > 0 and tmem["pool_live"] == 0
    _close(state_to_numpy(tstate), jax.tree.map(np.asarray, jstate),
           "final state")


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

MEMORY_LINE = re.compile(
    r"^memory: spills (\d+)  fills (\d+)  evictions (\d+)  peak pool "
    r"(\d+)/(\d+) slots \((\d+\.\d) MB(, int8 spill)?\)$", re.M)


def test_driver_runs_pool_cap_flags(capsys):
    """``--pool-cap 2 --spill-quant --eviction lru`` on the CPU smoke
    args: the run trains and prints the reference's ``memory:`` line (no
    stall here, so no traffic)."""
    out = ttrain.main(SMOKE_ARGS + ["--rounds", "2", "--pool-cap", "2",
                                    "--spill-quant", "--eviction", "lru"])
    m = MEMORY_LINE.search(capsys.readouterr().out)
    assert m is not None
    assert m.group(5) == "2" and m.group(7) == ", int8 spill"
    assert out["memory"]["eviction"] == "lru"
    assert out["memory"]["spill_quant"] is True
    assert all(np.isfinite(h[k]) for h in out["history"]
               for k in ("d_loss", "s_loss"))


def test_driver_spills_and_fills_under_a_stall(capsys):
    """``run_pod`` with a stalled profile (ω=2, pool 2): slots spill and
    fill back, and the ``memory:`` line counts them."""
    args = ttrain.build_parser().parse_args(
        SMOKE_ARGS + ["--rounds", "4", "--omega", "2", "--pool-cap", "2"])
    args.profiles = _StalledProfiles(2, stall_rounds=2)
    out = ttrain.run_pod(args)
    spills, fills = map(int, MEMORY_LINE.search(
        capsys.readouterr().out).group(1, 2))
    assert spills == fills == out["memory"]["spills"] > 0
    assert out["memory"]["pool_live"] == 0
    assert out["memory"]["peak_buffered"] > 2 * 2     # past the ring
    assert all(s.memory_s >= 0.0 for s in out["round_stats"])
