"""The torch port's baselines against the JAX package's, on the CPU: the six
protocols (classic FL, FedAsync, FedBuff, SplitFed, PiPar, OAFL) on the
port's event simulator with no hooks (bit-identical over a small grid),
the hook calls they make (the same calls in the same order), their two
learners driven through them from the JAX learner's init, the Eq. 6-8
split (``core/partition.py``, equal floats), ``lm_batches`` (exact), and
the refusals of the planes that come later.  Then
``tests/test_simulation.py``'s and ``tests/test_communication.py``'s
orderings of FedOptima against the baselines, on the port alone.

Learner tolerance: the reference's own gradient tolerance, 1e-4
(``tests/test_kernel_grads.py`` GTOL), as in ``tests/test_torch_sim.py``.
Everything the simulator counts is compared exactly.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import baselines as jbase
from repro.core import learning as jlearn
from repro.core import partition as jpartn
from repro.core import simulation as jsim
from repro.data import partitioner as jpart
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.models import cnn as jcnn
from repro_torch.configs import registry as treg
from repro_torch.convert import state_from_numpy
from repro_torch.core import baselines as tbase
from repro_torch.core import learning as tlearn
from repro_torch.core import partition as tpartn
from repro_torch.core import simulation as tsim
from repro_torch.data import partitioner as tpart
from repro_torch.data import pipeline as tpipe
from repro_torch.data import synthetic as tsyn
from repro_torch.models import cnn as tcnn
from repro_torch.models.common import tree_leaves

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-4
TOTAL = 8 * 4096     # the nominal dataset of test_simulation's comm check

# tests/test_simulation.py's costs
COSTS = dict(dev_fwd_flops=1e9, dev_bwd_flops=2e9, full_fwd_flops=5e9,
             srv_flops_per_batch=8e9, act_bytes=1e6, dev_model_bytes=4e6,
             full_model_bytes=2e7, batch_size=32)


class Recorder:
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


def _run(pkg_base, pkg_sim, name, K, H, duration, costs=COSTS, hooks=None,
         **kw):
    fn = pkg_base.REGISTRY[name]
    return fn(pkg_sim.SimModel(**costs), pkg_sim.heterogeneous_cluster(K),
              duration=duration, H=H, hooks=hooks, **kw)


def _assert_metrics_equal(tm, jm):
    """Every field of the port's Metrics, its derived figures and its
    registry snapshot equal the reference's, bit for bit."""
    for f in dataclasses.fields(tm):
        got, want = getattr(tm, f.name), getattr(jm, f.name)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and np.array_equal(got, want), \
                f.name
        else:
            assert got == want, f.name
    for prop in ("dev_idle_frac", "srv_idle_frac", "throughput"):
        assert getattr(tm, prop) == getattr(jm, prop), prop
    assert tm.comm_per_round(TOTAL) == jm.comm_per_round(TOTAL)
    assert tm.steady_summary() == jm.steady_summary()
    assert tm.contribution_balance() == jm.contribution_balance()
    assert tm.to_registry().snapshot() == jm.to_registry().snapshot()


# ---------------------------------------------------------------------------
# (a) the six baselines with no hooks: bit-identical
# ---------------------------------------------------------------------------

PROTOCOLS = [("fl", {}), ("fedasync", {}), ("fedbuff", {}),
             ("fedbuff", {"buffer_size": 3}), ("splitfed", {}),
             ("pipar", {}), ("oafl", {})]
GRID = [(name, kw, K, H) for name, kw in PROTOCOLS for K in (4, 8)
        for H in (1, 10)]


@pytest.mark.parametrize(
    "name,kw,K,H", GRID,
    ids=[f"{n}{'-Z' + str(kw['buffer_size']) if kw else ''}-K{K}-H{H}"
         for n, kw, K, H in GRID])
def test_baseline_bit_identical(name, kw, K, H):
    """No hooks: every Metrics field equal; then with recording hooks the
    same calls in the same order (and the metrics unmoved by them)."""
    jm = _run(jbase, jsim, name, K, H, 150.0, **kw)
    tm = _run(tbase, tsim, name, K, H, 150.0, **kw)
    _assert_metrics_equal(tm, jm)
    assert tm.dev_samples > 0 and tm.aggregations > 0
    if name in ("fl", "splitfed", "pipar"):
        assert tm.rounds > 0
    jrec, trec = Recorder(), Recorder()
    jm2 = _run(jbase, jsim, name, K, H, 150.0, hooks=jrec, **kw)
    tm2 = _run(tbase, tsim, name, K, H, 150.0, hooks=trec, **kw)
    _assert_metrics_equal(tm2, jm2)
    _assert_metrics_equal(tm2, tm)
    assert trec.calls == jrec.calls and len(trec.calls) > 0


def test_fedbuff_default_buffer_is_a_quarter_of_the_fleet():
    """Z = max(2, K // 4): at K=16 the default equals buffer_size=4, and
    differs from Z=3."""
    def run(**kw):
        m = _run(tbase, tsim, "fedbuff", 16, 10, 150.0, **kw)
        return m.aggregations, m.bytes_down, float(m.dev_busy.sum())
    assert run() == run(buffer_size=4) != run(buffer_size=3)


# ---------------------------------------------------------------------------
# (b) the orderings of tests/test_simulation.py and tests/test_communication.py
# ---------------------------------------------------------------------------

DUR = 400.0


@pytest.fixture(scope="module")
def results():
    model, cluster = tsim.SimModel(**COSTS), tsim.heterogeneous_cluster(8)
    out = {"fedoptima": tsim.simulate_fedoptima(model, cluster,
                                                duration=DUR)}
    for name, fn in tbase.REGISTRY.items():
        out[name] = fn(model, cluster, duration=DUR)
    return out


def test_fedoptima_lowest_device_idle_among_offloading(results):
    """Fig. 8/9: FedOptima device idle <= all offloading baselines."""
    for base in ("splitfed", "pipar", "oafl"):
        assert results["fedoptima"].dev_idle_frac <= \
            results[base].dev_idle_frac + 1e-6


def test_fedoptima_lowest_server_idle(results):
    """Fig. 8/9: server idle lower than every baseline."""
    for name, m in results.items():
        assert results["fedoptima"].srv_idle_frac <= m.srv_idle_frac + 1e-6


def test_fedoptima_highest_throughput(results):
    """Fig. 10/11 (Observation 3)."""
    for name, m in results.items():
        assert results["fedoptima"].throughput >= m.throughput - 1e-6, name


def test_async_beats_sync_on_heterogeneous_devices(results):
    """Stragglers: FedAsync devices idle less than classic FL's."""
    assert results["fedasync"].dev_idle_frac < results["fl"].dev_idle_frac


def test_pipar_overlap_beats_splitfed(results):
    assert results["pipar"].throughput >= results["splitfed"].throughput


def test_fedoptima_comm_lower_than_oafl(results):
    """Fig. 2: flow control + no gradient return cut communication."""
    assert results["fedoptima"].comm_per_round(TOTAL) < \
        results["oafl"].comm_per_round(TOTAL)


@pytest.fixture(scope="module")
def comm():
    """tests/test_communication.py's run: activations of 2 MB, ω=8."""
    model = tsim.SimModel(**dict(COSTS, act_bytes=2e6))
    cluster = tsim.heterogeneous_cluster(8)
    return (tsim.simulate_fedoptima(model, cluster, duration=400.0, omega=8),
            tbase.simulate_oafl(model, cluster, duration=400.0), model)


def test_fedoptima_comm_below_oafl(comm):
    fo, oafl, _ = comm
    assert fo.comm_per_round(TOTAL) < oafl.comm_per_round(TOTAL)


def test_fedoptima_downlink_carries_no_gradients(comm):
    """Down traffic is only model refreshes: per sample far below OAFL's
    per-sample gradient returns."""
    fo, oafl, _ = comm
    fo_down = fo.bytes_down / max(fo.dev_samples, 1)
    oafl_down = oafl.bytes_down / max(oafl.dev_samples, 1)
    assert fo_down < 0.5 * oafl_down


def test_flow_control_gates_uploads(comm):
    """With ω=8 and 8 devices, uploads per device iteration stay <= 1."""
    fo, _, model = comm
    iters = fo.dev_samples / model.batch_size
    uploads = fo.bytes_up / model.act_bytes
    assert uploads <= iters + 1


# ---------------------------------------------------------------------------
# (c) the learners through the baselines, from the JAX learner's init
# ---------------------------------------------------------------------------

# run_sim's costs: a few tens of steps per device in 40 simulated seconds
LEARN_COSTS = dict(dev_fwd_flops=2e9, dev_bwd_flops=4e9, full_fwd_flops=6e9,
                   srv_flops_per_batch=1.2e10, act_bytes=2e6,
                   dev_model_bytes=1e6, full_model_bytes=4e6, batch_size=32)
LEARN_K, LEARN_IMG, LEARN_DUR = 4, 8, 40.0


def _port(tree):
    return state_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _close(got, want, tol=TOL):
    got = [t.detach().numpy() for t in tree_leaves(got)]
    want = [np.asarray(w) for w in jax.tree.leaves(want)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol)


def _datasets(pkg_syn, pkg_part, pkg_pipe):
    data = pkg_syn.classification_dataset(512, 10, img_size=LEARN_IMG,
                                          seed=0)
    parts = pkg_part.dirichlet_partition(data.y, LEARN_K, alpha=0.5, seed=0)
    return [pkg_pipe.DeviceDataset(data.x[ix], data.y[ix], batch=32, seed=g)
            for g, ix in enumerate(parts)]


def _learners(name):
    """(JAX learner, port learner from its init) for the baseline."""
    jcfg = jcnn.vgg5_config(img_size=LEARN_IMG)
    tcfg = tcnn.vgg5_config(img_size=LEARN_IMG)
    jds = _datasets(jsyn, jpart, jpipe)
    tds = _datasets(tsyn, tpart, tpipe)
    jad, tad = jlearn.ModelAdapter(jcnn, jcfg), tlearn.ModelAdapter(tcnn, tcfg)
    if name in ("fl", "fedasync", "fedbuff"):
        jl = jlearn.FullModelLearner(jad, jds)
        return jl, tlearn.FullModelLearner(tad, tds, device="cpu",
                                           init=_port(jl.global_params))
    jl = jlearn.SplitLearner(jad, jds, 1)
    return jl, tlearn.SplitLearner(
        tad, tds, 1, device="cpu", init=_port(list(jl.g_dev) + list(jl.g_srv)))


@pytest.mark.parametrize("name", list(tbase.REGISTRY))
def test_learner_through_baseline_matches_jax(name):
    """VGG-5 at 8x8, K=4, 40 simulated seconds: the Metrics and the
    learner's counts exact, every device's params and the global (and
    server) params at 1e-4."""
    jl, tl = _learners(name)
    jm = _run(jbase, jsim, name, LEARN_K, 10, LEARN_DUR, costs=LEARN_COSTS,
              hooks=jl)
    tm = _run(tbase, tsim, name, LEARN_K, 10, LEARN_DUR, costs=LEARN_COSTS,
              hooks=tl)
    _assert_metrics_equal(tm, jm)
    assert (tl.dev_steps, tl.versions, tl.version) == \
        (jl.dev_steps, jl.versions, jl.version)
    assert tl.dev_steps * LEARN_COSTS["batch_size"] == tm.dev_samples > 0
    assert tl.version > 0
    for k in range(LEARN_K):
        _close(tl.dev[k], jl.dev[k])
    if isinstance(tl, tlearn.FullModelLearner):
        _close(tl.global_params, jl.global_params)
    else:
        assert set(tl._pending) == set(jl._pending)
        init = _learners(name)[1].g_srv
        assert any(not torch.equal(a, b) for a, b in
                   zip(tree_leaves(tl.g_srv), tree_leaves(init)))
        for k in range(LEARN_K):
            _close(tl.srv[k], jl.srv[k])
        _close(tl.g_dev, jl.g_dev)
        _close(tl.g_srv, jl.g_srv)


# ---------------------------------------------------------------------------
# (d) the Eq. 6-8 split
# ---------------------------------------------------------------------------

def _profiles_equal(tp, jp):
    assert type(tp).__name__ == type(jp).__name__ == "LayerProfile"
    for f in dataclasses.fields(jp):
        assert getattr(tp, f.name) == getattr(jp, f.name), f.name
    assert tp.n_units == jp.n_units


@pytest.mark.parametrize("arch", jreg.ARCHS)
def test_transformer_profile_matches_jax(arch):
    assert list(treg.ARCHS) == list(jreg.ARCHS)
    for seq in (64, 128):
        _profiles_equal(tpartn.transformer_profile(treg.get(arch), seq=seq),
                        jpartn.transformer_profile(jreg.get(arch), seq=seq))


def test_cnn_profile_matches_jax():
    for make in ("vgg5_config", "mobilenetv3ish_config"):
        _profiles_equal(tpartn.cnn_profile(getattr(tcnn, make)()),
                        jpartn.cnn_profile(getattr(jcnn, make)()))


def test_select_split_and_costs_match_jax():
    """Over seeded clusters of 1-8 devices (compute 1e8-1e11 FLOP/s,
    bandwidth 1e4-1e9 B/s, log-uniform) and a few batches: the same split
    and the same cost curve, for two archs and VGG-5."""
    rng = np.random.default_rng(0)
    profiles = [(tpartn.transformer_profile(treg.get(a), seq=64),
                 jpartn.transformer_profile(jreg.get(a), seq=64))
                for a in ("smollm-135m", "jamba-1.5-large-398b")]
    profiles.append((tpartn.cnn_profile(tcnn.vgg5_config()),
                     jpartn.cnn_profile(jcnn.vgg5_config())))
    for _ in range(20):
        n = int(rng.integers(1, 9))
        o_k = 10.0 ** rng.uniform(8, 11, size=n)
        b_k = 10.0 ** rng.uniform(4, 9, size=n)
        batch = int(rng.choice([1, 8, 32]))
        for tp, jp in profiles:
            assert tpartn.select_split(tp, o_k, b_k, batch=batch) == \
                jpartn.select_split(jp, o_k, b_k, batch=batch)
            assert tpartn.select_split(tp, o_k, b_k, min_server_units=2) == \
                jpartn.select_split(jp, o_k, b_k, min_server_units=2)
            tc = tpartn.split_costs(tp, o_k, b_k, batch=batch)
            jc = jpartn.split_costs(jp, o_k, b_k, batch=batch)
            assert tc.dtype == jc.dtype and np.array_equal(tc, jc)


def test_eq8_minimax_bruteforce():
    """tests/test_partition.py's check on the port: select_split is the
    brute-force argmin of Eq. 8."""
    prof = tpartn.transformer_profile(treg.get("smollm-135m"), seq=64)
    o_k = np.array([1e9, 2e9, 4e9])
    b_k = np.array([1e6, 5e6, 2e6])
    l_star = tpartn.select_split(prof, o_k, b_k)
    cum = np.cumsum(prof.flops)
    costs = [max(max(cum[l - 1] / o, prof.out_bytes[l - 1] / b)
                 for o, b in zip(o_k, b_k))
             for l in range(1, prof.n_units)]
    assert l_star == int(np.argmin(costs)) + 1


# ---------------------------------------------------------------------------
# (e) lm_batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
def test_lm_batches_exact(seed):
    toks = tsyn.lm_dataset(5000, 97, seed=seed)
    assert np.array_equal(toks, jsyn.lm_dataset(5000, 97, seed=seed))
    tit = tsyn.lm_batches(toks, 4, 16, seed=seed)
    jit_ = jsyn.lm_batches(toks, 4, 16, seed=seed)
    for _ in range(5):
        (tx, ty), (jx, jy) = next(tit), next(jit_)
        assert tx.dtype == jx.dtype and np.array_equal(tx, jx)
        assert ty.dtype == jy.dtype and np.array_equal(ty, jy)
    assert tx.shape == (4, 16) and np.array_equal(tx[:, 1:], ty[:, :-1])


# ---------------------------------------------------------------------------
# (f) what comes later is refused, naming its ROADMAP item
# ---------------------------------------------------------------------------

PLANE_ARGS = [("faults", "random", "A7.3a, the fault plane in the simulators"),
              ("fault_gate", False, "A7.3a, the fault plane in the simulators")]
REFUSALS = [(name, arg, value, item) for name in tbase.REGISTRY
            for arg, value, item in PLANE_ARGS]


@pytest.mark.parametrize("name,arg,value,item", REFUSALS,
                         ids=[f"{n}-{a}" for n, a, _, _ in REFUSALS])
def test_baseline_refuses_later_planes(name, arg, value, item):
    assert set(tbase.LATER) == {a for a, _, _ in PLANE_ARGS}
    with pytest.raises(NotImplementedError, match=item):
        _run(tbase, tsim, name, 4, 10, 10.0, **{arg: value})
