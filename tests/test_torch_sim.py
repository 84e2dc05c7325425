"""The torch port's sim-mode FedOptima learner against the JAX package's, on
the CPU: the paper's testbed models (VGG-5, MobileNetV3ish, Transformer-6
and a 2-layer Transformer-12) with their aux variants and split losses,
the numpy data helpers and the staleness-weighted aggregator (exact), the
event simulator with no hooks (bit-identical over a grid of policies, ω,
spill budgets and cluster sizes), the learner driven through the
simulator, and ``run_sim``.  Then ``tests/test_simulation.py``'s
properties on the port, and the refusals of the planes that come later.

Model tolerance: the reference's own gradient tolerance, 1e-4
(``tests/test_kernel_grads.py`` GTOL), as in ``tests/test_torch_model.py``;
float32 convolutions and matmuls of XLA and of torch on the CPU differ in
their last bits.  Everything the simulator counts is compared exactly.
"""
import argparse
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import aggregator as jagg
from repro.core import control_plane as jcp
from repro.core import learning as jlearn
from repro.core import simulation as jsim
from repro.data import partitioner as jpart
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.launch import train as jtrain
from repro.models import cnn as jcnn
from repro.models import text_classifier as jtext
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import aggregator as tagg
from repro_torch.core import control_plane as tcp
from repro_torch.core import learning as tlearn
from repro_torch.core import simulation as tsim
from repro_torch.data import partitioner as tpart
from repro_torch.data import pipeline as tpipe
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import train as ttrain
from repro_torch.models import cnn as tcnn
from repro_torch.models import text_classifier as ttext
from repro_torch.models.common import tree_leaves, tree_map

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-4
B = 4


def _close(got, want, tol=TOL):
    got = [t.detach().numpy() for t in tree_leaves(got)]
    want = [np.asarray(w) for w in jax.tree.leaves(want)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol)


def _port(tree):
    return state_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _init(tmod, cfg, seed):
    """Params drawn by the port, as numpy (the JAX init, op by op, takes
    tens of seconds for MobileNetV3ish on one core)."""
    return state_to_numpy(tmod.init_params(torch.Generator().manual_seed(seed),
                                           cfg))


def _grads(loss_of, tree):
    """(loss, d loss / d tree's leaves) of the port, through autograd."""
    live = [t.detach().requires_grad_() for t in tree_leaves(tree)]
    it = iter(live)
    loss = loss_of(tree_map(lambda _: next(it), tree))
    return loss, torch.autograd.grad(loss, live)


MODELS = {
    "vgg5": (jcnn, tcnn, lambda m: m.vgg5_config(img_size=32)),
    "mobilenetv3ish": (jcnn, tcnn, lambda m: m.mobilenetv3ish_config(
        n_classes=10, img_size=32)),
    "transformer6": (jtext, ttext, lambda m: m.transformer6_config(
        vocab=64, seq_len=16)),
    # Transformer-12's layer (50 heads of dim 2), two of them
    "transformer12-2l": (jtext, ttext, lambda m: m.transformer6_config(
        vocab=96, seq_len=16, n_heads=50, n_layers=2)),
}


def _inputs(jmod, cfg, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, cfg.n_classes, size=B).astype(np.int32)
    if jmod is jcnn:
        x = rng.normal(size=(B, cfg.img_size, cfg.img_size,
                             cfg.in_channels)).astype(np.float32)
        return x, y, torch.from_numpy(x)
    x = rng.integers(0, cfg.vocab, size=(B, cfg.seq_len)).astype(np.int32)
    return x, y, torch.from_numpy(x).long()


@pytest.mark.parametrize("name", list(MODELS))
def test_model_matches_jax(name):
    """Forward logits, loss, gradients and accuracy of the whole model."""
    jmod, tmod, make = MODELS[name]
    jcfg, tcfg = make(jmod), make(tmod)
    jp = _init(tmod, tcfg, 1)
    tp = _port(jp)
    x, y, tx = _inputs(jmod, jcfg)
    ty = torch.from_numpy(y).long()

    def jloss(p):
        logits = jmod.forward(p, jcfg, x)
        return jmod.ce_loss(logits, y), logits

    (jl, jlogits), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    _close(tmod.forward(tp, tcfg, tx), jlogits)
    tl, tg = _grads(lambda p: tmod.loss_fn(p, tcfg, tx, ty), tp)
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=TOL,
                               rtol=TOL)
    _close(list(tg), jax.tree.leaves(jg))
    assert float(tmod.accuracy(tp, tcfg, tx, ty)) == \
        float(np.mean(np.argmax(np.asarray(jlogits), -1) == y))


AUX_CASES = [(model, l_split, variant)
             for model, l_split in (("vgg5", 2), ("vgg5", 5), ("transformer6", 2))
             for variant in ("default", "classifier_only", "deep")] + \
    [("mobilenetv3ish", 4, "default")]


@pytest.mark.parametrize("model,l_split,variant", AUX_CASES,
                         ids=[f"{m}-{l}-{v}" for m, l, v in AUX_CASES])
def test_device_train_loss_aux_variants_match_jax(model, l_split, variant):
    """device_train_loss with each aux variant, at a conv-like split (vgg5
    at 2, mobilenet's bneck at 4), an fc split (vgg5 at 5) and an encoder
    split: loss, acts, and the gradients of the device half and aux."""
    jmod, tmod, make = MODELS[model]
    jcfg, tcfg = make(jmod), make(tmod)
    jp = _init(tmod, tcfg, 2)
    jdev, _ = jmod.split_params(jp, l_split)
    jaux, jspec = jmod.make_aux_params(jax.random.PRNGKey(3), jcfg, l_split,
                                       variant)
    _, tspec = tmod.make_aux_params(torch.Generator().manual_seed(0), tcfg,
                                    l_split, variant)
    assert tspec == jspec
    x, y, tx = _inputs(jmod, jcfg, seed=1)
    ty = torch.from_numpy(y).long()

    def jloss(dev, aux):
        return jmod.device_train_loss(dev, aux, jspec, jcfg, x, y, l_split)

    (jl, jacts), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jdev, jaux)
    tdev, taux = _port(jdev), _port(jaux)
    acts = []

    def tloss(both):
        loss, a = tmod.device_train_loss(both[0], both[1], tspec, tcfg, tx,
                                         ty, l_split)
        acts.append(a)
        return loss

    tl, tg = _grads(tloss, [tdev, taux])
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=TOL,
                               rtol=TOL)
    _close(acts[0], jacts)
    _close(list(tg), jax.tree.leaves(jg))


SERVER_CASES = [("vgg5", 1), ("vgg5", 4), ("mobilenetv3ish", 4),
                ("transformer6", 3)]


@pytest.mark.parametrize("model,l_split", SERVER_CASES,
                         ids=[f"{m}-{l}" for m, l in SERVER_CASES])
def test_server_forward_loss_matches_jax(model, l_split):
    """The server half on the device half's activations: loss and the
    server params' gradients."""
    jmod, tmod, make = MODELS[model]
    jcfg, tcfg = make(jmod), make(tmod)
    jp = _init(tmod, tcfg, 4)
    jdev, jsrv = jmod.split_params(jp, l_split)
    x, y, _ = _inputs(jmod, jcfg, seed=2)
    jacts = np.array(jax.jit(lambda d: jmod.forward(d, jcfg, x, upto=l_split))(
        jdev))
    jl, jg = jax.jit(jax.value_and_grad(lambda s: jmod.server_forward_loss(
        s, jcfg, jacts, y, l_split)))(jsrv)
    tl, tg = _grads(lambda s: tmod.server_forward_loss(
        s, tcfg, torch.from_numpy(jacts), torch.from_numpy(y).long(),
        l_split), _port(jsrv))
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=TOL,
                               rtol=TOL)
    _close(list(tg), jax.tree.leaves(jg))


# ---------------------------------------------------------------------------
# data helpers and the aggregator: exact
# ---------------------------------------------------------------------------

def test_classification_dataset_and_partition_exact():
    jd = jsyn.classification_dataset(600, 10, img_size=8, seed=3)
    td = tsyn.classification_dataset(600, 10, img_size=8, seed=3)
    assert np.array_equal(td.x, jd.x) and np.array_equal(td.y, jd.y)
    assert td.x.dtype == jd.x.dtype and td.y.dtype == jd.y.dtype
    for K, alpha in ((4, 0.5), (7, 0.1)):
        jp = jpart.dirichlet_partition(jd.y, K, alpha=alpha, seed=5)
        tp = tpart.dirichlet_partition(td.y, K, alpha=alpha, seed=5)
        assert all(np.array_equal(a, b) for a, b in zip(tp, jp))
        assert np.array_equal(tpart.partition_stats(td.y, tp),
                              jpart.partition_stats(jd.y, jp))


def test_device_dataset_exact_with_restore():
    d = jsyn.classification_dataset(50, 4, img_size=4, seed=1)
    jds = jpipe.DeviceDataset(d.x[:23], d.y[:23], batch=8, seed=2)
    tds = tpipe.DeviceDataset(d.x[:23], d.y[:23], batch=8, seed=2)
    for _ in range(7):
        (jx, jy), (tx, ty) = jds.next_batch(), tds.next_batch()
        assert np.array_equal(tx, jx) and np.array_equal(ty, jy)
    assert tds.state() == jds.state()
    tiny = tpipe.DeviceDataset(d.x[:5], d.y[:5], batch=8, seed=4)
    jtiny = jpipe.DeviceDataset(d.x[:5], d.y[:5], batch=8, seed=4)
    assert all(np.array_equal(a, b)
               for a, b in zip(tiny.next_batch(), jtiny.next_batch()))
    saved = tds.state()
    want = [tds.next_batch()[1] for _ in range(3)]
    fresh = tpipe.DeviceDataset(d.x[:23], d.y[:23], batch=8, seed=2)
    fresh.restore(saved)
    jfresh = jpipe.DeviceDataset(d.x[:23], d.y[:23], batch=8, seed=2)
    jfresh.restore(saved)
    for w in want:
        assert np.array_equal(fresh.next_batch()[1], w)
        assert np.array_equal(jfresh.next_batch()[1], w)


def test_async_aggregator_sequence_exact():
    """A sequence of arrivals at staleness 0..3 with a cap of 1, so some
    are rejected: the same weights, counters and bits as the reference."""
    rng = np.random.default_rng(7)
    tree0 = [{"w": rng.normal(size=(3, 4)).astype(np.float32)},
             {"b": rng.normal(size=5).astype(np.float32)}]
    aux0 = {"h": rng.normal(size=(4, 2)).astype(np.float32)}
    jag = jagg.AsyncAggregator(theta_d=tree0, theta_aux=aux0, max_delay=1)
    tag = tagg.AsyncAggregator(theta_d=_port(tree0), theta_aux=_port(aux0),
                               max_delay=1)
    for lag in (0, 0, 1, 0, 3, 2, 2, 5, 1):
        t_k = max(tag.version - lag, 0)
        d = jax.tree.map(lambda x: (x + rng.normal(size=x.shape)).astype(
            np.float32), tree0)
        a = jax.tree.map(lambda x: (x * 0.5).astype(np.float32), aux0)
        assert tag.aggregate(_port(d), _port(a), t_k) == \
            jag.aggregate(d, a, t_k)
        assert (tag.version, tag.n_accepted, tag.n_rejected) == \
            (jag.version, jag.n_accepted, jag.n_rejected)
        _close(tag.theta_d, jag.theta_d, tol=0.0)
        _close(tag.theta_aux, jag.theta_aux, tol=0.0)
    assert 0 < tag.n_rejected < tag.n_accepted
    _close(tagg.fedasync_update(_port(tree0), _port(d), 2),
           jagg.fedasync_update(tree0, d, 2), tol=0.0)


# ---------------------------------------------------------------------------
# the event simulator with no hooks: bit-identical
# ---------------------------------------------------------------------------

# run_sim's costs with a slower server, so the buffers fill and the spill
# budget is used in part of the grid
GRID_MODEL = dict(dev_fwd_flops=2e9, dev_bwd_flops=4e9, full_fwd_flops=6e9,
                  srv_flops_per_batch=2.4e11, act_bytes=2e6,
                  dev_model_bytes=1e6, full_model_bytes=4e6, batch_size=32)
RUN_SIM_MODEL = dict(GRID_MODEL, srv_flops_per_batch=1.2e10)
GRID = [(policy, omega, pool, K) for policy in ("counter", "fifo")
        for omega in (1, 2, 8) for pool in (0, omega) for K in (4, 8)]


def _run_both(K, duration, *, policy, omega, pool_cap, hooks=(None, None),
              model=GRID_MODEL):
    """[(Metrics, ControlPlane)] of the JAX simulator, then the port's."""
    out = []
    for sim, cp, hk in ((jsim, jcp, hooks[0]), (tsim, tcp, hooks[1])):
        control = cp.ControlPlane.for_sim(K, omega, policy=policy,
                                          pool_cap=pool_cap)
        m = sim.simulate_fedoptima(
            sim.SimModel(**model), sim.heterogeneous_cluster(K),
            duration=duration, omega=omega, H=10, policy=policy,
            pool_cap=pool_cap, control=control, hooks=hk)
        out.append((m, control))
    return out


def _assert_metrics_equal(tm, jm):
    for f in dataclasses.fields(tm):
        got, want = getattr(tm, f.name), getattr(jm, f.name)
        if f.name == "profiles":
            assert got.summary() == want.summary()
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


@pytest.mark.parametrize("policy,omega,pool,K", GRID,
                         ids=[f"{p}-w{o}-pool{c}-K{k}" for p, o, c, k in GRID])
def test_simulator_bit_identical(policy, omega, pool, K):
    (jm, jc), (tm, tc) = _run_both(K, 300.0, policy=policy, omega=omega,
                                   pool_cap=pool)
    _assert_metrics_equal(tm, jm)
    assert tc.memory_summary() == jc.memory_summary()
    assert list(tc.versions) == list(jc.versions)
    assert (tc.version, tc.n_accepted, tc.n_rejected) == \
        (jc.version, jc.n_accepted, jc.n_rejected)
    assert tm.max_buffered <= omega + pool


def test_simulator_grid_uses_the_spill_budget():
    """The grid's model fills the buffers: with a pool, some cells admit
    past ω (so the pool_cap cells test the spill accounting)."""
    (_, jc), (_, tc) = _run_both(4, 150.0, policy="counter", omega=1,
                                 pool_cap=1)
    assert tc.memory_summary()["spills"] > 0
    assert tc.memory_summary() == jc.memory_summary()


# ---------------------------------------------------------------------------
# the learner through the simulator
# ---------------------------------------------------------------------------

def _datasets(pkg_syn, pkg_part, pkg_pipe, K, img):
    data = pkg_syn.classification_dataset(512, 10, img_size=img, seed=0)
    parts = pkg_part.dirichlet_partition(data.y, K, alpha=0.5, seed=0)
    return data, [pkg_pipe.DeviceDataset(data.x[ix], data.y[ix], batch=32,
                                         seed=g)
                  for g, ix in enumerate(parts)]


def test_learner_through_simulator_matches_jax():
    """VGG-5 at 8x8, K=4, 40 s simulated, from the JAX learner's init: the
    hook counts are equal and every device's params, the aggregator's, the
    aux and the server params agree at 1e-4."""
    K, img = 4, 8
    jcfg, tcfg = jcnn.vgg5_config(img_size=img), tcnn.vgg5_config(img_size=img)
    _, jds = _datasets(jsyn, jpart, jpipe, K, img)
    _, tds = _datasets(tsyn, tpart, tpipe, K, img)
    jl = jlearn.FedOptimaLearner(jlearn.ModelAdapter(jcnn, jcfg), jds, 1)
    init = (_port(jl.dev[0]), _port(jl.srv), _port(jl.aux[0]))
    tl = tlearn.FedOptimaLearner(tlearn.ModelAdapter(tcnn, tcfg), tds, 1,
                                 device="cpu", init=init)
    (jm, _), (tm, _) = _run_both(K, 40.0, hooks=(jl, tl), policy="counter",
                                 omega=8, pool_cap=8, model=RUN_SIM_MODEL)
    _assert_metrics_equal(tm, jm)
    assert (tl.dev_steps, tl.srv_steps, tl.consumed, tl.versions) == \
        (jl.dev_steps, jl.srv_steps, jl.consumed, jl.versions)
    assert (tl.agg.version, tl.agg.n_accepted, tl.agg.n_rejected) == \
        (jl.agg.version, jl.agg.n_accepted, jl.agg.n_rejected)
    assert tl.dev_steps * 32 == tm.dev_samples
    assert tl.srv_steps == tm.srv_batches > 0
    for k in range(K):
        _close(tl.dev[k], jl.dev[k])
        _close(tl.aux[k], jl.aux[k])
    _close(tl.agg.theta_d, jl.agg.theta_d)
    _close(tl.agg.theta_aux, jl.agg.theta_aux)
    _close(tl.srv, jl.srv)


# ---------------------------------------------------------------------------
# run_sim
# ---------------------------------------------------------------------------

def _sim_args(**kw):
    base = dict(mode="sim", devices=4, duration=20.0, seed=0, omega=None,
                H=None, policy="counter", max_delay=16, pool_cap=None,
                fleet_trace=None, fleet_tiers=None, selection=None,
                faults=None, trace=None, sanitize=False, metrics_every=0,
                metrics_out=None, ckpt_dir=None)
    return argparse.Namespace(**{**base, **kw})


def test_run_sim_matches_jax(capsys):
    """Everything run_sim returns but the accuracy is learner-independent
    and equal to the JAX run_sim's; the lines it prints are the same up to
    the accuracy; the port's accuracy is above chance (10 classes)."""
    want = jtrain.run_sim(_sim_args())
    jlines = capsys.readouterr().out.splitlines()
    got = ttrain.run_sim(_sim_args(device="cpu"))
    tlines = capsys.readouterr().out.splitlines()
    assert set(got) == set(want)
    for key in set(want) - {"accuracy"}:
        assert got[key] == want[key], key
    assert got["accuracy"] > 0.1
    strip = lambda line: line.split("train-set acc")[0]
    assert [strip(l) for l in tlines] == [strip(l) for l in jlines]
    assert len(tlines) == 5


# ---------------------------------------------------------------------------
# tests/test_simulation.py's properties, on the port
# ---------------------------------------------------------------------------

MODEL = tsim.SimModel(dev_fwd_flops=1e9, dev_bwd_flops=2e9,
                      full_fwd_flops=5e9, srv_flops_per_batch=8e9,
                      act_bytes=1e6, dev_model_bytes=4e6,
                      full_model_bytes=2e7, batch_size=32)
CLUSTER = tsim.heterogeneous_cluster(8)
DUR = 400.0


def test_deterministic_given_seed():
    a = tsim.simulate_fedoptima(MODEL, CLUSTER, duration=100.0, seed=3)
    b = tsim.simulate_fedoptima(MODEL, CLUSTER, duration=100.0, seed=3)
    assert a.dev_samples == b.dev_samples and a.bytes_up == b.bytes_up


def test_omega_bounds_buffer():
    """§3.4.1: peak buffered activations never exceed ω."""
    for omega in (1, 4, 16):
        m = tsim.simulate_fedoptima(MODEL, CLUSTER, duration=DUR, omega=omega)
        assert m.max_buffered <= omega


def test_larger_omega_no_less_server_work():
    served = [tsim.simulate_fedoptima(MODEL, CLUSTER, duration=DUR,
                                      omega=o).srv_batches for o in (1, 8)]
    assert served[1] >= served[0]


# ---------------------------------------------------------------------------
# what comes later is refused, naming its ROADMAP item
# ---------------------------------------------------------------------------

PLANE_ARGS = [("faults", "random", "A7.3a, the fault plane in the simulators"),
              ("fault_gate", False, "A7.3a, the fault plane in the simulators")]


@pytest.mark.parametrize("name,value,item", PLANE_ARGS,
                         ids=[a for a, _, _ in PLANE_ARGS])
def test_simulator_refuses_later_planes(name, value, item):
    assert set(tsim.LATER) == {a for a, _, _ in PLANE_ARGS}
    with pytest.raises(NotImplementedError, match=item):
        tsim.simulate_fedoptima(MODEL, CLUSTER, duration=10.0,
                                **{name: value})


SIM_ARGS = ["--mode", "sim", "--device", "cpu", "--devices", "2",
            "--duration", "1"]
SIM_REFUSED = [(["--faults", "random"], "A7.3a, the fault plane in the simulators")]


@pytest.mark.parametrize("flags,item", SIM_REFUSED,
                         ids=[f[0] for f, _ in SIM_REFUSED])
def test_sim_mode_refuses_later_flags(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        ttrain.main(SIM_ARGS + flags)


def test_sim_mode_ignores_ckpt_dir(tmp_path):
    """As in the JAX driver, sim mode takes ``--ckpt-dir`` and writes
    nothing there: the run is the one without it."""
    d = tmp_path / "ckpt"
    plain = ttrain.main(SIM_ARGS)
    with_dir = ttrain.main(SIM_ARGS + ["--ckpt-dir", str(d)])
    assert not d.exists()
    for k in ("accuracy", "srv_idle", "dev_idle", "throughput", "memory",
              "consumed"):
        assert with_dir[k] == plain[k], k


def test_pool_cap_refused_on_the_pod_path_only():
    """Since the tiered store (A7.1) the pod path takes a pool too, in
    slots (ω·G + pool·G flow units); both paths refuse a negative one."""
    cp = tcp.ControlPlane(2, 1, pool_cap=1)
    assert (cp.flow.cap, cp.memory_summary()["spills"]) == (4, 0)
    with pytest.raises(ValueError, match="pool_cap must be >= 0"):
        ttrain.main(["--device", "cpu", "--rounds", "1", "--pool-cap", "-1"])
    cp = tcp.ControlPlane.for_sim(3, 2, pool_cap=2)
    assert (cp.flow.cap, cp.memory_summary()["spills"]) == (4, 0)
