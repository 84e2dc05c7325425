"""The torch port's FedOptima round against the JAX package's.

Both start from the JAX init (converted leaf for leaf), run the same
batches under plans from the port's ``ControlPlane`` — which must equal
the JAX ``ControlPlane``'s plans — and must agree on both losses and on
every state leaf after every round, at 1e-4 (the reference's GTOL).  The
JAX step is built on a (1, 1) mesh with Auto axes: the repo's debug mesh
has Explicit axes under jax 0.9, on which the reference step does not
build.  Round 2 drops group 1 and round 3 restores it, so retention and
non-uniform staleness weights run too.  Smoke smollm-135m, mamba2-780m,
qwen3-32b (qk-norm, the untied lm_head on the server) and gemma2-27b
(local and global blocks, soft-caps, GeGLU), llama-3.2-vision-90b (gated
cross blocks reading the frontend, which the ring carries) and whisper-tiny
(the encoder prefix on frames, its next-frame aux MSE, the decoder on the
server; the ring carries the decoder tokens), qwen3-moe-235b-a22b and
llama4-maverick-400b-a17b (the MoE FFN, its load-balance loss in both
losses) run with their kernel op (flash attention, SSD) on and off, and
command-r-plus-104b with it off.  Two rows run smollm in bfloat16 in both
packages, held at the reference's bfloat16 tolerance, 2e-2.
The batch's ``frontend`` is drawn from the seed here, not zeros as the
drivers feed it, so the cross blocks and the encoder train on data.

This file holds the harness (``_rounds``, ``_check_round``, ``_close``,
``_tol_ratio``, ``_drive``), smollm's rows and the ``adamw`` witness (C4),
the control plane's and ``train.main``'s checks; each other family's rows,
witnesses and driver runs are in a file of its own,
``tests/test_torch_round_<family>.py``, so that ``--dist loadfile``
spreads them over the workers.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import registry as jreg
from repro.core import control_plane as jcp
from repro.core import fedopt_step as JF
from repro_torch.configs import registry as treg
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import control_plane as tcp
from repro_torch.core import fedopt_step as TF
from repro_torch.launch import train as ttrain

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-4
BF16_TOL = 2e-2    # the reference's bfloat16 tolerance (tests/test_kernels.py)
ROSTERS = [np.array([True, True]), np.array([True, False]),
           np.array([True, True])]


def _f32(x):
    """JAX's bfloat16 leaves as float32, as ``state_to_numpy`` gives the
    port's."""
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _close(got, want, what, tol=TOL):
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, _f32(w), atol=tol, rtol=tol, err_msg=what), got, want)


@functools.lru_cache(maxsize=1)
def _jax_step(cfg):
    """The JAX step, jitted, and its init state for ``cfg``.  Kept for the
    next call with the same config (a witness runs its row's rounds two or
    three times): the step takes no donated buffers and JAX arrays are
    immutable, so the cached state is the init state."""
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    jitted, _, s_spec, _ = JF.jit_train_step(cfg, mesh, donate=False)
    state = jax.jit(lambda: JF.init_train_state(jax.random.PRNGKey(0), cfg),
                    out_shardings=s_spec)()
    return jitted, state, s_spec


def _assert_plans_equal(pt, pj):
    for f in dataclasses.fields(pt):
        np.testing.assert_array_equal(np.asarray(getattr(pt, f.name)),
                                      np.asarray(getattr(pj, f.name)),
                                      err_msg=f.name)


def _rounds(arch, use_kernel, opts, perturb=None, resync=(),
            rosters=ROSTERS, patterns=None):
    """Both packages' rounds from the JAX init, in lockstep under equal
    plans: yields (round, port metrics, JAX metrics, port state, JAX
    state) as numpy after each round.  ``perturb`` edits the port's init
    state in place before the first round; after each round in ``resync``
    the port goes on from the JAX state instead of its own.  ``rosters``
    gives each round's active groups (their length is G), ``patterns``
    each round's (produce, reads) straggler patterns (None: uniform)."""
    G = len(rosters[0])
    kw = dict(l_split=1, n_groups=G, seq_len=16, per_group_batch=4, H=2,
              omega=2, use_kernel=use_kernel, **opts)
    dtype = kw.pop("param_dtype", "float32")
    jcfg = JF.FedStepConfig(arch=jreg.smoke_config(arch),
                            param_dtype=getattr(jax.numpy, dtype), **kw)
    tcfg = TF.FedStepConfig(arch=treg.smoke_config(arch),
                            param_dtype=getattr(torch, dtype), **kw)
    jitted, jstate, s_spec = _jax_step(jcfg)
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    if perturb is not None:
        perturb(tstate)
    step = TF.make_train_step(tcfg)
    jplane = jcp.ControlPlane(G, jcfg.omega, jcfg.H)
    tplane = tcp.ControlPlane(G, tcfg.omega, tcfg.H)
    rng = np.random.default_rng(0)
    H, b, S = 2, 2, 16
    for r, active in enumerate(rosters):
        produce, reads = patterns[r] if patterns is not None else \
            (None, None)
        pj = jplane.plan_round(active=active, produce=produce, reads=reads)
        pt = tplane.plan_round(active=active, produce=produce, reads=reads)
        _assert_plans_equal(pt, pj)
        for g in pt.retire:
            jplane.retain_group(g, JF.gather_group_state(jstate, g))
            tplane.retain_group(g, TF.gather_group_state(tstate, g))
        for g in pt.restore:
            jstate = JF.scatter_group_state(
                jstate, g, jplane.release_group(g)["params"], s_spec)
            tstate = TF.scatter_group_state(
                tstate, g, tplane.release_group(g)["params"])
        tokens = rng.integers(0, tcfg.arch.vocab, (G, H, b, S))
        labels = rng.integers(0, tcfg.arch.vocab, (G, H, b, S))
        jbatch = {"tokens": tokens.astype(np.int32),
                  "labels": labels.astype(np.int32), **pj.batch_fields()}
        tbatch = {"tokens": torch.from_numpy(tokens),
                  "labels": torch.from_numpy(labels),
                  **pt.batch_fields("cpu")}
        if tcfg.arch.frontend_len:
            frontend = rng.standard_normal(
                (G, H, b, tcfg.arch.frontend_len, tcfg.arch.d_model)) \
                .astype(np.float32)
            jbatch["frontend"] = frontend
            tbatch["frontend"] = torch.from_numpy(frontend)
        jstate, jm = jitted(jstate, jbatch)
        tstate, tm = step(tstate, tbatch)
        jplane.finish_round(active=active)
        tplane.finish_round(active=active)
        # copies: the port's step updates its state in place
        yield (r, {k: float(v) for k, v in tm.items()},
               {k: float(v) for k, v in jm.items()},
               jax.tree.map(np.copy, state_to_numpy(tstate)),
               jax.tree.map(np.asarray, jstate))
        if r in resync:
            tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")


def _check_round(arch, use_kernel, opts):
    """The body of every family's ``test_round_matches_jax``: both losses
    and every state leaf at ``TOL`` (bfloat16: ``BF16_TOL``) after each
    round, and where the untied head and the decoder live."""
    tol = BF16_TOL if opts.get("param_dtype") == "bfloat16" else TOL
    for r, tm, jm, tstate, jstate in _rounds(arch, use_kernel, opts):
        _close(tm, jm, f"round {r} metrics", tol)
        _close(tstate, jstate, f"round {r} state", tol)
    # an untied head lives on the server only: aggregation never sees it
    cfg = treg.smoke_config(arch)
    assert ("lm_head" in tstate["srv"]) == (not cfg.tie_embeddings)
    assert "lm_head" not in tstate["dev"]
    # an encoder prefix has no token embedding; the decoder is server-only
    encdec = bool(cfg.n_decoder_layers)
    assert ("embed" in tstate["dev"]) != encdec
    assert ("dec_blocks" in tstate["srv"]) == encdec


# smollm-135m's rows (``adamw`` last, so that its witness below shares the
# JAX step's compile); the other families' rows are in
# tests/test_torch_round_{ssd,dense,vision,whisper,moe,llama4,bf16,hybrid}.py
# (one file per worker under --dist loadfile)
@pytest.mark.parametrize("arch,use_kernel,opts", [
    ("smollm-135m", False, {}), ("smollm-135m", True, {}),
    ("smollm-135m", False, dict(server_accum=True, pipeline_acts=False)),
    ("smollm-135m", False, dict(agg_compress=True)),
    ("smollm-135m", False, dict(remat=True)),
    ("smollm-135m", False, dict(remat=False)),
    ("smollm-135m", False, dict(server_opt="adamw")),
], ids=["plain", "kernel", "accum-nopipe", "agg-compress", "remat-True",
        "remat-False", "adamw"])
def test_round_matches_jax(arch, use_kernel, opts):
    _check_round(arch, use_kernel, opts)


def _embed_out_grads(srv, arch, jarch, acts, labels):
    """embed_out's server gradient on one batch: torch float32, JAX
    float32 and torch float64 (the CE in float64 too), and the float64
    sum of |term| over the tokens for each element (g[v, d] = sum_t
    dlogits[t, v] * h[t, d])."""
    from repro.models import transformer as jtfm
    from repro_torch.models import transformer as ttfm
    from repro_torch.models.common import tree_map

    def tgrad(dtype):
        p = tree_map(lambda x: x.to(dtype).requires_grad_(), srv)
        if dtype == torch.float32:
            loss = ttfm.server_forward_loss(p, arch, acts, labels,
                                            remat=False)
        else:                      # the float64 value, one chunk
            h, _ = ttfm._run_stack(p["blocks"], arch, acts.to(dtype),
                                   positions=ttfm._positions(acts),
                                   use_kernel=False, remat=False)
            logits = ttfm.rmsnorm_apply(p["final_norm"], h) @ p["embed_out"].T
            loss = torch.nn.functional.cross_entropy(
                logits.reshape(-1, arch.vocab), labels.reshape(-1))
        return torch.autograd.grad(loss, p["embed_out"])[0].double().numpy()

    jp = jax.tree.map(jax.numpy.asarray, state_to_numpy(srv))
    gj = jax.grad(lambda q: jtfm.server_forward_loss(
        q, jarch, jax.numpy.asarray(acts.numpy()),
        jax.numpy.asarray(labels.numpy().astype(np.int32))))(jp)
    with torch.no_grad():
        p = tree_map(lambda x: x.double(), srv)
        h, _ = ttfm._run_stack(p["blocks"], arch, acts.double(),
                               positions=ttfm._positions(acts),
                               use_kernel=False, remat=False)
        h = ttfm.rmsnorm_apply(p["final_norm"], h).reshape(-1, arch.d_model)
        dlogits = (torch.softmax(h @ p["embed_out"].T, -1)
                   - torch.nn.functional.one_hot(labels.reshape(-1),
                                                 arch.vocab)) / h.shape[0]
        terms = (dlogits.abs().T @ h.abs()).numpy()
    return (tgrad(torch.float32), np.asarray(gj["embed_out"], np.float64),
            tgrad(torch.float64), terms)


def test_adamw_row_gap_is_float32_roundoff(monkeypatch):
    """Why the ``adamw`` row of ``test_round_matches_jax`` misses 1e-4 on
    one element (ROADMAP C4): the first server step with data (round 0,
    iteration 1) gives ``embed_out[157, 14]`` a gradient whose 64 terms
    cancel a hundred-thousandfold, so the few-ulp difference between the
    two device halves' activations moves it by ~3%, and Adam's first step
    (lr·g/(|g| + eps), |g| ~ 4 eps) turns that into 2e-4 on the param.

    Witnesses, on the row's data:
    - on the same inputs, torch's float32 gradient is as close to the
      float64 one as JAX's, and at that element the two float32 values
      differ by under a tenth of the gap the row sees;
    - that element's terms cancel: sum|term| / |g| > 1e4;
    - the two steps' activations differ by a few ulps, and torch's
      float32 gradient on JAX's activations closes most of the gap.
    """
    from repro_torch.models import transformer as ttfm
    from repro_torch.models.common import tree_map
    kw = dict(l_split=1, n_groups=2, seq_len=16, per_group_batch=4, H=2,
              omega=2, server_opt="adamw")
    jcfg = JF.FedStepConfig(arch=jreg.smoke_config("smollm-135m"), **kw)
    tcfg = TF.FedStepConfig(arch=treg.smoke_config("smollm-135m"), **kw)
    jitted, jstate, _ = _jax_step(jcfg)
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    seen = []
    forward = ttfm.server_forward_loss

    def record(srv, arch, acts, labels, **k):
        seen.append((tree_map(lambda x: x.detach().clone(), srv),
                     acts.clone(), labels.clone()))
        return forward(srv, arch, acts, labels, **k)
    monkeypatch.setattr(ttfm, "server_forward_loss", record)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tcfg.arch.vocab, (2, 2, 2, 16))
    labels = rng.integers(0, tcfg.arch.vocab, (2, 2, 2, 16))
    pt = tcp.ControlPlane(2, 2, 2).plan_round(active=ROSTERS[0])
    pj = jcp.ControlPlane(2, 2, 2).plan_round(active=ROSTERS[0])
    TF.make_train_step(tcfg)(tstate, {
        "tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels),
        **pt.batch_fields("cpu")})
    jstate, _ = jitted(jstate, {"tokens": tokens.astype(np.int32),
                                "labels": labels.astype(np.int32),
                                **pj.batch_fields()})
    monkeypatch.undo()
    assert not seen[0][1].any()      # iteration 0 reads an empty slot
    srv, acts, lab = seen[1]         # iteration 1 reads slot 0
    g32, gj32, g64, terms = _embed_out_grads(srv, tcfg.arch, jcfg.arch,
                                             acts, lab)
    e = (157, 14)
    # float32 is as close to float64 in the port as in the reference
    err = {k: np.abs(g - g64).max() for k, g in (("torch", g32),
                                                  ("jax", gj32))}
    assert err["torch"] <= 1e-6 * np.abs(g64).max()
    assert err["torch"] <= 2 * err["jax"]
    assert terms[e] / abs(g64[e]) > 1e4
    # JAX's own step: its ring slot 0 holds the activations iteration 1
    # read, and Adam's first moment is (1 - b1) g with b1 = 0.9
    jacts = torch.from_numpy(np.array(jstate["act_buf"]["acts"][0]))
    assert np.array_equal(np.asarray(jstate["act_buf"]["labels"][0]),
                          lab.numpy())
    assert torch.allclose(jacts, acts, rtol=0, atol=1e-6 * acts.abs().max())
    g_jax_step = float(np.asarray(jstate["srv_opt"]["mu"]["embed_out"])[e]) \
        / 0.1
    g_on_jax_acts = _embed_out_grads(srv, tcfg.arch, jcfg.arch, jacts,
                                     lab)[0][e]
    gap = abs(g32[e] - g_jax_step)              # what the adamw row sees
    assert abs(g32[e] - gj32[e]) < 0.1 * gap     # not the gradient code
    assert abs(g_on_jax_acts - g_jax_step) < 0.5 * gap   # the activations
    print(f"embed_out[157, 14] gradient: float64 {g64[e]:.6e}, torch f32 "
          f"{g32[e]:.6e}, JAX f32 {gj32[e]:.6e} (same inputs); terms "
          f"sum|t| {terms[e]:.6e} = {terms[e] / abs(g64[e]):.3e} x |g|; "
          f"max err vs float64 torch {err['torch']:.3e} JAX {err['jax']:.3e}"
          f" of max|g| {np.abs(g64).max():.3e}; JAX step {g_jax_step:.6e}, "
          f"torch f32 on JAX's acts {g_on_jax_acts:.6e}; acts max diff "
          f"{float((jacts - acts).abs().max()):.3e} of max "
          f"{float(acts.abs().max()):.3e}")


def _tol_ratio(got, want):
    """max |got - want| / (TOL + TOL |want|): above 1 fails ``_close``."""
    return float(np.max(np.abs(got - want) / (TOL + TOL * np.abs(want))))


@pytest.mark.parametrize("omega,policy", [(1, "counter"), (2, "counter"),
                                          (3, "fifo")])
def test_control_plane_plans_match_jax(omega, policy):
    G, H = 4, 3
    jplane = jcp.ControlPlane(G, omega, H, policy=policy)
    tplane = tcp.ControlPlane(G, omega, H, policy=policy)
    rng = np.random.default_rng(omega)
    for _ in range(12):
        active = rng.random(G) >= 0.3
        active[rng.integers(0, G)] = True
        produce = rng.random((H, G)) < 0.8
        reads = rng.random(H) < 0.9
        pj = jplane.plan_round(active=active, produce=produce, reads=reads)
        pt = tplane.plan_round(active=active, produce=produce, reads=reads)
        _assert_plans_equal(pt, pj)
        for g in pt.retire:
            jplane.retain_group(g, None)
            tplane.retain_group(g, None)
        for g in pt.restore:
            jplane.release_group(g)
            tplane.release_group(g)
        jplane.finish_round(active=active)
        tplane.finish_round(active=active)
        fields = pt.batch_fields("cpu")
        np.testing.assert_array_equal(fields["send_mask"].numpy(),
                                      pt.send_mask)
        assert tplane.within_cap and jplane.within_cap
    assert tplane.consumption == jplane.consumption
    for attr in ("peak_buffered", "peak_live_slots", "n_accepted",
                 "n_rejected"):
        assert getattr(tplane, attr) == getattr(jplane, attr), attr
    assert (tplane.version, list(tplane.versions)) == \
        (jplane.version, list(jplane.versions))


SMOKE_ARGS = ["--device", "cpu", "--batch", "4", "--H", "2", "--seq-len",
              "16", "--groups-per-shard", "2"]


def test_driver_runs_rounds_with_retention(capsys):
    out = ttrain.main(SMOKE_ARGS + ["--rounds", "2", "--p-drop", "0.5",
                                    "--use-kernel"])
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("round")]
    assert len(lines) == 2 and len(out["history"]) == 2
    assert all(np.isfinite(m[k]) for m in out["history"]
               for k in ("d_loss", "s_loss"))
    assert "active 1/2" in lines[0]      # seed 0 drops group 1 in round 1


REFUSED = [  # flags, the error, what its message must name
    (["--window", "0"], ValueError, "window must be >= 1"),
    (["--pool-cap", "-1"], ValueError, "pool_cap must be >= 0"),
    # pod --faults runs since A7.3b: a schedule with crashes or tears
    # needs a store to recover from
    (["--faults", "random"], ValueError, "--ckpt-dir is required"),
    # sim mode runs since A6a; its fault plane is A7.3a's
    (["--mode", "sim", "--faults", "random"], NotImplementedError,
     "A7.3a, the fault plane in the simulators"),
    (["--faults", "bogus"], ValueError, "unknown --faults spec"),
    (["--window", "-1"], ValueError, "window must be >= 1"),
]


@pytest.mark.parametrize("flags,error,text", REFUSED,
                         ids=[f"flags{i}" for i in range(len(REFUSED))])
def test_driver_refuses_later_slices(flags, error, text):
    with pytest.raises(error, match=text):
        ttrain.main(SMOKE_ARGS + ["--rounds", "1"] + flags)


def _drive(arch, *flags):
    """Two smoke rounds of ``arch`` through ``train.main`` with the kernel
    ops (their plain versions on the CPU): finite losses.  Returns the
    driver's result."""
    out = ttrain.main(SMOKE_ARGS + ["--rounds", "2", "--arch", arch,
                                    "--use-kernel", *flags])
    assert len(out["history"]) == 2
    assert all(np.isfinite(m[k]) for m in out["history"]
               for k in ("d_loss", "s_loss"))
    return out


def test_driver_refuses_other_archs():
    assert "no-such-arch-7b" not in {**treg.ARCHS, **jreg.ARCHS}
    with pytest.raises(KeyError):
        ttrain.main(SMOKE_ARGS + ["--rounds", "1", "--arch",
                                  "no-such-arch-7b"])


def test_scheduler_and_flow_control_match_jax():
    """Random put/get/drain/remove and send/enqueue/dequeue/leave sequences
    give the same picks, counters and token state in both packages."""
    from repro.core import flow_control as jfc
    from repro.core import scheduler as jsc
    from repro_torch.core import flow_control as tfc
    from repro_torch.core import scheduler as tsc
    rng = np.random.default_rng(7)
    for policy in ("counter", "fifo"):
        js, ts = jsc.TaskScheduler(4, policy), tsc.TaskScheduler(4, policy)
        jf, tf = jfc.FlowController(omega=3), tfc.FlowController(omega=3)
        for k in range(4):
            jf.register(k)
            tf.register(k)
        for _ in range(300):
            op, k, s = rng.integers(0, 6), int(rng.integers(0, 4)), \
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
            elif op == 3:
                js.remove_device(k)
                ts.remove_device(k)
            elif op == 4 and jf.can_send(k):
                jf.mark_sent(k)
                tf.mark_sent(k)
                assert jf.on_enqueue(k) == tf.on_enqueue(k)
            elif op == 5:
                if rng.random() < 0.2:
                    jf.on_device_left(k)
                    tf.on_device_left(k)
                    jf.register(k)
                    tf.register(k)
                else:
                    jf.on_dequeue(k)
                    tf.on_dequeue(k)
            assert js.counters == ts.counters
            assert js.has_activation == ts.has_activation
            assert (jf.sender_active, jf.buffered, jf.inflight_by,
                    list(jf.grants)) == \
                (tf.sender_active, tf.buffered, tf.inflight_by,
                 list(tf.grants))
            assert jf.within_cap == tf.within_cap


def test_eviction_policies_match_jax():
    from repro.memory import policy as jpol
    from repro_torch.memory import policy as tpol
    rng = np.random.default_rng(3)
    for name in ("lru", "share"):
        jp, tp = jpol.make_eviction_policy(name), \
            tpol.make_eviction_policy(name)
        for _ in range(20):
            groups = {s: set(rng.choice(6, rng.integers(1, 4), replace=False))
                      for s in range(5)}
            shares = rng.random(6)
            kw = dict(groups_of=lambda s: groups[s],
                      share=lambda g: shares[g])
            touch = list(rng.integers(0, 4, 5))
            assert jp.victim(list(groups), touch=touch, **kw) == \
                tp.victim(list(groups), touch=touch, **kw)
            assert jp.fill_order(list(groups), **kw) == \
                tp.fill_order(list(groups), **kw)
    with pytest.raises(ValueError):
        tpol.make_eviction_policy("mru")


def test_lm_dataset_and_identity_schedule_match_jax():
    from repro.data.synthetic import lm_dataset as jlm
    from repro_torch.data.synthetic import lm_dataset as tlm
    np.testing.assert_array_equal(tlm(5000, 211, seed=3, structure=0.8),
                                  jlm(5000, 211, seed=3, structure=0.8))
    kw = dict(l_split=1, n_groups=3, seq_len=8, per_group_batch=4, H=4,
              omega=3)
    want = JF.identity_schedule(
        JF.FedStepConfig(arch=jreg.smoke_config("smollm-135m"), **kw))
    got = TF.identity_schedule(
        TF.FedStepConfig(arch=treg.smoke_config("smollm-135m"), **kw), "cpu")
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_quant_matches_jax():
    x = np.random.default_rng(5).standard_normal((3, 50, 7)).astype(np.float32)
    jq, js = JF._quant(x)
    tq, ts = TF._quant(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(TF._dequant((tq, ts)).numpy(),
                                  np.asarray(JF._dequant((jq, js))))


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-780m", "gemma2-27b",
                                  "llama-3.2-vision-90b", "whisper-tiny",
                                  "qwen3-moe-235b-a22b",
                                  "llama4-maverick-400b-a17b",
                                  "jamba-1.5-large-398b"])
def test_chip_smoke_reckons_kernel_launches(arch, monkeypatch):
    """``chip_smoke.launches_per_round``, which the card holds each path's
    counted launches to, against the kernel calls of one smoke round on the
    CPU (each wrapper runs its plain version there): self-attention and
    Mamba blocks on both halves, each kernel family counted from its own
    blocks (jamba runs both), whisper's decoder self-attention on the
    server, never a cross block or the aux block."""
    import importlib.util
    from pathlib import Path

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd as ssd_k
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = TF.FedStepConfig(arch=treg.smoke_config(arch), l_split=1,
                           n_groups=2, seq_len=16, per_group_batch=4, H=2,
                           omega=1, use_kernel=True)
    calls = {}
    for name in (*fa.launches, *ssd_k.launches):
        inner = getattr(ref, name)
        monkeypatch.setattr(ref, name, lambda *a, _n=name, _f=inner, **k: (
            calls.__setitem__(_n, calls.get(_n, 0) + 1), _f(*a, **k))[1])
    state = TF.init_train_state(torch.Generator().manual_seed(0), cfg)
    batch = ttrain._make_batch(
        cfg, ttrain._group_streams(cfg), np.random.default_rng(0),
        tcp.ControlPlane(2, 1, 2).plan_round(), "cpu")
    TF.make_train_step(cfg)(state, batch)
    n, want = cs.launches_per_round(cfg, (fa, ssd_k))
    assert n > 0 and {k: calls.get(k, 0) for k in want} == want
