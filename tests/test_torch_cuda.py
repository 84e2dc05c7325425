"""Card-only tests of the torch port: each CUDA kernel against its plain
version, and smoke rounds (smollm-135m, mamba2-780m) with the kernels
against the plain path.  This file imports no JAX, so it runs on the
machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

It also holds serving's forward-only SSD entry (``ops.ssd_prefill``)
against the plain scan's final state, and ``attention_decode`` on the card
against the CPU.

It also holds the pipelined executor to what only the card shows: its
handles keep their round across in-place updates, window 2 overlaps host
work with the card's, a round's dispatch makes no host sync, a traced
round's ``mesh`` span comes from its CUDA events, and the tiered store's
spill and fill of a ring slot stay on the stream.

It also runs the sim-mode FedOptima learner, and each baseline's learner,
on the card against the CPU (``chip_smoke.sim_card_vs_cpu`` at a tiny
size).

The attention rows include head dim 128 with a GQA group of 8 (qwen3-32b)
and with gemma2-27b's logit cap of 50 and a sliding window that cuts.

Each test decides inside itself whether a card exists and skips without
one (the CUDA kernels have no CPU mode).  Tolerances are chip_smoke.py's:
flash attention f32 forward 1e-4, f32 gradients 5e-4 + 1e-3·|ref| (sums
over 1024 keys in another order), bf16 3e-2; SSD 1e-4·scale +
1e-3·|ref|, the scale of each element's head from ``ref.ssd_scales`` (ddt
cancels two terms up to |A| = 48 times its size, dA sums terms that
cancel, and float32 rounds the chunk's log-decay |L| ~ 1e3 to ~1e-4).
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as treg
from repro_torch.core import control_plane as tcp
from repro_torch.core import fedopt_step as TF
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd as ssd_k
from repro_torch.launch import train as ttrain
from repro_torch.models.common import tree_leaves, tree_map


CUDA_CASES = [
    ((2, 1024, 1024, 9, 3, 64), dict(causal=True), torch.float32),
    ((2, 1000, 700, 9, 3, 64), dict(causal=True, window=256), torch.float32),
    ((1, 256, 256, 4, 2, 32), dict(causal=True, logit_cap=20.0),
     torch.float32),
    ((1, 200, 300, 4, 1, 16), dict(causal=False), torch.float32),
    ((1, 130, 130, 2, 2, 128), dict(causal=True), torch.float32),
    ((2, 1024, 1024, 9, 3, 64), dict(causal=True), torch.bfloat16),
    ((2, 300, 300, 4, 4, 16), dict(causal=True, window=32), torch.bfloat16),
    ((2, 256, 256, 8, 2, 32), dict(causal=True, logit_cap=15.0),
     torch.bfloat16),
    ((1, 300, 300, 4, 2, 128), dict(causal=True), torch.bfloat16),
    # head dim 128 at qwen3-32b's GQA group of 8, and at gemma2-27b's 32:16
    # heads with its cap of 50 and a window that cuts (gemma2's 4096 masks
    # nothing below S=4096, so a window of 300 stands for it here)
    ((1, 1024, 1024, 16, 2, 128), dict(causal=True), torch.float32),
    ((1, 1024, 1024, 8, 4, 128), dict(causal=True, window=300,
                                      logit_cap=50.0), torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kw,dtype", CUDA_CASES)
def test_cuda_kernels_match_plain(shape, kw, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    B, S, Skv, H, Hkv, hd = shape
    g = torch.Generator(device="cuda").manual_seed(0)
    mk = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)
    q, k, v, do = mk(B, H, S, hd), mk(B, Hkv, Skv, hd), mk(B, Hkv, Skv, hd), \
        mk(B, H, S, hd)
    f32 = dtype == torch.float32
    ftol, btol = ((1e-4, 1e-4), (5e-4, 1e-3)) if f32 else ((3e-2,) * 2,) * 2
    out, lse = fa.fa_fwd(q, k, v, **kw)
    out_r, lse_r = tref.fa_fwd(q, k, v, **kw)
    delta = torch.sum(do.float() * out_r.float(), dim=-1)
    args = (q, k, v, do, lse_r, delta)
    pairs = [(out, out_r, ftol), (lse, lse_r, ftol),
             (fa.fa_bwd_dq(*args, **kw), tref.fa_bwd_dq(*args, **kw), btol)]
    pairs += [(a, b, btol) for a, b in zip(fa.fa_bwd_dkv(*args, **kw),
                                           tref.fa_bwd_dkv(*args, **kw))]
    torch.cuda.synchronize()
    for got, want, (atol, rtol) in pairs:
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)


SSD_CUDA_CASES = [
    # (B, T, H, P, G, N, chunk), A's most negative value
    ((2, 1024, 48, 64, 1, 128, 256), -48.0),    # mamba2-780m, device half
    ((1, 1000, 8, 64, 2, 128, 200), -8.0),      # grouped B/C, ragged tile
    ((2, 100, 4, 64, 1, 128, 100), -4.0),       # one chunk, T < 256
    ((2, 64, 8, 16, 1, 16, 8), -8.0),           # the smoke shape
    ((1, 512, 4, 32, 4, 32, 128), -48.0),       # rep 1
]


def ssd_inputs(shape, a_min, seed=0):
    """x ~ N(0, 1), dt log-normal around 0.1 (the top of mamba2's dt
    range), A evenly from -1 down to a_min (mamba2's init has -1 .. -H),
    B, C ~ N(0, 1/4), dy ~ N(0, 1): float32 on the card.  The chunk's
    log-decay then reaches |L| ~ 0.1 |a_min| Q, whose float32 rounding
    (~1e-4 at the main shape) bounds how closely any two chunked forms
    agree."""
    B, T, H, P, G, N, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g, device="cuda")
    x, dt = mk(B, T, H, P), 0.1 * torch.exp(0.5 * mk(B, T, H))
    A = -torch.linspace(1.0, -a_min, H, device="cuda")
    Bm, Cm, dy = mk(B, T, G, N) * 0.5, mk(B, T, G, N) * 0.5, mk(B, T, H, P)
    return x, dt, A, Bm, Cm, dy


@pytest.mark.cuda
@pytest.mark.parametrize("shape,a_min", SSD_CUDA_CASES)
def test_cuda_ssd_kernels_match_plain(shape, a_min):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    x, dt, A, Bm, Cm, dy = ssd_inputs(shape, a_min)
    chunk = shape[-1]
    y, st = ssd_k.ssd_fwd(x, dt, A, Bm, Cm, chunk=chunk)
    y_r, st_r = tref.ssd_fwd(x, dt, A, Bm, Cm, chunk=chunk)
    grads = ssd_k.ssd_bwd(x, dt, A, Bm, Cm, st_r, dy, chunk=chunk)
    grads_r = tref.ssd_bwd(x, dt, A, Bm, Cm, st_r, dy, chunk=chunk)
    torch.cuda.synchronize()
    names = ("y", "states", "dx", "ddt", "dA", "dB", "dC")
    want = dict(zip(names, (y_r, st_r, *grads_r)))
    scale = tref.ssd_scales(x, dt, A, want)
    for name, got in zip(names, (y, st, *grads)):
        assert torch.isfinite(got).all(), name
        err = (got - want[name]).abs()
        assert bool((err <= 1e-4 * scale[name]
                     + 1e-3 * want[name].abs()).all()), \
            f"{name}: max abs err {float(err.max()):.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["ssd_fwd", "ssd_bwd"])
def test_cuda_ssd_is_deterministic(kernel):
    """Both SSD kernels sum across threads in a fixed order, with no
    atomics: two calls on the same inputs give bit-identical outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    shape, a_min = SSD_CUDA_CASES[0]
    x, dt, A, Bm, Cm, dy = ssd_inputs(shape, a_min)
    chunk = shape[-1]
    if kernel == "ssd_fwd":
        names = ("y", "states")
        call = lambda: ssd_k.ssd_fwd(x, dt, A, Bm, Cm, chunk=chunk)
    else:
        names = ("dx", "ddt", "dA", "dB", "dC")
        _, st = tref.ssd_fwd(x, dt, A, Bm, Cm, chunk=chunk)
        call = lambda: ssd_k.ssd_bwd(x, dt, A, Bm, Cm, st, dy, chunk=chunk)
    first, second = call(), call()
    for name, a, b in zip(names, first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("shape,a_min", [
    ((2, 1024, 48, 64, 1, 128, 256), -48.0),    # mamba2-780m's prefill
    ((2, 1000, 8, 64, 2, 128, 256), -8.0),      # padded, grouped B/C
    ((2, 100, 4, 64, 1, 128, 256), -4.0),       # T < chunk
])
def test_cuda_ssd_prefill_matches_plain_final_state(shape, a_min):
    """``ops.ssd_prefill``, serving's forward-only SSD entry, launches the
    forward kernel once and gives y and the final state of
    ``ref.ssd_scan`` on the padded inputs, at the SSD tolerance (the
    state's scale is its head's largest |value|, as the states')."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.kernels import ops
    x, dt, A, Bm, Cm, _ = ssd_inputs(shape, a_min)
    chunk = min(shape[-1], shape[1])
    ssd_k.reset_launches()
    y, h = ops.ssd_prefill(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_k.launches == {"ssd_fwd": 1, "ssd_bwd": 0}
    pad = (-shape[1]) % chunk
    y_r, _, h_r = tref.ssd_scan(*(tref.pad_steps(t, pad) for t in (x, dt)),
                                A, *(tref.pad_steps(t, pad) for t in (Bm, Cm)),
                                chunk=chunk)
    scale = tref.ssd_scales(x, dt, A, {"y": y_r[:, :shape[1]],
                                       "states": h_r[:, :, None]})
    for got, want, sc in ((y, y_r[:, :shape[1]], scale["y"]),
                          (h, h_r, scale["states"][:, :, 0])):
        err = (got - want).abs()
        assert torch.isfinite(got).all()
        assert bool((err <= 1e-4 * sc + 1e-3 * want.abs()).all()), \
            f"max abs err {float(err.max()):.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("window,cap,ring", [(None, None, False),
                                             (6, 50.0, True),
                                             (6, None, False)],
                         ids=["global", "ring-capped", "window"])
def test_cuda_attention_decode_matches_cpu(window, cap, ring):
    """``attention_decode`` on the card against the CPU on the same params,
    cache and token: the output and the cache it writes in place, at
    position 13 (past the ring's length of 6, so the ring has wrapped)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.models import attention as tattn
    cfg = tattn.AttentionConfig(d_model=256, n_heads=8, n_kv_heads=2,
                                head_dim=64, window=window,
                                attn_softcap=cap)
    g = torch.Generator().manual_seed(0)
    params = tattn.attention_init(g, cfg)
    T = window if ring else 32
    cache = {k: torch.randn(2, T, 2, 64, generator=g) for k in ("k", "v")}
    x = torch.randn(2, 1, 256, generator=g)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for dev in ("cpu", "cuda"):
            c = {k: v.to(dev) for k, v in cache.items()}
            y, c = tattn.attention_decode(tree_map(lambda t: t.to(dev),
                                                   params), cfg, x.to(dev),
                                          c, 13, ring=ring)
            out[dev] = (y.cpu(), {k: v.cpu() for k, v in c.items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=1e-5,
                               rtol=1e-5)
    for k in ("k", "v"):
        torch.testing.assert_close(out["cuda"][1][k], out["cpu"][1][k],
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,launches,kernel", [
    ("smollm-135m", fa.launches, "fa_fwd"),
    ("mamba2-780m", ssd_k.launches, "ssd_fwd"),
    ("qwen3-32b", fa.launches, "fa_fwd"),
    ("gemma2-27b", fa.launches, "fa_fwd"),
], ids=["smollm-135m", "mamba2-780m", "qwen3-32b", "gemma2-27b"])
def test_cuda_round_kernel_matches_plain(arch, launches, kernel):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    cfg = TF.FedStepConfig(arch=treg.smoke_config(arch), l_split=1,
                           n_groups=2, seq_len=64, per_group_batch=4, H=2,
                           omega=2)
    state0 = TF.init_train_state(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    plane = tcp.ControlPlane(2, cfg.omega, cfg.H)
    rng = np.random.default_rng(0)
    streams = ttrain._group_streams(cfg)
    batches = []
    for _ in range(2):
        batches.append(ttrain._make_batch(cfg, streams, rng,
                                          plane.plan_round(), "cuda"))
        plane.finish_round()
    losses = {}
    for uk in (False, True):
        step = TF.make_train_step(dataclasses.replace(cfg, use_kernel=uk))
        state = tree_map(torch.clone, state0)
        fa.reset_launches()
        ssd_k.reset_launches()
        losses[uk] = []
        for batch in batches:
            state, m = step(state, batch)
            losses[uk] += [float(m["d_loss"]), float(m["s_loss"])]
    # two rounds of H micro-iterations: G groups' device layers + the
    # server's (gemma2's period is 2 layers, so l_split 1 is 2 layers)
    dev_layers = cfg.l_split * cfg.arch.period
    assert launches[kernel] == 2 * cfg.H * (
        2 * dev_layers + cfg.arch.n_layers - dev_layers)
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b",
                                  "llama4-maverick-400b-a17b"])
def test_cuda_moe_round_is_deterministic_and_sync_free(arch):
    """A smoke MoE round twice from one state and batch: bit-identical
    metrics and state (the MoE dispatch and combine backwards are gathers
    summed in a fixed order, with no atomics), the second round dispatched
    under ``set_sync_debug_mode("error")`` (the routing's sort, slot maps
    and capacity drops take no host sync)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: determinism and host syncs")
    cfg = TF.FedStepConfig(arch=treg.smoke_config(arch), l_split=1,
                           n_groups=2, seq_len=64, per_group_batch=4, H=2,
                           omega=2, use_kernel=True)
    state0 = TF.init_train_state(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    batch = ttrain._make_batch(cfg, ttrain._group_streams(cfg),
                               np.random.default_rng(0),
                               tcp.ControlPlane(2, cfg.omega, cfg.H)
                               .plan_round(), "cuda")
    step = TF.make_train_step(cfg)
    first, m1 = step(tree_map(torch.clone, state0), batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again, m2 = step(tree_map(torch.clone, state0), batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(first),
                                                 tree_leaves(again)))
    assert np.isfinite(float(m1["s_loss"]))


# ---------------------------------------------------------------------------
# the pipelined executor and its handles on the card
# ---------------------------------------------------------------------------

def _sleep_cycles(ms: float) -> int:
    """``torch.cuda._sleep`` cycles for about ``ms`` milliseconds."""
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10_000_000)
    b.record()
    b.synchronize()
    return int(10_000_000 * ms / a.elapsed_time(b))


@pytest.mark.cuda
def test_cuda_handle_keeps_its_round_across_in_place_updates():
    """The clone runs in stream order after round r and before round
    r+1's in-place update, and the host copy waits on the handle's own
    events only: it is back while the next round still runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: streams and events")
    from repro_torch.core.handles import RoundHandle
    x = torch.zeros(4, 1 << 18, device="cuda")
    torch.cuda._sleep(_sleep_cycles(50))
    x.add_(1.0)                                   # round r, still queued
    h = RoundHandle.capture(0, {"dev": {"w": x}, "aux": {"b": x[:, :8]}},
                            to_host=True)
    torch.cuda._sleep(_sleep_cycles(400))         # round r+1 ...
    x.add_(1.0)                                   # ... updates in place
    t0 = time.perf_counter()
    host = h.host_tree()
    waited = time.perf_counter() - t0
    assert waited < 0.3, waited                   # not behind round r+1
    assert torch.equal(host["dev"]["w"], torch.ones(4, 1 << 18))
    assert torch.equal(h.group_state(2)["dev"]["w"], torch.ones(1 << 18))
    torch.cuda.synchronize()
    assert h.ready() and torch.equal(x.cpu(), torch.full((4, 1 << 18), 2.0))


@pytest.mark.cuda
def test_cuda_window2_overlaps_host_work_with_the_card():
    """Eight rounds of about 100 ms on the card and 40 ms of batch building
    on the host: window 1 takes about 8 × 140 ms, window 2 about 40 + 8 ×
    100 ms, because the drain waits on its own round's event, not on the
    whole stream.  The card's time is more than twice the host's, so each
    steady drain blocks and the estimator credits the overlap."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: overlap with the card")
    from repro_torch.core.executor import RoundExecutor
    cycles = _sleep_cycles(100.0)

    def step(state, batch):
        torch.cuda._sleep(cycles)
        return state, {"d_loss": state["x"].sum()}

    def batch_fn(r, plan):
        time.sleep(0.04)
        return {}

    walls, summaries = {}, {}
    for window in (1, 2):
        ex = RoundExecutor(step, tcp.ControlPlane(2, 1, 2), window=window)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, hist = ex.run({"x": torch.ones(4, device="cuda")}, 0, 8,
                         active_fn=lambda r: np.ones(2, bool),
                         batch_fn=batch_fn)
        walls[window] = time.perf_counter() - t0
        summaries[window] = ex.summary()
        assert [m["d_loss"] for m in hist] == [4.0] * 8
    assert walls[2] <= 0.8 * walls[1], walls
    assert summaries[2]["hidden_host_frac_steady"] > 0.5, summaries[2]
    assert summaries[2]["peak_in_flight"] == 2


@pytest.mark.cuda
def test_cuda_traced_rounds_take_their_times_from_events():
    """Six rounds of about 50 ms on the card and 10 ms of batch building on
    the host, at window 2, traced: the ``mesh`` spans come from the
    rounds' CUDA events, so their ends lie apart by ``completion_gap_s``
    (event to event) within 0.1 ms and each lasts about its round's card
    time; the values equal the untraced run's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA events")
    from repro_torch.core.executor import RoundExecutor, completion_gap_s
    from repro_torch.obs.trace import Tracer, traced, validate_chrome_trace
    cycles = _sleep_cycles(50.0)

    def step(state, batch):
        torch.cuda._sleep(cycles)
        state["x"].add_(1.0)
        return state, {"d_loss": state["x"].sum()}

    def batch_fn(r, plan):
        time.sleep(0.01)
        return {}

    def run():
        ex = RoundExecutor(step, tcp.ControlPlane(2, 1, 2), window=2)
        _, hist = ex.run({"x": torch.zeros(4, device="cuda")}, 0, 6,
                         active_fn=lambda r: np.ones(2, bool),
                         batch_fn=batch_fn)
        return ex, hist

    _, plain = run()
    tracer = Tracer(domain="wall")
    with traced(tracer):
        ex, hist = run()
    assert hist == plain == [{"d_loss": 4.0 * (r + 1)} for r in range(6)]
    mesh = [s for s in tracer.spans if s[0] == "mesh"]
    assert [s[4]["round"] for s in mesh] == list(range(6))
    for a, b, sa, sb in zip(mesh, mesh[1:], ex.stats, ex.stats[1:]):
        assert abs((b[3] - a[3]) - completion_gap_s(sa, sb)) < 1e-4
    assert all(0.045 < s[3] - s[2] < 0.1 for s in mesh[1:]), mesh
    assert {f"dev/{g}" for g in range(2)} <= set(tracer.lanes())
    assert validate_chrome_trace(tracer.to_chrome()) == []


@pytest.mark.cuda
def test_cuda_dispatch_makes_no_host_sync():
    """One smoke round's plan (with a rejoin, so the retained rows are
    scattered back), batch build, dispatch, metrics staging and handle
    capture under ``set_sync_debug_mode("error")``, which raises on a
    synchronising call; the drain comes after it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: host syncs")
    from repro_torch.core.executor import _stage_metrics
    from repro_torch.core.handles import RoundHandle
    cfg = TF.FedStepConfig(arch=treg.smoke_config("smollm-135m"), l_split=1,
                           n_groups=2, seq_len=64, per_group_batch=4, H=2,
                           omega=2, use_kernel=True)
    state = TF.init_train_state(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    step = TF.make_train_step(cfg)
    plane = tcp.ControlPlane(2, cfg.omega, cfg.H)
    streams = ttrain._group_streams(cfg)
    rng = np.random.default_rng(0)
    drop = np.array([True, False])
    plan = plane.plan_round(active=drop)            # outside: warm-up round
    for g in plan.retire:
        plane.retain_group(g, TF.gather_group_state(state, g))
    state, m = step(state, ttrain._make_batch(cfg, streams, rng, plan, "cuda"))
    plane.finish_round(active=drop)
    float(m["d_loss"])
    torch.cuda.set_sync_debug_mode("error")
    try:
        plan = plane.plan_round(active=np.ones(2, bool))
        for g in plan.restore:
            state = TF.scatter_group_state(
                state, g, plane.release_group(g)["params"])
        batch = ttrain._make_batch(cfg, streams, rng, plan, "cuda")
        state, metrics = step(state, batch)
        values, done = _stage_metrics(metrics)
        handle = RoundHandle.capture(1, state, keys=("dev", "aux"),
                                     to_host=True)
        plane.finish_round()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert plan.restore == (1,)
    done.synchronize()
    assert all(np.isfinite(float(v)) for v in values.values())
    host = handle.host_tree()
    for a, b in zip(tree_leaves(host), tree_leaves({k: state[k] for k in
                                                    ("dev", "aux")})):
        assert torch.equal(a, b.cpu())


@pytest.mark.cuda
def test_cuda_sim_learner_matches_cpu():
    """``chip_smoke.sim_card_vs_cpu`` (phase 7 (b)) at a tiny size: the
    VGG-5 FedOptimaLearner through ``simulate_fedoptima`` at 8x8, K=4, 10
    simulated seconds, from one init on the card and on the CPU (which
    replays the card's ReLU and pool choices): every count bit-identical,
    the final params within ``SIM_PARAMS_TOL`` of each leaf's largest
    |value|."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the learner on the card")
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    out = cs.sim_card_vs_cpu(torch, img=8, K=4, duration=10.0)
    assert out["counts"]["srv_batches"] > 0
    assert out["counts"]["aggregations"] > 0
    assert max(out["gaps"].values()) <= cs.SIM_PARAMS_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("protocol", ["fl", "fedasync", "fedbuff", "splitfed",
                                      "pipar", "oafl"])
def test_cuda_baseline_learner_matches_cpu(protocol):
    """``chip_smoke.sim_card_vs_cpu`` for each baseline at a tiny size:
    its VGG-5 learner (``FullModelLearner`` or ``SplitLearner``) at 8x8,
    K=4, 40 simulated seconds, on the card and on the CPU: every count
    bit-identical, the final global params within ``SIM_PARAMS_TOL``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the learner on the card")
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    out = cs.sim_card_vs_cpu(torch, img=8, K=4, duration=40.0,
                             protocol=protocol)
    assert out["counts"]["dev_samples"] > 0
    assert out["counts"]["aggregations"] > 0
    assert max(out["gaps"].values()) <= cs.SIM_PARAMS_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_cuda_spill_and_fill_stay_on_the_stream(quant):
    """One ring slot's spill into the tiered store, a later in-place write
    to that slot, and its fill back, enqueued behind 200 ms of queued work
    under ``set_sync_debug_mode("error")``: no move waits for the card,
    the spill holds the slot as the stream left it before the write, and
    the fill puts it back (bit for bit in float32, within max|x|/254 in
    int8)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: streams and pinned copies")
    from repro_torch.memory import ActivationStore
    gen = torch.Generator(device="cuda").manual_seed(0)
    ring = {"acts": torch.randn(2, 4, 64, 32, device="cuda", generator=gen),
            "labels": torch.randint(0, 100, (2, 4, 64), device="cuda",
                                    generator=gen)}
    state = {"act_buf": ring}
    want = {k: v[1].clone() for k, v in ring.items()}
    store = ActivationStore(1, quant=quant)
    torch.cuda._sleep(_sleep_cycles(200))
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        store.spill(0, TF.gather_act_slot(state, 1))
        for v in ring.values():
            v[1].zero_()                  # the next round's in-place write
        TF.scatter_act_slot(state, 1, store.fill(0))
        waited = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert waited < 0.1, waited           # not behind the queued 200 ms
    torch.cuda.synchronize()
    assert torch.equal(ring["labels"][1], want["labels"])
    err = float((ring["acts"][1] - want["acts"]).abs().max())
    amax = float(want["acts"].abs().max())
    assert err <= (amax / 254.0 + 1e-7 * amax if quant else 0.0), err
    assert len(store) == 0 and store.n_fills == 1
