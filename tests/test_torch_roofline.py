"""The port's cost model against the JAX package's: the dispatcher counter
(``repro_torch.analysis.cost``, in ``analysis/hlo.py``'s role), the H100
roofline and the 6·N·D accounting.

Mirrors ``tests/test_hlo_analysis.py`` case for case where eager mode has
a counterpart: a Python loop stands in for the scans (eager runs every
iteration, so there is no trip count to scale by), and a whole smoke round
of three archs is counted on the CPU and on ``meta`` and held within 10%
of ``analyze_compiled`` of the JAX ``jit_train_step`` on a (1, 1) Auto
mesh (as ``tests/test_torch_round.py`` builds it).  smollm's gap is then
accounted for product by product.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.analysis import analyze_compiled
from repro.analysis import count_params as jax_count_params
from repro.analysis import model_flops as jax_model_flops
from repro.configs import registry as jreg
from repro.core import fedopt_step as JF
from repro_torch.analysis import (HBM_BW, LINK_BW, PEAK_FLOPS,
                                  PEAK_FLOPS_F32, Cost, analyze_call,
                                  count_params, model_flops, roofline)
from repro_torch.analysis.cost import attention_flops, ssd_flops
from repro_torch.configs import registry as treg
from repro_torch.core import fedopt_step as TF
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models.common import tree_map

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROUND = dict(l_split=1, n_groups=2, seq_len=16, per_group_batch=4, H=2,
             omega=2)
ROUND_TOL = 0.10


def _zeros(device, *shape):
    return torch.zeros(shape, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

def test_cost_add_and_scale():
    a = Cost(flops=2.0, bytes=4.0)
    a.collective_bytes["all-reduce"] += 8.0
    b = a.scaled(3)
    assert b.flops == 6.0 and b.collective_bytes["all-reduce"] == 24.0
    a += b
    assert a.flops == 8.0 and a.total_collective_bytes == 32.0


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_matmul_flops_exact(device):
    _, cost = analyze_call(lambda a, b: a @ b, _zeros(device, 64, 32),
                           _zeros(device, 32, 16))
    assert cost.flops == 2 * 64 * 32 * 16
    # one mm: both operands read, the output written
    assert cost.bytes == 4 * (64 * 32 + 32 * 16 + 64 * 16)
    assert cost.collective_bytes == {}


def test_python_loop_counts_every_iteration():
    """Eager runs each of the 5 x 3 matmuls; all are counted."""
    def fn(x, w):
        for _ in range(5):
            ci = x
            for _ in range(3):
                ci = ci @ w
            x = ci
        return x.sum()

    _, cost = analyze_call(fn, _zeros("cpu", 4, 16), _zeros("cpu", 16, 16))
    assert cost.flops == 5 * 3 * 2 * 4 * 16 * 16


def test_inplace_slice_writes_count_slice_not_buffer():
    """A write into a view of a buffer moves the view's bytes."""
    def fn(buf, x):
        for i in range(100):
            buf[i:i + 1].copy_(x)
        return buf

    _, cost = analyze_call(fn, _zeros("cpu", 1024, 256),
                           _zeros("cpu", 1, 256))
    full_buffer_per_iter = 100 * 1024 * 256 * 4
    assert cost.bytes < full_buffer_per_iter / 100   # one buffer in all
    assert cost.bytes == 100 * 2 * 256 * 4          # read x, write a row


def test_views_and_allocations_are_free():
    def fn(x):
        y = x.t().reshape(16, 32).detach()[2:].unsqueeze(0).expand(3, 14, 32)
        return torch.empty_like(y)

    _, cost = analyze_call(fn, _zeros("cpu", 32, 16))
    assert cost.flops == 0 and cost.bytes == 0


def test_exclude_fn_zeroes_matching_buffers():
    def fn(q, k):
        s = q @ k.T                    # (128, 128) score-like
        return torch.softmax(s, dim=-1).sum()

    args = (_zeros("cpu", 128, 64), _zeros("cpu", 128, 64))
    _, base = analyze_call(fn, *args)
    _, excl = analyze_call(fn, *args,
                           exclude_fn=lambda d: tuple(d) == (128, 128))
    assert excl.bytes < base.bytes
    assert excl.flops == base.flops    # flops unchanged


def test_two_layer_mlp_flops_exact():
    def fn(x, w1, w2):
        h = torch.relu(x @ w1)
        return (h @ w2).sum()

    _, cost = analyze_call(fn, _zeros("cpu", 32, 64), _zeros("cpu", 64, 128),
                           _zeros("cpu", 128, 8))
    assert cost.flops == 2 * 32 * 64 * 128 + 2 * 32 * 128 * 8


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_kernel_ops_counted_by_their_formulas(device):
    """Each kernel op is one op, counted by its formula, on the CPU (where
    it runs its plain version, which the mode does not see again) as on
    meta; its bytes are its inputs and outputs, never the scores."""
    B, S, H, Hkv, hd = 2, 16, 4, 2, 8
    q = torch.randn(B, S, H, hd, device=device, requires_grad=True)
    k, v = (torch.randn(B, S, Hkv, hd, device=device, requires_grad=True)
            for _ in range(2))
    by_op = {}
    _, cost = analyze_call(
        lambda: ops.flash_attention(q, k, v, causal=True, window=5)
        .sum().backward(), by_op=by_op)
    want = {n: attention_flops(n, B, H, S, S, hd, causal=True, window=5)
            for n in ("fa_fwd", "fa_bwd_dq", "fa_bwd_dkv")}
    assert by_op == want
    assert cost.flops == sum(want.values())
    # the forward op alone moves q, k, v, out and lse, never the scores
    qt, kt, vt = (t.detach().transpose(1, 2).contiguous() for t in (q, k, v))
    _, cost = analyze_call(torch.ops.repro_torch.fa_fwd, qt, kt, vt, True, 5,
                           None)
    assert cost.bytes == 4 * (2 * B * H * S * hd + 2 * B * Hkv * S * hd
                              + B * H * S)

    Bs, T, Hs, P, G, N, chunk = 1, 16, 2, 4, 1, 8, 8
    x = torch.randn(Bs, T, Hs, P, device=device, requires_grad=True)
    dt = torch.rand(Bs, T, Hs, device=device)
    A = -torch.rand(Hs, device=device)
    Bm, Cm = (torch.randn(Bs, T, G, N, device=device) for _ in range(2))
    by_op = {}
    _, cost = analyze_call(
        lambda: ops.ssd(x, dt, A, Bm, Cm, chunk=chunk).sum().backward(),
        by_op=by_op)
    assert by_op == {n: ssd_flops(n, Bs, T, Hs, P, G, N, chunk)
                     for n in ("ssd_fwd", "ssd_bwd")}
    assert cost.flops == sum(by_op.values())


def test_analyze_call_refuses_a_kernel_launched_past_the_dispatcher():
    """A wrapper called directly on the card moves its launch count and no
    op reaches the mode: the count would miss its work."""
    def launch():
        fa.launches["fa_fwd"] += 1

    try:
        with pytest.raises(ValueError, match="past kernels/ops.py"):
            analyze_call(launch)
    finally:
        fa.launches["fa_fwd"] -= 1


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------

def test_roofline_terms_and_dominance():
    cost = Cost(flops=PEAK_FLOPS, bytes=HBM_BW / 2)
    cost.collective_bytes["all-reduce"] = LINK_BW / 8
    t = roofline(cost, model_flops_total=PEAK_FLOPS / 2, n_chips=1)
    assert abs(t.compute_s - 1.0) < 1e-9
    assert abs(t.memory_s - 0.5) < 1e-9
    assert abs(t.collective_s - 0.25) < 1e-9   # 2x ring factor
    assert t.dominant == "compute"
    assert abs(t.mfu - 0.5) < 1e-9
    # the same work against the float32 peak: the compute term grows by
    # the ratio of the peaks, the share shrinks by it
    f = roofline(cost, model_flops_total=PEAK_FLOPS / 2,
                 peak=PEAK_FLOPS_F32)
    assert abs(f.compute_s - PEAK_FLOPS / PEAK_FLOPS_F32) < 1e-9
    assert abs(f.mfu - 0.5) < 1e-9             # compute-bound either way
    assert f.to_dict()["peak"] == PEAK_FLOPS_F32
    assert t.to_dict()["mfu_bound"] == t.mfu


def test_model_flops_moe_counts_active_only():
    moe = treg.get("qwen3-moe-235b-a22b")
    total, active = count_params(moe)
    assert active < 0.2 * total        # 235B total vs ~22B active
    mf_train = model_flops(moe, 1000, kind="train")
    mf_inf = model_flops(moe, 1000, kind="infer")
    assert abs(mf_train / mf_inf - 3.0) < 1e-6


@pytest.mark.parametrize("arch", sorted(treg.ARCHS))
def test_param_and_model_flops_equal_jax(arch):
    """The port's arithmetic is the reference's, to the last bit."""
    t, j = treg.get(arch), jreg.get(arch)
    assert count_params(t) == jax_count_params(j)
    for kind in ("train", "infer"):
        assert model_flops(t, 4 * 8 * 1024, kind=kind) == \
            jax_model_flops(j, 4 * 8 * 1024, kind=kind)


# ---------------------------------------------------------------------------
# a whole round against the JAX HLO count
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _port_cost(arch: str, device: str, use_kernel: bool = False) -> Cost:
    """One smoke round of the port, counted on ``device``: the state and
    batch drawn on the CPU, then moved there (the slot indices stay host
    values).  ``use_kernel``: the kernel path (its ops' FLOPs by their
    formulas, under ``"kernels"``), else the plain path."""
    cfg = TF.FedStepConfig(arch=treg.smoke_config(arch),
                           use_kernel=use_kernel, **ROUND)
    gen = torch.Generator().manual_seed(0)
    state = TF.init_train_state(gen, cfg)
    batch = TF.concrete_train_batch(gen, cfg)
    if device != "cpu":
        state = tree_map(lambda x: x.to(device), state)
        batch = {k: v if k in ("read_slot", "write_slot") else v.to(device)
                 for k, v in batch.items()}
    by_op = {}
    _, cost = analyze_call(TF.make_train_step(cfg), state, batch,
                           by_op=by_op)
    cost.kernels = sum(f for n, f in by_op.items()
                       if n.startswith(("fa_", "ssd_")))
    return cost


@functools.lru_cache(maxsize=None)
def _jax_flops(arch: str) -> float:
    cfg = JF.FedStepConfig(arch=jreg.smoke_config(arch), **ROUND)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    jitted, _, _, _ = JF.jit_train_step(cfg, mesh, donate=False)
    compiled = jitted.lower(JF.abstract_train_state(cfg),
                            JF.train_input_specs(cfg)).compile()
    return analyze_compiled(compiled).flops


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-780m",
                                  "qwen3-moe-235b-a22b"])
def test_round_count_matches_jax_hlo(arch):
    cpu, meta = _port_cost(arch, "cpu"), _port_cost(arch, "meta")
    assert (meta.flops, meta.bytes) == (cpu.flops, cpu.bytes)
    ratio = cpu.flops / _jax_flops(arch)
    assert abs(ratio - 1.0) <= ROUND_TOL, ratio


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-780m"])
def test_kernel_round_counts_on_meta_as_on_cpu(arch):
    """The kernel path of a round, counted on meta, equals its count on the
    CPU, and its kernels' FLOPs are in it; the plain path runs no kernel
    op."""
    cpu, meta = (_port_cost(arch, d, True) for d in ("cpu", "meta"))
    assert (meta.flops, meta.bytes) == (cpu.flops, cpu.bytes)
    assert 0 < cpu.kernels < cpu.flops
    assert _port_cost(arch, "cpu").kernels == 0


def test_smollm_gap_is_aux_recompute_and_selective_remat():
    """smollm's port count exceeds the HLO count by exactly two sets of
    products that eager autograd runs and XLA does not: each group's aux
    head (head_in, then head_out) recomputed in the chunked CE's backward,
    which XLA folds into the forward's; and each block's attention output
    projection, recomputed by the port's selective remat (it saves only the
    kernels' outputs) where the JAX policy saves the block's ``tp_out``."""
    cfg = TF.FedStepConfig(arch=treg.smoke_config("smollm-135m"), **ROUND)
    a = cfg.arch
    G, H, tok = cfg.n_groups, cfg.H, cfg.micro_batch * cfg.seq_len
    srv_blocks = a.n_periods * a.period - cfg.l_split * a.period
    aux = G * H * 2 * tok * a.aux_dim * (a.d_model + a.vocab)
    o_proj = 2 * a.n_heads * a.hd * a.d_model
    remat = H * o_proj * tok * (G * cfg.l_split * a.period + G * srv_blocks)
    gap = _port_cost("smollm-135m", "cpu").flops - _jax_flops("smollm-135m")
    assert gap == aux + remat
