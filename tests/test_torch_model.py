"""The torch port's model functions against the JAX package's, on the same
params (converted from the JAX init) and the same numpy inputs, for smoke
smollm-135m, mamba2-780m, qwen3-32b, gemma2-27b, llama-3.2-vision-90b,
whisper-tiny, qwen3-moe-235b-a22b, llama4-maverick-400b-a17b and
jamba-1.5-large-398b: attention
(with qk-norm, and with soft-cap and sliding window), the gated cross
block, the MLPs (SwiGLU, GeGLU, GELU), the Mamba2 block, the capped CE over
the tied and the untied head, the next-frame aux MSE, and the two halves'
losses with their gradients (the VLM's with its frontend, whisper's
encoder prefix on frames and its enc-dec server loss, the MoE archs' and jamba's
hybrid period with their load-balance loss), each with the kernel ops
(flash attention, SSD) on and off, and jamba's Mamba blocks before the
MoE and the dense FFN.  The MoE FFN alone is held in ``tests/test_torch_moe.py``.  Tolerance: the
reference's own gradient tolerance, 1e-4 (``tests/test_kernel_grads.py``
GTOL); float32 matmuls of XLA and of torch on the CPU differ in their last
bits.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import mamba as jmamba
from repro.models import mlp as jmlp
from repro.models import transformer as jtfm
from repro_torch.configs import registry as treg
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import mamba as tmamba
from repro_torch.models import mlp as tmlp
from repro_torch.models import transformer as ttfm
from repro_torch.models.common import tree_map

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-4
ARCH = "smollm-135m"
MAMBA = "mamba2-780m"
QWEN3 = "qwen3-32b"            # qk-norm, untied head
GEMMA2 = "gemma2-27b"          # local + global, soft-caps, GeGLU
VISION = "llama-3.2-vision-90b"  # gated cross blocks on the frontend
WHISPER = "whisper-tiny"       # enc-dec on the frame stub
QWEN3_MOE = "qwen3-moe-235b-a22b"     # ("attn", "moe"), top-2 of 8 (smoke)
LLAMA4 = "llama4-maverick-400b-a17b"  # ("attn", "moe"), ("attn", "dense")
JAMBA = "jamba-1.5-large-398b"  # attention, then ("mamba", "moe" | "dense")
ALL_ARCHS = (ARCH, MAMBA, "command-r-plus-104b", QWEN3, GEMMA2, VISION,
             WHISPER, QWEN3_MOE, LLAMA4, JAMBA)
B, S = 2, 16
# (arch, use_kernel); the smollm cases keep their ids
ARCH_KERNEL = [pytest.param(ARCH, False, id="False"),
               pytest.param(ARCH, True, id="True"),
               pytest.param(MAMBA, False, id="mamba2-False"),
               pytest.param(MAMBA, True, id="mamba2-True"),
               pytest.param(QWEN3, False, id="qwen3-False"),
               pytest.param(QWEN3, True, id="qwen3-True"),
               pytest.param(GEMMA2, False, id="gemma2-False"),
               pytest.param(GEMMA2, True, id="gemma2-True"),
               pytest.param(VISION, False, id="vision-False"),
               pytest.param(VISION, True, id="vision-True"),
               pytest.param(QWEN3_MOE, False, id="qwen3-moe-False"),
               pytest.param(QWEN3_MOE, True, id="qwen3-moe-True"),
               pytest.param(LLAMA4, False, id="llama4-False"),
               pytest.param(LLAMA4, True, id="llama4-True"),
               pytest.param(JAMBA, False, id="jamba-False"),
               pytest.param(JAMBA, True, id="jamba-True")]
# whisper's server half is server_encdec_loss, tested on its own
WHISPER_KERNEL = [pytest.param(WHISPER, False, id="whisper-False"),
                  pytest.param(WHISPER, True, id="whisper-True")]


def _close(got, want, tol=TOL):
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, np.asarray(w), atol=tol, rtol=tol), got, want)


@functools.cache
def _setup(arch):
    cfg = jreg.smoke_config(arch)
    full = jtfm.init_params(jax.random.PRNGKey(0), cfg)
    aux = jtfm.make_aux_params(jax.random.PRNGKey(1), cfg,
                               regression=bool(cfg.n_decoder_layers))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    acts = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    # the frontend stub's embeddings (F = 8 != S = 16): image patches or
    # mel frames
    frontend = rng.standard_normal((B, cfg.frontend_len, cfg.d_model)) \
        .astype(np.float32) if cfg.frontend_len else None
    np_ = lambda t: jax.tree.map(np.asarray, t)
    return dict(cfg=cfg, full=np_(full), aux=np_(aux), tokens=tokens,
                labels=labels, acts=acts, frontend=frontend)


@pytest.fixture(scope="module")
def setup():
    return _setup(ARCH)


def _leaves_grad(tree):
    return tree_map(lambda x: x.requires_grad_(), tree)


def test_smoke_and_full_configs_match_jax():
    assert set(treg.ARCHS) == set(ALL_ARCHS)
    for arch in ALL_ARCHS:
        for name in ("full", "smoke"):
            j = jreg.get(arch) if name == "full" else jreg.smoke_config(arch)
            t = treg.get(arch) if name == "full" else treg.smoke_config(arch)
            for f in dataclasses.fields(t):
                assert getattr(t, f.name) == getattr(j, f.name), \
                    (arch, name, f.name)
            assert (t.n_periods, t.hd) == (j.n_periods, j.hd)
            for mixer in ("attn", "local"):
                ta = dataclasses.asdict(t.attn_cfg(mixer))
                ja = dataclasses.asdict(j.attn_cfg(mixer))
                assert ta == {k: ja[k] for k in ta}, (arch, name, mixer)
            tc = dataclasses.asdict(t.cross_cfg())
            jc = dataclasses.asdict(j.cross_cfg())
            assert tc == {k: jc[k] for k in tc} and not tc["causal"]
            # whisper's family is "audio": its encoder is causal there too
            assert t.attn_cfg("attn").causal
            assert dataclasses.asdict(t.mlp_cfg()) == \
                dataclasses.asdict(j.mlp_cfg())
            if t.n_experts:
                tm = dataclasses.asdict(t.moe_cfg())
                jm = dataclasses.asdict(j.moe_cfg())
                assert tm == {k: jm[k] for k in tm}, (arch, name)
            if t.ssm_state:
                assert dataclasses.asdict(t.mamba_cfg()) == \
                    dataclasses.asdict(j.mamba_cfg())
                assert t.mamba_cfg().n_heads == j.mamba_cfg().n_heads


@pytest.mark.parametrize("use_kernel", [False, True])
def test_attention_apply_matches_jax(setup, use_kernel):
    cfg = setup["cfg"]
    p = jax.tree.map(lambda x: x[0], setup["full"]["blocks"][0]["mixer"])
    want = jattn.attention_apply(p, cfg.attn_cfg("attn"), setup["acts"],
                                 use_kernel=use_kernel)
    got = tattn.attention_apply(state_from_numpy(p, "cpu"),
                                treg.smoke_config(ARCH).attn_cfg("attn"),
                                torch.from_numpy(setup["acts"]),
                                use_kernel=use_kernel)
    _close(got.numpy(), want)


@pytest.mark.parametrize("arch,mixer", [(QWEN3, "attn"), (GEMMA2, "local")],
                         ids=["qwen3-qk_norm", "gemma2-local-cap-window"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_attention_variants_match_jax(arch, mixer, use_kernel):
    """qk-norm (smoke qwen3: q and k RMS-normed over hd before RoPE) and
    the soft-cap with a sliding window (smoke gemma2's local block: cap
    50, window 8 at S = 16, so the window cuts), with their gradients."""
    st = _setup(arch)
    cfg = st["cfg"]
    pos = [m for m, _ in cfg.pattern].index(mixer)
    p = jax.tree.map(lambda x: x[0], st["full"]["blocks"][pos]["mixer"])
    if mixer == "attn":
        assert {"q_norm", "k_norm"} <= set(p)
    else:
        assert cfg.attn_cfg(mixer).window < S
    # x2 scales the local block's logits by 4, so that the cap of 50 moves
    # the output by ~2e-2 (at x1 by ~1e-3); the loss is linear in y, so
    # its gradients are as well conditioned as y itself
    x = st["acts"] * (1.0 if mixer == "attn" else 2.0)
    r = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        y = jattn.attention_apply(p, cfg.attn_cfg(mixer), x,
                                  use_kernel=use_kernel)
        return jax.numpy.sum(y * r), y
    (_, want), want_g = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(p, x)
    tp = _leaves_grad(state_from_numpy(p, "cpu"))
    tx = torch.from_numpy(x).requires_grad_()
    got = tattn.attention_apply(tp, treg.smoke_config(arch).attn_cfg(mixer),
                                tx, use_kernel=use_kernel)
    torch.sum(got * torch.from_numpy(r)).backward()
    _close(got.detach().numpy(), want)
    _close(state_to_numpy((tree_map(lambda t: t.grad, tp), tx.grad)),
           want_g)


def test_sdpa_reference_and_chunked_match_jax():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 40, 4, 16), np.float32)
    k = rng.standard_normal((2, 40, 2, 16), np.float32)
    v = rng.standard_normal((2, 40, 2, 16), np.float32)
    kw = dict(causal=True, window=12, logit_cap=20.0)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    _close(tattn.sdpa_reference(*t, **kw).numpy(),
           jattn.sdpa_reference(q, k, v, **kw))
    _close(tattn.sdpa_chunked(*t, chunk_q=16, **kw).numpy(),
           jattn.sdpa_chunked(q, k, v, chunk_q=16, **kw))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mamba_apply_matches_jax(use_kernel):
    """The Mamba2 block, with the SSD op on and off, and its gradients;
    T = 20 is not a multiple of the smoke chunk 8, so both pad."""
    st = _setup(MAMBA)
    cfg = st["cfg"]
    p = jax.tree.map(lambda x: x[0], st["full"]["blocks"][0]["mixer"])
    x = np.random.default_rng(4).standard_normal((B, 20, cfg.d_model)) \
        .astype(np.float32)

    def jloss(p, x):
        y = jmamba.mamba_apply(p, cfg.mamba_cfg(), x, use_kernel=use_kernel)
        return jax.numpy.sum(jax.numpy.sin(y)), y
    (_, want), want_g = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(p, x)
    tp = _leaves_grad(state_from_numpy(p, "cpu"))
    tx = torch.from_numpy(x).requires_grad_()
    got = tmamba.mamba_apply(tp, treg.smoke_config(MAMBA).mamba_cfg(), tx,
                             use_kernel=use_kernel)
    torch.sum(torch.sin(got)).backward()
    _close(got.detach().numpy(), want)
    _close(state_to_numpy((tree_map(lambda t: t.grad, tp), tx.grad)),
           want_g)


def test_mlp_apply_matches_jax(setup):
    cfg = setup["cfg"]
    p = jax.tree.map(lambda x: x[0], setup["full"]["blocks"][0]["ffn"])
    want = jmlp.mlp_apply(p, cfg.mlp_cfg(), setup["acts"])
    got = tmlp.mlp_apply(state_from_numpy(p, "cpu"),
                         treg.smoke_config(ARCH).mlp_cfg(),
                         torch.from_numpy(setup["acts"]))
    _close(got.numpy(), want)


@pytest.mark.parametrize("activation", ["geglu", "gelu"])
def test_mlp_activations_match_jax(activation):
    """GeGLU (gelu on the gate, gemma2) and the non-gated GELU FFN (no
    w_gate), with gradients; gelu is jax.nn.gelu's tanh form."""
    jcfg = jmlp.MlpConfig(d_model=64, d_ff=96, activation=activation)
    tcfg = tmlp.MlpConfig(d_model=64, d_ff=96, activation=activation)
    assert jreg.smoke_config(GEMMA2).mlp_cfg() == \
        jmlp.MlpConfig(64, 96, "geglu")
    p = jax.tree.map(np.asarray, jmlp.mlp_init(jax.random.PRNGKey(2), jcfg))
    assert ("w_gate" in p) == (activation == "geglu")
    x = np.random.default_rng(5).standard_normal((B, S, 64)) \
        .astype(np.float32) * 2.0

    def jloss(p, x):
        y = jmlp.mlp_apply(p, jcfg, x)
        return jax.numpy.sum(jax.numpy.sin(y)), y
    (_, want), want_g = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(p, x)
    tp = _leaves_grad(state_from_numpy(p, "cpu"))
    tx = torch.from_numpy(x).requires_grad_()
    got = tmlp.mlp_apply(tp, tcfg, tx)
    torch.sum(torch.sin(got)).backward()
    _close(got.detach().numpy(), want)
    _close(state_to_numpy((tree_map(lambda t: t.grad, tp), tx.grad)),
           want_g)
    assert set(tmlp.mlp_init(torch.Generator().manual_seed(0), tcfg)) == \
        set(p)


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("cap", [30.0, 0.5])
def test_chunked_ce_loss_final_softcap_matches_jax(tie, cap):
    """gemma2's final soft-cap on each CE chunk's logits, before the
    softmax, for the tied head (embed.T) and the untied lm_head, with the
    gradients of the hidden states and the head.  Cap 30 is gemma2's own;
    at smoke widths its logits stay far below it, so cap 0.5 makes tanh
    bend them.  S = 16 over ce_chunk 6 gives two chunks and a remainder."""
    jcfg = jreg.smoke_config(GEMMA2).scaled(tie_embeddings=tie,
                                            final_softcap=cap, ce_chunk=6)
    tcfg = treg.smoke_config(GEMMA2).scaled(tie_embeddings=tie,
                                            final_softcap=cap, ce_chunk=6)
    rng = np.random.default_rng(6)
    key = "embed" if tie else "lm_head"
    shape = (jcfg.vocab, 64) if tie else (64, jcfg.vocab)
    head = {key: rng.standard_normal(shape).astype(np.float32)}
    h = rng.standard_normal((B, S, 64)).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.8).astype(np.float32)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p, h: jtfm.chunked_ce_loss(p, jcfg, h, labels, mask),
        argnums=(0, 1)))(head, h)
    tp = _leaves_grad(state_from_numpy(head, "cpu"))
    th = torch.from_numpy(h).requires_grad_()
    loss = ttfm.chunked_ce_loss(tp, tcfg, th, torch.from_numpy(labels).long(),
                                torch.from_numpy(mask))
    loss.backward()
    _close(loss.item(), want)
    _close(state_to_numpy((tree_map(lambda t: t.grad, tp), th.grad)),
           want_g)
    uncapped = ttfm.chunked_ce_loss(
        tp, tcfg.scaled(final_softcap=None), th,
        torch.from_numpy(labels).long(), torch.from_numpy(mask))
    if cap < 1:                          # the cap really bends the logits
        assert abs(uncapped.item() - loss.item()) > 1.0


@pytest.mark.parametrize("arch", ["command-r-plus-104b", QWEN3, GEMMA2,
                                  VISION, WHISPER, QWEN3_MOE, LLAMA4, JAMBA])
def test_convert_goes_across_by_key(arch):
    """The JAX init converted to the port holds the same leaves under the
    same keys (q_norm, k_norm, lm_head, the MoE router and experts
    included), and the port's own init has the same key set and shapes.  JAX orders dict keys sorted and the
    port keeps insertion order, so both are compared by key path."""
    def by_path(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: v for key in tree
                    for k, v in by_path(tree[key], f"{prefix}/{key}").items()}
        if isinstance(tree, (list, tuple)):
            return {k: v for i, x in enumerate(tree)
                    for k, v in by_path(x, f"{prefix}/{i}").items()}
        return {prefix: np.asarray(tree)}
    st = _setup(arch)
    want = by_path(st["full"])
    got = by_path(state_to_numpy(state_from_numpy(st["full"], "cpu")))
    mine = by_path(state_to_numpy(ttfm.init_params(
        torch.Generator().manual_seed(0), treg.smoke_config(arch))))
    assert set(got) == set(want) == set(mine)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert mine[k].shape == want[k].shape, k
    cfg = st["cfg"]
    assert ("/lm_head" in want) == (not cfg.tie_embeddings)
    assert any(k.endswith("/q_norm/scale") for k in want) == cfg.qk_norm
    moe = {k.rsplit("/", 1)[1] for k in want if "/ffn/router" in k
           or "/ffn/we_" in k}
    assert moe == ({"router", "we_gate", "we_up", "we_down"}
                   if cfg.n_experts else set())
    dev, srv = ttfm.split_params(state_from_numpy(st["full"], "cpu"),
                                 treg.smoke_config(arch), 1)
    jdev, jsrv = jtfm.split_params(st["full"], cfg, 1)
    assert set(srv) == set(jsrv) and set(dev) == set(jdev)
    _close(state_to_numpy((dev, srv)), (jdev, jsrv), tol=0)


def _torch_input(x):
    if x is None:
        return None
    return torch.from_numpy(x).long() if x.dtype == np.int32 else \
        torch.from_numpy(x)


@pytest.mark.parametrize("arch,use_kernel", ARCH_KERNEL + WHISPER_KERNEL)
def test_device_train_loss_matches_jax(arch, use_kernel):
    """The device half: the token embed, the device period and the aux
    network; llama-vision's cross blocks (one in its period, and the aux
    block) read the frontend; whisper's encoder prefix is fed the frames,
    which are its aux labels too (no embed; next-frame MSE)."""
    setup = _setup(arch)
    cfg = setup["cfg"]
    dev, _ = jtfm.split_params(setup["full"], cfg, 1)
    tok, lab, fe = setup["tokens"], setup["labels"], setup["frontend"]
    if cfg.n_decoder_layers:
        tok, lab, fe = fe, fe, None
        assert "embed" not in dev

    def jloss(d, a):
        return jtfm.device_train_loss(d, a, cfg, tok, lab, frontend=fe,
                                      use_kernel=use_kernel)
    (want_loss, want_acts), want_g = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(dev, setup["aux"])

    d = _leaves_grad(state_from_numpy(dev, "cpu"))
    a = _leaves_grad(state_from_numpy(setup["aux"], "cpu"))
    loss, acts = ttfm.device_train_loss(
        d, a, treg.smoke_config(arch), _torch_input(tok), _torch_input(lab),
        frontend=_torch_input(fe), use_kernel=use_kernel)
    loss.backward()
    _close(loss.item(), want_loss)
    _close(acts.detach().numpy(), want_acts)
    _close(state_to_numpy(tree_map(lambda x: x.grad, (d, a))), want_g)


@pytest.mark.parametrize("arch,use_kernel", ARCH_KERNEL)
def test_server_forward_loss_matches_jax(arch, use_kernel):
    """The server half and its head; llama-vision's server cross block
    reads the frontend."""
    setup = _setup(arch)
    cfg = setup["cfg"]
    _, srv = jtfm.split_params(setup["full"], cfg, 1)
    acts, lab, fe = setup["acts"], setup["labels"], setup["frontend"]
    want, want_g = jax.jit(jax.value_and_grad(
        lambda s: jtfm.server_forward_loss(s, cfg, acts, lab, frontend=fe,
                                           use_kernel=use_kernel)))(srv)
    s = _leaves_grad(state_from_numpy(srv, "cpu"))
    loss = ttfm.server_forward_loss(s, treg.smoke_config(arch),
                                    torch.from_numpy(acts),
                                    torch.from_numpy(lab).long(),
                                    frontend=_torch_input(fe),
                                    use_kernel=use_kernel)
    loss.backward()
    _close(loss.item(), want)
    _close(state_to_numpy(tree_map(lambda x: x.grad, s)), want_g)


def _counting(monkeypatch, name, calls):
    inner = getattr(tref, name)

    def counted(*a, **kw):
        calls[name] += 1
        return inner(*a, **kw)
    monkeypatch.setattr(tref, name, counted)


@pytest.mark.parametrize("arch,remat,fwd_per_layer", [
    pytest.param(ARCH, False, 1, id="False-1"),
    pytest.param(ARCH, True, 2, id="True-2"),
    pytest.param(ARCH, "selective", 1, id="selective-1"),
    pytest.param(MAMBA, True, 2, id="mamba2-True-2"),
    pytest.param(MAMBA, "selective", 1, id="mamba2-selective-1")])
def test_remat_keeps_values_and_selective_saves_the_forward(
        setup, monkeypatch, arch, remat, fwd_per_layer):
    """remat changes memory, not values; under "selective" the backward
    reuses the saved forward outputs ((out, lse), (y, states)) and never
    runs a forward kernel again."""
    cfg = treg.smoke_config(arch).scaled(n_layers=3)
    gen = torch.Generator().manual_seed(0)
    params = ttfm.init_params(gen, cfg)
    _, srv = ttfm.split_params(params, cfg, 1)
    acts = torch.from_numpy(setup["acts"])
    labels = torch.from_numpy(setup["labels"]).long()

    def run(r):
        s = _leaves_grad(tree_map(lambda x: x.detach().clone(), srv))
        loss = ttfm.server_forward_loss(s, cfg, acts, labels,
                                        use_kernel=True, remat=r)
        loss.backward()
        return loss.item(), state_to_numpy(tree_map(lambda x: x.grad, s))

    want = run(False)
    fwd, *bwd = ("fa_fwd", "fa_bwd_dq", "fa_bwd_dkv") if arch == ARCH else \
        ("ssd_fwd", "ssd_bwd")
    calls = dict.fromkeys([fwd, *bwd], 0)
    for name in calls:
        _counting(monkeypatch, name, calls)
    got = run(remat)
    n_layers = cfg.n_layers - 1
    assert calls == {fwd: fwd_per_layer * n_layers,
                     **dict.fromkeys(bwd, n_layers)}
    _close(got, want, tol=1e-6)


@pytest.mark.parametrize("name,hyper", [("sgd", {}), ("sgd", dict(momentum=0.9)),
                                        ("adamw", {})])
def test_optimizers_match_jax(name, hyper):
    from repro.optim.optimizers import make_optimizer as jmake
    from repro_torch.optim.optimizers import make_optimizer as tmake
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((5, 3)).astype(np.float32),
              "b": [rng.standard_normal(3).astype(np.float32)]}
    jinit, jupd = jmake(name, **dict(hyper))
    tinit, tupd = tmake(name, **dict(hyper))
    jp, js = params, jinit(params)
    tp = state_from_numpy(params, "cpu")
    ts = tinit(tp)
    for _ in range(3):
        grads = jax.tree.map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32), params)
        jp, js = jupd(jp, grads, js, 0.05)
        tp, ts = tupd(tp, state_from_numpy(grads, "cpu"), ts, 0.05)
    _close(state_to_numpy((tp, ts)), (jp, js), tol=1e-6)


def test_split_and_merge_params_round_trip(setup):
    cfg = treg.smoke_config(ARCH)
    full = state_from_numpy(setup["full"], "cpu")
    dev, srv = ttfm.split_params(full, cfg, 1)
    jdev, jsrv = jtfm.split_params(setup["full"], setup["cfg"], 1)
    _close(state_to_numpy((dev, srv)), (jdev, jsrv), tol=0)
    _close(state_to_numpy(ttfm.merge_params(dev, srv, cfg)), setup["full"],
           tol=0)


@pytest.mark.parametrize("n_layers", [3, 27])
def test_server_grads_on_unwritten_ring_rows(n_layers):
    """A ring slot row no group has written is all zero.  At 3 server
    layers the JAX gradients are finite and the port's equal them; at
    smollm's 27 they overflow to NaN in the reference (1e3 per RMSNorm in
    the input gradient, times the rows' zero activations), while the
    port's stay finite and keep the live rows' share.  Smoke widths: the
    overflow depends on depth, not width."""
    jcfg = jreg.smoke_config(ARCH).scaled(n_layers=n_layers + 1)
    full = jax.tree.map(np.asarray,
                        jtfm.init_params(jax.random.PRNGKey(0), jcfg))
    _, srv = jtfm.split_params(full, jcfg, 1)
    rng = np.random.default_rng(0)
    acts = rng.standard_normal((2, 8, jcfg.d_model)).astype(np.float32)
    acts[1] = 0.0                                   # an unwritten row
    labels = rng.integers(0, jcfg.vocab, (2, 8)).astype(np.int32)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda s: jtfm.server_forward_loss(s, jcfg, acts, labels)))(srv)
    s = _leaves_grad(state_from_numpy(srv, "cpu"))
    loss = ttfm.server_forward_loss(
        s, treg.smoke_config(ARCH).scaled(n_layers=n_layers + 1),
        torch.from_numpy(acts), torch.from_numpy(labels).long())
    loss.backward()
    got_g = state_to_numpy(tree_map(lambda x: x.grad, s))
    _close(loss.item(), want)
    assert all(np.isfinite(g).all() for g in jax.tree.leaves(got_g))
    if n_layers == 3:
        _close(got_g, want_g)
    else:
        assert any(np.isnan(g).any() for g in jax.tree.leaves(want_g))
        # only the live row trains: its own gradients, computed alone
        s1 = _leaves_grad(state_from_numpy(srv, "cpu"))
        ttfm.server_forward_loss(
            s1, treg.smoke_config(ARCH).scaled(n_layers=n_layers + 1),
            torch.from_numpy(acts[:1]), torch.from_numpy(labels[:1]).long()
        ).backward()
        _close(got_g, state_to_numpy(tree_map(lambda x: x.grad / 2, s1)))


# ---------------------------------------------------------------------------
# Cross-attention, the frontend and the enc-dec server loss
# ---------------------------------------------------------------------------

def _jvg(fn, *args):
    """JAX value and gradients of fn's scalar over every arg; fn returns
    (scalar, aux)."""
    return jax.jit(jax.value_and_grad(
        fn, argnums=tuple(range(len(args))), has_aux=True))(*args)


def _grads(tree):
    return state_to_numpy(tree_map(lambda x: x.grad, tree))


@pytest.mark.parametrize("arch,stack,pos", [(VISION, "blocks", 4),
                                            (WHISPER, "dec_blocks", 1)],
                         ids=["llama-vision", "whisper-decoder"])
def test_cross_block_matches_jax(arch, stack, pos):
    """The gated cross block, h + tanh(gate) * cross_attn(ln1(h),
    frontend) and its FFN, at S = 16 queries over F = 8 frontend positions
    (no RoPE, no mask), with the gradients of its params, h and the
    frontend.  The gate is set to 0.7: at its zero init a wrong
    cross-attention would pass."""
    st = _setup(arch)
    cfg = st["cfg"] if stack == "blocks" else jtfm._decoder_cfg(st["cfg"])
    tcfg = treg.smoke_config(arch)
    tcfg = tcfg if stack == "blocks" else ttfm._decoder_cfg(tcfg)
    assert cfg.pattern[pos] == ("cross", "dense")
    p = jax.tree.map(lambda x: np.array(x[0]), st["full"][stack][pos])
    p["gate"] = np.float32(0.7)
    h, fe = st["acts"], st["frontend"]
    assert fe.shape[1] != h.shape[1]
    r = np.random.default_rng(8).standard_normal(h.shape).astype(np.float32)

    def jloss(p, h, fe):
        y, _ = jtfm._apply_block(p, cfg, "cross", "dense", h,
                                 positions=np.arange(S)[None], frontend=fe)
        return jax.numpy.sum(y * r), y
    (_, want), want_g = _jvg(jloss, p, h, fe)
    tp = _leaves_grad(state_from_numpy(p, "cpu"))
    th, tfe = (torch.from_numpy(x).requires_grad_() for x in (h, fe))
    got, _ = ttfm._apply_block(tp, tcfg, "cross", "dense", th,
                               positions=ttfm._positions(th), frontend=tfe)
    torch.sum(got * torch.from_numpy(r)).backward()
    _close(got.detach().numpy(), want)
    _close((_grads(tp), th.grad.numpy(), tfe.grad.numpy()), want_g)
    assert abs(float(want_g[0]["gate"])) > 1e-3     # the gate trains


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("pos,ffn", [(1, "moe"), (2, "dense")],
                         ids=["mamba-moe", "mamba-dense"])
def test_mamba_ffn_blocks_match_jax(pos, ffn, use_kernel):
    """jamba's Mamba blocks before the MoE FFN (the odd positions of its
    period) and before the dense FFN: the block's output, its load-balance
    loss and the gradients of its params and its input, with the SSD op on
    and off."""
    st = _setup(JAMBA)
    cfg, tcfg = st["cfg"], treg.smoke_config(JAMBA)
    assert cfg.pattern[pos] == tcfg.pattern[pos] == ("mamba", ffn)
    p = jax.tree.map(lambda x: np.array(x[0]), st["full"]["blocks"][pos])
    h = st["acts"]
    r = np.random.default_rng(9).standard_normal(h.shape).astype(np.float32)

    def jloss(p, h):
        y, aux = jtfm._apply_block(p, cfg, "mamba", ffn, h,
                                   positions=np.arange(S)[None],
                                   use_kernel=use_kernel)
        return jax.numpy.sum(y * r) + aux, (y, aux)
    (_, (want, want_aux)), want_g = _jvg(jloss, p, h)
    tp = _leaves_grad(state_from_numpy(p, "cpu"))
    th = torch.from_numpy(h).requires_grad_()
    got, aux = ttfm._apply_block(tp, tcfg, "mamba", ffn, th,
                                 positions=ttfm._positions(th),
                                 use_kernel=use_kernel)
    (torch.sum(got * torch.from_numpy(r)) + aux).backward()
    _close(got.detach().numpy(), want)
    _close(float(torch.as_tensor(aux).detach()), want_aux)
    _close((_grads(tp), th.grad.numpy()), want_g)
    assert (ffn == "moe") == (float(want_aux) > 0)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("dead_row", [False, True],
                         ids=["live", "unwritten-row"])
def test_server_encdec_loss_matches_jax(use_kernel, dead_row):
    """Whisper's server objective: the encoder's last layer on the
    devices' acts (F = 8 frames), the final norm, then the decoder on the
    tokens (S = 16) cross-attending to the encoder states, CE on the tied
    head; value and gradients.  With an unwritten ring row (acts, tokens
    and labels all zero) the encoder's input row is all zero and the
    port's dead-row guard must keep every gradient the reference
    computes (finite at this depth)."""
    st = _setup(WHISPER)
    cfg = st["cfg"]
    _, srv = jtfm.split_params(st["full"], cfg, 1)
    acts = st["frontend"].copy()
    tok, lab = st["tokens"].copy(), st["labels"].copy()
    if dead_row:
        acts[1], tok[1], lab[1] = 0.0, 0, 0
    (want, _), want_g = _jvg(lambda s: (jtfm.server_encdec_loss(
        s, cfg, acts, tok, lab, use_kernel=use_kernel), 0.0), srv)
    assert all(np.isfinite(g).all() for g in jax.tree.leaves(want_g))
    s = _leaves_grad(state_from_numpy(srv, "cpu"))
    loss = ttfm.server_encdec_loss(
        s, treg.smoke_config(WHISPER), torch.from_numpy(acts),
        torch.from_numpy(tok).long(), torch.from_numpy(lab).long(),
        use_kernel=use_kernel)
    loss.backward()
    _close(loss.item(), want)
    _close((_grads(s),), want_g)
    assert {"dec_blocks", "dec_norm", "embed_out"} <= set(srv)


def test_aux_head_loss_regression_matches_jax():
    """Whisper's aux network on the encoder prefix: its block, the norm
    and the factorized head back to d_model (``head_reg``), MSE against
    the next input frame; value and the gradients of the aux params, the
    acts and the frames."""
    st = _setup(WHISPER)
    aux, acts, frames = st["aux"], st["acts"][:, :8], st["frontend"]
    assert "head_reg" in aux and "head_out" not in aux

    def jloss(a, x, f):
        return jtfm.aux_head_loss(a, st["cfg"], x, f), 0.0
    (want, _), want_g = _jvg(jloss, aux, acts, frames)
    ta = _leaves_grad(state_from_numpy(aux, "cpu"))
    tx, tf = (torch.from_numpy(x).requires_grad_() for x in (acts, frames))
    loss = ttfm.aux_head_loss(ta, treg.smoke_config(WHISPER), tx, tf)
    loss.backward()
    _close(loss.item(), want)
    _close((_grads(ta), tx.grad.numpy(), tf.grad.numpy()), want_g)
    mine = ttfm.make_aux_params(torch.Generator().manual_seed(0),
                                treg.smoke_config(WHISPER), regression=True)
    assert set(mine) == set(aux) and mine["head_reg"].shape == \
        aux["head_reg"].shape


@pytest.mark.parametrize("arch", [VISION, WHISPER])
def test_frontend_split_and_merge_round_trip(arch):
    """Split and merge of the VLM (device embed, untied head on the
    server) and the enc-dec (no device embed; the decoder and the tied
    head on the server) give the JAX split and the full params back."""
    st = _setup(arch)
    cfg = treg.smoke_config(arch)
    dev, srv = ttfm.split_params(state_from_numpy(st["full"], "cpu"), cfg, 1)
    jdev, jsrv = jtfm.split_params(st["full"], st["cfg"], 1)
    _close(state_to_numpy((dev, srv)), (jdev, jsrv), tol=0)
    _close(state_to_numpy(ttfm.merge_params(dev, srv, cfg)), st["full"],
           tol=0)
