"""The port's mixture-of-experts FFN against the JAX package's single-host
dispatch (``moe_apply_grouped`` with no expert offset or psum), on the same
params (converted from the JAX init) and inputs drawn from a numpy seed:
the output, the load-balance loss and the gradients of x and of all four
params, at 1e-5.  The inputs overflow some experts' capacity (dropped
assignments) and hold rows of exact zeros beside live ones: an all-zero row
gives uniform router probabilities, so every expert ties, as on the
server's unwritten ring rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import mlp as jmlp
from repro.models import transformer as jtfm
from repro_torch.configs import registry as treg
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.models import mlp as tmlp
from repro_torch.models import transformer as ttfm

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5
B, S = 2, 16
# (d_model, d_ff, n_experts, top_k, activation, capacity factor)
CASES = {"top2": (32, 48, 8, 2, "swiglu", 1.0),
         "top1": (32, 48, 8, 1, "swiglu", 1.0),
         "top8-of-32": (32, 24, 32, 8, "swiglu", 1.0),
         "gelu-cf1.25": (32, 48, 8, 2, "gelu", 1.25)}


def _close(got, want, tol=TOL):
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, np.asarray(w), atol=tol, rtol=tol), got, want)


def _case(name):
    D, F, E, k, act, cf = CASES[name]
    jcfg = jmlp.MoeConfig(d_model=D, d_ff=F, n_experts=E, top_k=k,
                          activation=act)
    tcfg = tmlp.MoeConfig(d_model=D, d_ff=F, n_experts=E, top_k=k,
                          activation=act)
    params = jax.tree.map(np.asarray, jmlp.moe_init(jax.random.PRNGKey(3),
                                                    jcfg))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    x[0, 3:7] = 0.0          # tokens whose router probabilities all tie
    x[1, 10:] = 0.0
    r = rng.standard_normal((B, S, D)).astype(np.float32)
    return jcfg, tcfg, params, x, r, cf


def _drops(top_idx, E, C):
    """Assignments past their expert's capacity."""
    counts = np.bincount(np.asarray(top_idx).reshape(-1), minlength=E)
    return int(np.sum(np.maximum(counts - C, 0)))


@pytest.mark.parametrize("name", list(CASES))
def test_moe_apply_grouped_matches_jax(name):
    jcfg, tcfg, params, x, r, cf = _case(name)

    def jloss(p, x):
        y, aux = jmlp.moe_apply_grouped(p, jcfg, x, capacity_factor=cf)
        return jnp.sum(y * r) + 0.3 * aux, (y, aux)
    (_, (want_y, want_aux)), want_g = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, x)

    tp = {k: v.requires_grad_() for k, v in
          state_from_numpy(params, "cpu").items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = tmlp.moe_apply_grouped(tp, tcfg, tx, capacity_factor=cf)
    (torch.sum(y * torch.from_numpy(r)) + 0.3 * aux).backward()
    _close(y.detach().numpy(), want_y)
    _close(aux.item(), want_aux)
    _close((state_to_numpy({k: v.grad for k, v in tp.items()}),
            tx.grad.numpy()), want_g)
    assert set(tp) == set(params) == set(tmlp.moe_init(
        torch.Generator().manual_seed(0), tcfg))
    # the case really drops assignments, and routes the zero rows
    top_idx, _, _ = jmlp._top_k_route(params, jcfg, x.reshape(B * S, -1))
    C = tmlp.moe_capacity(tcfg, B * S, cf)
    assert C == max(1, int(cf * B * S * tcfg.top_k / tcfg.n_experts))
    assert _drops(top_idx, tcfg.n_experts, C) > 0
    assert float(np.abs(want_g[1][1, 12]).max()) > 0   # a zero row trains


@pytest.mark.parametrize("name", list(CASES))
def test_top_k_route_breaks_ties_as_jax(name):
    """The port's routing gives JAX's expert ids, weights and loss, with
    the tied zero rows on experts 0..k-1."""
    jcfg, tcfg, params, x, _, _ = _case(name)
    xt = x.reshape(B * S, -1)
    want = jmlp._top_k_route(params, jcfg, xt)
    got = tmlp._top_k_route(state_from_numpy(params, "cpu"), tcfg,
                            torch.from_numpy(xt))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close((got[1].numpy(), got[2].item()), (want[1], want[2]))
    np.testing.assert_array_equal(got[0].numpy()[3],
                                  np.arange(tcfg.top_k))


def test_torch_topk_breaks_ties_otherwise():
    """Why the routing sorts instead of calling ``torch.topk``: on a row
    whose probabilities all tie, ``torch.topk`` does not return the lower
    ids first, so it would route the zero rows to other experts than
    ``jax.lax.top_k`` does (and fill other experts' capacity)."""
    jcfg, tcfg, params, x, _, _ = _case("top2")
    xt = torch.from_numpy(x.reshape(B * S, -1))
    probs = torch.softmax(xt @ torch.tensor(params["router"]), dim=-1)
    assert torch.equal(probs[3], torch.full_like(probs[3], 1 / 8))
    want = np.asarray(jax.lax.top_k(jnp.asarray(probs.numpy()),
                                    tcfg.top_k)[1])
    topk = torch.topk(probs, tcfg.top_k).indices.numpy()
    assert not np.array_equal(topk, want)
    got = tmlp._top_k_route(state_from_numpy(params, "cpu"), tcfg, xt)[0]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("remat", [False, True, "selective"])
def test_moe_block_matches_jax(remat):
    """The ("attn", "moe") block in smoke qwen3-moe's server stack: h and
    the stack's summed MoE loss, and their gradients, under each remat
    mode (the routing is recomputed in the backward; values unchanged)."""
    arch = "qwen3-moe-235b-a22b"
    cfg, tcfg = jreg.smoke_config(arch), treg.smoke_config(arch)
    full = jax.tree.map(np.asarray, jtfm.init_params(jax.random.PRNGKey(0),
                                                     cfg))
    blocks = full["blocks"]
    rng = np.random.default_rng(1)
    h = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    h[1] = 0.0
    r = rng.standard_normal(h.shape).astype(np.float32)

    def jloss(p, h):
        out, aux = jtfm._run_stack(p, cfg, h, positions=jnp.arange(S)[None],
                                   remat=False)
        return jnp.sum(out * r) + 0.7 * aux, (out, aux)
    (_, (want_h, want_aux)), want_g = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(blocks, h)
    tb = jax.tree.map(lambda x: x.requires_grad_(),
                      state_from_numpy(blocks, "cpu"))
    th = torch.from_numpy(h).requires_grad_()
    out, aux = ttfm._run_stack(tb, tcfg, th, positions=ttfm._positions(th),
                               remat=remat)
    (torch.sum(out * torch.from_numpy(r)) + 0.7 * aux).backward()
    _close((out.detach().numpy(), aux.item()), (want_h, want_aux), tol=1e-4)
    _close((state_to_numpy(jax.tree.map(lambda x: x.grad, tb)),
            th.grad.numpy()), want_g, tol=1e-4)
    assert float(want_aux) > 0


def test_chip_smoke_replayed_route_is_the_route():
    """``chip_smoke.replay_route``, with which the card's kernel-vs-plain
    check on a MoE path routes the plain run, gives the port's routing bit
    for bit (weights, loss and the router's gradient) when it replays the
    router's own choice, and counts the tokens whose own choice differs
    when it replays another (here every token's top-k reversed)."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    _, tcfg, params, x, _, _ = _case("top8-of-32")
    xt = torch.from_numpy(x.reshape(B * S, -1))

    def run(route):
        p = {k: v.requires_grad_() for k, v in
             state_from_numpy(params, "cpu").items()}
        idx, w, aux, *counts = route(p)
        r = torch.arange(w.numel(), dtype=w.dtype).reshape(w.shape)
        grad = torch.autograd.grad(torch.sum(w * r) + aux, p["router"])[0]
        return idx, w.detach(), aux.detach(), grad, counts
    own_idx, own_w, own_aux, own_grad, _ = run(
        lambda p: tmlp._top_k_route(p, tcfg, xt))
    _, w, aux, grad, (n, gap) = run(
        lambda p: cs.replay_route(torch, p, tcfg, xt, own_idx))
    assert int(n) == 0 and float(gap) == float("inf")
    assert torch.equal(w, own_w) and torch.equal(aux, own_aux)
    assert torch.equal(grad, own_grad)
    _, w, aux, _, (n, gap) = run(
        lambda p: cs.replay_route(torch, p, tcfg, xt, own_idx.flip(-1)))
    assert int(n) == B * S and float(gap) == 0.0   # the zero rows tie
    torch.testing.assert_close(w, own_w.flip(-1))
    assert torch.equal(aux, own_aux)
