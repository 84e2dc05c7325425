"""The torch port's serving path against the JAX package's, on the CPU.

Both start from the JAX init of each of the ten smoke configs, converted
leaf for leaf, and the same numpy prompts (and frontend embeddings for the
VLM and the enc-dec):

- ``prefill``: the last logits and every decode-cache leaf (attention K/V,
  the ring of a local block, Mamba states, cross K/V), with the kernel
  ops off for every arch and on for smollm, mamba2 and jamba (the JAX side
  runs its kernels in interpret mode; the port's wrappers run their plain
  versions on the CPU; the port's Mamba prefill takes ``ops.ssd_prefill``);
- three ``serve_decode_step``s from the same converted caches, gemma2's
  local ring wrapped by a prompt of 12 past its window of 8;
- decode after prefill against the prefill of the longer sequence, on the
  port alone, as the reference's ``test_prefill_decode_consistency``;
- ``generate``'s greedy tokens and ``init_serve_state``'s layout.

Tolerance: 1e-4, the reference's GTOL; 2e-4 where the reference's own
consistency test uses it.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import serve as jserve
from repro.models import mamba as jmamba
from repro.models import transformer as jtfm
from repro_torch.configs import registry as treg
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttfm

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-4
ARCHS = sorted(treg.ARCHS)
KERNEL_ARCHS = ["smollm-135m", "mamba2-780m", "jamba-1.5-large-398b"]
B, S, MAX_LEN, STEPS = 2, 12, 32, 3


def _close(got, want, what, tol=TOL):
    assert jax.tree.structure(jax.tree.map(np.asarray, want)) == \
        jax.tree.structure(got), what
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, np.asarray(w), atol=tol, rtol=tol, err_msg=what), got, want)


@functools.cache
def _setup(arch):
    cfg = jreg.smoke_config(arch)
    params = jax.tree.map(np.asarray,
                          jtfm.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (B, S + STEPS)).astype(np.int32)
    frontend = rng.standard_normal((B, cfg.frontend_len, cfg.d_model)) \
        .astype(np.float32) if cfg.frontend_len else None
    return cfg, params, tokens, frontend


def _torch(x):
    if x is None:
        return None
    return torch.from_numpy(x).long() if x.dtype == np.int32 else \
        torch.from_numpy(x)


@functools.cache
def _jax_prefill(arch, use_kernel):
    cfg, params, tokens, fe = _setup(arch)
    out = jax.jit(lambda p, t, f: jtfm.prefill(
        p, cfg, t, max_len=MAX_LEN, frontend=f, use_kernel=use_kernel))(
        params, tokens[:, :S], fe)
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("arch,use_kernel",
                         [(a, False) for a in ARCHS]
                         + [(a, True) for a in KERNEL_ARCHS])
def test_prefill_matches_jax(arch, use_kernel):
    cfg, params, tokens, fe = _setup(arch)
    with torch.no_grad():
        got = ttfm.prefill(state_from_numpy(params, "cpu"),
                           treg.smoke_config(arch), _torch(tokens[:, :S]),
                           max_len=MAX_LEN, frontend=_torch(fe),
                           use_kernel=use_kernel)
    _close(state_to_numpy(got), _jax_prefill(arch, use_kernel),
           f"{arch} prefill (logits, caches)")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_decode_matches_jax(arch):
    """Three decode steps from the JAX prefill's caches, converted: the
    logits and every cache leaf after each step (the port updates its
    caches in place, the JAX package returns new ones)."""
    cfg, params, tokens, _ = _setup(arch)
    tcfg, tparams = treg.smoke_config(arch), state_from_numpy(params, "cpu")
    _, jcaches = _jax_prefill(arch, False)
    tcaches = state_from_numpy(jcaches, "cpu")
    step = jax.jit(lambda p, c, t, pos: jtfm.serve_decode_step(
        p, cfg, c, t, pos))
    if arch == "gemma2-27b":
        assert S > cfg.window      # the local ring has wrapped
    for i in range(STEPS):
        tok = tokens[:, S + i:S + i + 1]
        jlogits, jcaches = step(params, jcaches, tok, np.int32(S + i))
        with torch.no_grad():
            tlogits, tcaches = ttfm.serve_decode_step(
                tparams, tcfg, tcaches, _torch(tok), S + i)
        _close(state_to_numpy((tlogits, tcaches)), (jlogits, jcaches),
               f"{arch} decode step {i}")


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma2-27b", "mamba2-780m",
                                  "jamba-1.5-large-398b", "whisper-tiny",
                                  "llama-3.2-vision-90b"])
def test_decode_after_prefill_matches_prefill(arch):
    """Decode after the prefill of S tokens equals the prefill of S + 1, on
    the port alone, at the reference's 2e-4 and with its dropless MoE
    capacity (``tests/test_archs.py::test_prefill_decode_consistency``)."""
    cfg = treg.smoke_config(arch)
    if cfg.n_experts:
        cfg = cfg.scaled(moe_capacity_factor=float(cfg.n_experts) / cfg.top_k)
    params = ttfm.init_params(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen)
    fe = torch.randn(B, cfg.frontend_len, cfg.d_model, generator=gen) \
        if cfg.frontend_len else None
    with torch.no_grad():
        _, caches = ttfm.prefill(params, cfg, tok[:, :S], max_len=MAX_LEN,
                                 frontend=fe)
        got, _ = ttfm.serve_decode_step(params, cfg, caches, tok[:, S:], S)
        want, _ = ttfm.prefill(params, cfg, tok, max_len=MAX_LEN, frontend=fe)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4, rtol=0)


def test_generate_matches_jax():
    """Greedy tokens of ``generate`` on smollm: the prefill's argmax, then
    argmaxes of decode steps."""
    arch = "smollm-135m"
    cfg, params, tokens, _ = _setup(arch)
    want = jserve.generate(params, cfg, tokens[:, :S], new_tokens=8,
                           max_len=S + 8)
    got = tserve.generate(state_from_numpy(params, "cpu"),
                          treg.smoke_config(arch), _torch(tokens[:, :S]),
                          new_tokens=8, max_len=S + 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_cross_cache_matches_jax():
    """The cross blocks' K/V of the frontend, stacked over the periods
    (None at the other positions), against the JAX package's, and against
    the cross caches ``prefill`` primes."""
    arch = "llama-3.2-vision-90b"
    cfg, params, tokens, fe = _setup(arch)
    tcfg, tparams = treg.smoke_config(arch), state_from_numpy(params, "cpu")
    want = jtfm.prefill_cross_cache(params, cfg, fe)
    got = ttfm.prefill_cross_cache(tparams, tcfg, _torch(fe))
    assert [g is None for g in got] == [w is None for w in want] == \
        [m != "cross" for m, _ in tcfg.pattern]
    _close(state_to_numpy([g for g in got if g is not None]),
           [w for w in want if w is not None], "prefill_cross_cache")
    with torch.no_grad():
        _, caches = ttfm.prefill(tparams, tcfg, _torch(tokens[:, :S]),
                                 max_len=MAX_LEN, frontend=_torch(fe))
    for g, c in zip(got, caches):
        if g is not None:
            assert all(torch.equal(g[k], c[k]) for k in ("k", "v"))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_serve_state_matches_jax(arch):
    want = jtfm.init_serve_state(jreg.smoke_config(arch), B, MAX_LEN)
    got = ttfm.init_serve_state(treg.smoke_config(arch), B, MAX_LEN)
    assert jax.tree.structure(jax.tree.map(np.asarray, want)) == \
        jax.tree.structure(state_to_numpy(got))
    for g, w in zip(jax.tree.leaves(state_to_numpy(got)),
                    jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype and not g.any()


@pytest.mark.parametrize("T,chunk", [(24, 8), (21, 8), (5, 8)],
                         ids=["whole-chunks", "padded", "T<chunk"])
def test_ssd_prefill_matches_jax_plain_path(T, chunk):
    """``ops.ssd_prefill`` (the forward kernel's plain version on the CPU,
    then the last chunk's step) against the JAX plain ``ssd_chunked`` on
    the same padded inputs: y and the final state; and on the port's side
    the final state equals ``ref.ssd_scan``'s."""
    rng = np.random.default_rng(T)
    b, H, P, G, N = 2, 4, 8, 2, 16
    x = rng.standard_normal((b, T, H, P)).astype(np.float32)
    dt = (0.1 * np.exp(0.5 * rng.standard_normal((b, T, H)))) \
        .astype(np.float32)
    A = -np.linspace(1.0, 8.0, H).astype(np.float32)
    Bm, Cm = (0.5 * rng.standard_normal((b, T, G, N)).astype(np.float32)
              for _ in range(2))
    Q = min(chunk, T)
    pad = (-T) % Q
    padded = [np.pad(t, [(0, 0), (0, pad)] + [(0, 0)] * (t.ndim - 2))
              for t in (x, dt, Bm, Cm)]
    want_y, want_h = jmamba.ssd_chunked(padded[0], padded[1], A, *padded[2:],
                                        Q)
    got_y, got_h = ops.ssd_prefill(*(torch.from_numpy(t)
                                     for t in (x, dt, A, Bm, Cm)),
                                   chunk=chunk)
    _close((got_y.numpy(), got_h.numpy()),
           (np.asarray(want_y)[:, :T], want_h), "ssd_prefill")
    scan_h = ref.ssd_scan(*(torch.from_numpy(t) for t in
                            (padded[0], padded[1], A, *padded[2:])),
                          chunk=Q)[2]
    assert torch.equal(got_h, scan_h)


@pytest.mark.parametrize("arch", ARCHS)
def test_chip_smoke_reckons_serve_launches(arch, monkeypatch):
    """``chip_smoke.serve_launches``, which the card holds each served
    path's kernel prefill to, against the kernel calls of a smoke prefill
    and decode step on the CPU (each wrapper runs its plain version there):
    ``fa_fwd`` per self-attention block, ``ssd_fwd`` per Mamba block, no
    backward kernel, and none in decode."""
    import importlib.util
    from pathlib import Path

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd as ssd_k
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    calls = {name: 0 for name in (*fa.launches, *ssd_k.launches)}
    for name in calls:
        inner = getattr(ref, name)
        monkeypatch.setattr(ref, name, lambda *a, _n=name, _f=inner, **k: (
            calls.__setitem__(_n, calls[_n] + 1), _f(*a, **k))[1])
    cfg, params, tokens, fe = _setup(arch)
    tcfg, tparams = treg.smoke_config(arch), state_from_numpy(params, "cpu")
    with torch.inference_mode():
        _, caches = ttfm.prefill(tparams, tcfg, _torch(tokens[:, :S]),
                                 max_len=MAX_LEN, frontend=_torch(fe),
                                 use_kernel=True)
        want = cs.serve_launches(tcfg, (fa, ssd_k))
        assert calls == want and sum(want.values()) > 0
        ttfm.serve_decode_step(tparams, tcfg, caches,
                               _torch(tokens[:, S:S + 1]), S)
    assert calls == want
