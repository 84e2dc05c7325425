"""The torch port's SSD op against the JAX package's.

On the CPU the port's op runs the kernels' plain versions
(``repro_torch/kernels/ref.py``) through the same custom ops and
autograd.Function that launch the CUDA kernels on the card; the JAX op
runs its Pallas kernels in interpret mode, as ``tests/test_kernels.py``
and ``tests/test_kernel_grads.py`` run them.  Inputs come from numpy, drawn
as the JAX tests draw theirs (x ~ N(0, 1), dt = softplus(N(0, 1) - 1),
A = -exp(N(0, 1/4)), B, C ~ N(0, 1/4)).  The CUDA kernels themselves are
tested on the card by ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd import ssd_bwd_chunked_pallas, ssd_fwd_chunked_pallas
from repro.models import mamba as jmamba
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd as ssd_k
from repro_torch.models import mamba as tmamba

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

jax.config.update("jax_enable_x64", False)

FWD_TOL = 5e-4      # tests/test_kernels.py, SSD
GTOL = 1e-4         # tests/test_kernel_grads.py

SSD_SHAPES = [      # tests/test_kernels.py: (B, T, H, P, G, N, chunk)
    (1, 128, 4, 32, 1, 16, 32),
    (2, 64, 8, 16, 2, 8, 16),
    (1, 96, 4, 64, 1, 32, 32),
]
SSD_GRAD_CASES = [  # tests/test_kernel_grads.py: ((B, T, H, P, G, N), chunk)
    ((1, 64, 4, 16, 1, 8), 16),
    ((2, 64, 8, 16, 2, 8), 32),     # grouped B/C (rep=4)
    ((1, 50, 4, 16, 1, 8), 16),     # ragged: T % chunk != 0 (padding bwd)
    ((1, 12, 4, 16, 1, 8), 32),     # T < chunk (clamp + single chunk)
]
NAMES = ["x", "dt", "A", "B", "C"]


def _inputs(shape, seed=0):
    B, T, H, P, G, N = shape
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (f(B, T, H, P), np.log1p(np.exp(f(B, T, H) - 1.0)),
            -np.exp(f(H) * 0.5), f(B, T, G, N) * 0.5, f(B, T, G, N) * 0.5)


def _jax_grads(fn, args):
    loss = lambda *a: jnp.sum(jnp.sin(fn(*a)))
    return fn(*args), jax.grad(loss, argnums=tuple(range(5)))(*args)


def _torch_grads(fn, args):
    ts = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
          for a in args]
    y = fn(*ts)
    torch.sum(torch.sin(y)).backward()
    return y.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_matches_jax_kernel_and_oracle(shape):
    args = _inputs(shape[:6])
    chunk = shape[6]
    got = tops.ssd(*(torch.from_numpy(a) for a in args), chunk=chunk)
    want = jops.ssd(*args, chunk=chunk, interpret=True)
    oracle, _ = tref.ssd_reference(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL,
                               rtol=FWD_TOL)
    np.testing.assert_allclose(oracle.numpy(),
                               np.asarray(jref.ssd_reference(*args)[0]),
                               atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("shape,chunk", SSD_GRAD_CASES)
def test_ssd_grads_match_jax(shape, chunk):
    args = _inputs(shape)
    want_y, want = _jax_grads(
        lambda *a: jops.ssd(*a, chunk=chunk, interpret=True), args)
    got_y, got = _torch_grads(lambda *a: tops.ssd(*a, chunk=chunk), args)
    np.testing.assert_allclose(got_y, np.asarray(want_y), atol=FWD_TOL,
                               rtol=FWD_TOL)
    for g, w, name in zip(got, want, NAMES):
        np.testing.assert_allclose(g, np.asarray(w), atol=GTOL, rtol=GTOL,
                                   err_msg=f"d{name} {shape} chunk={chunk}")
    # and the port's two plain paths agree with the sequential oracle
    _, oracle = _torch_grads(lambda *a: tref.ssd_reference(*a)[0], args)
    for g, w, name in zip(got, oracle, NAMES):
        np.testing.assert_allclose(g, w, atol=GTOL, rtol=GTOL,
                                   err_msg=f"d{name} vs the oracle")


@pytest.mark.parametrize("shape,chunk", [((2, 64, 8, 16, 2, 8), 16),
                                         ((1, 96, 4, 32, 1, 16), 32)])
def test_ssd_kernel_functions_match_jax_kernels(shape, chunk):
    """The plain versions of both kernels against the Pallas kernels
    themselves: y and the entry states, then dx, ddt, dA (summed over the
    batch) and the group-summed dB, dC from the same states and dy."""
    args = _inputs(shape)
    dy = np.random.default_rng(9).standard_normal(args[0].shape) \
        .astype(np.float32)
    jy, jst = ssd_fwd_chunked_pallas(*args, chunk=chunk, interpret=True)
    t = [torch.from_numpy(a) for a in args]
    ty, tst = ssd_k.ssd_fwd(*t, chunk=chunk)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=FWD_TOL,
                               rtol=FWD_TOL)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), atol=FWD_TOL,
                               rtol=FWD_TOL)
    want = ssd_bwd_chunked_pallas(*args, np.asarray(jst), dy, chunk=chunk,
                                  interpret=True)
    got = ssd_k.ssd_bwd(*t, torch.from_numpy(np.array(jst)),
                        torch.from_numpy(dy), chunk=chunk)
    for g, w, name in zip(got, want, NAMES):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GTOL,
                                   rtol=GTOL, err_msg=f"d{name}")


def test_plain_ssd_chunked_matches_jax():
    args = _inputs((2, 64, 4, 16, 2, 8))
    want_y, want_h = jmamba.ssd_chunked(*args, 16)
    got_y, got_h = tmamba.ssd_chunked(*(torch.from_numpy(a) for a in args),
                                      16)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                               atol=FWD_TOL, rtol=FWD_TOL)


def test_plain_ssd_grads_finite_at_full_width_decay():
    """Reference fault: at mamba2-780m's decay (A down to -48, as its
    A_log init gives, dt 0.1, one 256-step chunk) the JAX plain path
    ``ssd_chunked`` takes exp of L_t - L_s for s > t too, which overflows,
    and its ``where`` backward turns 0 · inf into NaN in dA and ddt.  The
    port's plain path masks the difference before exp: its gradients are
    finite and equal the JAX kernel path's (which never forms the
    overflowing exp in its backward)."""
    B, T, H, P, G, N = 1, 256, 4, 16, 1, 16
    x, _, _, Bm, Cm = _inputs((B, T, H, P, G, N), seed=3)
    dt = np.full((B, T, H), 0.1, np.float32)
    A = -np.array([1.0, 8.0, 24.0, 48.0], np.float32)
    args = (x, dt, A, Bm, Cm)
    _, jplain = _jax_grads(lambda *a: jmamba.ssd_chunked(*a, T)[0], args)
    assert any(not np.isfinite(np.asarray(g)).all() for g in jplain)
    _, jkernel = _jax_grads(
        lambda *a: jops.ssd(*a, chunk=T, interpret=True), args)
    _, got = _torch_grads(lambda *a: tmamba.ssd_chunked(*a, T)[0], args)
    for g, w, name in zip(got, jkernel, NAMES):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, np.asarray(w), atol=GTOL, rtol=GTOL,
                                   err_msg=f"d{name}")


def test_ddt_tolerance_follows_its_conditioning():
    """Why the card's SSD checks judge each output's error against its
    head's size (``ref.ssd_scales``: 1e-4 · scale + 1e-3 · |ref|): ddt =
    dla·A + <dxb, x> cancels two terms up to |A| = 48 times its own size,
    and dA_h sums B·T terms that cancel.  At mamba2-780m's widths and decay
    the float32 plain backward, against its float64 evaluation, misses an
    elementwise 1e-4 + 1e-3·|ref| bound on some ddt elements but meets the
    scaled one on every output, head by head."""
    B, T, H, P, G, N, Q = 1, 512, 8, 64, 1, 128, 256
    rng = np.random.default_rng(0)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    x, dt = f(B, T, H, P), 0.1 * torch.exp(0.5 * f(B, T, H))
    A = -torch.linspace(1.0, 48.0, H)
    Bm, Cm, dy = f(B, T, G, N) * 0.5, f(B, T, G, N) * 0.5, f(B, T, H, P)
    args = (x, dt, A, Bm, Cm)
    y, states = tref.ssd_fwd(*args, chunk=Q)
    wide = tuple(t.double() for t in args)
    got = (y, states, *tref.ssd_bwd(*args, states, dy, chunk=Q))
    want = (*tref.ssd_fwd(*wide, chunk=Q), *tref.ssd_bwd(
        *wide, states.double(), dy.double(), chunk=Q))
    names = ("y", "states", "dx", "ddt", "dA", "dB", "dC")
    want = dict(zip(names, want))
    scale = tref.ssd_scales(*wide[:3], want)
    for g, name in zip(got, names):
        w = want[name]
        err = (g.double() - w).abs()
        assert bool((err <= 1e-4 * scale[name] + 1e-3 * w.abs()).all()), name
        if name == "ddt":
            assert not bool((err <= 1e-4 + 1e-3 * w.abs()).all())


def test_cpu_path_launches_no_kernel():
    ssd_k.reset_launches()
    args = [torch.from_numpy(a).requires_grad_()
            for a in _inputs((1, 32, 4, 16, 1, 8))]
    tops.ssd(*args, chunk=16).sum().backward()
    assert ssd_k.launches == {"ssd_fwd": 0, "ssd_bwd": 0}


@pytest.mark.parametrize("bad", ["dtype", "groups", "chunk", "states",
                                 "dt"])
def test_wrapper_rejects_bad_inputs(bad):
    x, dt, A, Bm, Cm = (torch.from_numpy(a)
                        for a in _inputs((1, 32, 4, 16, 1, 8)))
    if bad == "dtype":
        x = x.double()
    elif bad == "groups":
        Bm = Cm = torch.zeros(1, 32, 3, 8)
    elif bad == "dt":
        dt = dt[:, :, :2]
    if bad == "states":
        with pytest.raises(ValueError):
            ssd_k.ssd_bwd(x, dt, A, Bm, Cm, torch.zeros(1, 4, 3, 8, 16), x,
                          chunk=16)
        return
    with pytest.raises(ValueError):
        ssd_k.ssd_fwd(x, dt, A, Bm, Cm, chunk=12 if bad == "chunk" else 16)


def test_mamba_apply_bf16_kernel_matches_jax():
    """bfloat16 params and input through the SSD op: the op casts to
    float32 for the kernels and returns y in x's dtype, as the Pallas
    kernel does.  Tolerance: chip_smoke.py's bf16 rows, 0.03 + 0.03·|ref|."""
    from repro.configs import registry as jreg
    from repro_torch.configs import registry as treg
    mcfg = jreg.smoke_config("mamba2-780m").mamba_cfg()
    p = jmamba.mamba_init(jax.random.PRNGKey(0), mcfg, dtype=jnp.bfloat16)
    x = np.random.default_rng(4).standard_normal((2, 20, mcfg.d_model)) \
        .astype(np.float32)
    want = jmamba.mamba_apply(p, mcfg, jnp.asarray(x, jnp.bfloat16),
                              use_kernel=True)
    to_t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(
        torch.bfloat16).requires_grad_()
    tp = jax.tree.map(to_t, p)
    tx = to_t(x)
    got = tmamba.mamba_apply(tp, treg.smoke_config("mamba2-780m").mamba_cfg(),
                             tx, use_kernel=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32), atol=3e-2,
                               rtol=3e-2)
    torch.sum(got.float()).backward()
    for t in [tx, *jax.tree.leaves(tp)]:
        assert t.grad.dtype == torch.bfloat16
        assert bool(torch.isfinite(t.grad.float()).all())
