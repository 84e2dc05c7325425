"""The torch port's flash-attention op against the JAX package's.

On the CPU the port's op runs the kernels' plain versions
(``repro_torch/kernels/ref.py``) through the same custom ops and
autograd.Function that launch the CUDA kernels on the card; the JAX op
runs its Pallas kernels in interpret mode, as ``tests/test_kernels.py``
and ``tests/test_kernel_grads.py`` run them.  Inputs come from numpy.
The CUDA kernels themselves are tested on the card by
``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention_fwd_bhsd
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

jax.config.update("jax_enable_x64", False)

FWD_TOL = 2e-5      # tests/test_kernels.py, f32
GTOL = 1e-4         # tests/test_kernel_grads.py

CASES = [
    # (B, S, Skv, H, Hkv, hd), options
    ((1, 128, 128, 4, 4, 32), dict(causal=True)),                  # MHA
    ((2, 128, 128, 8, 2, 32), dict(causal=True)),                  # GQA 4:1
    ((1, 64, 64, 4, 1, 32), dict(causal=False)),                   # MQA, full
    ((1, 192, 192, 4, 4, 32), dict(causal=True, window=32)),       # window
    ((1, 128, 128, 4, 2, 32), dict(causal=True, logit_cap=20.0)),  # softcap
    ((1, 100, 100, 4, 2, 32), dict(causal=True)),                  # ragged S
    ((1, 100, 72, 4, 2, 32), dict(causal=False)),                  # ragged Skv
    ((1, 128, 128, 9, 3, 64), dict(causal=True)),                  # smollm
]
IDS = ["mha", "gqa4", "mqa", "window32", "softcap20", "ragged_s",
       "ragged_skv", "smollm"]


def _qkv(shape, seed=0):
    B, S, Skv, H, Hkv, hd = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd), np.float32),
            rng.standard_normal((B, Skv, Hkv, hd), np.float32),
            rng.standard_normal((B, Skv, Hkv, hd), np.float32))


def _jax_grads(q, k, v, kw):
    loss = lambda q, k, v: jnp.sum(jnp.sin(
        jops.flash_attention(q, k, v, interpret=True, **kw)))
    out = jops.flash_attention(q, k, v, interpret=True, **kw)
    return out, jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


def _torch_grads(q, k, v, kw):
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tops.flash_attention(*ts, **kw)
    torch.sum(torch.sin(out)).backward()
    return out.detach(), [t.grad for t in ts]


@pytest.mark.parametrize("shape,kw", CASES, ids=IDS)
def test_flash_attention_matches_jax(shape, kw):
    q, k, v = _qkv(shape)
    want_out, want_grads = _jax_grads(q, k, v, kw)
    got_out, got_grads = _torch_grads(q, k, v, kw)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=FWD_TOL, rtol=FWD_TOL)
    for g, w, name in zip(got_grads, want_grads, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GTOL,
                                   rtol=GTOL, err_msg=f"d{name}")


@pytest.mark.parametrize("shape,kw", CASES, ids=IDS)
def test_lse_matches_jax_kernel(shape, kw):
    """The forward's lse, NEG_INF convention included (a window over a
    short Skv leaves rows with no visible key)."""
    q, k, v = (np.swapaxes(x, 1, 2) for x in _qkv(shape, seed=1))
    _, want = flash_attention_fwd_bhsd(q, k, v, interpret=True, **kw)
    _, got = fa.fa_fwd(*(torch.from_numpy(np.ascontiguousarray(x))
                         for x in (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL,
                               rtol=FWD_TOL)


def test_fully_masked_rows_give_zero_and_neg_inf():
    q, k, v = (torch.from_numpy(np.swapaxes(x, 1, 2).copy())
               for x in _qkv((1, 64, 16, 2, 1, 16)))
    out, lse = fa.fa_fwd(q, k, v, causal=True, window=4)
    dead = torch.arange(64) >= 16 + 4 - 1          # no key in the window
    assert torch.all(out[:, :, dead] == 0)
    assert torch.all(lse[:, :, dead] == tref.NEG_INF)
    assert torch.all(lse[:, :, ~dead] > tref.NEG_INF)


def test_cpu_path_launches_no_kernel():
    fa.reset_launches()
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv((1, 32, 32, 2, 2, 16)))
    tops.flash_attention(q, k, v, causal=True).sum().backward()
    assert fa.launches == {"fa_fwd": 0, "fa_bwd_dq": 0, "fa_bwd_dkv": 0}


@pytest.mark.parametrize("bad", ["dtype", "heads", "head_dim", "window",
                                 "lse"])
def test_wrapper_rejects_bad_inputs(bad):
    q, k, v = (torch.zeros(1, 2, 8, 16), torch.zeros(1, 2, 8, 16),
               torch.zeros(1, 2, 8, 16))
    kw = dict(causal=True)
    if bad == "dtype":
        k = k.double()
    elif bad == "heads":
        q = torch.zeros(1, 3, 8, 16)
    elif bad == "head_dim":
        k, v = torch.zeros(1, 2, 8, 8), torch.zeros(1, 2, 8, 8)
    elif bad == "window":
        kw["window"] = 0
    if bad == "lse":
        with pytest.raises(ValueError):
            fa.fa_bwd_dq(q, k, v, q, torch.zeros(1, 2, 7), torch.zeros(1, 2, 8),
                         **kw)
        return
    with pytest.raises(ValueError):
        fa.fa_fwd(q, k, v, **kw)
