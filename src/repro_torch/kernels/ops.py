"""Differentiable flash attention and SSD over the five kernels.

Every launch is registered as a ``torch.library`` custom op
(``repro_torch::fa_fwd``, ``fa_bwd_dq``, ``fa_bwd_dkv``, ``ssd_fwd``,
``ssd_bwd``), each with a fake implementation, so that a selective-
checkpoint policy can see them: under ``remat="selective"`` the forward
kernels' outputs — (out, lse) and (y, states) — are saved and the backward
never launches a forward kernel again (the JAX package's "kernel_out"
checkpoint name).  ``_FlashAttention`` and ``_SSD`` are the ``custom_vjp``s
of the JAX ``kernels/ops.py``: for attention the forward kernel, then
Δ = rowsum(dO ⊙ O) as a torch op, then the dq and dk/dv kernels; for SSD
the chunked-scan forward, then the reverse-scan backward.  ``ssd_prefill``
is the forward alone with the final state, for prefill: no gradient.
"""
# No `from __future__ import annotations`: torch.library reads the op
# schemas from the annotations at registration.
from typing import Optional

import torch

from . import flash_attention as fa
from . import ssd as ssd_k
from .ref import pad_steps, ssd_final_state


@torch.library.custom_op("repro_torch::fa_fwd", mutates_args=())
def _fa_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, window: Optional[int],
               logit_cap: Optional[float]) -> tuple[torch.Tensor, torch.Tensor]:
    return fa.fa_fwd(q, k, v, causal=causal, window=window,
                     logit_cap=logit_cap)


@_fa_fwd_op.register_fake
def _(q, k, v, causal, window, logit_cap):
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


@torch.library.custom_op("repro_torch::fa_bwd_dq", mutates_args=())
def _fa_bwd_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  causal: bool, window: Optional[int],
                  logit_cap: Optional[float]) -> torch.Tensor:
    return fa.fa_bwd_dq(q, k, v, do, lse, delta, causal=causal,
                        window=window, logit_cap=logit_cap)


@_fa_bwd_dq_op.register_fake
def _(q, k, v, do, lse, delta, causal, window, logit_cap):
    return q.new_empty(q.shape, dtype=torch.float32)


@torch.library.custom_op("repro_torch::fa_bwd_dkv", mutates_args=())
def _fa_bwd_dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                   causal: bool, window: Optional[int],
                   logit_cap: Optional[float]
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    return fa.fa_bwd_dkv(q, k, v, do, lse, delta, causal=causal,
                         window=window, logit_cap=logit_cap)


@_fa_bwd_dkv_op.register_fake
def _(q, k, v, do, lse, delta, causal, window, logit_cap):
    return (k.new_empty(k.shape, dtype=torch.float32),
            k.new_empty(k.shape, dtype=torch.float32))


@torch.library.custom_op("repro_torch::ssd_fwd", mutates_args=())
def _ssd_fwd_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor,
                chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    return ssd_k.ssd_fwd(x, dt, A, Bm, Cm, chunk=chunk)


@_ssd_fwd_op.register_fake
def _(x, dt, A, Bm, Cm, chunk):
    b, T, H, P = x.shape
    return torch.empty_like(x), x.new_empty(b, H, T // chunk, Bm.shape[3], P)


@torch.library.custom_op("repro_torch::ssd_bwd", mutates_args=())
def _ssd_bwd_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, states: torch.Tensor,
                dy: torch.Tensor, chunk: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor, torch.Tensor]:
    return ssd_k.ssd_bwd(x, dt, A, Bm, Cm, states, dy, chunk=chunk)


@_ssd_bwd_op.register_fake
def _(x, dt, A, Bm, Cm, states, dy, chunk):
    return (torch.empty_like(x), torch.empty_like(dt), torch.empty_like(A),
            torch.empty_like(Bm), torch.empty_like(Cm))


#: Ops whose outputs the selective-remat policy saves (models/transformer).
SAVED_OPS = (torch.ops.repro_torch.fa_fwd.default,
             torch.ops.repro_torch.ssd_fwd.default)


class _FlashAttention(torch.autograd.Function):
    """q (B, H, S, hd), k/v (B, Hkv, Skv, hd) -> out (B, H, S, hd)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_cap):
        out, lse = torch.ops.repro_torch.fa_fwd(q, k, v, causal, window,
                                                logit_cap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window, logit_cap)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        delta = torch.sum(do.float() * out.float(), dim=-1)
        dq = torch.ops.repro_torch.fa_bwd_dq(q, k, v, do, lse, delta,
                                             *ctx.opts)
        dk, dv = torch.ops.repro_torch.fa_bwd_dkv(q, k, v, do, lse, delta,
                                                  *ctx.opts)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    logit_cap: Optional[float] = None):
    """q (B, S, H, hd); k, v (B, Skv, Hkv, hd) -> (B, S, H, hd).
    Differentiable; the kernels run in (B, H, S, hd), as the JAX
    ``ops._flash_attention_jit`` swaps axes around its Pallas calls."""
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    out = _FlashAttention.apply(qt, kt, vt, causal, window, logit_cap)
    return out.transpose(1, 2)


class _SSD(torch.autograd.Function):
    """x (B, T, H, P), dt (B, T, H), A (H,), Bm/Cm (B, T, G, N), T a
    multiple of ``chunk`` -> y (B, T, H, P)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        y, states = torch.ops.repro_torch.ssd_fwd(x, dt, A, Bm, Cm, chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm, states)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, A, Bm, Cm, states = ctx.saved_tensors
        grads = torch.ops.repro_torch.ssd_bwd(
            x, dt, A, Bm, Cm, states, dy.float().contiguous(), ctx.chunk)
        return (*(g.to(t.dtype) for g, t in zip(grads, (x, dt, A, Bm, Cm))),
                None)


def ssd(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """Chunked SSD sequence mixer.  x: (B, T, H, P); dt: (B, T, H);
    A: (H,); Bm, Cm: (B, T, G, N) -> y (B, T, H, P).  Differentiable
    (reverse chunk scan).  ``chunk`` is clamped to T, then T is padded to a
    chunk multiple (zero dt ⇒ identity decay, zero input ⇒ no state
    change), as the JAX ``ops.ssd`` does.  The kernels run in float32:
    every input is cast to it, and y comes back in x's dtype, as the
    Pallas kernel casts each tile and returns y in x's dtype."""
    T = x.shape[1]
    chunk = min(chunk, T)
    if chunk < 1:
        raise ValueError(f"empty sequence: T={T}")
    pad = (-T) % chunk
    x32, dt, Bm, Cm = (pad_steps(t.float(), pad).contiguous()
                       for t in (x, dt, Bm, Cm))
    y = _SSD.apply(x32, dt, A.float().contiguous(), Bm, Cm, chunk)
    return y[:, :T].to(x.dtype)


def ssd_prefill(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """The SSD forward with the state after the last step, for prefill:
    (y (B, T, H, P) in x's dtype, final state (B, H, N, P) float32).  Pads
    as :func:`ssd` does and launches the forward kernel once; its entry
    state of the last chunk is then stepped through that chunk
    (``ref.ssd_final_state``; the padded steps leave it unchanged).  The
    outputs carry no gradient: the inputs are detached."""
    T = x.shape[1]
    chunk = min(chunk, T)
    if chunk < 1:
        raise ValueError(f"empty sequence: T={T}")
    pad = (-T) % chunk
    x32, dt, Bm, Cm = (pad_steps(t.detach().float(), pad).contiguous()
                       for t in (x, dt, Bm, Cm))
    A = A.detach().float().contiguous()
    y, states = torch.ops.repro_torch.ssd_fwd(x32, dt, A, Bm, Cm, chunk)
    return (y[:, :T].to(x.dtype),
            ssd_final_state(x32, dt, A, Bm, states, chunk=chunk))
