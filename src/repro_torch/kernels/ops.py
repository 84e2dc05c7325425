"""Differentiable flash attention over the three kernels.

The three launches are registered as ``torch.library`` custom ops
(``repro_torch::fa_fwd``, ``fa_bwd_dq``, ``fa_bwd_dkv``), each with a fake
implementation, so that a selective-checkpoint policy can see them: under
``remat="selective"`` the forward's (out, lse) are saved and the backward
never launches the forward kernel again (the JAX package's "kernel_out"
checkpoint name).  ``_FlashAttention`` is the ``custom_vjp`` of the JAX
``kernels/ops.py``: forward kernel, then Δ = rowsum(dO ⊙ O) as a torch op,
then the dq and dk/dv kernels.
"""
# No `from __future__ import annotations`: torch.library reads the op
# schemas from the annotations at registration.
from typing import Optional

import torch

from . import flash_attention as fa


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


#: Ops whose outputs the selective-remat policy saves (models/transformer).
SAVED_OPS = (torch.ops.repro_torch.fa_fwd.default,)


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
