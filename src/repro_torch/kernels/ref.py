"""Plain PyTorch versions of the three flash-attention kernels.

Each function has its kernel's exact semantics and layout — q, o, do
(B, H, S, hd), k, v (B, Hkv, Skv, hd), lse and delta (B, H, S) float32 —
so the CPU tests run them in the kernels' place and ``chip_smoke.py``
holds each CUDA kernel against them on the card.  A fully-masked row gives
out 0 and lse ``NEG_INF`` (the JAX oracle ``ref.flash_attention_reference``
gives -inf there; the kernels, and these, follow the Pallas kernels).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def visible(S: int, Skv: int, *, causal: bool, window: int | None,
            device) -> torch.Tensor:
    """(S, Skv) bool: may query qpos attend to key kpos (top-left causal,
    sliding window ``kpos > qpos - window``)."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones(S, Skv, dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _logits(q, k, *, logit_cap):
    """z = softcap(scale · q kᵀ) with the kv heads repeated over each GQA
    group: (B, H, S, Skv) float32."""
    group = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    s = (q.float() @ kf.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    if logit_cap is not None:
        s = logit_cap * torch.tanh(s / logit_cap)
    return s


def fa_fwd(q, k, v, *, causal: bool, window: int | None = None,
           logit_cap: float | None = None):
    """Returns (out like q, lse (B, H, S) float32)."""
    group = q.shape[1] // k.shape[1]
    mask = visible(q.shape[2], k.shape[2], causal=causal, window=window,
                   device=q.device)
    s = _logits(q, k, logit_cap=logit_cap).masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1)
    vf = v.float().repeat_interleave(group, dim=1)
    out = (p @ vf) / torch.where(l > 0, l, 1.0)[..., None]
    lse = torch.where(l > 0, m[..., 0] + torch.log(torch.where(l > 0, l, 1.0)),
                      NEG_INF)
    return out.to(q.dtype), lse


def _p_ds(q, k, v, do, lse, delta, *, causal, window, logit_cap):
    """Recomputed probabilities p and logit gradients dS, (B, H, S, Skv)."""
    group = q.shape[1] // k.shape[1]
    mask = visible(q.shape[2], k.shape[2], causal=causal, window=window,
                   device=q.device)
    z = _logits(q, k, logit_cap=logit_cap)
    p = torch.where(mask, torch.exp(z - lse[..., None]), 0.0)
    vf = v.float().repeat_interleave(group, dim=1)
    dp = do.float() @ vf.transpose(-1, -2)
    ds = p * (dp - delta[..., None])
    if logit_cap is not None:
        ds = ds * (1.0 - torch.square(z / logit_cap))
    return p, ds


def fa_bwd_dq(q, k, v, do, lse, delta, *, causal: bool,
              window: int | None = None, logit_cap: float | None = None):
    """dq = scale · Σ_j dS_ij k_j, float32 (B, H, S, hd)."""
    group = q.shape[1] // k.shape[1]
    _, ds = _p_ds(q, k, v, do, lse, delta, causal=causal, window=window,
                  logit_cap=logit_cap)
    kf = k.float().repeat_interleave(group, dim=1)
    return (ds @ kf) * (1.0 / math.sqrt(q.shape[-1]))


def fa_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool,
               window: int | None = None, logit_cap: float | None = None):
    """(dk, dv), float32 (B, Hkv, Skv, hd): Σ over the GQA group's query
    heads of scale · dSᵀ q and pᵀ dO."""
    B, H, S, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    p, ds = _p_ds(q, k, v, do, lse, delta, causal=causal, window=window,
                  logit_cap=logit_cap)
    dk = (ds.transpose(-1, -2) @ q.float()) * (1.0 / math.sqrt(hd))
    dv = p.transpose(-1, -2) @ do.float()
    fold = lambda t: t.reshape(B, Hkv, H // Hkv, Skv, hd).sum(dim=2)
    return fold(dk), fold(dv)
