"""Attention with GQA, qk-norm, sliding window and logit soft-capping, and
cross-attention (llama-3.2-vision's image layers, whisper's decoder).

``attention_apply`` dispatches to the flash-attention kernels
(``repro_torch.kernels.ops.flash_attention``) when ``use_kernel`` is set,
otherwise to the plain ``sdpa_chunked``.  Both share the parameter layout
and both are differentiable.  The projections stay ``torch.matmul``.
``attention_decode`` is the one-token step over a KV cache
(``kv_cache_init``), global or a ring of the window's length.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .common import (apply_rope, dense_init, rmsnorm_apply, rmsnorm_init,
                     softcap)


@dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int | None = None          # default d_model // n_heads
    qk_norm: bool = False                # Qwen3
    attn_softcap: float | None = None    # Gemma-2 (e.g. 50.0)
    window: int | None = None            # sliding-window size; None = global
    rope_theta: float = 10000.0
    causal: bool = True
    chunk_q: int = 1024                  # query-chunk size of sdpa_chunked

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else \
            self.d_model // self.n_heads


def attention_init(gen: torch.Generator, cfg: AttentionConfig, *,
                   dtype=torch.float32) -> dict:
    hd = cfg.hd
    p = {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd, dtype=dtype),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype=dtype),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype=dtype),
        "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model, dtype=dtype,
                         scale=1.0 / (cfg.n_heads * hd) ** 0.5),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, device=gen.device, dtype=dtype)
        p["k_norm"] = rmsnorm_init(hd, device=gen.device, dtype=dtype)
    return p


def _project_qkv(params: dict, cfg: AttentionConfig, x, xkv=None):
    """x: (B, S, D) -> q (B, S, H, hd); k/v (B, Skv, Hkv, hd) from ``xkv``
    (B, Skv, D), or from x for self-attention; with qk-norm, q and k are
    RMS-normed over hd here, before RoPE."""
    xkv = x if xkv is None else xkv
    B, S, _ = x.shape
    Skv = xkv.shape[1]
    q = (x @ params["wq"]).reshape(B, S, cfg.n_heads, cfg.hd)
    k = (xkv @ params["wk"]).reshape(B, Skv, cfg.n_kv_heads, cfg.hd)
    v = (xkv @ params["wv"]).reshape(B, Skv, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        q = rmsnorm_apply(params["q_norm"], q)
        k = rmsnorm_apply(params["k_norm"], k)
    return q, k, v


def _mask(qpos, kpos, *, causal: bool, window: int | None):
    mask = torch.ones(qpos.shape[0], kpos.shape[0], dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def sdpa_reference(q, k, v, *, causal: bool, window: int | None,
                   logit_cap: float | None):
    """Plain attention with GQA, materialising the (S, Skv) scores.
    q: (B, S, H, hd); k, v: (B, Skv, Hkv, hd)."""
    B, S, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, Hkv, H // Hkv, hd).float()
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) / math.sqrt(hd)
    if logit_cap is not None:
        logits = softcap(logits, logit_cap)
    mask = _mask(torch.arange(S, device=q.device),
                 torch.arange(Skv, device=q.device), causal=causal,
                 window=window)
    probs = torch.softmax(logits.masked_fill(~mask, -1e30), dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def sdpa_chunked(q, k, v, *, causal: bool, window: int | None,
                 logit_cap: float | None, chunk_q: int = 1024):
    """Query-chunked attention, numerically the same as sdpa_reference; at
    most one chunk's (B, H, cq, Skv) logits exist at a time.  K/V are
    expanded to H heads, as in the JAX version."""
    B, S, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    kf = k.repeat_interleave(group, dim=2).float()     # (B, Skv, H, hd)
    vf = v.repeat_interleave(group, dim=2).float()
    scale = 1.0 / math.sqrt(hd)
    kv_pos = torch.arange(Skv, device=q.device)

    def chunk_attn(qc, qpos):
        logits = torch.einsum("bqhd,bthd->bhqt", qc.float(), kf) * scale
        if logit_cap is not None:
            logits = softcap(logits, logit_cap)
        mask = _mask(qpos, kv_pos, causal=causal, window=window)
        probs = torch.softmax(logits.masked_fill(~mask, -1e30), dim=-1)
        return torch.einsum("bhqt,bthd->bqhd", probs, vf).to(q.dtype)

    cq = min(chunk_q, S)
    pos = torch.arange(S, device=q.device)
    return torch.cat([chunk_attn(q[:, i:i + cq], pos[i:i + cq])
                      for i in range(0, S, cq)], dim=1)


def attention_apply(params: dict, cfg: AttentionConfig, x, *, xkv=None,
                    positions=None, use_kernel: bool = False,
                    return_kv: bool = False):
    """Full-sequence attention (training, prefill). x: (B, S, D).
    Self-attention rotates q and k (RoPE) and masks as ``cfg`` says;
    cross-attention to ``xkv`` (B, Skv, D) has neither RoPE nor a causal
    mask.  With ``return_kv`` also returns the (rotated) {"k", "v"}
    (B, Skv, Hkv, hd) to prime the caches (prefill)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, xkv)
    if xkv is None:
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        causal = cfg.causal
    else:
        causal = False
    if use_kernel:
        from repro_torch.kernels import ops as kops
        out = kops.flash_attention(q, k, v, causal=causal, window=cfg.window,
                                   logit_cap=cfg.attn_softcap)
    else:
        out = sdpa_chunked(q, k, v, causal=causal, window=cfg.window,
                           logit_cap=cfg.attn_softcap, chunk_q=cfg.chunk_q)
    out = out.reshape(B, S, cfg.n_heads * cfg.hd) @ params["wo"]
    if return_kv:
        return out, {"k": k, "v": v}
    return out


# ---------------------------------------------------------------------------
# KV-cache decode path
# ---------------------------------------------------------------------------

def kv_cache_init(cfg: AttentionConfig, batch: int, max_len: int,
                  dtype=torch.float32, *, device=None) -> dict:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, device=device, dtype=dtype),
            "v": torch.zeros(shape, device=device, dtype=dtype)}


def attention_decode(params: dict, cfg: AttentionConfig, x, cache: dict,
                     position: int, ring: bool = False):
    """Single-token decode step.  x: (B, 1, D); cache {"k", "v"}
    (B, T, Hkv, hd); ``position`` (a host int) is the new token's index,
    the same for the whole batch.  Returns (out (B, 1, D), cache): the new
    k and v are written into ``cache`` in place (the JAX package returns
    an updated copy), as the port's train step updates its state.

    ``ring`` treats the cache as a ring buffer of length T (a sliding-
    window layer keeps only the last ``window`` K/V): the write index is
    ``position % T`` and slot j holds position p_j = position - ((position
    - j) % T), valid iff p_j >= 0.  RoPE uses absolute positions, so ring
    slots stay rotated as written."""
    B = x.shape[0]
    T = cache["k"].shape[1]
    q, k, v = _project_qkv(params, cfg, x)
    pos = torch.full((B, 1), position, dtype=torch.int64, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    write = position % T if ring else position
    cache["k"][:, write] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, write] = v[:, 0].to(cache["v"].dtype)
    kv_pos = torch.arange(T, device=x.device)
    if ring:
        # the ring's length is the window: no further window mask
        valid = position - torch.remainder(position - kv_pos, T) >= 0
    else:
        valid = kv_pos <= position
        if cfg.window is not None:
            valid &= kv_pos > position - cfg.window
    hd, Hkv = cfg.hd, cfg.n_kv_heads
    qg = q.reshape(B, 1, Hkv, cfg.n_heads // Hkv, hd).float()
    logits = torch.einsum("bskgh,btkh->bkgst", qg, cache["k"].float()) \
        * (1.0 / math.sqrt(hd))
    if cfg.attn_softcap is not None:
        logits = softcap(logits, cfg.attn_softcap)
    probs = torch.softmax(logits.masked_fill(~valid, -1e30), dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, cache["v"].float())
    out = out.reshape(B, 1, cfg.n_heads * hd).to(x.dtype) @ params["wo"]
    return out, cache
