"""Mamba2 block (state-space duality / SSD).

Follows arXiv:2405.21060, as the JAX package's ``models/mamba.py``.  The
sequence mixer is the chunked SSD algorithm: a quadratic term within each
chunk and a linear recurrence across chunks.  ``mamba_apply`` sends it to
the CUDA SSD kernels (``repro_torch.kernels.ops.ssd``) when ``use_kernel``
is set, otherwise to the plain ``ssd_chunked``; both are differentiable.
With ``return_state`` (prefill) it also returns the decode state after the
last position; the kernel path then takes the forward kernel alone
(``ops.ssd_prefill``, no gradient).  ``mamba_decode`` steps that state one
token at a time.

Shapes (per mamba2 conventions):
  x      (B, T, H, P)   inputs per head      (P = head_dim)
  dt     (B, T, H)      per-head step size (after softplus + bias)
  A      (H,)           negative decay rates (stored as A_log)
  B, C   (B, T, G, N)   input/output projections (G groups, N = ssm state)
  state  (B, H, N, P)
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as Fn

from repro_torch.kernels import ref

from .common import dense_init, rmsnorm_apply, rmsnorm_init, silu


@dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_state: int = 128          # N
    head_dim: int = 64          # P
    expand: int = 2
    n_groups: int = 1
    conv_kernel: int = 4
    chunk: int = 256            # SSD chunk length Q
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def mamba_init(gen: torch.Generator, cfg: MambaConfig, *,
               dtype=torch.float32) -> dict:
    H, G, N = cfg.n_heads, cfg.n_groups, cfg.d_state
    dev = gen.device
    d_in_proj = 2 * cfg.d_inner + 2 * G * N + H  # z, x, B, C, dt
    # dt bias so softplus(dt_bias) spans [dt_min, dt_max] log-uniformly
    u = torch.rand(H, generator=gen, device=dev)
    lo, hi = math.log(cfg.dt_min), math.log(cfg.dt_max)
    dt_init = torch.exp(u * (hi - lo) + lo)
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))  # inverse softplus
    return {
        "in_proj": dense_init(gen, cfg.d_model, d_in_proj, dtype=dtype),
        "conv_w": torch.randn(cfg.conv_kernel, cfg.conv_dim, generator=gen,
                              device=dev, dtype=dtype) * 0.2,
        "conv_b": torch.zeros(cfg.conv_dim, device=dev, dtype=dtype),
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                        device=dev)),
        "D": torch.ones(H, device=dev),
        "dt_bias": dt_bias,
        "norm": rmsnorm_init(cfg.d_inner, device=dev, dtype=dtype),
        "out_proj": dense_init(gen, cfg.d_inner, cfg.d_model, dtype=dtype),
    }


def _split_in_proj(cfg: MambaConfig, zxbcdt):
    """(z, xBC, dt) along the last axis; dt is (..., H)."""
    return torch.split(zxbcdt, [cfg.d_inner, cfg.conv_dim, cfg.n_heads],
                       dim=-1)


def _causal_conv(xBC, conv_w, conv_b, cache=None):
    """Depthwise causal conv over time, as a shift-sum.  xBC: (B, T, Cd);
    conv_w: (K, Cd); ``cache`` (B, K-1, Cd), the last K-1 inputs before
    xBC (zeros when None).  Returns (out, the new cache)."""
    K, T = conv_w.shape[0], xBC.shape[1]
    xp = Fn.pad(xBC, (0, 0, K - 1, 0)) if cache is None else \
        torch.cat([cache.to(xBC.dtype), xBC], dim=1)
    # sum_k w[k] * x[t - (K-1) + k]
    out = sum(xp[:, k:k + T, :] * conv_w[k][None, None, :] for k in range(K))
    # a copy: a view would keep all of xp alive in the caches
    return silu(out + conv_b), xp[:, T:, :].clone()


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """Chunked SSD scan, the plain path.  x: (b, T, H, P); dt: (b, T, H);
    A: (H,); B, C: (b, T, G, N); T divisible by ``chunk``.  Returns
    (y (b, T, H, P), final_state (b, H, N, P)), float32.  Each decay
    e^{L_t - L_s} is taken only where s <= t (``kernels.ref``), so its
    gradient stays finite at any decay."""
    y, _, h_final = ref.ssd_scan(x, dt, A, B, C, chunk=chunk)
    return y, h_final


def mamba_apply(params: dict, cfg: MambaConfig, x, use_kernel: bool = False,
                return_state: bool = False):
    """Full-sequence forward.  x: (B, T, d_model) -> (B, T, d_model).
    With ``return_state`` also returns the decode state after the last
    position, {"ssm" (B, H, N, P) float32, "conv" (B, K-1, conv_dim)}, to
    prime the caches (prefill)."""
    Bb, T, _ = x.shape
    H, G, N, P = cfg.n_heads, cfg.n_groups, cfg.d_state, cfg.head_dim
    z, xBC, dt = _split_in_proj(cfg, x @ params["in_proj"])
    xBC, conv_cache = _causal_conv(xBC, params["conv_w"], params["conv_b"])
    xi, Bm, Cm = torch.split(xBC, [cfg.d_inner, G * N, G * N], dim=-1)
    dt = Fn.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    xi = xi.reshape(Bb, T, H, P)
    Bm = Bm.reshape(Bb, T, G, N)
    Cm = Cm.reshape(Bb, T, G, N)
    state = None
    if use_kernel:
        from repro_torch.kernels import ops as kops
        if return_state:   # the forward kernel alone; no gradient
            y, state = kops.ssd_prefill(xi, dt, A, Bm, Cm, chunk=cfg.chunk)
        else:              # differentiable; ops.ssd clamps and pads
            y = kops.ssd(xi, dt, A, Bm, Cm, chunk=cfg.chunk)
    else:
        # pad T to a chunk multiple (zero dt => identity decay, zero input)
        Q = min(cfg.chunk, T)
        pad = (-T) % Q
        y, state = ssd_chunked(*(ref.pad_steps(t, pad) for t in (xi, dt)), A,
                               *(ref.pad_steps(t, pad) for t in (Bm, Cm)), Q)
        y = y[:, :T]
    y = y + params["D"][None, None, :, None] * xi.float()
    y = y.reshape(Bb, T, cfg.d_inner).to(x.dtype)
    y = rmsnorm_apply(params["norm"], y * silu(z))
    out = y @ params["out_proj"]
    if return_state:
        return out, {"ssm": state, "conv": conv_cache}
    return out


# ---------------------------------------------------------------------------
# Decode (single token, recurrent state)
# ---------------------------------------------------------------------------

def mamba_state_init(cfg: MambaConfig, batch: int, dtype=torch.float32, *,
                     device=None) -> dict:
    return {
        "ssm": torch.zeros(batch, cfg.n_heads, cfg.d_state, cfg.head_dim,
                           device=device),
        "conv": torch.zeros(batch, cfg.conv_kernel - 1, cfg.conv_dim,
                            device=device, dtype=dtype),
    }


def mamba_decode(params: dict, cfg: MambaConfig, x, state: dict):
    """One-step decode.  x: (B, 1, d_model) -> (y (B, 1, d_model), the new
    state): h <- e^{dt A} h + dt B xᵀ, y = C · h + D x."""
    Bb = x.shape[0]
    H, G, N, P = cfg.n_heads, cfg.n_groups, cfg.d_state, cfg.head_dim
    z, xBC, dt = _split_in_proj(cfg, x @ params["in_proj"])
    xBC, conv_cache = _causal_conv(xBC, params["conv_w"], params["conv_b"],
                                   cache=state["conv"])
    xi, Bm, Cm = torch.split(xBC, [cfg.d_inner, G * N, G * N], dim=-1)
    dt = Fn.softplus(dt.float() + params["dt_bias"])[:, 0]          # (B, H)
    A = -torch.exp(params["A_log"])
    xi = xi.reshape(Bb, H, P).float()
    Bm = Bm.reshape(Bb, G, N).float().repeat_interleave(H // G, dim=1)
    Cm = Cm.reshape(Bb, G, N).float().repeat_interleave(H // G, dim=1)
    a = torch.exp(dt * A[None, :])                                  # (B, H)
    h = state["ssm"] * a[..., None, None] + \
        torch.einsum("bhn,bh,bhp->bhnp", Bm, dt, xi)
    y = torch.einsum("bhn,bhnp->bhp", Cm, h) + params["D"][None, :, None] * xi
    y = y.reshape(Bb, 1, cfg.d_inner).to(x.dtype)
    y = rmsnorm_apply(params["norm"], y * silu(z))
    return y @ params["out_proj"], {"ssm": h, "conv": conv_cache}
