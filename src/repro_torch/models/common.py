"""Common model building blocks: initializers, norms, RoPE, activations,
and the tree helpers the port needs.

Params are plain nested dicts and lists of tensors in the JAX layout:
dense weights are ``(in, out)`` and used as ``x @ W``.  Every initializer
draws from an explicit ``torch.Generator`` on the target device.
"""
from __future__ import annotations

import math

import torch


def tree_map(fn, tree, *rest):
    """``jax.tree.map`` over nested dicts, lists and tuples of tensors."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_lerp(a, b, alpha: float):
    """(1 - alpha) * a + alpha * b over trees, in new tensors and in the JAX
    package's order of operations (the FedAsync update)."""
    return tree_map(lambda x, y: (1.0 - alpha) * x + alpha * y, a, b)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
               dtype=torch.float32, scale: float | None = None):
    """Variance-scaling (fan-in) init, (in_dim, out_dim)."""
    std = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return torch.randn(in_dim, out_dim, generator=gen, device=gen.device,
                       dtype=dtype) * std


def embed_init(gen: torch.Generator, vocab: int, dim: int, *,
               dtype=torch.float32):
    return torch.randn(vocab, dim, generator=gen, device=gen.device,
                       dtype=dtype) * 0.02


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(dim: int, *, device, dtype=torch.float32) -> dict:
    return {"scale": torch.ones(dim, device=device, dtype=dtype)}


def rmsnorm_apply(params: dict, x, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def layernorm_init(dim: int, *, device, dtype=torch.float32) -> dict:
    return {"scale": torch.ones(dim, device=device, dtype=dtype),
            "bias": torch.zeros(dim, device=device, dtype=dtype)}


def layernorm_apply(params: dict, x, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (RoPE)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10000.0, *, device):
    """Inverse frequencies for RoPE; shape (head_dim // 2,), float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x, positions, theta: float = 10000.0):
    """Rotate pairs of channels. x: (..., seq, heads, head_dim);
    positions: (..., seq)."""
    inv_freq = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., :, None].float() * inv_freq   # (..., seq, hd/2)
    angles = angles[..., None, :]                          # (..., seq, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def silu(x):
    return x * torch.sigmoid(x)


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation (the exact erf form
    differs from it by up to ~5e-4)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def softcap(logits, cap: float):
    """Gemma-2 style logit soft-capping: cap * tanh(x / cap)."""
    return cap * torch.tanh(logits / cap)
