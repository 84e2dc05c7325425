"""Optimizers as functional transforms on nested dicts of tensors.

Interface, as in the JAX package::

    state = <opt>_init(params)
    params, state = <opt>_update(params, grads, state, lr, ...)

``make_optimizer(name, **hyper)`` returns an (init, update) pair with the
hyperparameters bound; update takes (params, grads, state, lr).  Updates
return new tensors and leave their inputs untouched.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.common import tree_leaves, tree_map


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64,
                       device=tree_leaves(params)[0].device)


# ---------------------------------------------------------------------------
# SGD (+ momentum) — the paper's device/server optimizer
# ---------------------------------------------------------------------------

def sgd_init(params, momentum: float = 0.0) -> dict:
    if momentum == 0.0:
        return {"step": _step0(params)}
    return {"step": _step0(params),
            "velocity": tree_map(torch.zeros_like, params)}


def sgd_update(params, grads, state: dict, lr, momentum: float = 0.0,
               weight_decay: float = 0.0):
    if weight_decay:
        grads = tree_map(lambda g, p: g + weight_decay * p, grads, params)
    if momentum == 0.0:
        new_params = tree_map(lambda p, g: p - lr * g, params, grads)
        return new_params, {"step": state["step"] + 1}
    vel = tree_map(lambda v, g: momentum * v + g, state["velocity"], grads)
    new_params = tree_map(lambda p, v: p - lr * v, params, vel)
    return new_params, {"step": state["step"] + 1, "velocity": vel}


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {"step": _step0(params), "mu": tree_map(zeros, params),
            "nu": tree_map(zeros, params)}


def adamw_update(params, grads, state: dict, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
    step = state["step"] + 1
    t = step.float()
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                  state["mu"], grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                  state["nu"], grads)
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t

    def upd(p, m, v):
        mhat = m / bc1
        vhat = v / bc2
        return (p - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p)
                ).to(p.dtype)

    return tree_map(upd, params, mu, nu), {"step": step, "mu": mu, "nu": nu}


def make_optimizer(name: str, **hyper) -> tuple[Callable, Callable]:
    if name == "sgd":
        momentum = hyper.pop("momentum", 0.0)
        return (lambda p: sgd_init(p, momentum),
                lambda p, g, s, lr: sgd_update(p, g, s, lr, momentum, **hyper))
    if name == "adamw":
        return (adamw_init,
                lambda p, g, s, lr: adamw_update(p, g, s, lr, **hyper))
    raise ValueError(f"unknown optimizer {name}")
