"""Dense feed-forward block: the gated SwiGLU and GeGLU, and the plain GELU
FFN (no ``w_gate``).  The projections stay ``torch.matmul``."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .common import dense_init, gelu, silu

GATED = ("swiglu", "geglu")


@dataclass(frozen=True)
class MlpConfig:
    d_model: int
    d_ff: int
    activation: str = "swiglu"   # "swiglu" | "geglu" | "gelu"


def mlp_init(gen: torch.Generator, cfg: MlpConfig, *,
             dtype=torch.float32) -> dict:
    if cfg.activation in GATED:
        return {"w_gate": dense_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype),
                "w_up": dense_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype),
                "w_down": dense_init(gen, cfg.d_ff, cfg.d_model, dtype=dtype)}
    return {"w_up": dense_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype),
            "w_down": dense_init(gen, cfg.d_ff, cfg.d_model, dtype=dtype)}


def mlp_apply(params: dict, cfg: MlpConfig, x):
    if cfg.activation in GATED:
        act = silu if cfg.activation == "swiglu" else gelu
        h = act(x @ params["w_gate"]) * (x @ params["w_up"])
        return h @ params["w_down"]
    return gelu(x @ params["w_up"]) @ params["w_down"]
