"""Dense feed-forward block: SwiGLU, the FFN of the architectures this
slice of the port runs.  The projections stay ``torch.matmul``."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .common import dense_init, silu


@dataclass(frozen=True)
class MlpConfig:
    d_model: int
    d_ff: int
    activation: str = "swiglu"


def _check(cfg: MlpConfig) -> None:
    if cfg.activation != "swiglu":
        raise NotImplementedError(
            f"activation {cfg.activation!r}: the torch port runs SwiGLU "
            "only; other FFNs come with their architectures' slices")


def mlp_init(gen: torch.Generator, cfg: MlpConfig, *,
             dtype=torch.float32) -> dict:
    _check(cfg)
    return {"w_gate": dense_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype),
            "w_up": dense_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype),
            "w_down": dense_init(gen, cfg.d_ff, cfg.d_model, dtype=dtype)}


def mlp_apply(params: dict, cfg: MlpConfig, x):
    _check(cfg)
    h = silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]
