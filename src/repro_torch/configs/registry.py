"""Architecture registry: ``--arch <id>`` resolves here.

The port registers the architectures whose layers it runs:
``smollm-135m``, ``mamba2-780m``, ``command-r-plus-104b``, ``qwen3-32b``,
``gemma2-27b``, ``llama-3.2-vision-90b``, ``whisper-tiny``,
``qwen3-moe-235b-a22b``, ``llama4-maverick-400b-a17b`` and
``jamba-1.5-large-398b``: all ten of the JAX registry's.
``smoke_config`` is the JAX registry's reduction (same family and pattern,
tiny dims, runnable on CPU).
"""
from __future__ import annotations

from repro_torch.models.api import ArchConfig

from . import (command_r_plus_104b, gemma2_27b, jamba_1_5_large_398b,
               llama4_maverick_400b_a17b, llama_3_2_vision_90b, mamba2_780m,
               qwen3_32b, qwen3_moe_235b_a22b, smollm_135m, whisper_tiny)

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG for m in (command_r_plus_104b, qwen3_32b,
                                      smollm_135m, gemma2_27b,
                                      llama_3_2_vision_90b, mamba2_780m,
                                      whisper_tiny, jamba_1_5_large_398b,
                                      qwen3_moe_235b_a22b,
                                      llama4_maverick_400b_a17b)}


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}' for the torch port; known: "
                       f"{sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ArchConfig:
    cfg = get(name)
    kw = dict(
        n_layers=2 * cfg.period, d_model=64, n_heads=4,
        n_kv_heads=max(1, 4 * cfg.n_kv_heads // cfg.n_heads), head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 96, vocab=211,
        frontend_len=8 if cfg.frontend_len else 0,
        window=8 if cfg.window else None, aux_dim=32, ce_chunk=64)
    if cfg.n_experts:
        kw.update(n_experts=8, top_k=min(cfg.top_k, 2))
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
    if cfg.n_decoder_layers:
        kw.update(n_decoder_layers=2)
    return cfg.scaled(**kw)
