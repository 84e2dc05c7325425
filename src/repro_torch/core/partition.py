"""Pre-processor: DNN profiling + split-point selection (paper §3.2.1).

The Pre-processor profiles the model M to obtain per-layer FLOPs {O_l} and
output sizes {S_l}, then picks the split point (Eq. 6–8)::

    t_train_k(l)    = sum_{i<=l} O_i / o_k                      (6)
    t_transfer_k(l) = S_l / b_k                                 (7)
    l* = argmin_l max_k max(t_train_k(l), t_transfer_k(l))      (8)

Profiles are analytic (no tracing): exact MAC counts for convs/matmuls.
For transformers the unit "layer" is one *period* of the pattern so splits
never cut an alternation motif (gemma2 local/global, jamba 1:7).

A copy of the JAX package's ``core/partition.py``, on the port's
``ArchConfig`` and ``CnnConfig``: host arithmetic only, the same floats.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.models.api import ArchConfig
from repro_torch.models.cnn import CnnConfig


@dataclass(frozen=True)
class LayerProfile:
    """Per-splittable-unit profile, plus totals."""
    flops: tuple           # O_l: forward FLOPs per sample for unit l
    out_bytes: tuple       # S_l: activation bytes per sample at unit l output
    names: tuple
    total_flops: float     # full forward FLOPs per sample
    head_flops: float      # final head/classifier FLOPs per sample
    param_bytes_cum: tuple # cumulative parameter bytes through unit l

    @property
    def n_units(self) -> int:
        return len(self.flops)


# ---------------------------------------------------------------------------
# Transformer profiles (per period, per sample = per sequence)
# ---------------------------------------------------------------------------

def _attn_flops(cfg: ArchConfig, seq: int, window: int | None) -> float:
    hd = cfg.hd
    proj = 2 * seq * cfg.d_model * (cfg.n_heads * hd)            # q
    proj += 2 * 2 * seq * cfg.d_model * (cfg.n_kv_heads * hd)    # k, v
    proj += 2 * seq * (cfg.n_heads * hd) * cfg.d_model           # o
    ctx = min(seq, window) if window else seq
    scores = 2 * 2 * seq * ctx * cfg.n_heads * hd                # qk^T + pv
    return float(proj + scores)


def _mlp_flops(cfg: ArchConfig, seq: int) -> float:
    mats = 3 if cfg.activation in ("swiglu", "geglu") else 2
    return float(mats * 2 * seq * cfg.d_model * cfg.d_ff)


def _moe_flops(cfg: ArchConfig, seq: int) -> float:
    mats = 3 if cfg.activation in ("swiglu", "geglu") else 2
    router = 2 * seq * cfg.d_model * cfg.n_experts
    return float(router + cfg.top_k * mats * 2 * seq * cfg.d_model * cfg.d_ff)


def _mamba_flops(cfg: ArchConfig, seq: int) -> float:
    m = cfg.mamba_cfg()
    di, N, H, P = m.d_inner, m.d_state, m.n_heads, m.head_dim
    proj = 2 * seq * cfg.d_model * (2 * di + 2 * m.n_groups * N + H)
    proj += 2 * seq * di * cfg.d_model
    conv = 2 * seq * m.conv_dim * m.conv_kernel
    Q = min(m.chunk, seq)
    # SSD: intra-chunk (seq*Q per head: CB^T scores + weighted sum) + states
    intra = 2 * 2 * seq * Q * H * (N + P) / 2 * 2  # scores (N) + apply (P)
    states = 2 * 2 * seq * H * N * P               # state build + read
    return float(proj + conv + intra + states)


def _period_flops(cfg: ArchConfig, seq: int, frontend_len: int = 0) -> float:
    total = 0.0
    for mixer, ffn in cfg.pattern:
        if mixer in ("attn",):
            total += _attn_flops(cfg, seq, None)
        elif mixer == "local":
            total += _attn_flops(cfg, seq, cfg.window)
        elif mixer == "cross":
            hd = cfg.hd
            fl = frontend_len or cfg.frontend_len or seq
            total += 2 * seq * cfg.d_model * cfg.n_heads * hd * 2      # q,o
            total += 2 * 2 * fl * cfg.d_model * cfg.n_kv_heads * hd    # k,v
            total += 2 * 2 * seq * fl * cfg.n_heads * hd
        elif mixer == "mamba":
            total += _mamba_flops(cfg, seq)
        if ffn == "dense":
            total += _mlp_flops(cfg, seq)
        elif ffn == "moe":
            total += _moe_flops(cfg, seq)
    return total


def _period_param_bytes(cfg: ArchConfig, dtype_bytes: int = 4) -> float:
    n = 0
    hd = cfg.hd
    for mixer, ffn in cfg.pattern:
        if mixer in ("attn", "local", "cross"):
            n += cfg.d_model * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) \
                + cfg.n_heads * hd * cfg.d_model
        elif mixer == "mamba":
            m = cfg.mamba_cfg()
            n += cfg.d_model * (2 * m.d_inner + 2 * m.n_groups * m.d_state + m.n_heads)
            n += m.d_inner * cfg.d_model + m.conv_dim * m.conv_kernel
        if ffn == "dense":
            mats = 3 if cfg.activation in ("swiglu", "geglu") else 2
            n += mats * cfg.d_model * cfg.d_ff
        elif ffn == "moe":
            mats = 3 if cfg.activation in ("swiglu", "geglu") else 2
            n += cfg.n_experts * mats * cfg.d_model * cfg.d_ff + cfg.d_model * cfg.n_experts
    return float(n * dtype_bytes)


def transformer_profile(cfg: ArchConfig, seq: int, dtype_bytes: int = 4) -> LayerProfile:
    per_period = _period_flops(cfg, seq)
    embed = 0.0  # lookup, negligible FLOPs
    head = 2 * seq * cfg.d_model * cfg.vocab
    act_bytes = seq * cfg.d_model * dtype_bytes
    n = cfg.n_periods
    pbytes = _period_param_bytes(cfg, dtype_bytes)
    return LayerProfile(
        flops=tuple([per_period] * n),
        out_bytes=tuple([act_bytes] * n),
        names=tuple(f"period_{i}" for i in range(n)),
        total_flops=embed + per_period * n + head,
        head_flops=head,
        param_bytes_cum=tuple(cfg.vocab * cfg.d_model * dtype_bytes + pbytes * (i + 1)
                              for i in range(n)),
    )


# ---------------------------------------------------------------------------
# CNN profiles (per sample)
# ---------------------------------------------------------------------------

def cnn_profile(cfg: CnnConfig, dtype_bytes: int = 4) -> LayerProfile:
    flops, out_bytes, names, pbytes_cum = [], [], [], []
    cin, hw, pbytes = cfg.in_channels, cfg.img_size, 0.0
    for spec in cfg.layers:
        kind = spec["kind"]
        if kind == "conv":
            s = spec.get("stride", 1)
            hw_out = hw // s
            f = 2 * spec["k"] ** 2 * cin * spec["cout"] * hw_out * hw_out
            pbytes += spec["k"] ** 2 * cin * spec["cout"] * dtype_bytes
            cin, hw = spec["cout"], hw_out // (2 if spec.get("pool") else 1)
        elif kind == "bneck":
            ce = int(round(cin * spec["expand"]))
            s = spec.get("stride", 1)
            hw_out = hw // s
            f = (2 * cin * ce * hw * hw               # expand 1x1
                 + 2 * spec["k"] ** 2 * ce * hw_out * hw_out   # depthwise
                 + 2 * ce * spec["cout"] * hw_out * hw_out)    # project
            pbytes += (cin * ce + spec["k"] ** 2 * ce + ce * spec["cout"]) * dtype_bytes
            cin, hw = spec["cout"], hw_out
        elif kind in ("flatten", "gap"):
            f = 0.0
            cin = cin * hw * hw if kind == "flatten" else cin
            hw = 1
        elif kind == "fc":
            f = 2 * cin * spec["dout"]
            pbytes += cin * spec["dout"] * dtype_bytes
            cin = spec["dout"]
        flops.append(float(f))
        out_bytes.append(float(cin * hw * hw * dtype_bytes))
        names.append(f"{kind}_{len(names)}")
        pbytes_cum.append(pbytes)
    total = sum(flops)
    return LayerProfile(tuple(flops), tuple(out_bytes), tuple(names),
                        total, flops[-1], tuple(pbytes_cum))


# ---------------------------------------------------------------------------
# Split-point selection (Eq. 6–8)
# ---------------------------------------------------------------------------

def select_split(profile: LayerProfile, device_flops: list[float],
                 bandwidths: list[float], min_server_units: int = 1,
                 batch: int = 1) -> int:
    """Returns l* in [1, n_units - min_server_units].

    device_flops o_k in FLOP/s; bandwidths b_k in bytes/s; batch scales the
    per-iteration compute/transfer identically (so it cancels in the argmax
    structure but keeps units honest)."""
    n = profile.n_units
    lo, hi = 1, n - min_server_units
    best_l, best_cost = lo, float("inf")
    cum = np.cumsum(profile.flops)
    for l in range(lo, hi + 1):
        cost = 0.0
        for o_k, b_k in zip(device_flops, bandwidths):
            t_train = batch * cum[l - 1] / o_k
            t_tx = batch * profile.out_bytes[l - 1] / b_k
            cost = max(cost, max(t_train, t_tx))
        if cost < best_cost:
            best_cost, best_l = cost, l
    return best_l


def split_costs(profile: LayerProfile, device_flops: list[float],
                bandwidths: list[float], batch: int = 1) -> np.ndarray:
    """Full cost curve over l (for the partition benchmark/figure)."""
    cum = np.cumsum(profile.flops)
    out = []
    for l in range(1, profile.n_units + 1):
        cost = max(max(batch * cum[l - 1] / o, batch * profile.out_bytes[l - 1] / b)
                   for o, b in zip(device_flops, bandwidths))
        out.append(cost)
    return np.array(out)
