"""Roofline model for one NVIDIA H100 SXM5.

Three terms per (arch × shape), all in seconds *per step per card* (the
port runs one card, so the counted quantities are the card's):

  compute_s    = FLOPs / peak_FLOPs
  memory_s     = bytes / HBM_bw
  collective_s = Σ_kind alg_factor(kind) × bytes_kind / link_bw

The counts come from ``analysis.cost.analyze_call`` (the port's counter
over the torch dispatcher, in the JAX package's ``hlo.py`` role).

Hardware constants, from NVIDIA's H100 datasheet for the SXM5 part
(NVIDIA H100 80GB HBM3 at its 700 W limit), dense rates without sparsity:

  PEAK_FLOPS       989.4e12  bf16 on the tensor cores, the reference's
                             meaning of its peak ("bf16 / chip")
  PEAK_FLOPS_TF32  494.7e12  TF32 on the tensor cores
  PEAK_FLOPS_F32    66.9e12  float32 on the CUDA cores
  HBM_BW            3.35e12  bytes/s, HBM3
  LINK_BW           450e9    bytes/s, NVLink 4, per direction

A card whose power limit is set below 700 W runs slower under load, so a
share against these peaks is stated beside the card's limit.  The port's
rounds run float32 with TF32 off (``core/fedopt_step.make_train_step``):
``roofline(..., peak=PEAK_FLOPS_F32)`` reads a round against the peak its
arithmetic can reach, and a float32-accurate product on the tensor cores
(3xTF32, the attention and SSD kernels) takes three TF32 products, so its
peak is ``PEAK_FLOPS_TF32 / 3``.  Algorithm factors model ring
collectives: an all-reduce moves ≈2× its payload per card (reduce-scatter
+ all-gather phases); one-shot collectives move ≈1×.

Also reports MODEL_FLOPS = 6·N·D (6·N_active·D for MoE) and the usefulness
ratio MODEL_FLOPS / counted FLOPs — remat, aux heads and the server's
pass over the ring show up here.  ``count_params`` and ``model_flops`` are
the JAX package's arithmetic, on the port's ``ArchConfig``.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.api import ArchConfig

from .cost import Cost

PEAK_FLOPS = 989.4e12        # bf16 / card, tensor cores, dense
PEAK_FLOPS_TF32 = 494.7e12   # TF32 / card, tensor cores, dense
PEAK_FLOPS_F32 = 66.9e12     # float32 / card, CUDA cores
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # bytes/s per direction, NVLink 4

ALG_FACTOR = {
    "all-reduce": 2.0,           # ring RS + AG
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "ragged-all-to-all": 1.0,
    "collective-permute": 1.0,
    "collective-broadcast": 1.0,
}


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes: float
    collective_bytes: dict
    model_flops_per_chip: float = 0.0
    peak: float = PEAK_FLOPS

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Lower-bound step time: terms overlap, so max (roofline)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs (per card) — remat/redundancy
        waste."""
        return self.model_flops_per_chip / self.flops if self.flops else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline bound, against
        ``peak``."""
        if self.step_s == 0:
            return 0.0
        return self.model_flops_per_chip / (self.step_s * self.peak)

    def to_dict(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "flops": self.flops,
            "bytes": self.bytes,
            "collective_bytes": dict(self.collective_bytes),
            "model_flops_per_chip": self.model_flops_per_chip,
            "dominant": self.dominant, "useful_ratio": self.useful_ratio,
            "mfu_bound": self.mfu, "step_s": self.step_s, "peak": self.peak,
        }


def roofline(cost: Cost, *, model_flops_total: float = 0.0,
             n_chips: int = 1, peak: float = PEAK_FLOPS) -> RooflineTerms:
    coll_s = sum(ALG_FACTOR.get(k, 1.0) * v / LINK_BW
                 for k, v in cost.collective_bytes.items())
    return RooflineTerms(
        compute_s=cost.flops / peak,
        memory_s=cost.bytes / HBM_BW,
        collective_s=coll_s,
        flops=cost.flops,
        bytes=cost.bytes,
        collective_bytes=dict(cost.collective_bytes),
        model_flops_per_chip=model_flops_total / max(n_chips, 1),
        peak=peak,
    )


# ---------------------------------------------------------------------------
# MODEL_FLOPS accounting (6·N·D; MoE counts active experts only)
# ---------------------------------------------------------------------------

def count_params(arch: ArchConfig) -> tuple[float, float]:
    """(total, active) parameter counts from the config (analytic)."""
    D, hd = arch.d_model, arch.hd
    per_pos_total = per_pos_active = 0.0
    for mixer, ffn in arch.pattern:
        p = 0.0
        if mixer in ("attn", "local", "cross"):
            p += D * arch.n_heads * hd + 2 * D * arch.n_kv_heads * hd \
                + arch.n_heads * hd * D
        elif mixer == "mamba":
            d_in = 2 * D
            G, N = 1, arch.ssm_state
            H = d_in // arch.ssm_head_dim
            d_in_proj = 2 * d_in + 2 * G * N + H
            p += D * d_in_proj + d_in * D         # in_proj + out_proj
        per_pos_total += p
        per_pos_active += p
        if ffn == "dense":
            mats = 3 if arch.activation in ("swiglu", "geglu") else 2
            per_pos_total += mats * D * arch.d_ff
            per_pos_active += mats * D * arch.d_ff
        elif ffn == "moe":
            mats = 3 if arch.activation in ("swiglu", "geglu") else 2
            per_expert = mats * D * arch.d_ff
            per_pos_total += arch.n_experts * per_expert + D * arch.n_experts
            per_pos_active += arch.top_k * per_expert + D * arch.n_experts
    n_periods = arch.n_periods
    total = per_pos_total * n_periods
    active = per_pos_active * n_periods
    # embeddings + head (counted once; tied or not, compute touches it once)
    total += arch.vocab * D
    active += arch.vocab * D
    if not arch.tie_embeddings:
        total += arch.vocab * D
        active += arch.vocab * D
    if arch.n_decoder_layers:
        # decoder stack: self-attn + cross-attn + mlp per 2-layer period
        dec = (2 * (D * arch.n_heads * hd + 2 * D * arch.n_kv_heads * hd
                    + arch.n_heads * hd * D)
               + (3 if arch.activation in ("swiglu", "geglu") else 2)
               * D * arch.d_ff) * (arch.n_decoder_layers // 2 or 1)
        total += dec
        active += dec
    return total, active


def model_flops(arch: ArchConfig, n_tokens: float, *,
                kind: str = "train") -> float:
    """6·N_active·D for training; 2·N_active·D for inference forward."""
    _, active = count_params(arch)
    mult = 6.0 if kind == "train" else 2.0
    return mult * active * n_tokens
