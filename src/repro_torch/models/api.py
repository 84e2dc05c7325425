"""Architecture description consumed by the port's model code.

One :class:`ArchConfig` describes a model whose layer stack repeats a
*period*: ``pattern`` lists (mixer, ffn) pairs and the stack is
``pattern * n_periods``.  Per-position params are stacked over periods,
leaves shaped ``(n_periods, ...)``, as in the JAX package.  The port runs
the ``("attn", "dense")``, ``("local", "dense")``, ``("mamba", "none")``,
``("cross", "dense")``, ``("attn", "none")``, ``("attn", "moe")``,
``("mamba", "moe")`` and ``("mamba", "dense")`` blocks: decoder LMs
(smollm, mamba2, command-r-plus, qwen3, gemma2), the mixture-of-experts
LMs (qwen3-moe, llama4-maverick: ``n_experts`` experts, ``top_k`` per
token, capacity factor ``moe_capacity_factor``), the hybrid (jamba:
attention and Mamba blocks in one period, MoE on its odd positions), the VLM
backbone whose cross blocks read the frontend stub's embeddings
(llama-3.2-vision) and the encoder-decoder (whisper: ``n_layers`` encoder
layers on the frame stub, ``n_decoder_layers`` decoder layers).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

from .attention import AttentionConfig
from .mamba import MambaConfig
from .mlp import MlpConfig, MoeConfig


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    pattern: tuple = (("attn", "dense"),)
    head_dim: int | None = None
    qk_norm: bool = False
    attn_softcap: float | None = None
    final_softcap: float | None = None
    window: int | None = None          # sliding-window size for "local" mixers
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    activation: str = "swiglu"
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.0
    # Mamba / SSD
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # enc-dec (audio): n_layers counts encoder layers; decoder mirrors it
    n_decoder_layers: int = 0
    # vlm / audio frontend stub: frontend embedding positions; 0 = none
    frontend_len: int = 0
    aux_dim: int = 512                 # FedOptima aux head bottleneck dim
    ce_chunk: int = 512                # sequence positions per CE chunk
    attn_chunk: int = 1024             # query-chunk size of sdpa_chunked

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_periods(self) -> int:
        if self.n_layers % self.period:
            raise ValueError(f"{self.name}: {self.n_layers} layers is not a "
                             f"multiple of the period {self.period}")
        return self.n_layers // self.period

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else \
            self.d_model // self.n_heads

    def attn_cfg(self, mixer: str) -> AttentionConfig:
        # the JAX package's test: no arch has the family "audio_enc", so
        # whisper's ("audio") encoder self-attention is causal there too
        return AttentionConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            qk_norm=self.qk_norm, attn_softcap=self.attn_softcap,
            window=self.window if mixer == "local" else None,
            rope_theta=self.rope_theta, causal=(self.family != "audio_enc"),
            chunk_q=self.attn_chunk)

    def cross_cfg(self) -> AttentionConfig:
        """Cross-attention to the frontend: no qk-norm, cap or window, and
        no causal mask."""
        return AttentionConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            causal=False, chunk_q=self.attn_chunk)

    def mlp_cfg(self) -> MlpConfig:
        return MlpConfig(d_model=self.d_model, d_ff=self.d_ff,
                         activation=self.activation)

    def moe_cfg(self) -> MoeConfig:
        return MoeConfig(d_model=self.d_model, d_ff=self.d_ff,
                         n_experts=self.n_experts, top_k=self.top_k,
                         activation=self.activation)

    def mamba_cfg(self) -> MambaConfig:
        return MambaConfig(d_model=self.d_model, d_state=self.ssm_state,
                           head_dim=self.ssm_head_dim, chunk=self.ssm_chunk)

    def scaled(self, **kw) -> "ArchConfig":
        """Reduced copy for smoke tests."""
        return replace(self, **kw)
