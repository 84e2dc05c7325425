"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7, MoE 16e top-2.

[arXiv:2403.19887; hf]
72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536
Period: 8 layers, attention at position 0, MoE on odd positions.
"""
from repro_torch.models.api import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid", n_layers=72, d_model=8192,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=24576, vocab=65536,
    pattern=(("attn", "dense"), ("mamba", "moe"), ("mamba", "dense"),
             ("mamba", "moe"), ("mamba", "dense"), ("mamba", "moe"),
             ("mamba", "dense"), ("mamba", "moe")),
    n_experts=16, top_k=2, ssm_state=128, ssm_head_dim=64,
    activation="swiglu", tie_embeddings=False)
