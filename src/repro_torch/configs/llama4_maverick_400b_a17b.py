"""llama4-maverick-400b-a17b — MoE top-1, early fusion.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, 128e top-1,
MoE interleaved every other layer.
"""
from repro_torch.models.api import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, head_dim=128, d_ff=8192, vocab=202048,
    pattern=(("attn", "moe"), ("attn", "dense")), n_experts=128, top_k=1,
    activation="swiglu", tie_embeddings=False)
