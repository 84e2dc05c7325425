"""qwen3-moe-235b-a22b — 128-expert top-8 MoE with qk_norm.

[hf:Qwen/Qwen3-30B-A3B; hf]
94L d_model=4096 64H (GQA kv=4) d_ff=1536(per-expert) vocab=151936
"""
from repro_torch.models.api import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe", n_layers=94, d_model=4096,
    n_heads=64, n_kv_heads=4, head_dim=128, d_ff=1536, vocab=151936,
    pattern=(("attn", "moe"),), n_experts=128, top_k=8, qk_norm=True,
    activation="swiglu", tie_embeddings=False)
