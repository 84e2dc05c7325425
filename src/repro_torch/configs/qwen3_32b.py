"""qwen3-32b — dense GQA decoder with qk_norm.

[hf:Qwen/Qwen3-8B; hf]
64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936
"""
from repro_torch.models.api import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b", family="lm", n_layers=64, d_model=5120,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=25600, vocab=151936,
    qk_norm=True, activation="swiglu", tie_embeddings=False)
