"""command-r-plus-104b — dense GQA decoder, no-bias.

[hf:CohereForAI/c4ai-command-r-v01; unverified]
64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000
"""
from repro_torch.models.api import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b", family="lm", n_layers=64, d_model=12288,
    n_heads=96, n_kv_heads=8, head_dim=128, d_ff=33792, vocab=256000,
    activation="swiglu", tie_embeddings=True)
