"""smollm-135m — llama-arch small (primary e2e demo arch).

[hf:HuggingFaceTB/SmolLM-135M; hf]
30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152
"""
from repro_torch.models.api import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m", family="lm", n_layers=30, d_model=576,
    n_heads=9, n_kv_heads=3, head_dim=64, d_ff=1536, vocab=49152,
    activation="swiglu", tie_embeddings=True)
