"""gemma2-27b — local+global alternating attention, logit softcap.

[arXiv:2408.00118; hf]
46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000
"""
from repro_torch.models.api import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b", family="lm", n_layers=46, d_model=4608,
    n_heads=32, n_kv_heads=16, head_dim=128, d_ff=36864, vocab=256000,
    attn_softcap=50.0, final_softcap=30.0, window=4096,
    pattern=(("local", "dense"), ("attn", "dense")),
    activation="geglu", tie_embeddings=True)
