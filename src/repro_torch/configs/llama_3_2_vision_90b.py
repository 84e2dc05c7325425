"""llama-3.2-vision-90b — VLM backbone, gated cross-attention image layers.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256
The frontend (vision tower) is a stub: the batch carries precomputed patch
embeddings, which the cross-attention layers read.
"""
from repro_torch.models.api import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm", n_layers=100, d_model=8192,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=28672, vocab=128256,
    pattern=(("attn", "dense"), ("attn", "dense"), ("attn", "dense"),
             ("attn", "dense"), ("cross", "dense")),
    frontend_len=1024, activation="swiglu", tie_embeddings=False)
