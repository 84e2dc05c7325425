"""mamba2-780m — attention-free SSM (state-space duality).

[arXiv:2405.21060; unverified]
48L d_model=1536 ssm_state=128 vocab=50280
"""
from repro_torch.models.api import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m", family="ssm", n_layers=48, d_model=1536,
    n_heads=24, n_kv_heads=24, d_ff=0, vocab=50280,
    pattern=(("mamba", "none"),), ssm_state=128, ssm_head_dim=64,
    tie_embeddings=True)
