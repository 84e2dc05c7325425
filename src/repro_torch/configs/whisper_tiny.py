"""whisper-tiny — encoder-decoder audio; the conv frontend is a stub.

[arXiv:2212.04356; unverified]
4L d_model=384 6H d_ff=1536 vocab=51865; the decoder mirrors the encoder.
The batch carries precomputed mel-frame embeddings (frontend_len frames).
"""
from repro_torch.models.api import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio", n_layers=4, d_model=384,
    n_heads=6, n_kv_heads=6, d_ff=1536, vocab=51865,
    n_decoder_layers=4, frontend_len=1500, activation="gelu",
    tie_embeddings=True)
