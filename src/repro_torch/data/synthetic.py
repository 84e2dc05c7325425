"""Synthetic LM token streams (numpy; a copy of the JAX package's
``lm_dataset``, so both packages draw the same tokens from one seed)."""
from __future__ import annotations

import numpy as np


def lm_dataset(n_tokens: int, vocab: int, seed: int = 0,
               structure: float = 0.85) -> np.ndarray:
    """Token stream where next = (a*cur + b) % vocab with prob `structure`,
    else uniform — learnable by any LM, with an entropy floor."""
    rng = np.random.default_rng(seed)
    a, b = 31, 7
    toks = np.empty(n_tokens, dtype=np.int32)
    toks[0] = rng.integers(0, vocab)
    det = rng.random(n_tokens) < structure
    rnd = rng.integers(0, vocab, size=n_tokens)
    for i in range(1, n_tokens):
        toks[i] = (a * toks[i - 1] + b) % vocab if det[i] else rnd[i]
    return toks
