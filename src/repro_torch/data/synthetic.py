"""Synthetic datasets (numpy; copies of the JAX package's
``classification_dataset`` and ``lm_dataset``, so both packages draw the
same data from one seed).

  * ``classification_dataset`` — class-conditional Gaussian images (NHWC)
    whose class structure is learnable, for the sim-mode learners.
  * ``lm_dataset`` — token streams with a deterministic next-token
    structure, for the pod round.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ClassificationData:
    x: np.ndarray      # (N, H, W, C) float32
    y: np.ndarray      # (N,) int32


def classification_dataset(n: int, n_classes: int, img_size: int = 32,
                           channels: int = 3, seed: int = 0,
                           noise: float = 0.8) -> ClassificationData:
    rng = np.random.default_rng(seed)
    # class prototypes with low-frequency spatial structure
    base = rng.normal(size=(n_classes, img_size // 4, img_size // 4,
                            channels))
    protos = base.repeat(4, axis=1).repeat(4, axis=2).astype(np.float32)
    y = rng.integers(0, n_classes, size=n).astype(np.int32)
    x = protos[y] + noise * rng.normal(
        size=(n, img_size, img_size, channels)).astype(np.float32)
    return ClassificationData(x=x.astype(np.float32), y=y)


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
