"""Non-IID data partitioning across devices (paper §5.2): a copy of the JAX
package's ``data/partitioner.py`` (numpy, the same draws from one seed).

"The dataset is split in a non-IID manner across devices using the
Dirichlet distribution with 0.5 prior [31]: each device is assigned a
vector with the size of the number of classes drawn from a Dirichlet
distribution.  For each device, a label is randomly selected based on its
corresponding vector, and a data point with this label is sampled without
replacement, until every data sample is allocated."
"""
from __future__ import annotations

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_devices: int, alpha: float = 0.5,
                        seed: int = 0) -> list[np.ndarray]:
    """Returns per-device index arrays covering all samples exactly once."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    # per-device class preference vectors
    prefs = rng.dirichlet([alpha] * n_classes, size=n_devices)  # (K, C)
    # pools of indices per class, shuffled
    pools = [list(rng.permutation(np.flatnonzero(labels == c)))
             for c in range(n_classes)]
    remaining = np.array([len(p) for p in pools], dtype=np.float64)
    out: list[list[int]] = [[] for _ in range(n_devices)]
    n_total = len(labels)
    # the reference draws a device order here and never reads it; the
    # draw stays, so every later draw of the stream is the reference's
    rng.permutation(n_total)
    k = 0
    for _ in range(n_total):
        dev = k % n_devices
        k += 1
        # renormalise preference over classes that still have samples
        w = prefs[dev] * (remaining > 0)
        s = w.sum()
        if s <= 0:
            w = (remaining > 0).astype(np.float64)
            s = w.sum()
        c = rng.choice(n_classes, p=w / s)
        out[dev].append(pools[c].pop())
        remaining[c] -= 1
    return [np.array(sorted(ix), dtype=np.int64) for ix in out]


def partition_stats(labels: np.ndarray, parts: list[np.ndarray]) -> np.ndarray:
    """(K, C) matrix of class counts per device — for tests/diagnostics."""
    n_classes = int(labels.max()) + 1
    return np.stack([np.bincount(labels[ix], minlength=n_classes)
                     for ix in parts])
