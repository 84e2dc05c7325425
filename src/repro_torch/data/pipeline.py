"""Per-device data pipelines: seeded, restartable batch iterators (numpy; a
copy of the JAX package's ``data/pipeline.py``, the same batches from one
seed)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class DeviceDataset:
    """A device's local shard with a deterministic, checkpointable cursor."""
    x: np.ndarray
    y: np.ndarray
    batch: int
    seed: int = 0
    _epoch: int = 0
    _pos: int = 0
    _order: np.ndarray | None = None

    def __post_init__(self):
        self._reshuffle()

    def _reshuffle(self):
        rng = np.random.default_rng((self.seed, self._epoch))
        self._order = rng.permutation(len(self.x))
        self._pos = 0

    def next_batch(self):
        if self._pos + self.batch > len(self.x):
            self._epoch += 1
            self._reshuffle()
        ix = self._order[self._pos:self._pos + self.batch]
        self._pos += self.batch
        if len(ix) < self.batch:  # tiny shards: sample with wraparound
            extra = self._order[: self.batch - len(ix)]
            ix = np.concatenate([ix, extra])
        return self.x[ix], self.y[ix]

    # --- checkpointing ---
    def state(self) -> dict:
        return {"epoch": self._epoch, "pos": self._pos}

    def restore(self, state: dict):
        self._epoch = state["epoch"]
        self._reshuffle()
        self._pos = state["pos"]
