"""Checkpoints: atomic, CRC-checked snapshots in the JAX package's layout
(``store``)."""
from . import store

__all__ = ["store"]
