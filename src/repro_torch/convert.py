"""Weights and state across the two packages.

``state_from_numpy`` takes the JAX train state as numpy
(``jax.tree.map(np.asarray, state)``) and gives the port's state, leaf for
leaf, with every stacked axis kept; ``state_to_numpy`` goes back.  Integer
leaves are int64 in the port (torch's index type) and int32 in the JAX
package.  bfloat16 leaves cross as float32 numpy (exact both ways): numpy
has no bfloat16 of its own, and the one JAX hands over (``ml_dtypes``)
torch cannot read.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import tree_map


def state_from_numpy(tree, device):
    def leaf(x):
        x = np.asarray(x)
        if x.dtype.name == "bfloat16":
            return torch.from_numpy(x.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        t = torch.from_numpy(np.array(x, copy=True))
        if np.issubdtype(x.dtype, np.integer):
            t = t.to(torch.int64)
        return t.to(device)
    return tree_map(leaf, tree)


def state_to_numpy(state):
    def leaf(t):
        t = t.detach().cpu()
        x = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        return x.astype(np.int32) if np.issubdtype(x.dtype, np.integer) else x
    return tree_map(leaf, state)
