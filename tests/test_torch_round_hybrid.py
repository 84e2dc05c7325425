"""The round rows of jamba-1.5-large-398b against the JAX package's round:
the hybrid period (one attention block, seven Mamba blocks, MoE on the odd
positions) with both kernel families' ops on and off.  Both miss 1e-4
(ROADMAP C8); their witness is ``tests/test_torch_round_jamba.py``'s (one
file per row, each a worker of its own under ``--dist loadfile``).  Split
from ``tests/test_torch_round.py``; the helpers are that file's.
"""
import pytest

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_round import _check_round


@pytest.mark.parametrize("arch,use_kernel,opts", [
    ("jamba-1.5-large-398b", False, {}), ("jamba-1.5-large-398b", True, {}),
], ids=["jamba-plain", "jamba-kernel"])
def test_round_matches_jax(arch, use_kernel, opts):
    _check_round(arch, use_kernel, opts)
