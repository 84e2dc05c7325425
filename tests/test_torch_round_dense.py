"""The round rows of the dense-attention family against the JAX package's
round: smoke qwen3-32b (qk-norm, the untied lm_head on the server) and
gemma2-27b (local and global blocks, soft-caps, GeGLU) with the
flash-attention op on and off, command-r-plus-104b with it off, and the
three through the driver.  Split from ``tests/test_torch_round.py`` so that
``--dist loadfile`` gives these rows a worker of their own; the helpers are
that file's.
"""
import pytest

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_round import _check_round, _drive


@pytest.mark.parametrize("arch,use_kernel,opts", [
    ("qwen3-32b", False, {}), ("qwen3-32b", True, {}),
    ("gemma2-27b", False, {}), ("gemma2-27b", True, {}),
    ("command-r-plus-104b", False, {}),
], ids=["qwen3-plain", "qwen3-kernel", "gemma2-plain", "gemma2-kernel",
        "command-r-plus-plain"])
def test_round_matches_jax(arch, use_kernel, opts):
    _check_round(arch, use_kernel, opts)


@pytest.mark.parametrize("arch", ["qwen3-32b", "gemma2-27b",
                                  "command-r-plus-104b"])
def test_driver_runs_dense_attention_archs(arch):
    _drive(arch)
