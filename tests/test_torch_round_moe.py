"""The round rows of qwen3-moe-235b-a22b against the JAX package's round
(the MoE FFN, its load-balance loss in both losses), with the
flash-attention op on and off; the driver.  Split from
``tests/test_torch_round.py`` so that ``--dist loadfile`` gives these rows
a worker of their own; the helpers are that file's.
"""
import pytest

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_round import _check_round, _drive


@pytest.mark.parametrize("arch,use_kernel,opts", [
    ("qwen3-moe-235b-a22b", False, {}), ("qwen3-moe-235b-a22b", True, {}),
], ids=["qwen3-moe-plain", "qwen3-moe-kernel"])
def test_round_matches_jax(arch, use_kernel, opts):
    _check_round(arch, use_kernel, opts)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b"])
def test_driver_runs_moe_archs(arch):
    """The MoE arch through ``train.main``, with churn: the load-balance
    loss is in both losses, which stay finite."""
    out = _drive(arch, "--p-drop", "0.5")
    assert "we_down" in out["state"]["srv"]["blocks"][0]["ffn"]
