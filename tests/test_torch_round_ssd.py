"""The round rows of the SSD family against the JAX package's round:
smoke mamba2-780m with the SSD kernel op on and off, and mamba2 and
jamba-1.5-large-398b through the driver.  Split from
``tests/test_torch_round.py`` so that ``--dist loadfile`` gives these rows
a worker of their own; the helpers are that file's.
"""
import pytest

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_round import _check_round, _drive


@pytest.mark.parametrize("arch,use_kernel,opts", [
    ("mamba2-780m", False, {}), ("mamba2-780m", True, {}),
], ids=["mamba2-plain", "mamba2-kernel"])
def test_round_matches_jax(arch, use_kernel, opts):
    _check_round(arch, use_kernel, opts)


def test_driver_runs_mamba2(capsys):
    _drive("mamba2-780m")


def test_driver_runs_jamba():
    """jamba through ``train.main`` with the kernel ops and churn: both
    kernel families' plain versions on the CPU, finite losses, the MoE
    experts on the odd pattern positions."""
    out = _drive("jamba-1.5-large-398b", "--p-drop", "0.5")
    blocks = out["state"]["srv"]["blocks"]
    assert ["we_down" in b["ffn"] for b in blocks] == [False, True] * 4
