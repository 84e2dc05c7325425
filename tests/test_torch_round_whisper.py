"""The round rows of whisper-tiny against the JAX package's round: the
encoder prefix on frames, its next-frame aux MSE, the decoder on the
server (the ring carries the decoder tokens), with the flash-attention op
on and off; the driver.  Split from ``tests/test_torch_round.py`` so that
``--dist loadfile`` gives these rows a worker of their own; the helpers are
that file's.
"""
import pytest

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_round import _check_round, _drive


@pytest.mark.parametrize("arch,use_kernel,opts", [
    ("whisper-tiny", False, {}), ("whisper-tiny", True, {}),
], ids=["whisper-plain", "whisper-kernel"])
def test_round_matches_jax(arch, use_kernel, opts):
    _check_round(arch, use_kernel, opts)


@pytest.mark.parametrize("arch", ["whisper-tiny"])
def test_driver_runs_frontend_archs(arch):
    """The driver feeds zero frontends, as the JAX driver does: whisper's
    encoder then computes on zeros and its next-frame aux loss is exactly
    0.  The ring carries the decoder tokens."""
    out = _drive(arch, "--p-drop", "0.5")
    assert all(m["d_loss"] == 0.0 for m in out["history"])
    ring = out["state"]["act_buf"]
    assert "tokens" in ring and "frontend" not in ring
