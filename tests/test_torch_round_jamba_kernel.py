"""The ``jamba-kernel`` witness of ROADMAP C8
(``tests/test_torch_round_jamba.py`` holds its body and the ``jamba-plain``
one); a file of its own so that ``--dist loadfile`` gives it a worker.
"""
import pytest

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_round_jamba import check_jamba_gap


@pytest.mark.parametrize("use_kernel", [True], ids=["jamba-kernel"])
def test_jamba_gap_is_roundoff_then_router_flips(use_kernel, monkeypatch):
    check_jamba_gap(use_kernel, monkeypatch)
