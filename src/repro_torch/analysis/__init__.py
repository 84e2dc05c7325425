"""Analysis layer: the protocol sanitizer.

Stdlib only, so ``from repro_torch.analysis import sanitize`` inside
``repro_torch.core`` costs no torch import and creates no cycle.
"""
from . import sanitize  # noqa: F401

__all__ = ["sanitize"]
