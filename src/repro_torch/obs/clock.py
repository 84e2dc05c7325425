"""The blessed wall-clock for instrumented hot paths.

Hot-path modules (``core/``, ``memory/``, ``fleet/``, ``runtime/``,
``faults/``) must not call ``time.perf_counter``/``time.monotonic``
directly — lint rule RP002 enforces it — so that every interval a span
or a stats field reports was read from ONE clock, and tests can reason
about the tracer's time domain.  ``now()`` is that clock: monotonic,
seconds, float.  Simulated runs never call it (their clock is ``sim.t``,
passed to the tracer explicitly); only host-side pod code does.
A copy of the JAX package's ``obs/clock.py``.
"""
from __future__ import annotations

import time

__all__ = ["now"]


def now() -> float:
    """Monotonic wall-clock seconds (the only sanctioned hot-path read)."""
    return time.perf_counter()
