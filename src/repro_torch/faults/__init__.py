"""Chaos plane on the pod round: seeded fault injection + the recovery
machinery's tests.

``schedule`` — the deterministic fault-scenario artifact
(``fault-schedule-v1``); ``quarantine`` — the poison-update validation
gate; ``inject`` — the schedule player for the pod executor
(``PodFaultInjector``) and ``tear_snapshot``; ``crash_harness`` — the
kill-at-a-round-boundary SIGKILL sweep proving crash-consistent, bit-exact
resume.  The simulators' player (``FaultInjector``, ``install_timeouts``)
comes with ROADMAP item A7.3a.
"""
from .inject import InjectedCrash, PodFaultInjector, tear_snapshot
from .quarantine import UpdateGate, make_payload
from .schedule import (BASELINE_CLASSES, CLASSES, CORRUPT_KINDS,
                       FAULT_FORMAT, POD_CLASSES, SIM_CLASSES, TEAR_MODES,
                       FaultEvent, FaultSchedule, make_fault_schedule)

__all__ = [
    "FAULT_FORMAT", "CLASSES", "CORRUPT_KINDS", "TEAR_MODES",
    "SIM_CLASSES", "BASELINE_CLASSES", "POD_CLASSES",
    "FaultEvent", "FaultSchedule", "make_fault_schedule",
    "UpdateGate", "make_payload",
    "PodFaultInjector", "InjectedCrash", "tear_snapshot",
]
