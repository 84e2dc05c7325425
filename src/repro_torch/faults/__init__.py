"""Chaos plane: seeded fault injection + the recovery machinery's tests.

``schedule`` — the deterministic fault-scenario artifact
(``fault-schedule-v1``); ``quarantine`` — the poison-update validation
gate; ``inject`` — the schedule players for the event simulators
(``FaultInjector``, ``install_timeouts``) and the pod executor
(``PodFaultInjector``, ``tear_snapshot``); ``crash_harness`` — the
kill-at-a-round-boundary SIGKILL sweep proving crash-consistent, bit-exact
resume.
"""
from .inject import (FaultInjector, InjectedCrash, PodFaultInjector,
                     tear_snapshot)
from .quarantine import UpdateGate, make_payload
from .schedule import (BASELINE_CLASSES, CLASSES, CORRUPT_KINDS,
                       FAULT_FORMAT, POD_CLASSES, SIM_CLASSES, TEAR_MODES,
                       FaultEvent, FaultSchedule, make_fault_schedule)

__all__ = [
    "FAULT_FORMAT", "CLASSES", "CORRUPT_KINDS", "TEAR_MODES",
    "SIM_CLASSES", "BASELINE_CLASSES", "POD_CLASSES",
    "FaultEvent", "FaultSchedule", "make_fault_schedule",
    "UpdateGate", "make_payload",
    "FaultInjector", "PodFaultInjector", "InjectedCrash", "tear_snapshot",
]
