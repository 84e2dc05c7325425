"""Elastic scaling: the number of participating devices K changes mid-run.

FedOptima's design makes this nearly free (paper §3.4.2): the server holds
ONE model + a global activation cap ω, so admission of a new device is just
(1) registering an activation queue, (2) sending it the current global
device-side model, and (3) flow control naturally throttles the new
sender.  Departure is queue removal; in-flight activations still train.

`ElasticRegistry` is the control-plane bookkeeping used by both the event
simulator and the training drivers.  A copy of the JAX package's
``runtime/elastic.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class DeviceInfo:
    device_id: int
    flops_per_s: float
    bandwidth: float            # bytes/s
    joined_at: float = 0.0
    active: bool = True
    left_at: float | None = None   # time of the last departure (None: never
                                   # left, or currently active)
    absences: int = 0              # departures so far (churn accounting)


@dataclass
class ElasticRegistry:
    devices: dict = field(default_factory=dict)
    _next_id: int = 0

    def join(self, flops_per_s: float, bandwidth: float, t: float = 0.0) -> int:
        did = self._next_id
        self._next_id += 1
        self.devices[did] = DeviceInfo(did, flops_per_s, bandwidth, t, True)
        return did

    def leave(self, device_id: int, t: float | None = None):
        if device_id in self.devices:
            info = self.devices[device_id]
            if info.active:
                # only the first leave of an absence records the timestamp:
                # a repeated (defensive) leave must not reset or erase it
                info.absences += 1
                info.left_at = t
            info.active = False

    def rejoin(self, device_id: int, t: float = 0.0):
        if device_id in self.devices:
            self.devices[device_id].active = True
            self.devices[device_id].joined_at = t
            self.devices[device_id].left_at = None

    def absence(self, device_id: int, t: float) -> float | None:
        """How long device_id has been gone as of time t (None if active
        or its departure was recorded without a timestamp)."""
        info = self.devices[device_id]
        if info.active or info.left_at is None:
            return None
        return t - info.left_at

    @property
    def active_ids(self) -> list[int]:
        return [d for d, i in self.devices.items() if i.active]

    def set_bandwidth(self, device_id: int, bw: float):
        self.devices[device_id].bandwidth = bw
