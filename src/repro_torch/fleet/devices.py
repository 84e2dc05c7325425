"""Capability-tier heterogeneity sampling (fleet emulation).

Real fleets are capability-skewed, not four equal speed groups: a few
server-class boxes, a band of mid-range phones, a long tail of
constrained devices (the Apodotiko heterogeneous-environment picture).
:class:`DeviceProfile` describes one capability tier as lognormal
flops/bandwidth distributions around a median; :func:`sample_cluster`
draws a seeded K-device :class:`~repro_torch.core.simulation.SimCluster` from a
weighted tier mix, replacing the single uniform
``heterogeneous_cluster`` helper as the way fleets are built (that
helper now lives here too, as the deterministic paper-Table-3 special
case, and stays re-exported from ``core.simulation`` unchanged).

Tier specs are strings so they ride CLIs and JSON: ``"low,mid,high"``
(equal weights) or ``"low:3,premium:1"`` (3:1 mix).

A copy of the JAX package's ``fleet/devices.py``: the same (K, tiers,
seed) samples the same cluster, bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DeviceProfile:
    """One capability tier: lognormal flops/bandwidth around a median."""
    name: str
    flops: float                # median device compute, FLOP/s
    bw: float                   # median link bandwidth, bytes/s
    flops_sigma: float = 0.0    # lognormal sigma (0 = every device exact)
    bw_sigma: float = 0.0

    def sample(self, n: int, rng: np.random.Generator):
        """(flops, bw) arrays for n devices of this tier."""
        f = self.flops * np.exp(rng.normal(0.0, self.flops_sigma, n)) \
            if self.flops_sigma else np.full(n, float(self.flops))
        b = self.bw * np.exp(rng.normal(0.0, self.bw_sigma, n)) \
            if self.bw_sigma else np.full(n, float(self.bw))
        return f, b


#: Built-in tiers, spanning the REFL/Apodotiko capability spread: a ~13x
#: flops range low -> premium, with wider spread at the low end (cheap
#: hardware varies more) and bandwidth growing with tier.
TIERS = {
    "low": DeviceProfile("low", 1.5e9, 25e6 / 8,
                         flops_sigma=0.35, bw_sigma=0.40),
    "mid": DeviceProfile("mid", 5e9, 50e6 / 8,
                         flops_sigma=0.25, bw_sigma=0.30),
    "high": DeviceProfile("high", 1.2e10, 100e6 / 8,
                          flops_sigma=0.20, bw_sigma=0.25),
    "premium": DeviceProfile("premium", 2e10, 200e6 / 8,
                             flops_sigma=0.15, bw_sigma=0.20),
}

DEFAULT_TIERS = "low,mid,high,premium"


def parse_tiers(spec) -> list[tuple[DeviceProfile, float]]:
    """Parse a tier spec into (profile, weight) pairs.

    ``spec`` is a comma-separated list of ``name`` or ``name:weight``
    entries (names from :data:`TIERS`), or an already-parsed list of
    (DeviceProfile, weight) pairs, passed through."""
    if not isinstance(spec, str):
        return [(p, float(w)) for p, w in spec]
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, w = part.partition(":")
        if name not in TIERS:
            raise ValueError(f"unknown device tier {name!r}; "
                             f"choose from {sorted(TIERS)}")
        weight = float(w) if w else 1.0
        if weight <= 0:
            raise ValueError(f"tier weight must be > 0, got {part!r}")
        out.append((TIERS[name], weight))
    if not out:
        raise ValueError(f"empty tier spec {spec!r}")
    return out


def tier_counts(K: int, tiers) -> list[int]:
    """Largest-remainder apportionment of K devices over the tier weights
    (deterministic: ties break toward earlier tiers)."""
    pairs = parse_tiers(tiers)
    w = np.asarray([weight for _, weight in pairs], float)
    quota = K * w / w.sum()
    counts = np.floor(quota).astype(int)
    rest = quota - counts
    order = sorted(range(len(rest)), key=lambda j: (-rest[j], j))
    for i in order[:K - int(counts.sum())]:
        counts[i] += 1
    return [int(c) for c in counts]


def sample_cluster(K: int, tiers=DEFAULT_TIERS, *, srv_ratio: float = 50.0,
                   seed: int = 0):
    """Draw a K-device SimCluster from a weighted capability-tier mix.

    Devices are laid out tier-by-tier (slowest first, mirroring the old
    helper's grouped layout); per-device flops/bandwidth are sampled from
    each tier's lognormals under one seeded RNG, so the same (K, tiers,
    seed) always yields the same cluster.  The server is ``srv_ratio`` x
    the fastest sampled device."""
    from repro_torch.core.simulation import SimCluster

    pairs = parse_tiers(tiers)
    counts = tier_counts(K, pairs)
    rng = np.random.default_rng(seed)
    flops, bw = [], []
    for (profile, _), n in zip(pairs, counts):
        f, b = profile.sample(n, rng)
        flops.append(f)
        bw.append(b)
    dev_flops = np.concatenate(flops)
    dev_bw = np.concatenate(bw)
    return SimCluster(dev_flops=dev_flops, dev_bw=dev_bw,
                      srv_flops=float(dev_flops.max()) * srv_ratio)


def heterogeneous_cluster(K: int, base_flops: float = 5e9,
                          speed_groups=(1.0, 1.33, 2.67, 3.84),
                          bw: float = 100e6 / 8, srv_ratio: float = 50.0,
                          seed: int = 0):
    """Paper Table 3-style cluster: 4 equal-size speed groups; server is
    srv_ratio x the fastest device.  The deterministic special case of
    :func:`sample_cluster` (zero-sigma tiers), kept verbatim for every
    existing benchmark/test."""
    from repro_torch.core.simulation import SimCluster

    groups = np.array([speed_groups[i * len(speed_groups) // K]
                       for i in range(K)])
    return SimCluster(dev_flops=base_flops * groups,
                      dev_bw=np.full(K, bw),
                      srv_flops=base_flops * max(speed_groups) * srv_ratio)
