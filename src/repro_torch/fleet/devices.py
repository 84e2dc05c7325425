"""The paper's heterogeneous device cluster (Table 3): a copy of the JAX
package's ``fleet.devices.heterogeneous_cluster``.  Capability tiers and
sampled fleets come with the fleet plane (ROADMAP item A7)."""
from __future__ import annotations

import numpy as np


def heterogeneous_cluster(K: int, base_flops: float = 5e9,
                          speed_groups=(1.0, 1.33, 2.67, 3.84),
                          bw: float = 100e6 / 8, srv_ratio: float = 50.0,
                          seed: int = 0):
    """Paper Table 3-style cluster: 4 equal-size speed groups; the server is
    srv_ratio x the fastest device.  ``seed`` is unused, as in the
    reference (the cluster is deterministic)."""
    from repro_torch.core.simulation import SimCluster

    groups = np.array([speed_groups[i * len(speed_groups) // K]
                       for i in range(K)])
    return SimCluster(dev_flops=base_flops * groups,
                      dev_bw=np.full(K, bw),
                      srv_flops=base_flops * max(speed_groups) * srv_ratio)
