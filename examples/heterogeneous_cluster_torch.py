"""Scenario: heterogeneous edge cluster with churn (paper §6.2-§6.4), on the
torch port.

The counterpart of ``examples/heterogeneous_cluster.py``, and its output
byte for byte.  Simulates the paper's Testbed-B-style cluster (16
devices, 4 speed groups) running FedOptima vs all six baselines, prints
the idle-time/throughput table, then repeats under churn (p=0.3) to show
the retention gap.  The simulators are host arithmetic with no learner, so
``--device`` is taken for the examples' common interface and not used.

Run:  PYTHONPATH=src python examples/heterogeneous_cluster_torch.py
"""
import argparse

from repro_torch.core.baselines import REGISTRY
from repro_torch.core.simulation import (SimModel, heterogeneous_cluster,
                                         simulate_fedoptima)
from repro_torch.runtime.fault_tolerance import ChurnModel

MODEL = SimModel(dev_fwd_flops=2.5e9, dev_bwd_flops=5.0e9,
                 full_fwd_flops=1.4e10, srv_flops_per_batch=2.6e10,
                 act_bytes=3.2e6, dev_model_bytes=1.2e6,
                 full_model_bytes=2.2e7, batch_size=32)
CLUSTER = heterogeneous_cluster(16, base_flops=8e9,
                                speed_groups=(1.0, 1.33, 2.67, 3.84),
                                bw=100e6 / 8, srv_ratio=50.0)
DUR = 1200.0


def table(churn=None, tag=""):
    print(f"\n=== {tag} ===")
    print(f"{'method':12s} {'srv idle':>9s} {'dev idle':>9s} "
          f"{'samples/s':>10s}")
    rows = {}
    m = simulate_fedoptima(MODEL, CLUSTER, duration=DUR, omega=8,
                           churn=churn)
    rows["fedoptima"] = m
    for name, fn in REGISTRY.items():
        rows[name] = fn(MODEL, CLUSTER, duration=DUR, churn=churn)
    for name, m in rows.items():
        print(f"{name:12s} {m.srv_idle_frac:9.1%} {m.dev_idle_frac:9.1%} "
              f"{m.throughput:10.1f}")
    return rows


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda",
                   help="unused: the simulators run on the host")
    return p


def main(argv=None) -> None:
    """Print both tables and the retention."""
    build_parser().parse_args(argv)
    stable = table(tag="stable environment (Fig. 8/10)")
    churny = table(churn=ChurnModel(n_devices=16, p_drop=0.3,
                                    interval=600.0, bw_lo=50e6 / 8,
                                    bw_hi=100e6 / 8, seed=0),
                   tag="unstable: p_drop=0.3, bandwidth re-drawn / 10 min "
                       "(Fig. 12)")

    print("\nretention R(0.3) = T(p)/T(0):")
    for name in stable:
        r = churny[name].throughput / max(stable[name].throughput, 1e-9)
        print(f"  {name:12s} {r:.2f}")


if __name__ == "__main__":
    main()
