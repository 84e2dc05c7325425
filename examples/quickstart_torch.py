"""Quickstart: the FedOptima pipeline on the torch port, in ~60 lines.

The counterpart of ``examples/quickstart.py``, without its debug mesh: the
port runs on one card.

1. Pick an architecture (any of the 10 assigned ids) at smoke scale.
2. Split it at a period boundary (paper Eq. 8 picks the split from device
   profiles; here we take the default).
3. Run a few hybrid rounds: device groups train their block with the
   auxiliary-network local loss; the server trains the rest centrally on
   the activation stream; async aggregation merges device blocks.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import registry
from repro_torch.core import fedopt_step as F

ARCH = "smollm-135m"
ROUNDS = 8


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, or cpu)")
    return p


def main(argv=None) -> list:
    """Run the quickstart's rounds; returns each round's losses as floats."""
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)

    arch = registry.smoke_config(ARCH)
    cfg = F.FedStepConfig(
        arch=arch,
        l_split=F.default_l_split(arch),       # device-side periods
        n_groups=4,                            # FL device groups
        seq_len=64, per_group_batch=4, H=4,    # 4 local iters per round
        lr_d=0.1, lr_s=0.1)

    step = F.make_train_step(cfg)
    state = F.init_train_state(
        torch.Generator(device=device).manual_seed(0), cfg)

    print(f"{ARCH}: {arch.n_periods} periods, split at {cfg.l_split} "
          f"(device) / {arch.n_periods - cfg.l_split} (server), "
          f"{cfg.n_groups} groups x H={cfg.H}")

    history = []
    for r in range(ROUNDS):
        batch = F.concrete_train_batch(
            torch.Generator(device=device).manual_seed(100 + r), cfg)
        state, metrics = step(state, batch)
        m = {k: float(v) for k, v in metrics.items()}
        history.append(m)
        print(f"round {r+1}: device aux loss {m['d_loss']:.4f}  "
              f"server loss {m['s_loss']:.4f}  "
              f"global version {int(state['version'])}")

    print("done — devices never waited for the server (activation buffer "
          "is one step stale), and no gradient ever crossed "
          "server->device.")
    return history


if __name__ == "__main__":
    main()
