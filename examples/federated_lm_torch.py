"""End-to-end driver on the torch port: train the ~135M-param smollm
architecture (the smoke reduction by default, full width and depth with
--full) with FedOptima on non-IID synthetic LM shards, with checkpointing.

The counterpart of ``examples/federated_lm.py``, through the port's
``run_pod`` on one card: the same run, less the reference's mesh flags.
On the CPU the same code path runs with ``--device cpu``.

Run:  PYTHONPATH=src python examples/federated_lm_torch.py \\
          [--rounds 200] [--full] [--device cpu]
"""
import argparse
import os
import tempfile

from repro_torch.launch import train


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--rounds", type=int, default=200)
    p.add_argument("--full", action="store_true",
                   help="full smollm-135m config (slow on CPU)")
    p.add_argument("--ckpt-dir",
                   default=os.path.join(tempfile.gettempdir(),
                                        "fedoptima_lm_ckpt"))
    p.add_argument("--ckpt-every", type=int, default=25)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, or cpu)")
    return p


def main(argv=None) -> dict:
    """Train, print the losses' change and check that the server learned;
    returns ``run_pod``'s dict."""
    args = build_parser().parse_args(argv)

    targs = train.build_parser().parse_args([
        "--mode", "pod", "--arch", "smollm-135m",
        *(["--full"] if args.full else []), "--rounds", str(args.rounds),
        "--seq-len", "1024" if args.full else "128", "--batch", "8",
        "--H", "4", "--l-split", "0", "--lr-d", "0.08", "--lr-s", "0.08",
        "--server-opt", "adamw", "--groups-per-shard", "4",
        "--p-drop", "0.05",                     # light churn, §3.4.2
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", str(args.ckpt_every),
        "--log-every", "10", "--seed", "0", "--device", args.device])
    out = train.run_pod(targs)
    h = out["history"]
    print(f"\ntrained {len(h)} rounds; server loss "
          f"{h[0]['s_loss']:.3f} -> {h[-1]['s_loss']:.3f}, device aux loss "
          f"{h[0]['d_loss']:.3f} -> {h[-1]['d_loss']:.3f}")
    if not h[-1]["s_loss"] < h[0]["s_loss"]:
        raise AssertionError("server did not learn")
    return out


if __name__ == "__main__":
    main()
