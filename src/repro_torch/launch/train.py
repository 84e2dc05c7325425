"""Training driver: the FedOptima pod round on one card.

``--mode pod`` runs the hybrid round (``core/fedopt_step``) for ``--rounds``
rounds as a synchronous loop — the JAX driver's ``--window 1`` path, whose
metrics equal every other window's.  Per round it takes the roster
(``--p-drop``), plans the round on the host ``ControlPlane``, retires and
restores dropped groups through the retention store, builds the batch with
the JAX driver's numpy RNG stream, runs the step, closes the round's
staleness accounting and prints one ``round N d_loss … s_loss …`` line.

``--arch`` runs at its smoke reduction unless ``--full`` is given.  The
step runs on ``--device`` (default ``cuda``); the CPU runs the kernels'
plain versions.

Examples::

    python -m repro_torch.launch.train --mode pod --full --arch smollm-135m \\
        --use-kernel --groups-per-shard 4 --batch 8 --H 4 --seq-len 1024 \\
        --l-split 3 --omega 1 --rounds 3
    python -m repro_torch.launch.train --mode pod --full --arch mamba2-780m \\
        --use-kernel --groups-per-shard 4 --batch 8 --H 4 --seq-len 1024 \\
        --l-split 6 --omega 1 --rounds 3
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import fedopt_step as F
from repro_torch.core.control_plane import ControlPlane
from repro_torch.data.synthetic import lm_dataset

#: Flags whose machinery comes with later slices of the port: flag ->
#: (attribute, the value that means "off", the slice that brings it).
LATER = {
    "--mode sim": ("mode", "pod", "the sim-mode learners (queue A item 9)"),
    "--window": ("window", 1,
                 "the pipelined RoundExecutor and round handles (queue A)"),
    "--pool-cap": ("pool_cap", 0, "the tiered activation store (queue A)"),
    "--ckpt-dir": ("ckpt_dir", None, "checkpoints (queue A)"),
    "--faults": ("faults", None, "the fault plane (queue A item 10)"),
    "--fleet-trace": ("fleet_trace", None, "the fleet plane (item 10)"),
    "--fleet-tiers": ("fleet_tiers", None, "the fleet plane (item 10)"),
    "--selection": ("selection", None, "the fleet plane (item 10)"),
    "--trace": ("trace", None, "the telemetry plane (item 10)"),
    "--sanitize": ("sanitize", False, "the protocol sanitizer (item 10)"),
    "--metrics-every": ("metrics_every", 0, "the metrics registry (item 10)"),
    "--metrics-out": ("metrics_out", None, "the metrics registry (item 10)"),
}


def _refuse_later_slices(args) -> None:
    for flag, (attr, off, later) in LATER.items():
        value = getattr(args, attr, off)
        if value != off:
            raise NotImplementedError(
                f"{flag}={value!r}: not in the torch port yet; it comes with "
                f"{later}")


def _group_streams(cfg: F.FedStepConfig, seed: int = 0):
    """Per-group non-IID token streams (distinct synthetic grammars)."""
    return [lm_dataset(200_000, cfg.arch.vocab, seed=seed + g,
                       structure=0.75 + 0.2 * (g % 3) / 2)
            for g in range(cfg.n_groups)]


def _make_batch(cfg: F.FedStepConfig, streams, rng: np.random.Generator,
                plan, device) -> dict:
    """One round's inputs: per-group token windows drawn exactly as the JAX
    driver draws them, plus the plan's schedule and weight fields."""
    G, H, b, S = cfg.n_groups, cfg.H, cfg.micro_batch, cfg.seq_len
    tokens = np.zeros((G, H, b, S), np.int64)
    labels = np.zeros((G, H, b, S), np.int64)
    for g in range(G):
        n = len(streams[g]) - S - 1
        idx = rng.integers(0, n, size=(H, b))
        for h in range(H):
            for i in range(b):
                j = idx[h, i]
                tokens[g, h, i] = streams[g][j:j + S]
                labels[g, h, i] = streams[g][j + 1:j + S + 1]
    batch = {"tokens": torch.from_numpy(tokens).to(device),
             "labels": torch.from_numpy(labels).to(device)}
    batch.update(plan.batch_fields(device))
    return batch


def _apply_retention(cplane: ControlPlane, state: dict, plan) -> dict:
    """Gather dropped groups' dev/aux into the retention store and scatter
    rejoining groups' retained params back, before the round runs."""
    for g in plan.retire:
        cplane.retain_group(g, F.gather_group_state(state, g))
    for g in plan.restore:
        state = F.scatter_group_state(state, g,
                                      cplane.release_group(g)["params"])
    return state


def pod_config(args) -> F.FedStepConfig:
    arch = registry.get(args.arch) if args.full else \
        registry.smoke_config(args.arch)
    return F.FedStepConfig(
        arch=arch, l_split=args.l_split or F.default_l_split(arch),
        n_groups=args.groups_per_shard, seq_len=args.seq_len,
        per_group_batch=args.batch, H=args.H or 4, lr_d=args.lr_d,
        lr_s=args.lr_s, server_opt=args.server_opt, omega=args.omega or 1,
        use_kernel=args.use_kernel)


def run_pod(args) -> dict:
    """Run ``args.rounds`` rounds; returns {"history", "final", "consumed"}.
    A programmatic caller may set ``args.on_round(r, metrics)``, called
    after each round with its metrics as floats."""
    _refuse_later_slices(args)
    device = torch.device(args.device)
    cfg = pod_config(args)
    G = cfg.n_groups
    step = F.make_train_step(cfg)
    cplane = ControlPlane(G, cfg.omega, cfg.H, policy=args.policy,
                          max_delay=args.max_delay)
    state = F.init_train_state(
        torch.Generator(device=device).manual_seed(args.seed), cfg)
    streams = _group_streams(cfg, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    on_round = getattr(args, "on_round", None)
    history = []
    t0 = time.time()
    for r in range(args.rounds):
        active = rng.random(G) >= args.p_drop
        if not active.any():
            active[rng.integers(0, G)] = True
        plan = cplane.plan_round(active=active)
        state = _apply_retention(cplane, state, plan)
        batch = _make_batch(cfg, streams, rng, plan, device)
        state, metrics = step(state, batch)
        cplane.finish_round(active=active)
        m = {k: float(v) for k, v in metrics.items()}   # waits for the round
        history.append(m)
        if on_round is not None:
            on_round(r, m)
        if (r + 1) % args.log_every == 0:
            tok_s = cfg.global_batch * cfg.seq_len * args.log_every / \
                (time.time() - t0)
            print(f"round {r+1:4d}  d_loss {m['d_loss']:.4f}  "
                  f"s_loss {m['s_loss']:.4f}  active {int(active.sum())}/{G}"
                  f"  {tok_s:,.0f} tok/s", flush=True)
            t0 = time.time()
    consumed = [cplane.consumption.get(g, 0) for g in range(G)]
    print(f"contribution balance: consumed={consumed}")
    return {"history": history, "final": history[-1] if history else None,
            "consumed": consumed}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--mode", default="pod", choices=("pod", "sim"))
    p.add_argument("--arch", default="smollm-135m")
    p.add_argument("--full", action="store_true",
                   help="use the full config (not the smoke reduction)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the step (cuda, or cpu for the "
                        "kernels' plain versions)")
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--batch", type=int, default=8,
                   help="sequences per group per round")
    p.add_argument("--H", type=int, default=None,
                   help="local iterations per round (default 4)")
    p.add_argument("--l-split", type=int, default=0)
    p.add_argument("--lr-d", type=float, default=0.05)
    p.add_argument("--lr-s", type=float, default=0.05)
    p.add_argument("--server-opt", default="sgd", choices=("sgd", "adamw"))
    p.add_argument("--omega", type=int, default=None,
                   help="activation ring depth ω (default 1)")
    p.add_argument("--policy", default="counter", choices=("counter", "fifo"),
                   help="Task Scheduler consumption policy (Alg. 3)")
    p.add_argument("--max-delay", type=int, default=16,
                   help="staleness cap D for aggregation (Alg. 4)")
    p.add_argument("--use-kernel", action="store_true",
                   help="run attention through the CUDA flash-attention "
                        "kernels (forward, dq, dk/dv) and Mamba2's SSD "
                        "through the CUDA SSD kernels (forward, backward)")
    p.add_argument("--groups-per-shard", type=int, default=4,
                   help="FL device groups on the card")
    p.add_argument("--p-drop", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=1)
    # later slices of the port: refused with NotImplementedError when set
    p.add_argument("--window", type=int, default=1)
    p.add_argument("--pool-cap", type=int, default=0)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--faults", default=None)
    p.add_argument("--fleet-trace", default=None)
    p.add_argument("--fleet-tiers", default=None)
    p.add_argument("--selection", default=None)
    p.add_argument("--trace", default=None)
    p.add_argument("--sanitize", action="store_true")
    p.add_argument("--metrics-every", type=float, default=0)
    p.add_argument("--metrics-out", default=None)
    return p


def main(argv=None) -> dict:
    return run_pod(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
