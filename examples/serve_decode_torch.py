"""Scenario: batched serving with the merged global model, on the torch port.

The counterpart of ``examples/serve_decode.py``.  After a FedOptima round
the device and server halves merge into one model (``merge_params``), and
serving is prefill plus cached decode.  The default arch is the hybrid
jamba: one cache holds attention K/V and Mamba states, and its MoE blocks
route every decoded token.

Run:  PYTHONPATH=src python examples/serve_decode_torch.py \\
          [--arch jamba-1.5-large-398b] [--device cpu] [--use-kernel]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import fedopt_step as F
from repro_torch.core.control_plane import ControlPlane
from repro_torch.launch import train
from repro_torch.launch.serve import generate
from repro_torch.models import transformer as tfm
from repro_torch.models.common import tree_map


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="jamba-1.5-large-398b")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--new-tokens", type=int, default=12)
    p.add_argument("--device", default="cuda")
    p.add_argument("--use-kernel", action="store_true")
    args = p.parse_args()

    arch = registry.smoke_config(args.arch)
    device = torch.device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)

    # train one hybrid round, then merge the halves for serving
    cfg = F.FedStepConfig(arch=arch, l_split=1, n_groups=2, seq_len=32,
                          per_group_batch=2, H=2, use_kernel=args.use_kernel)
    state = F.init_train_state(gen, cfg)
    plan = ControlPlane(cfg.n_groups, cfg.omega, cfg.H).plan_round()
    batch = train._make_batch(cfg, train._group_streams(cfg),
                              np.random.default_rng(0), plan, device)
    state, metrics = F.make_train_step(cfg)(state, batch)
    print(f"[{arch.name}] trained one round: d_loss "
          f"{float(metrics['d_loss']):.4f} s_loss "
          f"{float(metrics['s_loss']):.4f}")
    dev0 = tree_map(lambda x: x[0], state["dev"])   # any group (merged)
    params = tfm.merge_params(dev0, state["srv"], arch)

    prompts = torch.randint(0, arch.vocab, (args.batch, 16), generator=gen,
                            device=device)
    frontend = None
    if arch.frontend_len:
        frontend = torch.randn(args.batch, arch.frontend_len, arch.d_model,
                               generator=gen, device=device)
    t0 = time.perf_counter()
    out = generate(params, arch, prompts, new_tokens=args.new_tokens,
                   max_len=16 + args.new_tokens, frontend=frontend,
                   use_kernel=args.use_kernel)
    dt = time.perf_counter() - t0
    assert bool(torch.isfinite(out.float()).all())
    print(f"[{arch.name}] served {args.batch} requests x {args.new_tokens} "
          f"tokens in {dt:.2f}s ({args.batch * args.new_tokens / dt:.1f} "
          f"tok/s, smoke config on {args.device})")
    print("sample:", out[0].tolist())


if __name__ == "__main__":
    main()
