"""Serving driver: batched prefill and cached decode with the merged model.

FedOptima is a training system; serving runs the merged (device + server)
model, ``transformer.merge_params``, through ``prefill`` and
``serve_decode_step``, as the JAX package's ``launch/serve.py`` does.  The
model runs on ``--device`` (default ``cuda``); ``--use-kernel`` sends the
prefill's self-attention through the flash-attention forward kernel and
its Mamba blocks through the SSD forward kernel (decode takes none).
``--arch`` runs at its smoke reduction unless ``--full`` is given.

Examples::

    python -m repro_torch.launch.serve --device cpu --arch jamba-1.5-large-398b
    python -m repro_torch.launch.serve --full --arch smollm-135m --use-kernel \\
        --batch 8 --prompt-len 1024 --new-tokens 32
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import registry
from repro_torch.models import transformer as tfm


def _next_token(logits, greedy: bool, gen):
    if greedy:
        return torch.argmax(logits, dim=-1)[:, None]
    return torch.multinomial(torch.softmax(logits.float(), dim=-1), 1,
                             generator=gen)


def generate(params, arch, prompts, *, new_tokens: int, max_len: int,
             frontend=None, greedy: bool = True, gen=None,
             use_kernel: bool = False):
    """prompts: (B, S0) ids.  Returns (B, S0 + new_tokens).  The first new
    token is the prefill's argmax; the others are argmaxes (``greedy``) or
    draws from the softmax with the ``torch.Generator`` ``gen``.  Positions
    are host ints."""
    with torch.inference_mode():
        S0 = prompts.shape[1]
        logits, caches = tfm.prefill(params, arch, prompts, max_len=max_len,
                                     frontend=frontend, use_kernel=use_kernel)
        out = [prompts]
        token = torch.argmax(logits, dim=-1)[:, None]
        for i in range(new_tokens):
            out.append(token)
            if i == new_tokens - 1:
                break
            logits, caches = tfm.serve_decode_step(params, arch, caches,
                                                   token, S0 + i)
            token = _next_token(logits, greedy, gen)
        return torch.cat(out, dim=1)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--arch", default="smollm-135m")
    p.add_argument("--full", action="store_true",
                   help="use the full config (not the smoke reduction)")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--new-tokens", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, or cpu for the kernels' plain "
                        "versions)")
    p.add_argument("--use-kernel", action="store_true",
                   help="prefill through the CUDA flash-attention and SSD "
                        "forward kernels")
    return p


def main(argv=None) -> torch.Tensor:
    args = build_parser().parse_args(argv)
    arch = registry.get(args.arch) if args.full else \
        registry.smoke_config(args.arch)
    device = torch.device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = tfm.init_params(gen, arch)
    prompts = torch.randint(0, arch.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=device)
    frontend = None
    if arch.frontend_len:
        frontend = torch.randn(args.batch, arch.frontend_len, arch.d_model,
                               generator=gen, device=device)
    t0 = time.perf_counter()
    out = generate(params, arch, prompts, new_tokens=args.new_tokens,
                   max_len=args.prompt_len + args.new_tokens,
                   frontend=frontend, use_kernel=args.use_kernel)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    assert out.shape == (args.batch, args.prompt_len + args.new_tokens)
    print(f"served {args.batch} requests x {args.new_tokens} new tokens in "
          f"{dt:.2f} s ({args.batch * args.new_tokens / dt:.1f} tok/s, "
          f"'{arch.name}' {'full' if args.full else 'smoke'} on "
          f"{args.device}{', kernels' if args.use_kernel else ''})")
    print("first request tokens:", out[0, -args.new_tokens:].tolist())
    return out


if __name__ == "__main__":
    main()
