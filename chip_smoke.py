#!/usr/bin/env python3
"""Chip smoke test of the torch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failed check raises and the script
exits non-zero:

1. device — the card's name and power limit, torch and CUDA versions; no
   CUDA device is an error.  TF32 is set off and stated.
2. build — the three flash-attention kernels are compiled from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel);
   build time and ptxas registers / shared memory per kernel.
3. kernels — each kernel against its plain PyTorch version on the card, at
   smollm-135m's attention shape (B=2 and B=8, S=1024, 9:3 heads, hd 64,
   causal, f32) and at ragged S, S != Skv, window, soft-cap, MHA, MQA,
   bf16 and the other head dims; times (CUDA events, median of 30 after
   warm-up) beside the plain version, PyTorch's SDPA and the card's bound.
4. main path — the pod round of full-width smollm-135m (G=4, batch 8, H=4,
   seq 1024, l_split 3, ω=1): two rounds with the kernels and two with the
   plain ``sdpa_chunked`` path from the same state, batches and plans,
   whose losses must agree; then three rounds of the driver
   (``repro_torch.launch.train.run_pod``) with the kernels, with every
   kernel's launches counted per round.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): float32 on the CUDA cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
TOL = {("float32", "fwd"): (1e-4, 1e-4), ("float32", "bwd"): (5e-4, 1e-3),
       ("bfloat16", "fwd"): (3e-2, 3e-2), ("bfloat16", "bwd"): (3e-2, 3e-2)}
KERNELS = {
    "fa_fwd": ("src/repro_torch/kernels/csrc/fa_fwd.cu",
               "src/repro/kernels/flash_attention.py:63"),
    "fa_bwd_dq": ("src/repro_torch/kernels/csrc/fa_bwd_dq.cu",
                  "src/repro/kernels/flash_attention.py:226"),
    "fa_bwd_dkv": ("src/repro_torch/kernels/csrc/fa_bwd_dkv.cu",
                   "src/repro/kernels/flash_attention.py:266"),
}
MAIN_ARGS = ["--mode", "pod", "--full", "--arch", "smollm-135m",
             "--groups-per-shard", "4", "--batch", "8", "--H", "4",
             "--seq-len", "1024", "--l-split", "3", "--omega", "1",
             "--use-kernel", "--device", "cuda"]


def smi_name_power() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# 1-2. device and build
# ---------------------------------------------------------------------------

def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: "
          f"{smi_name_power()} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | count {torch.cuda.device_count()} | "
          f"tf32 matmul {torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn {torch.backends.cudnn.allow_tf32}", flush=True)


def phase_build(fa):
    info = fa.build()
    print(f"[build] {info.path.name}: {info.seconds:.1f} s"
          f"{' (cached)' if info.cached else ''}", flush=True)
    for src, log in info.ptxas.items():
        for line in log.splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1] if "'" in line else line
                print(f"[build] {src}: {name}")
            elif "Used" in line or "spill" in line:
                print(f"[build] {src}:   {line.strip()}")


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

CASES = [
    # name, (B, S, Skv, H, Hkv, hd), options, dtype
    ("main-dev", (2, 1024, 1024, 9, 3, 64), dict(causal=True), "float32"),
    ("main-srv", (8, 1024, 1024, 9, 3, 64), dict(causal=True), "float32"),
    ("ragged", (2, 1000, 1000, 9, 3, 64), dict(causal=True), "float32"),
    ("S!=Skv", (2, 1024, 768, 9, 3, 64), dict(causal=True), "float32"),
    ("S!=Skv-full", (2, 700, 1024, 9, 3, 64), dict(causal=False), "float32"),
    ("window256", (2, 1024, 1024, 9, 3, 64), dict(causal=True, window=256),
     "float32"),
    ("masked-rows", (2, 1024, 512, 9, 3, 64), dict(causal=True, window=256),
     "float32"),
    ("softcap20", (2, 1024, 1024, 9, 3, 64), dict(causal=True, logit_cap=20.0),
     "float32"),
    ("MHA", (2, 1024, 1024, 9, 9, 64), dict(causal=True), "float32"),
    ("MQA", (2, 1024, 1024, 9, 1, 64), dict(causal=True), "float32"),
    ("bf16", (2, 1024, 1024, 9, 3, 64), dict(causal=True), "bfloat16"),
    ("hd16", (2, 300, 300, 4, 4, 16), dict(causal=True, window=32), "float32"),
    ("hd32", (2, 256, 256, 8, 2, 32), dict(causal=True, logit_cap=15.0),
     "float32"),
    ("hd128", (1, 300, 300, 4, 2, 128), dict(causal=True), "float32"),
]


def _inputs(torch, shape, dtype, seed):
    B, S, Skv, H, Hkv, hd = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)
    return mk(B, H, S, hd), mk(B, Hkv, Skv, hd), mk(B, Hkv, Skv, hd), \
        mk(B, H, S, hd)


def _median_ms(torch, fn, n=30, warmup=5):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _close(torch, name, got, want, atol, rtol):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    max_abs = err.max().item()
    ok = bool((err <= atol + rtol * want.abs()).all()) and \
        bool(torch.isfinite(got).all())
    print(f"[kernels]   {name:5s} max_abs_err {max_abs:.3e}  "
          f"(limit {atol:g} + {rtol:g}*|ref|)  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return max_abs


def _bounds(torch, ref, shape, opts, dtype):
    """Least time (ms) for each kernel's work at this shape: the larger of
    its bytes over the HBM rate and its float32 flops over the CUDA-core
    peak, counting only the (q, k) pairs this mask makes visible."""
    B, S, Skv, H, Hkv, hd = shape
    vis = int(ref.visible(S, Skv, causal=opts["causal"],
                          window=opts.get("window"), device="cpu").sum())
    pairs = B * H * vis
    isz = torch.tensor([], dtype=dtype).element_size()
    q_b, kv_b, row_b = B * H * S * hd * isz, B * Hkv * Skv * hd * isz, \
        B * H * S * 4
    work = {  # name: (flops: multiply-adds of its products, bytes)
        "fa_fwd": (4 * hd * pairs, 2 * q_b + 2 * kv_b + row_b),
        "fa_bwd_dq": (6 * hd * pairs, 2 * q_b + 2 * kv_b + 2 * row_b
                      + B * H * S * hd * 4),
        "fa_bwd_dkv": (8 * hd * pairs, 2 * q_b + 2 * kv_b + 2 * row_b
                       + 2 * B * Hkv * Skv * hd * 4),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def _sdpa_ms(torch, q, k, v, do, opts):
    """One PyTorch call for the same function: SDPA forward, and SDPA's
    backward (which computes dq, dk and dv in one call)."""
    import torch.nn.functional as Fn
    if opts.get("window") or opts.get("logit_cap"):
        return None, None
    group = q.shape[1] // k.shape[1]
    kx = k.repeat_interleave(group, dim=1).requires_grad_()
    vx = v.repeat_interleave(group, dim=1).requires_grad_()
    qx = q.detach().clone().requires_grad_()
    fwd = lambda: Fn.scaled_dot_product_attention(qx, kx, vx,
                                                  is_causal=opts["causal"])
    fwd_ms = _median_ms(torch, lambda: fwd().detach())
    out = fwd()
    bwd_ms = _median_ms(torch, lambda: torch.autograd.grad(
        out, (qx, kx, vx), do, retain_graph=True))
    return fwd_ms, bwd_ms


def phase_kernels(torch, fa, ref) -> dict:
    record = {}
    for seed, (case, shape, opts, dt) in enumerate(CASES):
        dtype = getattr(torch, dt)
        q, k, v, do = _inputs(torch, shape, dtype, seed)
        print(f"[kernels] {case}: B,S,Skv,H,Hkv,hd={shape} {opts} {dt}",
              flush=True)
        out, lse = fa.fa_fwd(q, k, v, **opts)
        out_r, lse_r = ref.fa_fwd(q, k, v, **opts)
        delta = torch.sum(do.float() * out_r.float(), dim=-1)
        bwd_in = (q, k, v, do, lse_r, delta)
        dq = fa.fa_bwd_dq(*bwd_in, **opts)
        dk, dv = fa.fa_bwd_dkv(*bwd_in, **opts)
        dq_r = ref.fa_bwd_dq(*bwd_in, **opts)
        dk_r, dv_r = ref.fa_bwd_dkv(*bwd_in, **opts)
        torch.cuda.synchronize()
        fa_tol, bw_tol = TOL[(dt, "fwd")], TOL[(dt, "bwd")]
        err = {"fa_fwd": max(_close(torch, "out", out, out_r, *fa_tol),
                             _close(torch, "lse", lse, lse_r, *fa_tol)),
               "fa_bwd_dq": _close(torch, "dq", dq, dq_r, *bw_tol),
               "fa_bwd_dkv": max(_close(torch, "dk", dk, dk_r, *bw_tol),
                                 _close(torch, "dv", dv, dv_r, *bw_tol))}
        if not case.startswith("main"):
            continue
        runs = {"fa_fwd": (lambda: fa.fa_fwd(q, k, v, **opts),
                           lambda: ref.fa_fwd(q, k, v, **opts)),
                "fa_bwd_dq": (lambda: fa.fa_bwd_dq(*bwd_in, **opts),
                              lambda: ref.fa_bwd_dq(*bwd_in, **opts)),
                "fa_bwd_dkv": (lambda: fa.fa_bwd_dkv(*bwd_in, **opts),
                               lambda: ref.fa_bwd_dkv(*bwd_in, **opts))}
        bounds = _bounds(torch, ref, shape, opts, dtype)
        sdpa_fwd, sdpa_bwd = _sdpa_ms(torch, q, k, v, do, opts)
        for name, (kern, plain) in runs.items():
            ms, plain_ms = _median_ms(torch, kern), _median_ms(torch, plain)
            lib = sdpa_fwd if name == "fa_fwd" else sdpa_bwd
            bound_ms, bound_by = bounds[name]
            print(f"[kernels]   {name:10s} {ms:.4f} ms | plain {plain_ms:.4f}"
                  f" ms | SDPA {'fwd' if name == 'fa_fwd' else 'bwd'} "
                  f"{lib:.4f} ms | bound {bound_ms:.4f} ms ({bound_by})",
                  flush=True)
            rec = dict(shape=list(shape), max_abs_err=err[name], ms=ms,
                       plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=lib)
            record.setdefault(name, {})[case] = rec
    return record


# ---------------------------------------------------------------------------
# 4. the main path
# ---------------------------------------------------------------------------

def profile_round(torch, step, state, batch, top=12):
    """One kernel-path round under torch.profiler: device time by kernel
    and the device's busy share of the round's wall time (the profiler's
    own overhead is inside that wall time)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.self_device_time_total]
    # kernel entries where the profiler lists them, else the ops that own
    # the device time (never both: that would count it twice)
    events = [e for e in events if e.device_type.name == "CUDA"] or events
    kernels = [(e.key, e.self_device_time_total / 1e3) for e in events]
    busy = sum(ms for _, ms in kernels)
    print(f"[profile] one round: wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms ({busy / wall_ms:.1%}), idle "
          f"{1 - busy / wall_ms:.1%}")
    for name, ms in sorted(kernels, key=lambda x: -x[1])[:top]:
        print(f"[profile]   {ms:9.2f} ms {ms / busy:6.1%}  {name[:100]}")


def phase_main(torch, fa) -> dict:
    import numpy as np

    from repro_torch.core import fedopt_step as F
    from repro_torch.core.control_plane import ControlPlane
    from repro_torch.launch import train
    from repro_torch.models.common import tree_leaves, tree_map

    args = train.build_parser().parse_args(MAIN_ARGS + ["--rounds", "3"])
    cfg = train.pod_config(args)
    print(f"[main] {cfg.arch.name} full width: {cfg.arch.n_layers} layers, "
          f"d_model {cfg.arch.d_model}, heads {cfg.arch.n_heads}:"
          f"{cfg.arch.n_kv_heads}, G={cfg.n_groups}, batch "
          f"{cfg.per_group_batch}, H={cfg.H}, seq {cfg.seq_len}, l_split "
          f"{cfg.l_split}, omega {cfg.omega}, remat {cfg.remat!r}",
          flush=True)
    per_round = cfg.H * (cfg.n_groups * cfg.l_split
                         + cfg.arch.n_layers - cfg.l_split)

    # 4a: kernels vs plain sdpa_chunked, same state, batches and plans
    state0 = F.init_train_state(
        torch.Generator(device="cuda").manual_seed(args.seed), cfg)
    cplane = ControlPlane(cfg.n_groups, cfg.omega, cfg.H)
    streams = train._group_streams(cfg, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    batches = []
    for _ in range(2):
        plan = cplane.plan_round()
        batches.append(train._make_batch(cfg, streams, rng, plan, "cuda"))
        cplane.finish_round()
    losses, finals = {}, {}
    for use_kernel in (True, False):
        step = F.make_train_step(dataclasses.replace(cfg,
                                                     use_kernel=use_kernel))
        state = tree_map(torch.clone, state0)
        losses[use_kernel] = []
        for r, batch in enumerate(batches):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            m = {k: float(v) for k, v in m.items()}
            losses[use_kernel].append(m)
            print(f"[main] {'kernel' if use_kernel else 'plain '} round "
                  f"{r + 1}: d_loss {m['d_loss']!r} s_loss {m['s_loss']!r} "
                  f"({time.perf_counter() - t0:.2f} s)", flush=True)
        finals[use_kernel] = {k: state[k] for k in ("dev", "aux", "srv")}
        del state, step
    diff = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(finals[True]), tree_leaves(finals[False])))
    print(f"[main] params after 2 rounds, kernel vs plain: max abs diff "
          f"{diff:.3e}")
    del finals
    for r, (a, b) in enumerate(zip(losses[True], losses[False])):
        for key in ("d_loss", "s_loss"):
            rel = abs(a[key] - b[key]) / abs(b[key])
            print(f"[main] round {r + 1} {key}: kernel {a[key]:.6f} plain "
                  f"{b[key]:.6f} rel diff {rel:.2e} (limit 1e-3)")
            if not rel <= 1e-3:
                raise AssertionError(f"round {r + 1} {key}: kernel and plain "
                                     "paths disagree")
    profile_round(torch, F.make_train_step(cfg), tree_map(torch.clone, state0),
                  batches[1])
    del state0, batches

    # 4b: the driver, three rounds with the kernels, launches per round
    counts, walls = [], []
    t_prev = [time.perf_counter()]

    def on_round(r, m):
        counts.append(dict(fa.launches))
        fa.reset_launches()
        now = time.perf_counter()
        walls.append(now - t_prev[0])
        t_prev[0] = now

    args.on_round = on_round
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t_prev[0] = time.perf_counter()
    out = train.run_pod(args)
    peak = torch.cuda.max_memory_allocated()
    tokens = cfg.global_batch * cfg.seq_len
    for r, (m, c, w) in enumerate(zip(out["history"], counts, walls)):
        print(f"[main] driver round {r + 1}: d_loss {m['d_loss']:.6f} "
              f"s_loss {m['s_loss']:.6f} | {tokens / w:,.0f} tok/s "
              f"({w:.3f} s) | launches {c}", flush=True)
        if not all(math.isfinite(m[k]) for k in ("d_loss", "s_loss")):
            raise AssertionError(f"round {r + 1}: non-finite loss {m}")
        if any(n != per_round for n in c.values()):
            raise AssertionError(f"round {r + 1}: launches {c}, want "
                                 f"{per_round} of each kernel")
    tok_s = [tokens / w for w in walls]
    print(f"[main] tok/s per round {[round(t, 1) for t in tok_s]}, median "
          f"{statistics.median(tok_s):,.1f} | peak memory "
          f"{peak / 2**30:.2f} GiB | launches per round {per_round} of each "
          "kernel", flush=True)
    totals = {name: sum(c[name] for c in counts) for name in fa.launches}
    return {"launches": totals, "launches_per_round": counts,
            "tok_s": tok_s, "peak_bytes": peak}


def main() -> int:
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    phase_device(torch)
    phase_build(fa)
    record = phase_kernels(torch, fa, ref)
    main_path = phase_main(torch, fa)
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        rec = record[name]["main-srv"]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": main_path["launches"][name],
                        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                        "plain_ms": rec["plain_ms"],
                        "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"],
                        "library_ms": rec["library_ms"],
                        "shape": rec["shape"],
                        "device_shape": record[name]["main-dev"]})
    print(json.dumps({"kernels": kernels}))
    print(smi_name_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
