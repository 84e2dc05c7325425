#!/usr/bin/env python3
"""Chip smoke test of the torch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failed check raises and the script
exits non-zero:

1. device — the card's name and power limit, torch and CUDA versions; no
   CUDA device is an error.  TF32 is set off and stated.
2. build — the five kernels are compiled from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel);
   build time and ptxas registers / shared memory per kernel.
3. kernels — each kernel against its plain PyTorch version on the card.
   Flash attention at smollm-135m's attention shape (B=2 and B=8, S=1024,
   9:3 heads, hd 64, causal, f32) and at ragged S, S != Skv, window,
   soft-cap, MHA, MQA, the other head dims, and bf16 at each head dim;
   SSD at mamba2-780m's shape (B=2 and B=8, T=1024, 48 heads, P 64, G 1,
   N 128, Q 256, f32), ragged T, T < Q, grouped B/C, the smoke shape, a
   large decay and jamba-1.5-large-398b's shape (B=2, 256 heads; timed);
   at jamba's own decays (A down to -256) the kernels and the float32
   plain version against the plain version in float64
   (``SSD_CONDITIONING``, with a planted dA fault that must fail); at B=8 two ``ssd_fwd`` calls and two
   ``ssd_bwd`` calls on the same inputs must each be bit-identical (their
   sums run in a fixed order).  Then the head-dim-128 rows of the full-width qwen3-32b
   and gemma2-27b paths (``WIDE_CASES``), at every shape those paths give
   the kernels (server and device halves): 64:8 heads, 32:16 heads with the
   logit cap 50, gemma2's local blocks (window 4096) at S=1024, and at
   S=6144, where the window cuts.  Then the rows of the llama-3.2-vision
   and whisper paths (``FRONTEND_CASES``): 64:8 heads at hd 128 with
   micro-batch 1, and whisper's 6:6 heads at hd 64 over 1500 frames
   (batch 8 and 2) and 448 tokens (batch 8).  Then the rows of the MoE
   paths (``MOE_CASES``): qwen3-moe's 64:4 heads (group 16) and llama4's
   40:8 heads (group 5) at hd 128, server and device halves.  At the main
   shapes and the rows in ``WIDE_TIMED``, ``FRONTEND_CASES`` and
   ``MOE_TIMED``,
   times (CUDA events, median of 30 after warm-up) beside the plain
   version, one PyTorch call for the same function where there is one
   (SDPA) and the card's bound: the least time with the products as 3xTF32
   on the tensor cores (``bound_ms``) and on the CUDA cores
   (``bound_simt_ms``); and the port's whole attention backward (delta,
   dq, dk/dv) beside SDPA's backward.  Last, the MoE row: the port's
   ``moe_apply_grouped`` at qwen3-moe's server shape with phase 4c's
   expert cut (x (4, 1024, 4096), 32 experts, top-8, d_ff 1536, so
   capacity 1024); forward and backward twice on the same inputs, which
   must be bit-identical, the second under
   ``torch.cuda.set_sync_debug_mode("error")`` (any host sync fails), and
   the dropped assignments and times printed.
4. main paths — the pod round of full-width smollm-135m (G=4, batch 8,
   H=4, seq 1024, l_split 3, ω=1), then of full-width mamba2-780m cut to
   8 of its 48 layers (``MAIN_CUTS``; l_split 1, its 1:7 split): two rounds with the kernels and two with the plain
   path (``sdpa_chunked``, ``ssd_chunked``) from the same state, batches
   and plans: the kernels launch as reckoned from H, G and the split and
   the plain path never, losses within 1e-3 relative, params within
   ``PARAMS_TOL`` and finite; the second kernel round profiled; then the
   driver (``repro_torch.launch.train.run_pod``, two rounds of each)
   with the kernels at ``--window 1`` and ``--window 2``
   in turns (1, 2), each run with every kernel's launches counted over the run (rounds x the per-round count)
   and its peak memory, steady tok/s, host seconds inside ``step()`` per
   round and the executor's summary; the two windows' histories must be
   bit-identical.
   4c: then qwen3-32b (qk-norm, untied head), gemma2-27b (local and
   global blocks, soft-caps, GeGLU) and llama-3.2-vision-90b (gated cross
   blocks on the frontend stub) at every published width, cut in depth
   (``WIDE_PATHS``: 2, 4 and 4 layers, one period on each side of the
   split; llama-vision's period cut from five blocks to one attention
   block and the cross block) and run at G=2, whisper-tiny
   (encoder-decoder on the frame stub) with nothing cut, and the MoE
   archs qwen3-moe-235b-a22b and llama4-maverick-400b-a17b at every
   published width but the expert count (2 and 4 layers; 128 experts cut
   to one chip's share of an expert-parallel layer, 32 and 8; each half's
   capacity printed; the plain run replays the kernel run's expert
   choices, ``replay_route``), and jamba-1.5-large-398b, the first path
   with both kernel families, at every published width (4 layers, the
   period cut to attention + Mamba/MoE, 16 experts cut to 2, G=1; the
   launches of each family reckoned from its own blocks): the same
   kernels-vs-plain check and profiled round, and two driver rounds
   through the ``RoundExecutor`` at window 2 (steady tok/s, device ms per
   round, peak memory).  The cuts are printed on the path's first line.
   The driver feeds zero frontends, as the JAX driver does, so whisper's
   device loss is exactly 0 on both paths.
5. churn — full-width, full-depth smollm-135m under ``--p-drop 0.3`` for
   ``CHURN_ROUNDS`` rounds at windows 1 and 2: bit-identical histories and
   final params, and a dropped group must have been retired (gathered from the
   live state at a boundary) in both runs.
6. serving (``SERVE``), run right after each served path's driver: smollm,
   mamba2 and whisper whole, jamba at phase 4c's cuts, each from its
   trained final state merged with ``merge_params`` (the training state
   freed first).  The kernel prefill launches ``fa_fwd`` once per
   self-attention block and ``ssd_fwd`` once per Mamba block and nothing
   else, decode none; kernel against plain prefill (last logits and every
   cache leaf within ``SERVE_TOL`` of its scale); decode after the prefill
   of S tokens against the prefill of S + 1 on both paths (within
   ``SERVE_DECODE_TOL``); then greedy
   generation on both, with prefill ms, decode ms per step, tok/s, peak
   memory and the greedy tokens that differ printed.

7. sim — the sim-mode FedOptima learner, which runs no kernel of the five
   (their counts must stay 0): (a) ``launch/train.run_sim`` at its
   defaults on the card but ``SIM_RUN_DURATION`` (8 devices, 20
   simulated seconds, VGG-5 at
   16x16, ω=8, H=10, pool = ω): the flow cap held, accuracy above chance;
   its idle fractions, throughput, accuracy, memory line, balance, wall
   seconds, device and server steps per wall second and peak memory.
   (b) the VGG-5 learner at 32x32 through ``simulate_fedoptima`` (K=4, 20
   simulated seconds) from one init and the same data on the card
   (profiled: the card's busy share) and on the CPU, which replays the
   card's ReLU masks and max-pool choices (``ReplayChoices``; how many it
   would have taken otherwise is printed): every ``Metrics`` field, the
   hook counts and ``memory_summary`` bit-identical, the final
   aggregated device params, aux and server params within
   ``SIM_PARAMS_TOL`` of each leaf's largest |value|.  (c) the paper's
   four models at their published sizes (``SIM_MODELS``: VGG-5,
   MobileNetV3ish, Transformer-6 and -12), each through the learner for
   a short run (K=4): losses finite, hook counts equal to the simulator's;
   ms per device step, server step and aggregation, and peak memory.
8. baselines — the six baselines (``core/baselines.py``: classic FL,
   FedAsync, FedBuff, SplitFed, PiPar, OAFL) and their learners
   (``FullModelLearner``, ``SplitLearner``), which run no kernel of the
   five (their counts must stay 0): (a) each with no hooks beside
   ``simulate_fedoptima`` at ``tests/test_simulation.py``'s costs (K=8,
   400 simulated seconds): idle fractions, throughput and communication
   per round, and the orderings of that file and
   ``tests/test_communication.py`` must hold.  (b) Table 2 in miniature:
   VGG-5 at 32x32, K=4, 40 simulated seconds, through FedOptima and each
   baseline with its learner on the card, from one init on the same
   shards: hook counts equal to the simulator's, losses finite, the
   held-out accuracy of each.  (c) card against CPU for FedAsync and OAFL
   (phase 7 (b)'s check, the CPU replaying the card's choices; the card
   run profiled).  (d) the paper's four models at their published sizes
   under SplitFed and FedAsync (K=4, 20 simulated seconds): ms per device
   step, server step and aggregation, and peak memory.
9. tiered store — the activation ring's host spill tier
   (``repro_torch.memory.ActivationStore``) on smollm-135m's main path
   (full width and depth, G=4, batch 8, H=4, seq 1024, l_split 3, the
   kernels, ω=2, ``--pool-cap 2``) through ``run_pod`` with a stalled
   profile (``stalled_profiles``: the server reads nothing for
   ``STORE_STALL`` rounds, then drains for as many): at window 2 in float32
   (every boundary with moves run under
   ``torch.cuda.set_sync_debug_mode("error")``: a spill or fill that
   synchronises fails), at window 1 (histories and final state, ring
   included, bit-identical to window 2's) and at window 2 with
   ``--spill-quant``.  Each run: spills > 0, fills = spills, the pool
   empty at the end, the buffered contributions past the ω ring (the
   executor raises if the tiered cap ever breaks), finite losses, the
   kernels launched as reckoned; its ``memory_s`` per round, pool peak MB
   and ``hidden_host_frac_steady``.  Then ``--pool-cap 0`` with the store
   wired against the executor with no store (two rounds, one stalled):
   bit-identical.  Then one slot's spill and fill on the card, in float32
   and int8 (``STORE_TIMED`` pairs, CUDA events; the host's enqueue time
   beside them), the filled slot against the one spilled.
10. fleet — the fleet plane (``repro_torch.fleet``): (a) smollm-135m's
   main path (full width and depth, G=4, batch 8, H=4, seq 1024, l_split
   3, ω=1, the kernels) through ``run_pod`` under ``--fleet-trace weibull
   --fleet-tiers low:3,high:1 --selection refl:0.5`` (``FLEET_FLAGS``) for
   ``FLEET_ROUNDS`` rounds at windows 1 and 2: histories and final params
   bit-identical, at least one roster event in the elastic registry, each
   round's cohort at most half (rounded up) of the available groups, the
   tier-seeded produce and read patterns printed and not uniform, the
   kernels launched as reckoned (156 a round per attention kernel, as in
   phase 4).  (b) ``run_sim`` on the card under ``--fleet-trace flaky
   --fleet-tiers low,mid,high,premium --selection score:0.5``
   (``FLEET_SIM_FLAGS``; 8 devices, 100 simulated s): its event metrics
   equal, bit for bit, to the same ``simulate_fedoptima`` call on the host
   with no learner.  (c) FedAsync and SplitFed with their VGG-5 learners
   on the card under one flaky trace at phase 8 (c)'s size (K=4, 20
   simulated s): every ``Metrics`` field, the registry's contents
   included, equal to the host run with no learner, the hook counts equal
   to the simulator's.
11. telemetry — the telemetry plane (``repro_torch.obs``): (a) smollm-135m's
   main path (full width and depth, G=4, batch 8, H=4, seq 1024, l_split
   3, ω=1, the kernels) through ``run_pod`` at window 2 for
   ``TELEMETRY_ROUNDS`` rounds, twice from one seed: untraced, then with a
   wall-domain ``Tracer`` attached and ``--metrics-out``.  Histories and
   final params bit-identical, the Chrome export valid (and through
   ``python -m repro_torch.obs.trace``'s check), the ``mesh`` spans' ends
   (CUDA events placed on the wall clock by one anchor) apart by each
   pair of rounds' ``completion_gap_s`` within ``TELEMETRY_GAP_TOL``, the
   kernels launched as reckoned in both runs.  Printed: ``attribute_idle``
   over the steady rounds (from round 2's start on the card to the last
   round's completion) with the server's busy and idle shares by class, how much of
   the server's idle time each host lane covers, the longest span of each
   host lane, and the launches.  (b) ``run_sim`` at phase 7 (a)'s
   defaults but for ``TELEMETRY_SIM_DURATION`` simulated seconds,
   untraced and traced (sim domain): equal event metrics, the idle classes
   summing to the horizon for the server and each device, no kernel
   launched.

12. sanitizer — the protocol sanitizer (``repro_torch.analysis.sanitize``):
   (a) smollm-135m's main path (full width and depth, G=4, batch 8, H=4,
   seq 1024, l_split 3, the kernels) through ``run_pod`` at window 2 for 4
   rounds under ``--omega 2 --pool-cap 2 --p-drop 0.3`` and phase 9's
   stall (``SANITIZE_FLAGS``, ``SANITIZE_STALL``), once plain and once
   with a sanitizer attached: histories and final params bit-identical, 0
   violations, a group restored, every kind of ``SANITIZE_POD_KINDS``
   counted, the kernels launched as reckoned (156 a round per attention
   kernel); the events by kind and the host seconds per round (plan and
   ``step()`` dispatch of each run, and the sanitizer's own checks)
   printed.  (b) ``run_sim`` on the card under ``--fleet-trace flaky`` for
   20 simulated s, sanitized: 0 violations, departures checked, the event
   metrics equal to the host run with no learner and no sanitizer.  (c)
   FedAsync with its VGG-5 learner under phase 10 (c)'s trace, sanitized:
   0 violations, every ``Metrics`` field equal to the host run's.  (b)
   and (c) launch no kernel.

13. checkpoints — the checkpoint store (``repro_torch.checkpoint.store``)
   on smollm-135m's main path (full width and depth, G=4, batch 8, H=4,
   seq 1024, l_split 3, ω=1, the kernels) under ``--p-drop 0.3`` at pool
   0, a snapshot every ``CKPT_EVERY`` rounds into ``CKPT_DIR`` (its free
   space checked and printed first; removed afterwards): ``CKPT_ROUNDS``
   rounds unbroken at window 2, then for each of ``CKPT_CASES`` ((a)
   window 2 without flush, (b) window 1 with ``--ckpt-flush``)
   ``CKPT_EVERY`` rounds and a rerun of the command that resumes from the newest
   verified snapshot: the histories and every leaf of the final state
   bit-identical to the unbroken run's, a snapshot holding a retained
   group, the kernels launched as reckoned (156 a round per attention
   kernel) in every run.  Printed: a snapshot's bytes reckoned from the
   state's leaves and on disk, the retained groups each holds, the
   seconds of each save (host copy, leaves to numpy, CRC32, write and
   fsync), of each resume (verify, restore onto the card),
   ``handle_bytes_peak``, and the rounds' wall times with a save due and
   without.  (c) the spilled slots on a snapshot: ``CKPT_POOL_ROUNDS``
   rounds at ω=2 + ``--pool-cap 2`` under phase 9's stall (f32, window 2),
   unbroken and without checkpoints, against the same run with a snapshot
   every ``CKPT_POOL_EVERY`` rounds, killed in-process right after its
   snapshot (which holds the two spilled slots; their bytes printed) and
   resumed to the end: the restored slots fill back, and the histories
   and every leaf of the final state are bit-identical.  (d) crash
   recovery: a dense fault schedule (``ckpt_fault_schedule``, written as
   ``fault-schedule-v1`` JSON) on the same pool and stall with a snapshot
   every round and ``--ckpt-flush``: a timed-out group, a quarantined
   ``inf`` upload, a ``bitflip``-torn snapshot and a server crash at the
   next save boundary.  The crash must fire; the rerun of the command
   skips the torn snapshot, resumes from the newest verified one, and
   ends with ``matched: true``, one injection of each class and finite
   losses.  Then the simulators' fault plane, which runs no kernel of the
   five (their counts must stay 0 over (e) and (f)): (e) ``run_sim`` at
   phase 7 (a)'s defaults on the card under ``--faults random:2`` for 40
   simulated s (``SIM_FAULT_FLAGS``), sanitized: ``matched: true``,
   faults injected, the gate rejecting some, 0 violations, every
   ``Metrics`` field (``faults`` included) equal to the same
   ``simulate_fedoptima`` call on the host with no learner, the hook
   counts the simulator's and the losses finite; (f) FedAsync and
   SplitFed with their VGG-5 learners at phase 8 (c)'s size (K=4, 20
   simulated s) under a density-2 ``BASELINE_CLASSES`` schedule
   (``BASE_FAULT_SCHEDULE``), with the same checks against the host run.
   Each leg and the phase print their seconds.

Each part's seconds are printed on its ``[time]`` line.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): float32 on the CUDA cores, TF32 on the
# tensor cores (dense), HBM3.  A float32-accurate product on the tensor cores
# takes three TF32 products (3xTF32), so its peak is PEAK_TF32_FLOPS / 3.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
TOL = {("float32", "fwd"): (1e-4, 1e-4), ("float32", "bwd"): (5e-4, 1e-3),
       ("bfloat16", "fwd"): (3e-2, 3e-2), ("bfloat16", "bwd"): (3e-2, 3e-2)}
# SSD, f32: |got - want| <= 1e-4 scale + 1e-3 |want|, with the scale of
# each output's head from ``ref.ssd_scales`` (the largest |want| of the
# head; for dA the summed size of its terms).  The absolute part follows
# each head's size: ddt = dla A + <dxb, x> cancels two terms up to |A| = 48
# times larger than itself, and the chunk's log-decay |L| ~ 1e3 rounds to
# ~1e-4 in float32 in any form.  Against a float64 evaluation the float32
# plain version itself misses an elementwise 1e-4 + 1e-3 |ref| on ddt and
# meets this one (tests/test_torch_ssd.py::
# test_ddt_tolerance_follows_its_conditioning).
SSD_TOL = (1e-4, 1e-3)
KERNELS = {  # name: (source, the TPU kernel it replaces, its main path)
    "fa_fwd": ("src/repro_torch/kernels/csrc/fa_fwd.cu",
               "src/repro/kernels/flash_attention.py:63", "smollm-135m"),
    "fa_bwd_dq": ("src/repro_torch/kernels/csrc/fa_bwd_dq.cu",
                  "src/repro/kernels/flash_attention.py:226", "smollm-135m"),
    "fa_bwd_dkv": ("src/repro_torch/kernels/csrc/fa_bwd_dkv.cu",
                   "src/repro/kernels/flash_attention.py:266", "smollm-135m"),
    "ssd_fwd": ("src/repro_torch/kernels/csrc/ssd_fwd.cu",
                "src/repro/kernels/ssd.py:52", "mamba2-780m"),
    "ssd_bwd": ("src/repro_torch/kernels/csrc/ssd_bwd.cu",
                "src/repro/kernels/ssd.py:140", "mamba2-780m"),
}
MAIN_ARGS = ["--mode", "pod", "--full", "--groups-per-shard", "4",
             "--batch", "8", "--H", "4", "--seq-len", "1024", "--omega", "1",
             "--use-kernel", "--device", "cuda"]
MAIN_PATHS = {  # arch: its own flags
    "smollm-135m": ["--arch", "smollm-135m", "--l-split", "3"],
    "mamba2-780m": ["--arch", "mamba2-780m", "--l-split", "1"],
}
# Depth cuts of the main paths, as ``ArchConfig.scaled`` keywords: mamba2
# runs 8 of its 48 layers (1 on the device, 7 on the server, the 1:7 split
# of 6 and 42), at every published width, to keep the script inside its
# time; smollm runs whole
MAIN_CUTS = {"mamba2-780m": dict(n_layers=8)}
DRIVER_ROUNDS = {"smollm-135m": 2, "mamba2-780m": 2}   # per driver run
# The windows of the driver runs: one turn of each.  The windows'
# histories are compared, and phase 5 runs both windows again under churn;
# a timing of one tree against another in paired turns is
# ``tools/ab_driver.py``'s.
DRIVER_TURNS = (1, 2)
# Phase 4c: full width, cut in depth (no depth flag: the script builds the
# FedStepConfig itself); arch: (the cuts, as ``ArchConfig.scaled``
# keywords; l_split in periods; G; batch per group; seq).  H=4, so the
# device's micro-batch is batch / 4 and the server's batch G * batch / 4.
# llama-vision keeps one attention block before its cross block per
# period: its published five-block period needs two periods, 10 layers,
# and at f32 their device side alone (about 2 x 25 GB) does not fit beside
# the server's params and gradients.  whisper-tiny runs whole, with 448
# tokens, Whisper's text context (arXiv:2212.04356).  The MoE archs keep
# every width but the expert count: one expert layer of qwen3-moe is 9.66
# GB in f32 and one of llama4-maverick 64.4 GB, so each keeps one chip's
# share of an expert-parallel layer (128 experts over 4 chips: 32; over
# 16: 8), and the router picks among the experts held here.
# jamba-1.5-large-398b keeps every published width (d_model 8192, 64:8
# heads at hd 128, d_ff 24576, vocab 65536; SSD with 256 heads, N 128,
# P 64, G 1, chunk 256; top-2) with its eight-block period cut to attention
# at 0 and MoE at 1, as the rule reads, 4 layers (one period a side) and
# 16 experts cut to 2, one chip's share of an 8-way expert-parallel layer.
# Memory (f32): attention + dense FFN is 755.0M params, Mamba + MoE 406.9M
# + 2 x 604.0M = 1,614.9M; the device half is embed 536.9M + the period +
# the aux block (1,614.9M + 37.7M) = 4,559M, the server half the period +
# lm_head = 2,906.8M: 7.47B params, 29.9 GB, at G=1; at G=2 12.0B, 48.1
# GB, which does not fit (llama-vision's 40.55 GB of params peaked at 73.23
# GiB of 79.18).  With 2 experts at top-2 every token takes both, so this
# path exercises the dispatch and combine at full width but not the choice
# among experts (the CPU tests and phase 3's MoE row hold that), and the
# ("mamba", "dense") block is held on the CPU only.
WIDE_ARGS = ["--mode", "pod", "--full", "--H", "4", "--omega", "1",
             "--use-kernel", "--device", "cuda"]
WIDE_PATHS = {
    "qwen3-32b": (dict(n_layers=2), 1, 2, 8, 1024),
    "gemma2-27b": (dict(n_layers=4), 1, 2, 4, 1024),
    "llama-3.2-vision-90b": (dict(n_layers=4, pattern=(("attn", "dense"),
                                                       ("cross", "dense"))),
                             1, 2, 4, 1024),
    "whisper-tiny": ({}, 1, 4, 8, 448),
    "qwen3-moe-235b-a22b": (dict(n_layers=2, n_experts=32), 1, 2, 8, 1024),
    "llama4-maverick-400b-a17b": (dict(n_layers=4, n_experts=8), 1, 2, 4,
                                  1024),
    "jamba-1.5-large-398b": (dict(n_layers=4, n_experts=2,
                                  pattern=(("attn", "dense"),
                                           ("mamba", "moe"))), 1, 1, 8, 1024),
}
WIDE_NOTES = {
    "jamba-1.5-large-398b": (
        "memory (f32): device half embed 536.9M + attention/dense 755.0M + "
        "Mamba/MoE 1,614.9M + aux 1,652.6M = 4,559M params, server half "
        "2,369.9M + lm_head 536.9M = 2,906.8M: 7.47B, 29.9 GB at G=1 (48.1 "
        "GB at G=2 does not fit); 2 experts at top-2: every token takes "
        "both (dispatch and combine at full width, not the choice among "
        "experts); the (mamba, dense) block is held on the CPU only"),
}
# two driver rounds keep the script inside its time; the steady tok/s is
# then one round's, as mamba2's
WIDE_DRIVER_ROUNDS = 2
# Phase 6, serving: arch -> (batch, prompt length, new tokens).  Each is
# served from its path's trained final state, merged (``merge_params``):
# smollm whole, mamba2 at its depth cut, whisper whole over its 1500 frames (416 + 32 =
# 448 tokens, its text context), jamba at phase 4c's cuts.
SERVE = {"smollm-135m": (8, 1024, 16), "mamba2-780m": (8, 1024, 16),
         "whisper-tiny": (8, 416, 32), "jamba-1.5-large-398b": (2, 1024, 16)}
# Kernel prefill against plain prefill: the last logits and every cache
# leaf within 1e-3 of the leaf's largest |value| (relative), as the round's
# losses are held.  Decode after the prefill of S tokens against the
# prefill of S + 1: the last logits within 1e-4 of their largest |value|,
# ten times the plain path's own float32 spread between the two forms (at
# most 9.331e-06 over the four served paths on an H100).
SERVE_TOL = 1e-3
SERVE_DECODE_TOL = 1e-4
# Phase 9, the tiered store: smollm's main path with a ring of ω=2 slots and
# a host pool of 2 (``--pool-cap 2``); the server reads nothing for
# STORE_STALL rounds, then drains for as many (two stalled rounds spill and
# fill as many slots as three: 2 and 2, 16 contributions buffered; cut from
# 3 to make room for phase 10).  One slot holds 8 x 1024 x 576 float32
# acts (18.87 MB) and int64 labels (65.5 kB).  STORE_TIMED spill and fill
# pairs of one slot are timed after two untimed ones.
STORE_FLAGS = ["--omega", "2", "--pool-cap", "2"]
STORE_STALL = 2
STORE_TIMED = 10
# Phase 5: rounds of each churn run (seed 0 retires a group at the second
# round's boundary; cut from 3 to make room for phase 10).
CHURN_ROUNDS = 2
# Params after two rounds, kernels vs plain: max |difference| (phase 4).
# The paths read 2.384e-07 on an H100 (one float32 ulp at |p| in [2, 4)),
# whisper-tiny 8.792e-07; a wrong kernel moves params by lr_d (0.05) times
# its gradient's error.
PARAMS_TOL = 1e-5


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


def phase_build(build):
    info = build.build()
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
    ("bf16-hd16", (2, 300, 300, 4, 4, 16), dict(causal=True, window=32),
     "bfloat16"),
    ("bf16-hd32", (2, 256, 256, 8, 2, 32), dict(causal=True, logit_cap=15.0),
     "bfloat16"),
    ("bf16-hd128", (1, 300, 300, 4, 2, 128), dict(causal=True), "bfloat16"),
]
# The attention of phase 4c's paths at head dim 128.  Each shape the paths
# give the kernels: the server half's batch (G * batch / H) and the device
# half's micro-batch (batch / H, the "-dev" rows), and gemma2's local blocks
# (window 4096, which masks nothing at S=1024); and gemma2-local at S=6144,
# where the window cuts.  The rows in WIDE_TIMED are timed like the main
# rows.
WIDE_CASES = [
    ("qwen3", (4, 1024, 1024, 64, 8, 128), dict(causal=True), "float32"),
    ("gemma2", (2, 1024, 1024, 32, 16, 128),
     dict(causal=True, logit_cap=50.0), "float32"),
    ("gemma2-local", (1, 6144, 6144, 32, 16, 128),
     dict(causal=True, window=4096, logit_cap=50.0), "float32"),
    ("qwen3-dev", (2, 1024, 1024, 64, 8, 128), dict(causal=True), "float32"),
    ("gemma2-dev", (1, 1024, 1024, 32, 16, 128),
     dict(causal=True, logit_cap=50.0), "float32"),
    ("gemma2-local-srv", (2, 1024, 1024, 32, 16, 128),
     dict(causal=True, window=4096, logit_cap=50.0), "float32"),
    ("gemma2-local-dev", (1, 1024, 1024, 32, 16, 128),
     dict(causal=True, window=4096, logit_cap=50.0), "float32"),
]
WIDE_TIMED = ("qwen3", "gemma2", "gemma2-local")
# The self-attention of the frontend paths (phase 4c; cross blocks never
# take the kernels): llama-3.2-vision's device half at micro-batch 1 (its
# server half, batch 2, is qwen3-dev's shape), whisper's encoder over 1500
# frames on the server (batch 8) and the device (micro-batch 2), and its
# decoder over 448 tokens on the server.  All are timed.
FRONTEND_CASES = [
    ("llama-vision-dev", (1, 1024, 1024, 64, 8, 128), dict(causal=True),
     "float32"),
    ("whisper-enc", (8, 1500, 1500, 6, 6, 64), dict(causal=True), "float32"),
    ("whisper-enc-dev", (2, 1500, 1500, 6, 6, 64), dict(causal=True),
     "float32"),
    ("whisper-dec", (8, 448, 448, 6, 6, 64), dict(causal=True), "float32"),
]
# The self-attention of the MoE paths (phase 4c) at hd 128: qwen3-moe's
# 64:4 heads (group 16) on the server (batch 4) and the device
# (micro-batch 2), and llama4-maverick's 40:8 heads (group 5), batch 2 and
# 1.  The server rows are timed.
MOE_CASES = [
    ("qwen3-moe-srv", (4, 1024, 1024, 64, 4, 128), dict(causal=True),
     "float32"),
    ("qwen3-moe-dev", (2, 1024, 1024, 64, 4, 128), dict(causal=True),
     "float32"),
    ("llama4-srv", (2, 1024, 1024, 40, 8, 128), dict(causal=True),
     "float32"),
    ("llama4-dev", (1, 1024, 1024, 40, 8, 128), dict(causal=True),
     "float32"),
]
MOE_TIMED = ("qwen3-moe-srv", "llama4-srv")
TIMED = WIDE_TIMED + tuple(case for case, *_ in FRONTEND_CASES) + MOE_TIMED
# The MoE row: qwen3-moe's server MoE FFN with phase 4c's expert cut.
MOE_ROW = dict(x=(4, 1024, 4096), n_experts=32, top_k=8, d_ff=1536)


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


def _close(torch, name, got, want, atol, rtol, atol_text=None):
    """``atol`` is a number or a tensor that broadcasts against ``want``."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    max_abs = err.max().item()
    ok = bool((err <= atol + rtol * want.abs()).all()) and \
        bool(torch.isfinite(got).all())
    print(f"[kernels]   {name:5s} max_abs_err {max_abs:.3e}  "
          f"(limit {atol_text or f'{atol:g}'} + {rtol:g}*|ref|)  "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return max_abs


def _least_ms(flops, nbytes):
    """(bound_ms, bound_by, bound_simt_ms): the least time for this work
    with its float32-accurate products as 3xTF32 on the tensor cores (three
    TF32 products each), and with them on the CUDA cores; bytes at the HBM
    rate bound both."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = 3 * flops / PEAK_TF32_FLOPS
    t_simt = max(flops / PEAK_F32_FLOPS, t_bytes)
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", t_simt * 1e3)


def _bounds(torch, ref, shape, opts, dtype):
    """Least time (ms) for each kernel's work at this shape (``_least_ms``),
    counting only the (q, k) pairs this mask makes visible."""
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
    return {name: _least_ms(*w) for name, w in work.items()}


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


def _ms_text(ms) -> str:
    return "none" if ms is None else f"{ms:.4f} ms"


def phase_kernels(torch, fa, ref) -> dict:
    record = {}
    for seed, (case, shape, opts, dt) in enumerate(
            CASES + WIDE_CASES + FRONTEND_CASES + MOE_CASES):
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
        if not (case.startswith("main") or case in TIMED):
            continue
        runs = {"fa_fwd": (lambda: fa.fa_fwd(q, k, v, **opts),
                           lambda: ref.fa_fwd(q, k, v, **opts)),
                "fa_bwd_dq": (lambda: fa.fa_bwd_dq(*bwd_in, **opts),
                              lambda: ref.fa_bwd_dq(*bwd_in, **opts)),
                "fa_bwd_dkv": (lambda: fa.fa_bwd_dkv(*bwd_in, **opts),
                               lambda: ref.fa_bwd_dkv(*bwd_in, **opts))}
        bounds = _bounds(torch, ref, shape, opts, dtype)
        sdpa_fwd, sdpa_bwd = _sdpa_ms(torch, q, k, v, do, opts)

        def backward():  # as ops._FlashAttention.backward runs it
            d = torch.sum(do.float() * out.float(), dim=-1)
            fa.fa_bwd_dq(q, k, v, do, lse, d, **opts)
            fa.fa_bwd_dkv(q, k, v, do, lse, d, **opts)
        print(f"[kernels]   backward pair (delta, fa_bwd_dq, fa_bwd_dkv) "
              f"{_median_ms(torch, backward):.4f} ms | SDPA bwd "
              f"{_ms_text(sdpa_bwd)}", flush=True)
        for name, (kern, plain) in runs.items():
            ms, plain_ms = _median_ms(torch, kern), _median_ms(torch, plain)
            lib = sdpa_fwd if name == "fa_fwd" else sdpa_bwd
            bound_ms, bound_by, simt_ms = bounds[name]
            print(f"[kernels]   {name:10s} {ms:.4f} ms | plain {plain_ms:.4f}"
                  f" ms | SDPA {'fwd' if name == 'fa_fwd' else 'bwd'} "
                  f"{_ms_text(lib)} | bound {bound_ms:.4f} ms ({bound_by}, "
                  f"3xTF32) | CUDA-core bound {simt_ms:.4f} ms", flush=True)
            rec = dict(shape=list(shape), max_abs_err=err[name], ms=ms,
                       plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, bound_simt_ms=simt_ms,
                       library_ms=lib)
            record.setdefault(name, {})[case] = rec
        # gemma2-local's plain version holds several 4.8 GB score tensors
        del q, k, v, do, out, lse, out_r, lse_r, dq, dk, dv, dq_r, dk_r, \
            dv_r, delta, bwd_in, runs
        torch.cuda.empty_cache()
    return record


def phase_moe(torch) -> None:
    """The MoE row (``MOE_ROW``): forward and backward of
    ``moe_apply_grouped`` twice on the same inputs, bit-identical, the
    second pass with any host sync an error; dropped assignments, ms."""
    from repro_torch.models import mlp
    B, S, D = MOE_ROW["x"]
    cfg = mlp.MoeConfig(d_model=D, d_ff=MOE_ROW["d_ff"],
                        n_experts=MOE_ROW["n_experts"],
                        top_k=MOE_ROW["top_k"])
    E, C = cfg.n_experts, mlp.moe_capacity(cfg, B * S)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = {k: v.requires_grad_()
              for k, v in mlp.moe_init(gen, cfg).items()}
    x = torch.randn(B, S, D, generator=gen, device="cuda").requires_grad_()
    dy = torch.randn(B, S, D, generator=gen, device="cuda")
    leaves = [x, *params.values()]

    def fwd():
        return mlp.moe_apply_grouped(params, cfg, x)

    def fwd_bwd():
        y, aux = fwd()
        return (y, aux, *torch.autograd.grad(torch.sum(y * dy) + aux,
                                             leaves))
    print(f"[moe] moe_apply_grouped: x {(B, S, D)}, {E} experts, top-"
          f"{cfg.top_k}, d_ff {cfg.d_ff}, capacity {C} per expert, f32",
          flush=True)
    first = fwd_bwd()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = fwd_bwd()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    names = ("y", "aux", "dx", *(f"d{k}" for k in params))
    same = {n: bool(torch.equal(a, b)) for n, a, b in zip(names, first,
                                                           again)}
    finite = all(bool(torch.isfinite(t).all()) for t in first)
    with torch.no_grad():
        top_idx = mlp._top_k_route(params, cfg, x.reshape(-1, D))[0]
        counts = (top_idx.reshape(-1, 1)
                  == torch.arange(E, device="cuda")).sum(0)
        dropped = int(torch.clamp(counts - C, min=0).sum())
        loads = (int(counts.min()), int(counts.max()))
    fwd_ms = _median_ms(torch, fwd, n=10, warmup=2)
    fwd_bwd_ms = _median_ms(torch, fwd_bwd, n=10, warmup=2)
    print(f"[moe]   twice: bit-identical {same}; second pass under "
          f"set_sync_debug_mode('error'): no host sync | finite {finite} | "
          f"aux {float(first[1].detach()):.6f} | dropped {dropped} of "
          f"{B * S * cfg.top_k} assignments (expert loads {loads[0]}"
          f"..{loads[1]}) | forward {fwd_ms:.4f} ms, forward + backward "
          f"{fwd_bwd_ms:.4f} ms", flush=True)
    if not (all(same.values()) and finite):
        raise AssertionError(f"moe_apply_grouped: two passes differ or "
                             f"not finite: {same}, finite {finite}")
    del first, again, params, x, dy, leaves
    torch.cuda.empty_cache()


SSD_CASES = [
    # name, (B, T, H, P, G, N, chunk), A's most negative value
    ("main-dev", (2, 1024, 48, 64, 1, 128, 256), -48.0),
    ("main-srv", (8, 1024, 48, 64, 1, 128, 256), -48.0),
    ("ragged", (2, 1000, 48, 64, 1, 128, 256), -48.0),
    ("T<Q", (2, 100, 48, 64, 1, 128, 256), -48.0),
    ("grouped", (2, 1024, 8, 64, 2, 128, 256), -8.0),
    ("smoke", (2, 16, 8, 16, 1, 16, 8), -8.0),
    ("large-decay", (1, 256, 48, 64, 1, 128, 256), -48.0),
    # jamba-1.5-large-398b's Mamba blocks (both halves), at the other rows'
    # decays; its own range (A to -256) is SSD_CONDITIONING's
    ("jamba", (2, 1024, 256, 64, 1, 128, 256), -48.0),
]
SSD_TIMED = ("jamba",)
# jamba's own decays, A from -1 to -256 (A_log = log(1..H)), at dt ~0.1: the
# chunk's log-decay reaches ~6.5e3 and dA's terms cancel inside the chunk's
# reverse sums far past the scale ``ref.ssd_scales`` gives it, so float32
# cannot hold dA to SSD_TOL there, the plain version no more than the
# kernel.  Both are held against the plain version in float64: the kernel
# within the SSD_TOL limit or within 2x of the float32 plain version's own
# error, output by output.  A planted fault shows what 2x lets through: the
# kernel's dA with one chunk's term of its reverse chunk sum left out must
# fail it (it is printed, chunk by chunk, beside the limit), and dA with a
# single step's term left out is printed as what the check cannot see.
SSD_CONDITIONING = ((2, 1024, 256, 64, 1, 128, 256), -256.0)


def _ssd_inputs(torch, shape, a_min, seed, large_decay):
    """x ~ N(0, 1), dt log-normal around 0.1 (the top of mamba2's dt
    range; exactly 0.1 for the large-decay case), A from -1 down to a_min
    (mamba2's init has -1 .. -H), B, C ~ N(0, 1/4), dy ~ N(0, 1); T padded
    to a chunk multiple with zero dt and x, as ``ops.ssd`` pads."""
    from repro_torch.kernels.ref import pad_steps
    B, T, H, P, G, N, chunk = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g, device="cuda")
    x = mk(B, T, H, P)
    dt = torch.full((B, T, H), 0.1, device="cuda") if large_decay else \
        0.1 * torch.exp(0.5 * mk(B, T, H))
    A = -torch.linspace(1.0, -a_min, H, device="cuda")
    Bm, Cm, dy = mk(B, T, G, N) * 0.5, mk(B, T, G, N) * 0.5, mk(B, T, H, P)
    Q = min(chunk, T)
    pad = (-T) % Q
    x, dt, Bm, Cm, dy = (pad_steps(t, pad).contiguous()
                         for t in (x, dt, Bm, Cm, dy))
    return (x, dt, A, Bm, Cm), dy, Q


def _ssd_bounds(shape, Q):
    """Least time (ms) for each SSD kernel at this shape (``_least_ms``):
    its bytes (each input read once, each output written once) and its
    flops (2 per multiply-add), counting only the Q (Q + 1) / 2 pairs
    s <= t of each chunk, and
    the score product C·Bᵀ once per (batch, group, chunk): every head of a
    group shares it."""
    B, T, H, P, G, N, _ = shape
    T += (-T) % Q
    nc = T // Q
    blocks, pairs = B * H * nc, Q * (Q + 1) // 2
    scores = B * G * nc * pairs * N
    x_b, dt_b, bc_b = B * T * H * P * 4, B * T * H * 4, B * T * G * N * 4
    st_b = B * H * nc * N * P * 4
    work = {  # name: (multiply-adds, bytes)
        "ssd_fwd": (scores + blocks * (pairs * P + 2 * Q * N * P),
                    2 * x_b + dt_b + H * 4 + 2 * bc_b + st_b),
        "ssd_bwd": (scores + blocks * (pairs * (2 * N + 2 * P)
                                       + 4 * Q * N * P),
                    3 * x_b + 2 * dt_b + 2 * H * 4 + 4 * bc_b + st_b),
    }
    return {name: _least_ms(2 * macs, nbytes)
            for name, (macs, nbytes) in work.items()}


def phase_ssd_kernels(torch, ssd_k, ref) -> dict:
    record = {}
    for seed, (case, shape, a_min) in enumerate(SSD_CASES):
        large = case == "large-decay"
        args, dy, Q = _ssd_inputs(torch, shape, a_min, seed, large)
        print(f"[kernels] ssd {case}: B,T,H,P,G,N,chunk={shape} A down to "
              f"{a_min} dt {'0.1' if large else '~0.1'}, chunk used {Q}",
              flush=True)
        y, st = ssd_k.ssd_fwd(*args, chunk=Q)
        y_r, st_r = ref.ssd_fwd(*args, chunk=Q)
        bwd_in = (*args, st_r, dy)
        grads = ssd_k.ssd_bwd(*bwd_in, chunk=Q)
        grads_r = ref.ssd_bwd(*bwd_in, chunk=Q)
        torch.cuda.synchronize()
        names = ("y", "states", "dx", "ddt", "dA", "dB", "dC")
        want = dict(zip(names, (y_r, st_r, *grads_r)))
        scale = ref.ssd_scales(*args[:3], want)
        err = {n: _close(torch, n, got, want[n], SSD_TOL[0] * scale[n],
                         SSD_TOL[1], f"{SSD_TOL[0]:g}*scale of its head")
               for n, got in zip(names, (y, st, *grads))}
        err = {"ssd_fwd": max(err[n] for n in names[:2]),
               "ssd_bwd": max(err[n] for n in names[2:])}
        if case == "main-srv":  # fixed-order sums: bit-identical calls
            for name, first, again, outs in (
                    ("ssd_fwd", (y, st), ssd_k.ssd_fwd(*args, chunk=Q),
                     names[:2]),
                    ("ssd_bwd", grads, ssd_k.ssd_bwd(*bwd_in, chunk=Q),
                     names[2:])):
                same = [bool(torch.equal(a, b)) for a, b in zip(first, again)]
                print(f"[kernels]   {name} twice: bit-identical "
                      f"{dict(zip(outs, same))}", flush=True)
                if not all(same):
                    raise AssertionError(f"{name}: two calls on the same "
                                         "inputs differ")
        if not (case.startswith("main") or case in SSD_TIMED):
            continue
        runs = {"ssd_fwd": (lambda: ssd_k.ssd_fwd(*args, chunk=Q),
                            lambda: ref.ssd_fwd(*args, chunk=Q)),
                "ssd_bwd": (lambda: ssd_k.ssd_bwd(*bwd_in, chunk=Q),
                            lambda: ref.ssd_bwd(*bwd_in, chunk=Q))}
        bounds = _ssd_bounds(shape, Q)
        for name, (kern, plain) in runs.items():
            ms, plain_ms = _median_ms(torch, kern), _median_ms(torch, plain)
            bound_ms, bound_by, simt_ms = bounds[name]
            print(f"[kernels]   {name:10s} {ms:.4f} ms | plain {plain_ms:.4f}"
                  f" ms | library: none | bound {bound_ms:.4f} ms "
                  f"({bound_by}, 3xTF32) | CUDA-core bound {simt_ms:.4f} ms",
                  flush=True)
            rec = dict(shape=list(shape), max_abs_err=err[name], ms=ms,
                       plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, bound_simt_ms=simt_ms,
                       library_ms=None)
            record.setdefault(name, {})[case] = rec
    return record


def phase_ssd_conditioning(torch, ssd_k, ref) -> None:
    """``SSD_CONDITIONING``: the kernels and the float32 plain version
    against the plain version in float64, per output the largest error
    over the SSD_TOL limit (of the float64 outputs' scales)."""
    shape, a_min = SSD_CONDITIONING
    args, dy, Q = _ssd_inputs(torch, shape, a_min, len(SSD_CASES), False)
    a64 = [t.double() for t in args]
    _, st32 = ref.ssd_fwd(*args, chunk=Q)
    got = (*ssd_k.ssd_fwd(*args, chunk=Q),
           *ssd_k.ssd_bwd(*args, st32, dy, chunk=Q))
    plain = (*ref.ssd_fwd(*args, chunk=Q)[:1], st32,
             *ref.ssd_bwd(*args, st32, dy, chunk=Q))
    y64, st64 = ref.ssd_fwd(*a64, chunk=Q)
    names = ("y", "states", "dx", "ddt", "dA", "dB", "dC")
    want = dict(zip(names, (y64, st64, *ref.ssd_bwd(
        *a64, st64, dy.double(), chunk=Q))))
    scale = ref.ssd_scales(*a64[:3], want)
    torch.cuda.synchronize()
    print(f"[kernels] ssd conditioning: B,T,H,P,G,N,chunk={shape} A down to "
          f"{a_min} dt ~0.1, kernel and float32 plain against float64: max "
          f"error / (1e-4 scale + 1e-3 |ref|)", flush=True)
    lim = {n: SSD_TOL[0] * scale[n] + SSD_TOL[1] * want[n].abs()
           for n in names}
    ratio = lambda n, t: float(((t.double() - want[n]).abs() / lim[n]).max())
    for n, k, p in zip(names, got, plain):
        rk, rp = ratio(n, k), ratio(n, p)
        ok = rk <= max(1.0, 2.0 * rp) and bool(torch.isfinite(k).all())
        print(f"[kernels]   {n:6s} kernel {rk:.3f}  plain float32 {rp:.3f}  "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"ssd conditioning {n}: the kernel is "
                                 "further from float64 than float32 allows")
        if n == "dA":
            limit = max(1.0, 2.0 * rp)
    # the planted fault: each term dA_h = sum over (b, t) of dt dla, with
    # dt dla = (dt ddt - <dx, x>) / A, in float64
    dla_dt = (a64[1] * want["ddt"] - (want["dx"] * a64[0]).sum(-1)) / a64[2]
    chunks = dla_dt.unflatten(1, (-1, Q)).sum(dim=(0, 2))       # (nc, H)
    dA = got[4].double()
    faults = [ratio("dA", dA - term) for term in chunks]
    step = ratio("dA", dA - dla_dt[0, -1])
    print(f"[kernels]   dA planted fault, one chunk's term of the reverse "
          f"chunk sum left out: {' '.join(f'{r:.3f}' for r in faults)} "
          f"(chunk by chunk; must exceed the limit {limit:.3f}) | one step's "
          f"term left out: {step:.3f} (not seen at this conditioning)",
          flush=True)
    if not min(faults) > limit:
        raise AssertionError("ssd conditioning: a dA with a chunk's term "
                             "left out passes the check")
    del args, dy, a64, st32, got, plain, y64, st64, want, scale, lim
    del dla_dt, chunks, dA
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 4. the main paths
# ---------------------------------------------------------------------------

def profile_round(torch, round_fn, top=12, busy=None):
    """One kernel-path round, ``round_fn()``, under torch.profiler: device
    time by kernel and the device's busy share of the round's wall time
    (the profiler's own overhead is inside that wall time).  CUDA activity
    only: recording the host's ops too lengthened the rounds' wall (smollm
    read 23.7% busy with them, 39.9% without) and took 41 s to collect
    after smollm's profiled round, 57 s after mamba2's (9 s and 14 s
    without; an H100 host).  Returns the round's result; ``busy["share"]``
    is set to the busy share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = round_fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.self_device_time_total]
    # kernel entries where the profiler lists them, else the ops that own
    # the device time (never both: that would count it twice)
    events = [e for e in events if e.device_type.name == "CUDA"] or events
    kernels = [(e.key, e.self_device_time_total / 1e3) for e in events]
    busy_ms = sum(ms for _, ms in kernels)
    if busy is not None:
        busy["share"] = busy_ms / wall_ms
    print(f"[profile] one round: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({busy_ms / wall_ms:.1%}), idle "
          f"{1 - busy_ms / wall_ms:.1%}")
    for name, ms in sorted(kernels, key=lambda x: -x[1])[:top]:
        print(f"[profile]   {ms:9.2f} ms {ms / busy_ms:6.1%}  {name[:100]}")
    return out


def _describe(cfg) -> str:
    arch = cfg.arch
    if arch.pattern[0][0] == "mamba":
        m = arch.mamba_cfg()
        mixer = (f"SSD heads {m.n_heads}, N {m.d_state}, P {m.head_dim}, "
                 f"chunk {m.chunk}")
    else:
        mixer = f"heads {arch.n_heads}:{arch.n_kv_heads}"
    return (f"{arch.name} full width: {arch.n_layers} layers, d_model "
            f"{arch.d_model}, {mixer}, G={cfg.n_groups}, batch "
            f"{cfg.per_group_batch}, H={cfg.H}, seq {cfg.seq_len}, l_split "
            f"{cfg.l_split}, omega {cfg.omega}, remat {cfg.remat!r}")


def main_setup(arch: str, flags):
    """(args, cfg) of a main path: its flags, full width, and the depth
    ``MAIN_CUTS`` gives it (whole where it gives none)."""
    from repro_torch.launch import train
    args = train.build_parser().parse_args(MAIN_ARGS + MAIN_PATHS[arch]
                                           + list(flags))
    cfg = train.pod_config(args)
    cuts = MAIN_CUTS.get(arch)
    return args, (dataclasses.replace(cfg, arch=cfg.arch.scaled(**cuts))
                  if cuts else cfg)


def wide_setup(arch: str, flags):
    """(args, cfg) of a phase-4c path: the registry's full config with
    ``WIDE_PATHS``' cuts, every width kept."""
    from repro_torch.launch import train
    cuts, l_split, groups, batch, seq = WIDE_PATHS[arch]
    args = train.build_parser().parse_args(
        WIDE_ARGS + ["--arch", arch, "--l-split", str(l_split),
                     "--groups-per-shard", str(groups), "--batch", str(batch),
                     "--seq-len", str(seq), *flags])
    cfg = train.pod_config(args)
    return args, dataclasses.replace(cfg, arch=cfg.arch.scaled(**cuts))


def _takes(arch) -> dict:
    """Blocks of a period that take each kernel family: "fa_" the
    self-attention blocks, "ssd_" the Mamba blocks."""
    return {"fa_": sum(m in ("attn", "local") for m, _ in arch.pattern),
            "ssd_": sum(m == "mamba" for m, _ in arch.pattern)}


def _family(name: str) -> str:
    return "fa_" if name.startswith("fa_") else "ssd_"


def _model_blocks(arch) -> dict:
    """Per kernel family (``_takes``), the blocks of the whole model that
    take its kernels: every period's, and an enc-dec's decoder's
    self-attention blocks.  Cross blocks never do."""
    from repro_torch.models.transformer import _decoder_cfg
    n = {fam: arch.n_periods * k for fam, k in _takes(arch).items()}
    if arch.n_decoder_layers:
        dec = _decoder_cfg(arch)
        n = {fam: k + dec.n_periods * _takes(dec)[fam]
             for fam, k in n.items()}
    return n


def kernel_blocks(cfg) -> dict:
    """Per kernel family, the (device, server) blocks a micro-iteration
    runs that take its kernels: the device its ``l_split`` periods, the
    server the rest of the model (``_model_blocks``).  The aux block never
    takes them."""
    return {fam: (cfg.l_split * k, total - cfg.l_split * k)
            for (fam, k), total in zip(_takes(cfg.arch).items(),
                                       _model_blocks(cfg.arch).values())}


def launches_per_round(cfg, counters) -> tuple[int, dict]:
    """(n, want): each kernel launches once per block of its family per
    micro-iteration, H x (G x device blocks + server blocks) a round
    (``kernel_blocks``); n is the most any kernel launches."""
    blocks = kernel_blocks(cfg)
    want = {}
    for c in counters:
        for name in c.launches:
            dev, srv = blocks[_family(name)]
            want[name] = cfg.H * (cfg.n_groups * dev + srv)
    return max(want.values()), want


def serve_launches(arch, counters) -> dict:
    """One prefill with the kernels: ``fa_fwd`` once per self-attention
    block (an enc-dec's encoder and decoder), ``ssd_fwd`` once per Mamba
    block, and no other kernel (decode launches none)."""
    n = _model_blocks(arch)
    return {name: n[_family(name)] if name.endswith("_fwd") else 0
            for c in counters for name in c.launches}


def _reckoning(cfg) -> str:
    """Each family's launches a round, H x (G x device + server blocks)."""
    blocks = kernel_blocks(cfg)
    return "; ".join(
        f"{fam}* {cfg.H} x ({cfg.n_groups} x {dev} + {srv}) = "
        f"{cfg.H * (cfg.n_groups * dev + srv)}"
        for fam, (dev, srv) in blocks.items() if dev or srv)


def replay_route(torch, params, cfg, xt, chosen):
    """``mlp._top_k_route`` with the experts ``chosen`` (T, k) in place of
    the router's own top-k: the same softmax, the weights renormalised over
    the k and the load-balance loss, so a token whose own choice is
    ``chosen`` gets bit-identical values and gradients.  Returns
    (chosen, weights, aux, n, gap): n tokens chose otherwise (experts or
    their order), and ``gap`` is the smallest gap between adjacent
    probabilities among the k + 1 largest of those tokens (inf if none)."""
    E, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(xt.float() @ params["router"].float(), dim=-1)
    top_w = torch.gather(probs, 1, chosen)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    routed = (chosen[..., None] == torch.arange(E, device=xt.device)) \
        .float().sum(1)
    aux = E * torch.sum(routed.mean(0) / k * probs.mean(0))
    with torch.no_grad():
        top, own = torch.sort(probs, dim=-1, descending=True, stable=True)
        differ = (own[:, :k] != chosen).any(-1)
        top = top[:, :k + 1]
        gap = (top[:, :-1] - top[:, 1:]).min(-1).values
        gap = torch.where(differ, gap, torch.inf).min()
    return chosen, top_w, aux, differ.sum(), gap


def kernel_vs_plain(torch, tag: str, args, cfg, counters, want) -> None:
    """Two rounds with the kernels and two with the plain path from the same
    state, batches and plans: the kernels launch ``want`` times a round and
    the plain path never, the losses agree within 1e-3 relative and the
    params within PARAMS_TOL and are finite.  The second kernel round is
    profiled (``profile_round``).  The state is drawn from the seed for each
    run (two copies of a full-width state do not fit beside a round's
    gradients).

    On a MoE path the plain run replays the kernel run's expert choices
    (``replay_route``): a token whose two candidate experts' probabilities
    lie within the paths' last-bit differences would otherwise take another
    expert, and one such token moves the params past PARAMS_TOL.  The
    tokens whose own choice differed are counted and printed with their
    smallest probability gap, so the comparison holds the kernels'
    arithmetic alone."""
    import numpy as np

    from repro_torch.core import fedopt_step as F
    from repro_torch.core.control_plane import ControlPlane
    from repro_torch.launch import train
    from repro_torch.models import mlp
    from repro_torch.models.common import tree_leaves

    route, chosen, replayed = mlp._top_k_route, [], []

    def record(params, mcfg, xt):
        out = route(params, mcfg, xt)
        chosen.append(out[0])
        return out

    def replay(params, mcfg, xt):
        out = replay_route(torch, params, mcfg, xt, chosen[len(replayed)])
        replayed.append((xt.shape[0], *out[3:]))
        return out[:3]

    def fresh_state():
        torch.cuda.empty_cache()
        return F.init_train_state(
            torch.Generator(device="cuda").manual_seed(args.seed), cfg)

    cplane = ControlPlane(cfg.n_groups, cfg.omega, cfg.H)
    streams = train._group_streams(cfg, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    batches = []
    for _ in range(2):
        plan = cplane.plan_round()
        batches.append(train._make_batch(cfg, streams, rng, plan, "cuda"))
        cplane.finish_round()
    params = lambda st: [x for k in ("dev", "aux", "srv")
                         for x in tree_leaves(st[k])]
    losses = {}
    for use_kernel in (True, False):
        step = F.make_train_step(dataclasses.replace(cfg,
                                                     use_kernel=use_kernel))
        state = fresh_state()
        if use_kernel:
            n = sum(x.numel() for x in params(state))
            print(f"{tag} params: {n:,} ({n * 4 / 1e9:.2f} GB f32) for "
                  f"G={cfg.n_groups} groups, the aux networks and the "
                  f"server", flush=True)
        for c in counters:
            c.reset_launches()
        losses[use_kernel] = []
        if cfg.arch.n_experts:
            mlp._top_k_route = record if use_kernel else replay
        try:
            for r, batch in enumerate(batches):
                t0 = time.perf_counter()
                run = lambda: step(state, batch)
                profiled = use_kernel and r == 1
                state, m = profile_round(torch, run) if profiled else run()
                m = {k: float(v) for k, v in m.items()}
                losses[use_kernel].append(m)
                print(f"{tag} {'kernel' if use_kernel else 'plain '} round "
                      f"{r + 1}: d_loss {m['d_loss']!r} s_loss "
                      f"{m['s_loss']!r} ({time.perf_counter() - t0:.2f} s"
                      f"{', profiled' if profiled else ''})", flush=True)
        finally:
            mlp._top_k_route = route
        launches = {k: v for c in counters for k, v in c.launches.items()}
        if use_kernel:
            if launches != {k: 2 * n for k, n in want.items()}:
                raise AssertionError(f"{tag} launches over 2 rounds "
                                     f"{launches}, want 2 x {want}")
            if not all(bool(torch.isfinite(x).all()) for x in params(state)):
                raise AssertionError(f"{tag} non-finite params after the "
                                     "kernel rounds")
            kernel_final = [x.cpu() for x in params(state)]   # to the host
        elif any(launches.values()):
            raise AssertionError(f"{tag} the plain path launched {launches}")
        else:
            diff = max(float((x - y.to(x.device)).abs().max())
                       for x, y in zip(params(state), kernel_final))
        del state, step
    del kernel_final
    if cfg.arch.n_experts:
        if len(replayed) != len(chosen):
            raise AssertionError(f"{tag} the plain run routed {len(replayed)}"
                                 f" times, the kernel run {len(chosen)}")
        tokens = sum(t for t, _, _ in replayed)
        n = sum(int(d) for _, d, _ in replayed)
        gap = min(float(g) for _, _, g in replayed)
        print(f"{tag} router: the plain run replays the kernel run's expert "
              f"choices ({len(chosen)} routings, {tokens:,} tokens); its own"
              f" choice differed for {n} tokens (smallest gap between "
              f"adjacent top-{cfg.arch.top_k + 1} probabilities among them "
              f"{gap:.3e})", flush=True)
    print(f"{tag} launches per round {({k: n for k, n in want.items() if n})}"
          f", none on the plain path | "
          f"params after 2 rounds, kernel vs plain: max abs diff {diff:.3e} "
          f"(limit {PARAMS_TOL:g}), all finite True", flush=True)
    if not diff <= PARAMS_TOL:
        raise AssertionError(f"{tag} params: kernel and plain paths disagree")
    for r, (x, y) in enumerate(zip(losses[True], losses[False])):
        for key in ("d_loss", "s_loss"):
            # two exact zeros agree (whisper's device loss on zero frames)
            rel = 0.0 if x[key] == y[key] else \
                abs(x[key] - y[key]) / abs(y[key]) if y[key] else math.inf
            print(f"{tag} round {r + 1} {key}: kernel {x[key]:.6f} plain "
                  f"{y[key]:.6f} rel diff {rel:.2e} (limit 1e-3)")
            if not (rel <= 1e-3 and math.isfinite(x[key])):
                raise AssertionError(f"{tag} round {r + 1} {key}: kernel "
                                     "and plain paths disagree")
    del batches
    torch.cuda.empty_cache()


def phase_main(torch, arch: str, counters) -> dict:
    """One main path: kernels vs plain (a round of it profiled), the driver, and
    serving from the last driver run's final state.  ``counters`` are the
    kernel modules whose ``launches`` the driver's rounds read."""
    t_phase = time.perf_counter()
    args, cfg = main_setup(arch, ["--rounds", "2"])
    print(f"[main] {_describe(cfg)}", flush=True)
    per_round, want = launches_per_round(cfg, counters)
    kernel_vs_plain(torch, "[main]", args, cfg, counters, want)

    # 4b: the driver at windows 1 and 2, in turns
    rounds, turns = DRIVER_ROUNDS[arch], DRIVER_TURNS
    runs = []
    for i, window in enumerate(turns):
        run = drive(torch, *main_setup(arch, ["--rounds", str(rounds),
                                              "--window", str(window)]),
                    counters, keep_state=i == len(turns) - 1)
        want_total = {k: n * rounds for k, n in want.items()}
        for r, m in enumerate(run["history"]):
            if not all(math.isfinite(m[k]) for k in ("d_loss", "s_loss")):
                raise AssertionError(f"window {window} round {r + 1}: "
                                     f"non-finite loss {m}")
        if run["launches"] != want_total:
            raise AssertionError(f"window {window}: launches "
                                 f"{run['launches']}, want {want_total} "
                                 f"({rounds} rounds x {per_round})")
        if runs and run["history"] != runs[0][1]["history"]:
            raise AssertionError(f"window {window} differs from window 1: "
                                 f"{run['history']} vs "
                                 f"{runs[0][1]['history']}")
        runs.append((window, run))
    by = {w: [run for ww, run in runs if ww == w] for w in (1, 2)}
    steady = {w: [run["steady_tok_s"] for run in by[w]] for w in (1, 2)}
    peak = {w: max(run["peak_bytes"] for run in by[w]) for w in (1, 2)}
    print(f"[main] windows 1 and 2 (run in turns {turns}; {rounds} "
          f"rounds each): histories bit-identical | steady tok/s window 1 "
          f"{[round(t, 1) for t in steady[1]]} mean "
          f"{statistics.mean(steady[1]):,.1f}, window 2 "
          f"{[round(t, 1) for t in steady[2]]} mean "
          f"{statistics.mean(steady[2]):,.1f} | peak memory "
          f"{peak[1] / 2**30:.2f} / {peak[2] / 2**30:.2f} GiB | launches per "
          f"round {per_round} of each of "
          f"{[k for k, n in want.items() if n]} | phase "
          f"{time.perf_counter() - t_phase:.0f} s", flush=True)
    served = serve_trained(torch, cfg, runs[-1][1], counters)
    return {"launches": by[2][0]["launches"], "steady_tok_s": steady,
            "peak_bytes": peak, "serve": served}


def drive(torch, args, cfg, counters, keep_final: bool = False,
          keep_state: bool = False) -> dict:
    """One run of the driver (``train.run_pod(args, cfg)``): every kernel's
    launch count is set to 0 just before it and read just after, and the
    peak memory is taken over it alone.  Prints the losses, the steady
    tok/s (rounds 2..N over the time from the first round's completion to
    the last's, on the card's clock: a drain lags its round by up to
    window - 1 dispatches), the per-round tok/s, the host seconds per round
    inside step() apart from planning and building, and the executor's
    summary.  ``keep_final`` returns the final dev, aux and srv params,
    copied to the host; ``keep_state`` the final state as it lies on the
    card."""
    from repro_torch.core.executor import completion_gap_s
    from repro_torch.launch import train
    from repro_torch.models.common import tree_map
    tokens = cfg.global_batch * cfg.seq_len
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset_launches()
    t0 = time.perf_counter()
    out = train.run_pod(args, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for c in counters for k, v in c.launches.items()}
    peak = torch.cuda.max_memory_allocated()
    stats, xs = out["round_stats"], out["executor"]
    rounds = len(out["history"])      # a resumed run runs the rest only
    per_round = [tokens / completion_gap_s(a, b)
                 for a, b in zip(stats, stats[1:])]
    tag = f"[drive] {cfg.arch.name} --window {args.window}" + \
        (f" --p-drop {args.p_drop}" if args.p_drop else "") + \
        (f" --fleet-trace {args.fleet_trace}" if args.fleet_trace else "")
    print(f"{tag}: history "
          f"{[(m['d_loss'], m['s_loss']) for m in out['history']]}")
    steady = "n/a (one round)" if out["steady_tok_s"] is None else \
        f"{out['steady_tok_s']:,.1f}"
    print(f"{tag}: steady {steady} tok/s (rounds 2-"
          f"{rounds}, first to last completion) | per round after the first"
          f" {[round(t, 1) for t in per_round]} | whole run "
          f"{tokens * rounds / wall:,.1f} tok/s ({wall:.3f} s) | peak memory"
          f" {peak / 2**30:.2f} GiB | launches {launches}")
    print(f"{tag}: step() dispatch s per round "
          f"{[round(s.dispatch_s, 3) for s in stats]} | plan s "
          f"{[round(s.plan_s, 4) for s in stats]} | build s "
          f"{[round(s.build_s, 4) for s in stats]}")
    print(f"{tag}: executor peak_in_flight {xs['peak_in_flight']} "
          f"host_s_exposed_steady {xs['host_s_exposed_steady']:.6f} "
          f"hidden_host_frac_steady {xs['hidden_host_frac_steady']:.4f} "
          f"handle_bytes_peak {xs['handle_bytes_peak']} device_s_per_round "
          f"{xs['device_s_per_round']:.6f} retention "
          f"{xs['retention']}", flush=True)
    final = {k: tree_map(lambda x: x.cpu(), out["state"][k])
             for k in ("dev", "aux", "srv")} if keep_final else None
    return {"history": out["history"], "steady_tok_s": out["steady_tok_s"],
            "peak_bytes": peak, "launches": launches, "executor": xs,
            "memory": out["memory"], "round_stats": stats,
            "fleet": out["fleet"], "consumed": out["consumed"],
            "final": final,
            "state": out["state"] if keep_state else None}


def phase_churn(torch, counters) -> None:
    """smollm-135m at full width and full depth (30 layers) under churn
    (--p-drop 0.3, ``CHURN_ROUNDS`` rounds) at windows 1 and 2: the
    histories and the final params must be bit-identical, and both runs
    must have retired a dropped group."""
    from repro_torch.models.common import tree_leaves
    t0 = time.perf_counter()
    runs = {w: drive(torch, *main_setup("smollm-135m", [
        "--rounds", str(CHURN_ROUNDS), "--window", str(w), "--p-drop",
        "0.3"]), counters,
        keep_final=True) for w in (1, 2)}
    same_hist = runs[1]["history"] == runs[2]["history"]
    same_params = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(runs[1]["final"]), tree_leaves(runs[2]["final"])))
    retention = {w: runs[w]["executor"]["retention"] for w in (1, 2)}
    print(f"[churn] smollm-135m full width, 30 layers, --p-drop 0.3, "
          f"{CHURN_ROUNDS} rounds: windows 1 and 2 histories bit-identical "
          f"{same_hist}, "
          f"final params bit-identical {same_params}; retention {retention},"
          f" window 2 handle_bytes_peak "
          f"{runs[2]['executor']['handle_bytes_peak']}, peak memory "
          f"{runs[1]['peak_bytes'] / 2**30:.2f} / "
          f"{runs[2]['peak_bytes'] / 2**30:.2f} GiB | phase "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    if not (same_hist and same_params):
        raise AssertionError("windows 1 and 2 differ under churn")
    if not all(r["retired"] for r in retention.values()):
        raise AssertionError(f"no group was retired under churn: {retention}")


def stalled_profiles(n_groups: int, stall: int):
    """The reference tests' stalled profile (``tests/test_memory.py``
    ``_StalledProfiles``): for the first ``stall`` plans every group emits
    and the server reads nothing, so the backlog builds and slots spill;
    then emission stops and the server drains, so the pool fills back."""
    import numpy as np

    from repro_torch.core.executor import StragglerProfiles

    class Stalled(StragglerProfiles):
        planned = 0

        def produce(self, H):
            self.planned += 1       # produce() is called first each round
            return np.full((H, self.G), self.planned <= stall, bool)

        def reads(self, H):
            return np.full(H, self.planned > stall, bool)

        # the count of plans rides a snapshot, so a resumed run keeps the
        # stall's phase
        def summary(self):
            return {**super().summary(), "planned": self.planned}

        def load_summary(self, ps):
            super().load_summary(ps)
            self.planned = ps["planned"]
    return Stalled(n_groups)


def time_slot_moves(torch, state, quant: bool) -> dict:
    """One ring slot's spill (``gather_act_slot`` into a store: the int8
    encoding on the card under ``quant``, then the copy into pinned host
    memory) and fill (``store.fill``: the copy back and the decode on the
    card, then ``scatter_act_slot``), each timed with CUDA events around
    its enqueue, median of ``STORE_TIMED`` pairs after two untimed ones,
    with the host's enqueue time beside it.  The slot after each pair is
    held against its content before: bit-identical in float32, within
    max|x|/254 in int8 (float32 leaves slot 0 as it found it)."""
    from repro_torch.core import fedopt_step as F
    from repro_torch.memory import ActivationStore
    store = ActivationStore(1, quant=quant)
    before = {k: v.clone() for k, v in F.gather_act_slot(state, 0).items()}
    ms = {"spill": [], "fill": [], "spill_host": [], "fill_host": []}
    worst = 0.0
    for i in range(STORE_TIMED + 2):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        h0 = time.perf_counter()
        store.spill(i, F.gather_act_slot(state, 0))
        ev[1].record()
        h1 = time.perf_counter()
        F.scatter_act_slot(state, 0, store.fill(i))
        ev[2].record()
        h2 = time.perf_counter()
        torch.cuda.synchronize()
        after = F.gather_act_slot(state, 0)
        if not torch.equal(after["labels"], before["labels"]):
            raise AssertionError("a filled slot's labels differ")
        err = float((after["acts"] - before["acts"]).abs().max())
        amax = float(before["acts"].abs().max())
        bound = amax / 254.0 + 1e-7 * amax if quant else 0.0
        if err > bound:
            raise AssertionError(f"filled slot off by {err:.3e}, bound "
                                 f"{bound:.3e} (quant {quant})")
        worst = max(worst, err)
        if i >= 2:
            ms["spill"].append(ev[0].elapsed_time(ev[1]))
            ms["fill"].append(ev[1].elapsed_time(ev[2]))
            ms["spill_host"].append((h1 - h0) * 1e3)
            ms["fill_host"].append((h2 - h1) * 1e3)
    out = {k: statistics.median(v) for k, v in ms.items()}
    out.update(pool_mb=store.peak_pool_bytes / 1e6, max_err=worst,
               slot_mb=sum(v.numel() * v.element_size()
                           for v in before.values()) / 1e6)
    return out


def phase_store(torch, counters) -> dict:
    """Phase 9 (see the module docstring): smollm's main path with the
    tiered store under a stalled profile."""
    from repro_torch.core import executor as ex_mod
    from repro_torch.launch import train
    from repro_torch.models.common import tree_leaves
    t0 = time.perf_counter()
    _, cfg = main_setup("smollm-135m", STORE_FLAGS)
    per_round, want = launches_per_round(cfg, counters)
    boundaries = []          # (round, fills, spills) run under sync checks
    apply_memory = ex_mod.RoundExecutor._apply_memory

    def no_sync_memory(self, state, plan, r):
        if not (plan.fill or plan.spill):
            return apply_memory(self, state, plan, r)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return apply_memory(self, state, plan, r)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            boundaries.append((r, len(plan.fill), len(plan.spill)))

    def run(flags, stall, check_pool=True):
        args, cfg = main_setup("smollm-135m", STORE_FLAGS + flags)
        args.profiles = stalled_profiles(cfg.n_groups, stall)
        out = drive(torch, args, cfg, counters, keep_state=True)
        rounds = args.rounds
        if out["launches"] != {k: n * rounds for k, n in want.items()}:
            raise AssertionError(f"launches {out['launches']}, want "
                                 f"{rounds} x {want}")
        if not all(math.isfinite(m[k]) for m in out["history"]
                   for k in ("d_loss", "s_loss")):
            raise AssertionError(f"non-finite loss {out['history']}")
        mem = out["memory"]
        tag = f"[store] {' '.join(flags)}"
        print(f"{tag}: memory {mem} | memory_s per round "
              f"{[round(s.memory_s, 6) for s in out['round_stats']]} | plan"
              f" s {[round(s.plan_s, 4) for s in out['round_stats']]} | "
              f"hidden_host_frac_steady "
              f"{out['executor']['hidden_host_frac_steady']:.4f}",
              flush=True)
        if check_pool and not (
                mem["spills"] > 0 and mem["fills"] == mem["spills"]
                == mem["store_spills"] == mem["store_fills"]
                and mem["pool_live"] == mem["pool_entries"] == 0
                and mem["peak_buffered"] > cfg.omega * cfg.n_groups):
            raise AssertionError(f"{tag}: the pool did not spill past the "
                                 f"ring and drain: {mem}")
        return out

    def same(a, b):
        return a["history"] == b["history"] and all(
            torch.equal(x, y) for x, y in zip(tree_leaves(a["state"]),
                                              tree_leaves(b["state"])))

    rounds = ["--rounds", str(2 * STORE_STALL)]
    ex_mod.RoundExecutor._apply_memory = no_sync_memory
    try:
        f32 = run(rounds + ["--window", "2"], STORE_STALL)
    finally:
        ex_mod.RoundExecutor._apply_memory = apply_memory
    w1 = run(rounds + ["--window", "1"], STORE_STALL)
    if not same(f32, w1):
        raise AssertionError("windows 1 and 2 differ with the pool active")
    del w1
    # the ring as the float32 run left it: its slots were never quantised
    moves = time_slot_moves(torch, f32["state"], quant=False)
    moves8 = time_slot_moves(torch, f32["state"], quant=True)
    f32["state"] = None
    int8 = run(rounds + ["--window", "2", "--spill-quant"], STORE_STALL)
    int8["state"] = None
    # --pool-cap 0 with the store wired against no store at all
    wired = run(["--rounds", "2", "--pool-cap", "0"], 1, check_pool=False)
    executor = train.RoundExecutor

    def storeless(step, cplane, **kw):
        for k in ("store", "gather_slot", "scatter_slot"):
            kw.pop(k)
        return executor(step, cplane, **kw)
    train.RoundExecutor = storeless
    try:
        bare = run(["--rounds", "2", "--pool-cap", "0"], 1, check_pool=False)
    finally:
        train.RoundExecutor = executor
    if "memory" in bare["executor"] or not same(wired, bare):
        raise AssertionError("--pool-cap 0 with the store wired differs "
                             "from the storeless run")
    if wired["memory"]["spills"] or not boundaries:
        raise AssertionError(f"moves at pool 0, or none checked: "
                             f"{wired['memory']}, {boundaries}")
    del wired, bare
    print(f"[store] smollm-135m full width, omega 2 + pool 2, stall "
          f"{STORE_STALL} then drain {STORE_STALL}: spills/fills f32 "
          f"{f32['memory']['spills']}/{f32['memory']['fills']}, int8 "
          f"{int8['memory']['spills']}/{int8['memory']['fills']}; pool peak "
          f"{f32['memory']['peak_pool_bytes'] / 1e6:.3f} MB f32, "
          f"{int8['memory']['peak_pool_bytes'] / 1e6:.3f} MB int8; within "
          f"the tiered cap every round; windows 1 and 2 bit-identical; pool "
          f"0 wired == storeless; boundaries with moves under "
          f"set_sync_debug_mode('error'): {boundaries}; launches per round "
          f"{per_round} | {smi_name_power()}", flush=True)
    for name, m in (("f32", moves), ("int8", moves8)):
        print(f"[store] one slot ({m['slot_mb']:.3f} MB on the card), {name}"
              f": spill {m['spill']:.4f} ms, fill {m['fill']:.4f} ms (CUDA "
              f"events, median of {STORE_TIMED}; "
              f"{m['slot_mb'] / m['spill']:.2f} / "
              f"{m['slot_mb'] / m['fill']:.2f} GB/s of the slot's card "
              f"bytes) | host enqueue {m['spill_host']:.4f} / "
              f"{m['fill_host']:.4f} ms | pool {m['pool_mb']:.3f} MB | "
              f"round trip max err {m['max_err']:.3e} | {smi_name_power()}",
              flush=True)
    print(f"[store] phase {time.perf_counter() - t0:.0f} s", flush=True)
    return {"launches": f32["launches"], "moves": {"f32": moves,
                                                   "int8": moves8}}


def phase_wide(torch, arch: str, counters) -> dict:
    """A full-width path with ``WIDE_PATHS``' cuts: kernels vs plain (a
    round of it profiled), and ``WIDE_DRIVER_ROUNDS`` driver rounds at
    window 2."""
    from repro_torch.configs import registry

    t_phase = time.perf_counter()
    args, cfg = wide_setup(arch, ["--rounds", "2"])
    a, full = cfg.arch, registry.get(arch)
    per_round, want = launches_per_round(cfg, counters)
    cuts = [f"depth {full.n_layers} -> {a.n_layers} layers"] \
        if a.n_layers != full.n_layers else []
    if a.pattern != full.pattern:
        cuts.append(f"period {full.period} -> {a.period} blocks")
    moe = ""
    if a.n_experts:
        from repro_torch.models.mlp import moe_capacity
        cap = lambda tokens: moe_capacity(a.moe_cfg(), tokens,
                                          a.moe_capacity_factor)
        tokens = cfg.micro_batch * cfg.seq_len
        moe = (f", MoE top-{a.top_k} of {a.n_experts} experts, capacity C "
               f"{cap(tokens)} device / {cap(cfg.n_groups * tokens)} server"
               f" (cf {a.moe_capacity_factor})")
    if a.n_experts != full.n_experts:
        cuts.append(f"experts {full.n_experts} -> {a.n_experts}, one chip's "
                    f"share of a {full.n_experts // a.n_experts}-way "
                    "expert-parallel layer (the router picks among the "
                    "experts held here)")
    if cfg.n_groups != 4:
        cuts.append(f"G={cfg.n_groups} (the main paths: 4)")
    if cfg.per_group_batch != 8:
        cuts.append(f"batch {cfg.per_group_batch} per group (the main "
                    "paths: 8)")
    ssd = ""
    if a.ssm_state:
        m = a.mamba_cfg()
        ssd = (f", SSD heads {m.n_heads}, N {m.d_state}, P {m.head_dim}, G "
               f"{m.n_groups}, chunk {m.chunk}")
    note = f" | {WIDE_NOTES[arch]}" if arch in WIDE_NOTES else ""
    print(f"[wide] {arch} at every published width: d_model {a.d_model}, "
          f"heads {a.n_heads}:{a.n_kv_heads}, hd {a.hd}{ssd}, d_ff {a.d_ff} "
          f"({a.activation}), vocab {a.vocab}, pattern {list(a.pattern)}, "
          f"qk_norm {a.qk_norm}, attn cap {a.attn_softcap}, final cap "
          f"{a.final_softcap}, window {a.window}, tied head "
          f"{a.tie_embeddings}, frontend_len {a.frontend_len}, decoder "
          f"layers {a.n_decoder_layers}{moe} | cuts: "
          f"{'; '.join(cuts) or 'none'} | {a.n_layers} layers "
          f"({cfg.l_split * a.period} on the device side), G="
          f"{cfg.n_groups}, batch {cfg.per_group_batch} (micro-batch "
          f"{cfg.micro_batch}, server batch {cfg.n_groups * cfg.micro_batch})"
          f", H={cfg.H}, seq {cfg.seq_len}, omega {cfg.omega}, remat "
          f"{cfg.remat!r}, f32, TF32 off | launches per round, H x (G x "
          f"device blocks + server blocks that take the kernels): "
          f"{_reckoning(cfg)}{note}", flush=True)
    kernel_vs_plain(torch, f"[wide] {arch}", args, cfg, counters, want)
    run = drive(torch, *wide_setup(arch, [
        "--rounds", str(WIDE_DRIVER_ROUNDS), "--window", "2"]), counters,
        keep_state=arch in SERVE)
    if not all(math.isfinite(m[k]) for m in run["history"]
               for k in ("d_loss", "s_loss")):
        raise AssertionError(f"{arch} driver: non-finite loss")
    want_total = {k: n * WIDE_DRIVER_ROUNDS for k, n in want.items()}
    if run["launches"] != want_total:
        raise AssertionError(f"{arch} driver: launches {run['launches']}, "
                             f"want {want_total}")
    print(f"[wide] {arch}: driver window 2, {WIDE_DRIVER_ROUNDS} rounds: "
          f"steady {run['steady_tok_s']:,.1f} tok/s | device ms per round "
          f"{run['executor']['device_s_per_round'] * 1e3:.1f} | peak memory "
          f"{run['peak_bytes'] / 2**30:.2f} GiB | phase "
          f"{time.perf_counter() - t_phase:.0f} s", flush=True)
    served = serve_trained(torch, cfg, run, counters) if arch in SERVE \
        else None
    return {"launches": run["launches"], "per_round": per_round,
            "serve": served}


# ---------------------------------------------------------------------------
# 6. serving
# ---------------------------------------------------------------------------

def serve_trained(torch, cfg, run, counters) -> dict:
    """Serve ``cfg``'s arch from a driver run's final state: group 0's
    device half merged with the server half (``merge_params``), the rest of
    the training state freed first."""
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import merge_params
    state = run.pop("state")
    dev0 = tree_map(lambda x: x[0], state["dev"])
    params = merge_params(dev0, state["srv"], cfg.arch)
    del state, dev0
    torch.cuda.empty_cache()
    try:
        return phase_serve(torch, cfg.arch, params, counters)
    finally:
        del params
        torch.cuda.empty_cache()


def _rel_err(got, want) -> float:
    """max |got - want| / max |want|, over one tensor."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


def _timed(torch, fn):
    """(fn(), its time in ms on the card's clock, from CUDA events)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def phase_serve(torch, arch, params, counters) -> dict:
    """Serving on the card (``SERVE``): the kernel prefill launches
    ``fa_fwd`` once per self-attention block and ``ssd_fwd`` once per Mamba
    block and no other kernel, and decode none; the kernel prefill against
    the plain one (last logits and every cache leaf within ``SERVE_TOL`` of
    its scale); decode after the prefill of S tokens against the prefill
    of S + 1 on both paths, within ``SERVE_DECODE_TOL`` of the logits'
    scale;
    then greedy generation on both paths through the serving entry point,
    ``launch.serve.generate``, timed whole, with the decode's time per step
    taken as (generate - a prefill alone) / (new - 1).  Returns the
    launches of one kernel prefill."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import tree_leaves
    t0 = time.perf_counter()
    B, S, new = SERVE[arch.name]
    tag = f"[serve] {arch.name}"
    gen = torch.Generator(device="cuda").manual_seed(0)
    prompts = torch.randint(0, arch.vocab, (B, S + 1), generator=gen,
                            device="cuda")
    fe = torch.randn(B, arch.frontend_len, arch.d_model, generator=gen,
                     device="cuda") if arch.frontend_len else None
    want = serve_launches(arch, counters)
    none = {k: 0 for k in want}
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"{tag}: merged params {n:,} ({n * 4 / 1e9:.2f} GB f32), batch "
          f"{B}, prompt {S}, {new} new tokens"
          f"{f', {arch.frontend_len} frames' if fe is not None else ''}; "
          f"kernel prefill launches {({k: v for k, v in want.items() if v})}",
          flush=True)

    def launched(fn):
        torch.cuda.synchronize()
        for c in counters:
            c.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: v for c in counters for k, v in c.launches.items()}

    def prefill(tokens, use_kernel):
        return launched(lambda: tfm.prefill(
            params, arch, tokens, max_len=S + new, frontend=fe,
            use_kernel=use_kernel))

    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        (lk, ck), n_k = prefill(prompts[:, :S], True)
        (lp, cp), n_p = prefill(prompts[:, :S], False)
        if n_k != want or n_p != none:
            raise AssertionError(f"{tag} prefill launches: kernel {n_k} "
                                 f"(want {want}), plain {n_p} (want none)")
        errs = [_rel_err(lk, lp)] + [
            _rel_err(a, b) for a, b in zip(tree_leaves(ck), tree_leaves(cp))]
        finite = all(bool(torch.isfinite(x).all())
                     for x in [lk, *tree_leaves(ck)])
        print(f"{tag}: kernel vs plain prefill: last logits {errs[0]:.3e}, "
              f"the worst of {len(errs) - 1} cache leaves "
              f"{max(errs[1:]):.3e} (relative to each one's max |value|; "
              f"limit {SERVE_TOL:g}) | finite {finite}", flush=True)
        if not (max(errs) <= SERVE_TOL and finite):
            raise AssertionError(f"{tag}: kernel and plain prefill disagree")
        spread = {}
        for use_kernel, caches in ((True, ck), (False, cp)):
            (ld, _), n_d = launched(lambda: tfm.serve_decode_step(
                params, arch, caches, prompts[:, S:], S))
            (lw, _), _ = prefill(prompts, use_kernel)
            spread[use_kernel] = _rel_err(ld, lw)
            if any(n_d.values()):
                raise AssertionError(f"{tag}: decode launched {n_d}")
        del lk, ck, lp, cp
        print(f"{tag}: decode after the prefill of {S} tokens vs the prefill"
              f" of {S + 1}: kernel {spread[True]:.3e}, plain "
              f"{spread[False]:.3e} (relative to the logits' max |value|; "
              f"limit {SERVE_DECODE_TOL:g}); decode launched no kernel",
              flush=True)
        if not max(spread.values()) <= SERVE_DECODE_TOL:
            raise AssertionError(f"{tag}: decode disagrees with prefill")
        runs = {True: [], False: []}
        for uk in (True, False, False, True):      # in turns
            pre_ms = _timed(torch, lambda: tfm.prefill(
                params, arch, prompts[:, :S], max_len=S + new, frontend=fe,
                use_kernel=uk))[1]
            (out, gen_ms), n_g = launched(lambda: _timed(torch, lambda: (
                generate(params, arch, prompts[:, :S], new_tokens=new,
                         max_len=S + new, frontend=fe, use_kernel=uk))))
            if n_g != (want if uk else none):
                raise AssertionError(f"{tag}: generate launched {n_g}, want "
                                     f"{want if uk else none}")
            if out.shape != (B, S + new) or not torch.equal(out[:, :S],
                                                            prompts[:, :S]):
                raise AssertionError(f"{tag}: generate gave {out.shape}")
            runs[uk].append((out[:, S:], pre_ms,
                             (gen_ms - pre_ms) / (new - 1)))
    tok = {uk: r[0][0] for uk, r in runs.items()}
    same = all(torch.equal(r[0][0], r[1][0]) for r in runs.values())
    ms = {uk: [statistics.mean(x[i] for x in r) for i in (1, 2)]
          for uk, r in runs.items()}
    (pre_ms, dec_ms), (pre_p, dec_p) = ms[True], ms[False]
    differ = int((tok[True] != tok[False]).sum())
    print(f"{tag}: kernel prefill {pre_ms:.1f} ms (plain {pre_p:.1f}) | "
          f"decode {dec_ms:.2f} ms per step (plain {dec_p:.2f}), "
          f"{B * 1e3 / dec_ms:,.1f} tok/s (generate timed whole less a "
          f"prefill alone, over {new - 1} steps; means of two runs each, in "
          f"turns kernel, plain, plain, kernel; each path's two runs give the"
          f" same tokens: {same}) | peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | greedy "
          f"tokens that differ between the kernel and plain runs {differ} of "
          f"{tok[True].numel()} | phase {time.perf_counter() - t0:.0f} s",
          flush=True)
    return n_k


# ---------------------------------------------------------------------------
# 7. the sim-mode FedOptima learner
# ---------------------------------------------------------------------------

# run_sim's costs (simulated seconds come from these, not from the card)
SIM_COSTS = dict(dev_fwd_flops=2e9, dev_bwd_flops=4e9, full_fwd_flops=6e9,
                 srv_flops_per_batch=1.2e10, act_bytes=2e6,
                 dev_model_bytes=1e6, full_model_bytes=4e6, batch_size=32)
# (b): VGG-5 at 32x32, K=4, 20 simulated seconds, on the card and the CPU
SIM_CARD_CPU = dict(img=32, K=4, duration=20.0)
# (b): the card's final params against the CPU's, max |difference| over
# each leaf's largest |value| on the CPU, with the card's ReLU and pool
# choices replayed on the CPU (without the replay a near-tie that rounds
# the other way moves a gradient by ~6e-3 of its leaf, and the run's
# unstable first server steps grow that to ~0.4)
SIM_PARAMS_TOL = 1e-3
# (c): the paper's models at their published sizes, each with its split and
# SGD rate, K=4, a short run.  At run_sim's rate of 0.05 the text models'
# server loss grows past 1e6 and turns NaN within about 20 steps, in the
# JAX package's learner as in the port's (a CPU run of both on these
# data), so they train at 0.002.
SIM_MODELS = {  # name: (module, config, l_split, lr)
    "vgg5": ("cnn", "vgg5_config", 1, 0.05),
    "mobilenetv3ish": ("cnn", "mobilenetv3ish_config", 4, 0.05),
    "transformer6": ("text_classifier", "transformer6_config", 3, 0.002),
    "transformer12": ("text_classifier", "transformer12_config", 3, 0.002),
}
SIM_SAMPLES = 1024
SIM_MODEL_DURATION = 10.0
# (a): run_sim's defaults but 20 simulated seconds, to keep the script
# inside its time
SIM_RUN_DURATION = 20.0
# the baselines that train the whole model on the device (FullModelLearner);
# SplitFed, PiPar and OAFL train a split one (SplitLearner)
FULL_MODEL = ("fl", "fedasync", "fedbuff")


class TimedHooks:
    """A learner's hooks, each call timed to its end on the card (a sync on
    either side) and counted, the step's loss kept where the learner has
    one (the split learner's device step has none): the simulator calls
    these."""

    def __init__(self, torch, learner):
        self.torch, self.learner = torch, learner
        self.ms = {"device_iter": [], "server_train": [], "aggregate": [],
                   "sync_aggregate": []}
        self.losses = []

    def _call(self, name, *args, loss=None):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        getattr(self.learner, name)(*args)
        self.torch.cuda.synchronize()
        self.ms[name].append((time.perf_counter() - t0) * 1e3)
        if getattr(self.learner, loss or "", None) is not None:
            self.losses.append(getattr(self.learner, loss))

    def device_iter(self, k, send):
        self._call("device_iter", k, send, loss="dev_loss")

    def server_train(self, k):
        self._call("server_train", k, loss="srv_loss")

    def aggregate(self, k):
        self._call("aggregate", k)

    def sync_aggregate(self):
        self._call("sync_aggregate")


def _sim_datasets(cfg, K, samples=SIM_SAMPLES, seed=0):
    """Per-device shards: images from ``classification_dataset`` split by
    the Dirichlet partitioner, tokens and labels drawn from the seed."""
    import numpy as np
    from repro_torch.data.partitioner import dirichlet_partition
    from repro_torch.data.pipeline import DeviceDataset
    from repro_torch.data.synthetic import classification_dataset
    if hasattr(cfg, "img_size"):
        data = classification_dataset(samples, cfg.n_classes,
                                      img_size=cfg.img_size, seed=seed)
        x, y = data.x, data.y
    else:
        rng = np.random.default_rng(seed)
        x = rng.integers(0, cfg.vocab, size=(samples, cfg.seq_len),
                         dtype=np.int32)
        y = rng.integers(0, cfg.n_classes, size=samples, dtype=np.int32)
    parts = dirichlet_partition(y, K, alpha=0.5, seed=seed)
    return [DeviceDataset(x[ix], y[ix], batch=32, seed=g)
            for g, ix in enumerate(parts)]


def sim_learner_run(torch, adapter, datasets, l_split, device, duration,
                    init=None, hooks=None, lr=0.05, protocol="fedoptima",
                    fleet=None, faults=None):
    """A protocol's learner through its simulator over
    ``heterogeneous_cluster(K)`` at H=10: ``"fedoptima"``'s through
    ``simulate_fedoptima`` (ω=8, pool 8), a baseline's (``baselines.
    REGISTRY``) through its own, with ``FullModelLearner`` or
    ``SplitLearner``.  ``init``: (the full model's params, aux params),
    or None to draw them from seed 0.  ``fleet``, ``faults``: a
    ``FleetTrace`` and a ``FaultSchedule`` for a baseline's run.  Returns (Metrics, the ControlPlane or None,
    learner)."""
    from repro_torch.core.baselines import REGISTRY
    from repro_torch.core.control_plane import ControlPlane
    from repro_torch.core.learning import (FedOptimaLearner,
                                           FullModelLearner, SplitLearner)
    from repro_torch.core.simulation import (SimModel, heterogeneous_cluster,
                                             simulate_fedoptima)
    K = len(datasets)
    model, cluster = SimModel(**SIM_COSTS), heterogeneous_cluster(K)
    if protocol == "fedoptima":
        learner = FedOptimaLearner(
            adapter, datasets, l_split, lr_d=lr, lr_s=lr, device=device,
            init=None if init is None else
            (*adapter.split(init[0], l_split), init[1]))
        control = ControlPlane.for_sim(K, 8, pool_cap=8)
        m = simulate_fedoptima(model, cluster, duration=duration, omega=8,
                               H=10, pool_cap=8, control=control,
                               hooks=learner if hooks is None else
                               hooks(learner))
        return m, control, learner
    kw = dict(lr=lr, device=device, init=None if init is None else init[0])
    learner = FullModelLearner(adapter, datasets, **kw) \
        if protocol in FULL_MODEL else \
        SplitLearner(adapter, datasets, l_split, **kw)
    m = REGISTRY[protocol](model, cluster, duration=duration, H=10,
                           hooks=learner if hooks is None else hooks(learner),
                           fleet=fleet, faults=faults)
    return m, None, learner


def _metrics_view(m) -> dict:
    """Every ``Metrics`` field as plain values (the profiles by their
    summary, the elastic registry by its contents) and the derived
    figures."""
    import numpy as np
    out = {}
    for f in dataclasses.fields(m):
        v = getattr(m, f.name)
        if f.name == "registry" and v is not None:
            v = (v._next_id, [dataclasses.asdict(i)
                              for i in v.devices.values()])
        elif f.name == "profiles" and v is not None:
            v = v.summary()
        elif isinstance(v, np.ndarray):
            v = v.tolist()
        out[f.name] = v
    out.update(steady=m.steady_summary(), balance=m.contribution_balance())
    return out


def _sim_counts(m, control, learner) -> dict:
    """Everything the run counted, learner-independent and learner-side."""
    out = _metrics_view(m)
    if control is None:     # a baseline
        out["hooks"] = (learner.dev_steps, learner.versions, learner.version)
        return out
    out.update(memory=control.memory_summary(),
               versions=control.versions.tolist(),
               control=(control.version, control.n_accepted,
                        control.n_rejected),
               hooks=(learner.dev_steps, learner.srv_steps, learner.consumed,
                      learner.versions, learner.agg.version,
                      learner.agg.n_accepted, learner.agg.n_rejected))
    return out


def _check_hook_counts(name, m, control, learner, th=None,
                       protocol="fedoptima") -> None:
    """The learner trained what the simulator scheduled.  A baseline's
    counts are its hooks' calls (``th``, a ``TimedHooks``): one device
    step a batch, one server step a batch the server consumed, one
    ``aggregate`` per contribution FedAsync/FedBuff consumed, and one
    (``sync_``)``aggregate`` per aggregation otherwise."""
    B = SIM_COSTS["batch_size"]
    if control is None:
        n = {k: len(v) for k, v in th.ms.items()}
        got = (learner.dev_steps * B, n["device_iter"] * B,
               n["server_train"], n["aggregate"] + n["sync_aggregate"])
        want = (m.dev_samples, m.dev_samples, m.srv_batches,
                int(m.dev_consumed.sum())
                if protocol in ("fedasync", "fedbuff") else m.aggregations)
        if got != want:
            raise AssertionError(f"{name}: hook calls {got} != the "
                                 f"simulator's {want}")
        return
    got = (learner.dev_steps * B, learner.srv_steps,
           learner.agg.n_accepted + learner.agg.n_rejected,
           sum(learner.consumed.values()))
    want = (m.dev_samples, m.srv_batches, control.n_accepted,
            int(m.dev_consumed.sum()))
    if got != want or m.aggregations != control.n_accepted + \
            control.n_rejected:
        raise AssertionError(f"{name}: hook counts {got} != the simulator's "
                             f"{want}")


def _rel_gap(a, b) -> float:
    """max |a - b| over max |b|, for a leaf on any device and one on the
    host (0 where both are 0)."""
    scale = b.abs().max().item()
    diff = (a.detach().cpu() - b).abs().max().item()
    return diff / scale if scale else diff


class ReplayChoices:
    """The discrete choices of the CNN's layers, taken in one run and
    replayed in call order in another: each ReLU's mask (``torch.relu``)
    and each 2x2 max pool's argmax (``cnn._max_pool2``).  A near-tie that
    rounds one way on the card and the other on the CPU then takes the
    card's side in both runs, as ``replay_route`` does for a router's
    choices: the replayed ReLU is x times the card's mask (so is its
    gradient), the replayed pool gathers the card's
    argmax (and routes the gradient there).  ``otherwise`` counts the
    choices the replaying run would have made otherwise, of ``total``."""

    def __init__(self, torch):
        from collections import deque
        self.torch, self.queue = torch, deque()
        self.otherwise = self.total = 0

    def _swap(self, relu, pool):
        from repro_torch.models import cnn
        old = self.torch.relu, cnn._max_pool2
        self.torch.relu, cnn._max_pool2 = relu, pool
        return old

    def run(self, mode, fn):
        """``fn()`` with the choices recorded (``mode="record"``) or
        replayed (``"replay"``)."""
        torch, F = self.torch, self.torch.nn.functional
        relu0 = torch.relu

        def relu_record(x):
            self.queue.append(x > 0)
            return relu0(x)

        def pool_record(x):
            y, idx = F.max_pool2d(x.permute(0, 3, 1, 2), 2,
                                  return_indices=True)
            self.queue.append(idx)
            return y.permute(0, 2, 3, 1)

        def relu_replay(x):
            mask = self.queue.popleft().to(x.device)
            self.otherwise += int(((x > 0) != mask).sum())
            self.total += mask.numel()
            return x * mask

        def pool_replay(x):
            idx = self.queue.popleft().to(x.device)
            xc = x.permute(0, 3, 1, 2)
            own = F.max_pool2d(xc, 2, return_indices=True)[1]
            self.otherwise += int((own != idx).sum())
            self.total += idx.numel()
            y = xc.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
            return y.permute(0, 2, 3, 1)

        record = mode == "record"
        old = self._swap(relu_record if record else relu_replay,
                         pool_record if record else pool_replay)
        try:
            return fn()
        finally:
            self._swap(*old)


def _final_params(learner) -> dict:
    """The learner's global trees, by name."""
    if hasattr(learner, "agg"):             # FedOptima
        return {"agg.theta_d": learner.agg.theta_d,
                "agg.theta_aux": learner.agg.theta_aux, "srv": learner.srv}
    if hasattr(learner, "global_params"):   # full model
        return {"global": learner.global_params}
    return {"g_dev": learner.g_dev, "g_srv": learner.g_srv}


def sim_card_vs_cpu(torch, img, K, duration, profile=False,
                    protocol="fedoptima") -> dict:
    """(b): the same VGG-5 learner of ``protocol`` through its simulator
    from one init (drawn on the CPU from seed 0) and the same data, once on
    the card and once on the CPU, which replays the card run's ReLU masks
    and pool choices (``ReplayChoices``).  Every count must be
    bit-identical, and the final global params (FedOptima's aggregated
    device params, aux and server params) must agree within
    ``SIM_PARAMS_TOL`` of each leaf's largest |value|.  Returns the
    counts, the gaps, the choices replayed and the card's busy share (with
    ``profile``, from the profiled card run)."""
    from repro_torch.core.learning import ModelAdapter
    from repro_torch.models import cnn
    from repro_torch.models.common import tree_leaves, tree_map
    cfg = cnn.vgg5_config(img_size=img)
    adapter = ModelAdapter(cnn, cfg)
    gen = torch.Generator().manual_seed(0)
    full = adapter.init(gen)
    aux0, _ = adapter.make_aux(gen, 1)
    replay = ReplayChoices(torch)
    runs, busy, seconds = {}, {}, {}
    for device in ("cuda", "cpu"):
        init = tree_map(lambda t: t.to(device), (full, aux0))

        def run():
            return replay.run(
                "record" if device == "cuda" else "replay",
                lambda: sim_learner_run(torch, adapter, _sim_datasets(cfg, K),
                                        1, device, duration, init=init,
                                        protocol=protocol))
        if device == "cuda" and profile:
            runs[device] = profile_round(torch, run, top=6, busy=busy)
        else:
            t0 = time.perf_counter()
            runs[device] = run()
            seconds[device] = time.perf_counter() - t0
    counts = {d: _sim_counts(*r) for d, r in runs.items()}
    if counts["cuda"] != counts["cpu"]:
        diff = [k for k in counts["cpu"] if counts["cuda"][k] !=
                counts["cpu"][k]]
        raise AssertionError(f"{protocol} card vs CPU: counts differ in "
                             f"{diff}")
    if replay.queue:
        raise AssertionError(f"{protocol} card vs CPU: {len(replay.queue)} "
                             "of the card's choices were not replayed")
    a, b = (_final_params(runs[d][2]) for d in ("cuda", "cpu"))
    gaps = {tag: max(_rel_gap(x, y) for x, y in zip(tree_leaves(a[tag]),
                                                    tree_leaves(b[tag])))
            for tag in a}
    if not max(gaps.values()) <= SIM_PARAMS_TOL:
        raise AssertionError(f"{protocol} card vs CPU: params gaps {gaps} "
                             f"past {SIM_PARAMS_TOL} of the leaf's max "
                             "|value|")
    return {"counts": counts["cuda"], "gaps": gaps,
            "otherwise": (replay.otherwise, replay.total),
            "busy": busy.get("share"), "cpu_s": seconds.get("cpu")}


def paper_models(torch, protocol, duration, tag) -> dict:
    """The paper's four models at their published sizes (``SIM_MODELS``)
    through ``protocol``'s learner (K=4, ``duration`` simulated seconds),
    every hook timed (``TimedHooks``): losses finite, hook counts equal to
    the simulator's; ms per device step, server step and aggregation, and
    the peak memory, printed under ``tag``."""
    import math
    from repro_torch.core.learning import ModelAdapter
    from repro_torch.models import cnn, text_classifier
    models = {}
    for name, (mod, make, l_split, lr) in SIM_MODELS.items():
        module = {"cnn": cnn, "text_classifier": text_classifier}[mod]
        cfg = getattr(module, make)()
        datasets = _sim_datasets(cfg, 4)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        timed = {}

        def hooks(learner):
            timed["hooks"] = TimedHooks(torch, learner)
            return timed["hooks"]
        m, control, learner = sim_learner_run(
            torch, ModelAdapter(module, cfg), datasets, l_split, "cuda",
            duration, hooks=hooks, lr=lr, protocol=protocol)
        th = timed["hooks"]
        _check_hook_counts(f"{protocol} {name}", m, control, learner, th,
                           protocol)
        if not bool(torch.isfinite(torch.stack(th.losses)).all()):
            raise AssertionError(f"{protocol} {name}: a loss is not finite")
        n = {k: len(v) for k, v in th.ms.items()}
        med = {k: statistics.median(v) for k, v in th.ms.items() if v}
        mean = {k: statistics.fmean(v) for k, v in th.ms.items() if v}
        agg = "sync_aggregate" if n["sync_aggregate"] else "aggregate"
        last = {side: round(getattr(learner, attr).item(), 4)
                for side, attr in (("device", "dev_loss"),
                                   ("server", "srv_loss"))
                if getattr(learner, attr, None) is not None}
        models[name] = {"ms_median": med, "ms_mean": mean, "calls": n,
                        "peak_bytes": torch.cuda.max_memory_allocated()}
        print(f"{tag} {name} ({_sim_describe(cfg)}, l_split {l_split}, "
              f"lr {lr}, K=4, {duration} s simulated): "
              f"{n['device_iter']} device / {n['server_train']} server "
              f"steps / {n['aggregate'] + n['sync_aggregate']} aggregations,"
              f" counts equal to the Metrics', losses finite (last {last}) "
              f"| ms per device step median {med['device_iter']:.3f} mean "
              f"{mean['device_iter']:.3f}, per server step median "
              f"{med.get('server_train', math.nan):.3f} mean "
              f"{mean.get('server_train', math.nan):.3f}, per aggregation "
              f"median {med.get(agg, math.nan):.3f} | peak memory "
              f"{models[name]['peak_bytes'] / 2**20:.1f} MiB", flush=True)
    return models


def phase_sim(torch, counters) -> dict:
    """(a) run_sim at the reference's defaults on the card; (b) card
    against CPU (``sim_card_vs_cpu``, profiled); (c) the paper's four
    models at their published sizes through the learner.  No kernel of
    the five runs on this path: their counts must stay 0."""
    import math
    from repro_torch.launch import train
    t0 = time.perf_counter()
    for c in counters:
        c.reset_launches()
    # (a) run_sim at its defaults but the simulated time
    args = train.build_parser().parse_args(
        ["--mode", "sim", "--duration", str(SIM_RUN_DURATION)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    out = train.run_sim(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    mem = out["memory"]
    dev_steps = out["registry"]["counters"]["sim.dev_samples"] // \
        SIM_COSTS["batch_size"]
    srv_steps = sum(out["consumed"])
    print(f"[sim] (a) run_sim --mode sim on {args.device}: {args.devices} "
          f"devices, {args.duration} s simulated, VGG-5 16x16, omega 8, H "
          f"10, pool {mem['pool_cap']}: srv idle {out['srv_idle']:.4f} dev "
          f"idle {out['dev_idle']:.4f} throughput {out['throughput']:.2f} "
          f"samples/s accuracy {out['accuracy']:.4f} | memory {mem} | "
          f"balance {out['contribution_balance']} | wall {wall:.3f} s, "
          f"{dev_steps} device steps ({dev_steps / wall:.1f}/s), "
          f"{srv_steps} server steps ({srv_steps / wall:.1f}/s), peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB",
          flush=True)
    if mem["peak_buffered"] > mem["omega"] + mem["pool_cap"]:
        raise AssertionError(f"sim: flow cap broken: {mem}")
    if not (math.isfinite(out["accuracy"]) and out["accuracy"] > 0.1):
        raise AssertionError(f"sim: accuracy {out['accuracy']} is not "
                             "above chance (10 classes)")
    # (b) card against CPU
    t1 = time.perf_counter()
    b = sim_card_vs_cpu(torch, **SIM_CARD_CPU, profile=True)
    c = b["counts"]
    print(f"[sim] (b) VGG-5 {SIM_CARD_CPU['img']}x{SIM_CARD_CPU['img']}, K="
          f"{SIM_CARD_CPU['K']}, {SIM_CARD_CPU['duration']} s simulated, card"
          f" vs CPU from one init, the CPU replaying the card's ReLU and "
          f"pool choices ({b['otherwise'][0]} of {b['otherwise'][1]} chose "
          f"otherwise): every Metrics field, the hook counts and "
          f"memory_summary bit-identical (dev_samples {c['dev_samples']}, "
          f"srv_batches {c['srv_batches']}, aggregations "
          f"{c['aggregations']}, memory {c['memory']}); final params, "
          f"max|card - cpu| / max|cpu| per leaf, worst: "
          f"{ {k: f'{v:.3e}' for k, v in b['gaps'].items()} } <= "
          f"{SIM_PARAMS_TOL}; card busy {b['busy']:.1%} of the profiled "
          f"run; the CPU run {b['cpu_s']:.1f} s on {torch.get_num_threads()}"
          f" threads | {time.perf_counter() - t1:.1f} s", flush=True)
    # (c) the paper's models at their published sizes
    models = paper_models(torch, "fedoptima", SIM_MODEL_DURATION, "[sim] (c)")
    launches = {k: v for c in counters for k, v in c.launches.items()}
    if any(launches.values()):
        raise AssertionError(f"sim: a kernel of the five ran: {launches}")
    print(f"[sim] kernel launches over the phase: {launches} | phase "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    return {"run_sim": out, "card_vs_cpu": b, "models": models}

# ---------------------------------------------------------------------------
# 8. the baselines
# ---------------------------------------------------------------------------

# (a): tests/test_simulation.py's costs and fleet (K=8, 400 simulated s);
# tests/test_communication.py's run takes activations of 2 MB
BASE_COSTS = dict(dev_fwd_flops=1e9, dev_bwd_flops=2e9, full_fwd_flops=5e9,
                  srv_flops_per_batch=8e9, act_bytes=1e6,
                  dev_model_bytes=4e6, full_model_bytes=2e7, batch_size=32)
BASE_K, BASE_DURATION = 8, 400.0
BASE_TOTAL = 8 * 4096          # the nominal dataset of comm_per_round
# (b): Table 2 in miniature: VGG-5 32x32, K=4, every protocol's learner
# from one init on the same data, accuracy on held-out samples drawn with
# them (the same class prototypes)
BASE_TABLE2 = dict(img=32, K=4, duration=40.0, held_out=1024)
# (c): card against CPU for one full-model and one split protocol, at
# phase 7 (b)'s size
BASE_CARD_CPU = ("fedasync", "oafl")
# (d): the paper's models under one split and one full-model protocol;
# SplitFed's slowest device closes its first round at ~15 s
BASE_MODEL_PROTOCOLS = ("splitfed", "fedasync")
BASE_MODEL_DURATION = 20.0


def baseline_orderings() -> dict:
    """(a): the six baselines with no hooks beside ``simulate_fedoptima``;
    the orderings of ``tests/test_simulation.py`` and
    ``tests/test_communication.py`` must hold.  Returns the Metrics."""
    from repro_torch.core.baselines import REGISTRY, simulate_oafl
    from repro_torch.core.simulation import (SimModel, heterogeneous_cluster,
                                             simulate_fedoptima)
    model, cluster = SimModel(**BASE_COSTS), heterogeneous_cluster(BASE_K)
    res = {"fedoptima": simulate_fedoptima(model, cluster,
                                           duration=BASE_DURATION)}
    for name, fn in REGISTRY.items():
        res[name] = fn(model, cluster, duration=BASE_DURATION)
    for name, m in res.items():
        print(f"[baselines] (a) {name}: dev idle {m.dev_idle_frac:.4f} srv "
              f"idle {m.srv_idle_frac:.4f} throughput {m.throughput:.2f} "
              f"samples/s comm per round "
              f"{m.comm_per_round(BASE_TOTAL) / 1e6:.2f} MB | aggregations "
              f"{m.aggregations} rounds {m.rounds} srv_batches "
              f"{m.srv_batches}", flush=True)
    big = SimModel(**dict(BASE_COSTS, act_bytes=2e6))
    fo2 = simulate_fedoptima(big, cluster, duration=BASE_DURATION, omega=8)
    oafl2 = simulate_oafl(big, cluster, duration=BASE_DURATION)
    fo = res["fedoptima"]
    checks = {
        "device idle: fedoptima <= splitfed, pipar, oafl": all(
            fo.dev_idle_frac <= res[b].dev_idle_frac + 1e-6
            for b in ("splitfed", "pipar", "oafl")),
        "server idle: fedoptima lowest": all(
            fo.srv_idle_frac <= m.srv_idle_frac + 1e-6
            for m in res.values()),
        "throughput: fedoptima highest": all(
            fo.throughput >= m.throughput - 1e-6 for m in res.values()),
        "device idle: fedasync < fl":
            res["fedasync"].dev_idle_frac < res["fl"].dev_idle_frac,
        "throughput: pipar >= splitfed":
            res["pipar"].throughput >= res["splitfed"].throughput,
        "comm per round: fedoptima < oafl":
            fo.comm_per_round(BASE_TOTAL) < res["oafl"].comm_per_round(
                BASE_TOTAL),
        "comm per round at 2 MB acts: fedoptima < oafl":
            fo2.comm_per_round(BASE_TOTAL) < oafl2.comm_per_round(
                BASE_TOTAL),
        "downlink per sample at 2 MB acts: fedoptima < 0.5 oafl":
            fo2.bytes_down / max(fo2.dev_samples, 1) <
            0.5 * oafl2.bytes_down / max(oafl2.dev_samples, 1),
        "uploads per device iteration at 2 MB acts <= 1":
            fo2.bytes_up / big.act_bytes <=
            fo2.dev_samples / big.batch_size + 1,
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"baselines: orderings broken: {failed}")
    print(f"[baselines] (a) orderings held: {list(checks)}", flush=True)
    return res


def table2_miniature(torch) -> dict:
    """(b): VGG-5 through FedOptima and each baseline with its learner on
    the card, from one init (drawn on the CPU from seed 0) and the same
    shards: hook counts equal to the simulator's, losses finite; the
    held-out accuracy, steps and wall seconds of each."""
    from repro_torch.core.baselines import REGISTRY
    from repro_torch.core.learning import ModelAdapter
    from repro_torch.data.partitioner import dirichlet_partition
    from repro_torch.data.pipeline import DeviceDataset
    from repro_torch.data.synthetic import classification_dataset
    from repro_torch.models import cnn
    from repro_torch.models.common import tree_map
    img, K, duration, held = (BASE_TABLE2[k] for k in
                              ("img", "K", "duration", "held_out"))
    cfg = cnn.vgg5_config(img_size=img)
    adapter = ModelAdapter(cnn, cfg)
    gen = torch.Generator().manual_seed(0)
    full = adapter.init(gen)
    aux0, _ = adapter.make_aux(gen, 1)
    init = tree_map(lambda t: t.to("cuda"), (full, aux0))
    data = classification_dataset(SIM_SAMPLES + held, cfg.n_classes,
                                  img_size=img, seed=0)
    x, y = data.x[:SIM_SAMPLES], data.y[:SIM_SAMPLES]
    parts = dirichlet_partition(y, K, alpha=0.5, seed=0)
    out = {}
    for protocol in ("fedoptima", *REGISTRY):
        datasets = [DeviceDataset(x[ix], y[ix], batch=32, seed=g)
                    for g, ix in enumerate(parts)]
        timed = {}

        def hooks(learner):
            timed["hooks"] = TimedHooks(torch, learner)
            return timed["hooks"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m, control, learner = sim_learner_run(
            torch, adapter, datasets, 1, "cuda", duration, init=init,
            hooks=hooks, protocol=protocol)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        th = timed["hooks"]
        _check_hook_counts(f"table 2 {protocol}", m, control, learner, th,
                           protocol)
        if not bool(torch.isfinite(torch.stack(th.losses)).all()):
            raise AssertionError(f"table 2 {protocol}: a loss is not finite")
        acc = learner.eval_accuracy(data.x[SIM_SAMPLES:],
                                    data.y[SIM_SAMPLES:])
        n = {k: len(v) for k, v in th.ms.items()}
        out[protocol] = {"accuracy": acc, "calls": n, "wall_s": wall}
        print(f"[baselines] (b) {protocol}: VGG-5 {img}x{img}, K={K}, "
              f"{duration} s simulated: held-out accuracy {acc:.4f} on "
              f"{held} samples | {n['device_iter']} device / "
              f"{n['server_train']} server steps / "
              f"{n['aggregate'] + n['sync_aggregate']} aggregations, counts "
              f"equal to the Metrics', losses finite | dev idle "
              f"{m.dev_idle_frac:.4f} srv idle {m.srv_idle_frac:.4f} | wall "
              f"{wall:.2f} s", flush=True)
    return out


def phase_baselines(torch, counters) -> dict:
    """(a) the six baselines' event metrics and orderings; (b) Table 2 in
    miniature on the card; (c) card against CPU for ``BASE_CARD_CPU``
    (``sim_card_vs_cpu``); (d) the paper's four models under
    ``BASE_MODEL_PROTOCOLS``.  No kernel of the five runs on this path:
    their counts must stay 0."""
    t0 = time.perf_counter()
    for c in counters:
        c.reset_launches()
    baseline_orderings()
    table2 = table2_miniature(torch)
    card_cpu = {}
    for protocol in BASE_CARD_CPU:
        t1 = time.perf_counter()
        b = sim_card_vs_cpu(torch, **SIM_CARD_CPU, protocol=protocol,
                            profile=True)
        c = b["counts"]
        card_cpu[protocol] = b
        print(f"[baselines] (c) {protocol}: VGG-5 {SIM_CARD_CPU['img']}x"
              f"{SIM_CARD_CPU['img']}, K={SIM_CARD_CPU['K']}, "
              f"{SIM_CARD_CPU['duration']} s simulated, card vs CPU from "
              f"one init, the CPU replaying the card's ReLU and pool choices "
              f"({b['otherwise'][0]} of {b['otherwise'][1]} chose "
              f"otherwise): every Metrics field and the learner's counts "
              f"bit-identical (dev_samples {c['dev_samples']}, srv_batches "
              f"{c['srv_batches']}, aggregations {c['aggregations']}, "
              f"version {c['hooks'][2]}); final params, max|card - cpu| / "
              f"max|cpu| per leaf, worst: "
              f"{ {k: f'{v:.3e}' for k, v in b['gaps'].items()} } <= "
              f"{SIM_PARAMS_TOL}; card busy {b['busy']:.1%} of the profiled "
              f"run; the CPU run {b['cpu_s']:.1f} s | "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
    models = {p: paper_models(torch, p, BASE_MODEL_DURATION,
                              f"[baselines] (d) {p}")
              for p in BASE_MODEL_PROTOCOLS}
    launches = {k: v for c in counters for k, v in c.launches.items()}
    if any(launches.values()):
        raise AssertionError(f"baselines: a kernel of the five ran: "
                             f"{launches}")
    print(f"[baselines] kernel launches over the phase: {launches} | phase "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    return {"table2": table2, "card_vs_cpu": card_cpu, "models": models}


# ---------------------------------------------------------------------------
# 10. the fleet plane
# ---------------------------------------------------------------------------

# (a): smollm's main path under a Weibull on/off trace (one tick a round;
# up ~rounds/4, down ~rounds/8 at the median scale), a 3:1 low:high mix of
# capability tiers seeding the straggler profiles, and REFL selection of
# half the available groups
FLEET_FLAGS = ["--fleet-trace", "weibull", "--fleet-tiers", "low:3,high:1",
               "--selection", "refl:0.5"]
FLEET_ROUNDS = 2      # the trace has roster events (4 at G=4, seed 0)
# (b): run_sim's defaults (8 devices) for 100 simulated s under a flaky
# trace over a fleet sampled from all four tiers, score selection of half
# (the trace has 11 roster events in 100 s)
FLEET_SIM_FLAGS = ["--mode", "sim", "--fleet-trace", "flaky",
                   "--fleet-tiers", "low,mid,high,premium",
                   "--selection", "score:0.5", "--duration", "100"]
# (c): phase 8 (c)'s size (VGG-5 32x32, K=4, 20 simulated s) under one
# flaky trace of 12 ticks
FLEET_BASELINES = ("fedasync", "splitfed")
FLEET_TRACE = dict(p_drop=0.3, seed=0)


def fleet_pod(torch, counters) -> dict:
    """(a): smollm-135m's main path through ``run_pod`` under
    ``FLEET_FLAGS`` at windows 1 and 2."""
    from repro_torch.models.common import tree_leaves
    t0 = time.perf_counter()
    runs = {}
    for w in (1, 2):
        args, cfg = main_setup("smollm-135m", [
            "--rounds", str(FLEET_ROUNDS), "--window", str(w),
            *FLEET_FLAGS])
        runs[w] = drive(torch, args, cfg, counters, keep_final=True)
    per_round, want = launches_per_round(cfg, counters)
    want_total = {k: n * FLEET_ROUNDS for k, n in want.items()}
    fleet = runs[2]["fleet"]
    same_hist = runs[1]["history"] == runs[2]["history"]
    same_params = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(runs[1]["final"]), tree_leaves(runs[2]["final"])))
    same_roster = all(runs[1]["fleet"][k] == fleet[k] for k in
                      ("available", "cohorts", "roster_events"))
    halves = [(len(c), len(a)) for a, c in zip(fleet["available"],
                                               fleet["cohorts"])]
    restricted = all(c <= math.ceil(a / 2) for c, a in halves)
    uniform = fleet["produce_per_round"] == [cfg.H] * cfg.n_groups and \
        fleet["reads_per_round"] == cfg.H
    attention = {k: n // FLEET_ROUNDS for k, n in
                 runs[2]["launches"].items() if k.startswith("fa_")}
    print(f"[fleet] (a) smollm-135m full width, 30 layers, "
          f"{' '.join(FLEET_FLAGS)}, {FLEET_ROUNDS} rounds: windows 1 and 2 "
          f"histories bit-identical {same_hist}, final params bit-identical "
          f"{same_params}, rosters equal {same_roster} | available "
          f"{fleet['available']}, cohorts {fleet['cohorts']} (cohort/"
          f"available {halves}), roster events {fleet['roster_events']}, "
          f"selection {fleet['selection']} | tier-seeded emissions per round "
          f"{fleet['produce_per_round']} of H={cfg.H}, server reads "
          f"{fleet['reads_per_round']}/{cfg.H} | consumed "
          f"{runs[2]['consumed']} | "
          f"attention launches a round {attention} (phase 4: {per_round}) | "
          f"retention {runs[2]['executor']['retention']} | peak memory "
          f"{runs[1]['peak_bytes'] / 2**30:.2f} / "
          f"{runs[2]['peak_bytes'] / 2**30:.2f} GiB | "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    for w, run in runs.items():
        for r, m in enumerate(run["history"]):
            if not all(math.isfinite(m[k]) for k in ("d_loss", "s_loss")):
                raise AssertionError(f"fleet window {w} round {r + 1}: "
                                     f"non-finite loss {m}")
        if run["launches"] != want_total:
            raise AssertionError(f"fleet window {w}: launches "
                                 f"{run['launches']}, want {want_total}")
    if not (same_hist and same_params and same_roster):
        raise AssertionError("fleet: windows 1 and 2 differ")
    if fleet["roster_events"] < 1:
        raise AssertionError("fleet: no roster event in the registry")
    if not restricted:
        raise AssertionError(f"fleet: a cohort past half the available "
                             f"groups: {halves}")
    if uniform:
        raise AssertionError("fleet: the tier-seeded plans are uniform")
    return {"runs": runs, "attention_per_round": attention}


def host_sim(args) -> tuple[dict, object]:
    """``run_sim(args)``'s ``simulate_fedoptima`` call on the host with no
    learner: (the learner-independent part of run_sim's dict, Metrics)."""
    from repro_torch.core.control_plane import ControlPlane
    from repro_torch.core.executor import StragglerProfiles
    from repro_torch.core.simulation import (SimModel, heterogeneous_cluster,
                                             simulate_fedoptima)
    from repro_torch.faults import SIM_CLASSES
    from repro_torch.fleet import sample_cluster
    from repro_torch.launch import train
    omega, H = 8, 10                    # run_sim's defaults, pool = omega
    cluster = sample_cluster(args.devices, args.fleet_tiers, seed=args.seed) \
        if args.fleet_tiers else heterogeneous_cluster(args.devices)
    fleet = train._fleet_trace(args, args.devices, args.duration,
                               interval=max(args.duration / 12.0, 1.0),
                               bw=cluster.dev_bw)
    control = ControlPlane.for_sim(args.devices, omega, policy=args.policy,
                                   max_delay=args.max_delay, pool_cap=omega)
    profiles = StragglerProfiles(args.devices)
    m = simulate_fedoptima(SimModel(**SIM_COSTS), cluster,
                           duration=args.duration, omega=omega, H=H,
                           policy=args.policy, max_delay=args.max_delay,
                           pool_cap=omega, seed=args.seed, fleet=fleet,
                           selection=args.selection, control=control,
                           profiles=profiles,
                           faults=train._fault_schedule(
                               args, args.devices, args.duration,
                               SIM_CLASSES))
    host = {"srv_idle": m.srv_idle_frac, "dev_idle": m.dev_idle_frac,
            "throughput": m.throughput, "profiles": profiles.summary(),
            "produce_per_round": profiles.produce(H).sum(axis=0).tolist(),
            "reads_per_round": int(profiles.reads(H).sum()),
            "memory": control.memory_summary(),
            "consumed": m.dev_consumed.tolist(),
            "contribution_balance": m.contribution_balance(),
            "steady": m.steady_summary(),
            "registry": m.to_registry().snapshot()}
    if m.faults is not None:
        host["faults"] = m.faults
    return host, m


def fleet_sim(torch) -> dict:
    """(b): ``run_sim`` on the card under ``FLEET_SIM_FLAGS``; the same
    ``simulate_fedoptima`` call on the host with no learner must give the
    same event metrics, bit for bit."""
    from repro_torch.launch import train
    args = train.build_parser().parse_args(FLEET_SIM_FLAGS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = train.run_sim(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    host, m = host_sim(args)
    diff = [k for k in host if out[k] != host[k]]
    events = sum(i.absences for i in m.registry.devices.values())
    print(f"[fleet] (b) run_sim {' '.join(FLEET_SIM_FLAGS[2:])} on "
          f"{args.device}: {args.devices} devices, {args.duration} s "
          f"simulated: srv idle {out['srv_idle']:.4f} dev idle "
          f"{out['dev_idle']:.4f} throughput {out['throughput']:.2f} "
          f"samples/s accuracy {out['accuracy']:.4f} | consumed "
          f"{out['consumed']} | roster events {events}, active at the end "
          f"{len(m.registry.active_ids)}/{args.devices} | event metrics "
          f"equal to the host run with no learner: {not diff} | wall "
          f"{wall:.3f} s", flush=True)
    if diff:
        raise AssertionError(f"fleet: run_sim on the card differs from the "
                             f"host run in {diff}")
    if events < 1:
        raise AssertionError("fleet: run_sim saw no roster event")
    return {"run_sim": out, "wall_s": wall}


def fleet_baselines(torch) -> dict:
    """(c): ``FLEET_BASELINES`` with their VGG-5 learners on the card under
    one flaky trace (K=4, 20 simulated s); every ``Metrics`` field equal to
    the host run with no learner, the hook counts equal to the
    simulator's, losses finite."""
    from repro_torch.core.baselines import REGISTRY
    from repro_torch.core.learning import ModelAdapter
    from repro_torch.core.simulation import SimModel, heterogeneous_cluster
    from repro_torch.fleet import flaky_trace
    from repro_torch.models import cnn
    img, K, duration = (SIM_CARD_CPU[k] for k in ("img", "K", "duration"))
    cfg = cnn.vgg5_config(img_size=img)
    adapter = ModelAdapter(cnn, cfg)
    trace = flaky_trace(K, duration, interval=duration / 12, **FLEET_TRACE)
    leaves = int((trace.active[:-1] & ~trace.active[1:]).sum())
    out = {}
    for protocol in FLEET_BASELINES:
        timed = {}

        def hooks(learner):
            timed["hooks"] = TimedHooks(torch, learner)
            return timed["hooks"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m, _, learner = sim_learner_run(
            torch, adapter, _sim_datasets(cfg, K), 1, "cuda", duration,
            hooks=hooks, protocol=protocol, fleet=trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        th = timed["hooks"]
        _check_hook_counts(f"fleet {protocol}", m, None, learner, th,
                           protocol)
        if not bool(torch.isfinite(torch.stack(th.losses)).all()):
            raise AssertionError(f"fleet {protocol}: a loss is not finite")
        host = REGISTRY[protocol](SimModel(**SIM_COSTS),
                                  heterogeneous_cluster(K),
                                  duration=duration, H=10, fleet=trace)
        a, b = _metrics_view(m), _metrics_view(host)
        diff = [k for k in b if a[k] != b[k]]
        n = {k: len(v) for k, v in th.ms.items()}
        print(f"[fleet] (c) {protocol}: VGG-5 {img}x{img}, K={K}, "
              f"{duration} s simulated, flaky trace (p_drop "
              f"{FLEET_TRACE['p_drop']}, {trace.T} ticks, {leaves} leaves): "
              f"{n['device_iter']} device / {n['server_train']} server "
              f"steps / {n['aggregate'] + n['sync_aggregate']} "
              f"aggregations, counts equal to the Metrics', losses finite | "
              f"dev idle {m.dev_idle_frac:.4f} srv idle "
              f"{m.srv_idle_frac:.4f} throughput {m.throughput:.2f} | every "
              f"Metrics field equal to the host run with no learner: "
              f"{not diff} | wall {wall:.2f} s", flush=True)
        if diff:
            raise AssertionError(f"fleet {protocol}: the card run differs "
                                 f"from the host run in {diff}")
        out[protocol] = {"wall_s": wall, "calls": n}
    return out


def phase_fleet(torch, counters) -> dict:
    """(a) the pod round under a trace, tiers and selection; (b) run_sim
    and (c) two baselines under traces, their event metrics against the
    host's.  (b) and (c) run no kernel of the five: their counts must stay
    0."""
    t0 = time.perf_counter()
    pod = fleet_pod(torch, counters)
    for c in counters:
        c.reset_launches()
    sim = fleet_sim(torch)
    base = fleet_baselines(torch)
    launches = {k: v for c in counters for k, v in c.launches.items()}
    if any(launches.values()):
        raise AssertionError(f"fleet: a kernel of the five ran in (b) or "
                             f"(c): {launches}")
    print(f"[fleet] kernel launches over (b) and (c): {launches} | phase "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    return {"pod": pod, "sim": sim, "baselines": base}


# ---------------------------------------------------------------------------
# 11. the telemetry plane
# ---------------------------------------------------------------------------

# (a): smollm's main path at window 2, untraced and traced (2 rounds: one
# steady round, one gap between rounds)
TELEMETRY_ROUNDS = 2
# the mesh spans' ends are card events placed through one anchor: their
# differences are event-to-event times, as completion_gap_s is (seconds)
TELEMETRY_GAP_TOL = 1e-4
# (b): run_sim's defaults for 30 simulated seconds
TELEMETRY_SIM_DURATION = 30.0
TELEMETRY_DIR = ROOT / "build" / "telemetry"


def _steady_tracer(tracer, t_start: float, t_end: float):
    """The spans of ``tracer`` cut to [t_start, t_end], shifted to start at
    0 (its instants dropped: the pod records none)."""
    from repro_torch.obs.trace import Tracer
    out = Tracer(domain=tracer.domain)
    for lane, name, t0, t1, args in tracer.spans:
        a, b = max(t0, t_start), min(t1, t_end)
        if b > a:
            out.add_span(lane, name, a - t_start, b - t_start, **(args or {}))
    return out


def _idle_cover(tracer, lane: str, duration: float) -> float:
    """Seconds of the server's idle time (outside every ``mesh`` span)
    that spans of ``lane`` cover, over [0, duration]."""
    def merged(name):
        out = []
        for t0, t1 in sorted((s[2], s[3]) for s in tracer.spans
                             if s[0] == name):
            if out and t0 <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t1)
            else:
                out.append([t0, t1])
        return out
    busy, host = merged("mesh"), merged(lane)
    idle, t = [], 0.0
    for t0, t1 in busy:
        if t0 > t:
            idle.append((t, t0))
        t = max(t, t1)
    if t < duration:
        idle.append((t, duration))
    return sum(max(0.0, min(b, d) - max(a, c))
               for a, b in idle for c, d in host)


def telemetry_pod(torch, counters) -> dict:
    """(a): the pod round untraced and traced; the trace's checks."""
    from repro_torch.core.executor import completion_gap_s
    from repro_torch.models.common import tree_leaves
    from repro_torch.obs import trace as obs_trace
    from repro_torch.obs.idle import attribute_idle
    t0 = time.perf_counter()
    TELEMETRY_DIR.mkdir(parents=True, exist_ok=True)
    trace_path = TELEMETRY_DIR / "pod_trace.json"
    metrics_path = TELEMETRY_DIR / "pod_metrics.jsonl"
    metrics_path.unlink(missing_ok=True)
    flags = ["--rounds", str(TELEMETRY_ROUNDS), "--window", "2"]
    plain = drive(torch, *main_setup("smollm-135m", flags), counters,
                  keep_final=True)
    args, cfg = main_setup("smollm-135m", flags + [
        "--metrics-out", str(metrics_path)])
    tracer = obs_trace.Tracer(domain="wall")
    with obs_trace.traced(tracer):
        run = drive(torch, args, cfg, counters, keep_final=True)
    tracer.export_chrome(str(trace_path))
    per_round, want = launches_per_round(cfg, counters)
    want_total = {k: n * TELEMETRY_ROUNDS for k, n in want.items()}
    same_hist = plain["history"] == run["history"]
    same_params = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(plain["final"]), tree_leaves(run["final"])))
    problems = obs_trace.validate_chrome_trace(tracer.to_chrome())
    cli_rc = obs_trace._main([str(trace_path)])
    record = json.loads(metrics_path.read_text().splitlines()[0])
    walls = record["metrics"]["histograms"]["exec.round_wall_s"]
    mesh = sorted((s for s in tracer.spans if s[0] == "mesh"),
                  key=lambda s: s[4]["round"])
    stats = run["round_stats"]
    gaps = [(b[3] - a[3], completion_gap_s(sa, sb))
            for a, b, sa, sb in zip(mesh, mesh[1:], stats, stats[1:])]
    gap_err = max(abs(x - y) for x, y in gaps)
    # the steady rounds: from round 2's start on the card (its span, after
    # the clip) to the last round's completion; the gaps between them are
    # the server's idle time
    t_start, t_end = mesh[1][2], mesh[-1][3]
    steady = _steady_tracer(tracer, t_start, t_end)
    attr = attribute_idle(steady, duration=t_end - t_start)
    srv, devs, dur = attr["server"], attr["devices"], attr["duration"]
    host_lanes = sorted({s[0] for s in tracer.spans
                         if s[0].startswith("host/")})
    cover = {ln: _idle_cover(steady, ln, dur) for ln in host_lanes}
    longest = {ln: max(s[3] - s[2] for s in tracer.spans if s[0] == ln)
               for ln in host_lanes}
    lanes = tracer.lanes()
    print(f"[telemetry] (a) smollm-135m full width, 30 layers, window 2, "
          f"{TELEMETRY_ROUNDS} rounds, untraced then traced with "
          f"--metrics-out: histories bit-identical {same_hist}, final params "
          f"bit-identical {same_params} | trace {len(tracer.spans)} spans on "
          f"{len(lanes)} lanes {lanes}, validator problems {len(problems)}, "
          f"CLI rc {cli_rc} | mesh span ends apart vs completion_gap_s (ms) "
          f"{[(round(1e3 * x, 4), round(1e3 * y, 4)) for x, y in gaps]}, "
          f"max |difference| {gap_err * 1e3:.6f} ms <= "
          f"{TELEMETRY_GAP_TOL * 1e3} ms | metrics-out mode "
          f"{record['mode']} rounds {record['rounds']}, exec.round_wall_s "
          f"count {walls['count']}", flush=True)
    print(f"[telemetry] (a) steady rounds 2-{TELEMETRY_ROUNDS} "
          f"({dur * 1e3:.3f} ms from round 2's start on the card to round "
          f"{TELEMETRY_ROUNDS}'s completion): server (mesh) busy "
          f"{srv['busy_s'] / dur:.4f}, idle {srv['idle_frac']:.4f} = "
          f"task_dependency {srv['task_dependency_frac']:.4f} + straggler "
          f"{srv['straggler_frac']:.4f} (warmup {srv['warmup_s'] * 1e3:.3f} "
          f"ms) | devices busy {devs['busy_s'] / (devs['n'] * dur):.4f} "
          f"idle {devs['idle_frac']:.4f} | server idle ms covered "
          f"by each host lane "
          f"{ {ln: round(v * 1e3, 3) for ln, v in cover.items()} } of "
          f"{(srv['task_dependency_s'] + srv['straggler_s']) * 1e3:.3f} | "
          f"longest host span ms "
          f"{ {ln: round(v * 1e3, 3) for ln, v in longest.items()} } | "
          f"launches {run['launches']} ({per_round} a round per attention "
          f"kernel) | {time.perf_counter() - t0:.0f} s", flush=True)
    for name, r in (("untraced", plain), ("traced", run)):
        if r["launches"] != want_total:
            raise AssertionError(f"telemetry {name}: launches "
                                 f"{r['launches']}, want {want_total}")
        for m in r["history"]:
            if not all(math.isfinite(m[k]) for k in ("d_loss", "s_loss")):
                raise AssertionError(f"telemetry {name}: non-finite loss "
                                     f"{m}")
    if not (same_hist and same_params):
        raise AssertionError("telemetry: the traced run differs from the "
                             "untraced one")
    if problems or cli_rc != 0:
        raise AssertionError(f"telemetry: the trace is not valid: "
                             f"{problems[:5]}")
    if len(mesh) != TELEMETRY_ROUNDS or gap_err > TELEMETRY_GAP_TOL:
        raise AssertionError(f"telemetry: mesh spans {len(mesh)}, their "
                             f"ends against completion_gap_s {gaps}")
    need = {"mesh", "host/plan", "host/build", "host/drain", "host/control"}
    if not need <= set(lanes) or not any(ln.startswith("dev/")
                                         for ln in lanes):
        raise AssertionError(f"telemetry: lanes {lanes} miss some of "
                             f"{sorted(need)} or dev/*")
    if (record["mode"], record["rounds"]) != ("pod", TELEMETRY_ROUNDS):
        raise AssertionError(f"telemetry: metrics-out record {record}")
    return {"launches": run["launches"], "attribution": attr,
            "gap_err_s": gap_err, "cover": cover, "longest": longest}


def telemetry_sim(torch, counters) -> dict:
    """(b): run_sim untraced and traced in the sim domain."""
    from repro_torch.launch import train
    from repro_torch.obs.idle import attribute_idle
    from repro_torch.obs.trace import Tracer, traced
    t0 = time.perf_counter()
    for c in counters:
        c.reset_launches()
    argv = ["--mode", "sim", "--duration", str(TELEMETRY_SIM_DURATION)]
    plain = train.run_sim(train.build_parser().parse_args(argv))
    tracer = Tracer(domain="sim")
    with traced(tracer):
        out = train.run_sim(train.build_parser().parse_args(argv))
    launches = {k: v for c in counters for k, v in c.launches.items()}
    diff = [k for k in plain if k != "accuracy" and plain[k] != out[k]]
    attr = attribute_idle(tracer, duration=TELEMETRY_SIM_DURATION)
    srv = attr["server"]
    sums = [srv["busy_s"] + srv["warmup_s"] + srv["task_dependency_s"]
            + srv["straggler_s"]]
    sums += [sum(row[k] for k in ("busy_s", "warmup_s", "offline_s",
                                  "task_dependency_s", "straggler_s"))
             for row in attr["per_device"].values()]
    sum_err = max(abs(x - TELEMETRY_SIM_DURATION) for x in sums)
    print(f"[telemetry] (b) run_sim at its defaults for "
          f"{TELEMETRY_SIM_DURATION} simulated s, untraced and traced: event "
          f"metrics equal {not diff} (accuracy {plain['accuracy']:.4f} / "
          f"{out['accuracy']:.4f}) | trace {len(tracer.spans)} spans, "
          f"{len(tracer.instants)} instants on {len(tracer.lanes())} lanes | "
          f"server busy {srv['busy_s'] / TELEMETRY_SIM_DURATION:.4f} idle "
          f"{srv['idle_frac']:.4f} (task_dependency "
          f"{srv['task_dependency_frac']:.4f}, straggler "
          f"{srv['straggler_frac']:.4f}, warmup {srv['warmup_s']:.3f} s) | "
          f"devices idle {attr['devices']['idle_frac']:.4f} (task_dependency "
          f"{attr['devices']['task_dependency_frac']:.4f}, straggler "
          f"{attr['devices']['straggler_frac']:.4f}) | classes sum to the "
          f"horizon for {len(sums)} entities, max |sum - horizon| "
          f"{sum_err:.3e} s | kernel launches {launches} | "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    if diff:
        raise AssertionError(f"telemetry: the traced run_sim differs in "
                             f"{diff}")
    if sum_err > 1e-9 * TELEMETRY_SIM_DURATION:
        raise AssertionError(f"telemetry: idle classes do not sum to the "
                             f"horizon: {sums}")
    if any(launches.values()):
        raise AssertionError(f"telemetry: a kernel of the five ran in "
                             f"run_sim: {launches}")
    return {"attribution": attr}


def phase_telemetry(torch, counters) -> dict:
    """(a) the pod round traced on the wall clock; (b) run_sim traced in
    simulated time."""
    t0 = time.perf_counter()
    pod = telemetry_pod(torch, counters)
    sim = telemetry_sim(torch, counters)
    print(f"[telemetry] phase {time.perf_counter() - t0:.0f} s", flush=True)
    return {"pod": pod, "sim": sim}


# ---------------------------------------------------------------------------
# 12. the protocol sanitizer
# ---------------------------------------------------------------------------

# (a): smollm's main path at window 2 with a ring of ω=2 slots, a host pool
# of 2, churn and phase 9's stall (the server reads nothing for
# SANITIZE_STALL rounds, then drains), so every boundary holds the planner
# against the store with slots spilled and filled and groups dropped and
# restored
SANITIZE_FLAGS = ["--rounds", "4", "--window", "2", "--omega", "2",
                  "--pool-cap", "2", "--p-drop", "0.3"]
SANITIZE_STALL = 2
# the event kinds (a) must reach: the pod path's planner, flow control,
# scheduler, executor and store (departures and the sim chains are the
# event simulator's)
SANITIZE_POD_KINDS = {"cp.plan", "cp.finish", "exec.round", "flow.register",
                      "flow.grant", "flow.sent", "flow.enqueue",
                      "flow.dequeue", "sched.add", "store.spill",
                      "store.fill"}
# (b): run_sim under a flaky trace for 20 simulated seconds (9
# departures, as many as in 60)
SANITIZE_SIM_FLAGS = ["--mode", "sim", "--fleet-trace", "flaky",
                      "--duration", "20"]


def timed_sanitizer():
    """A ``ProtocolSanitizer`` that also sums the host seconds its checks
    take (``record``: the mirror, the window and the invariants)."""
    from repro_torch.analysis.sanitize import ProtocolSanitizer

    class Timed(ProtocolSanitizer):
        seconds = 0.0

        def record(self, kind, fields):
            t0 = time.perf_counter()
            try:
                super().record(kind, fields)
            finally:
                self.seconds += time.perf_counter() - t0
    return Timed()


def sanitize_pod(torch, counters) -> dict:
    """(a): the pod round under ``SANITIZE_FLAGS`` and the stall, once
    without and once with the sanitizer attached: bit-identical, 0
    violations, a restore planned, every kind of ``SANITIZE_POD_KINDS``
    counted, the kernels launched as reckoned."""
    from repro_torch.analysis.sanitize import sanitized
    from repro_torch.models.common import tree_leaves
    t0 = time.perf_counter()
    runs = {}
    for name in ("plain", "sanitized"):
        args, cfg = main_setup("smollm-135m", SANITIZE_FLAGS)
        args.profiles = stalled_profiles(cfg.n_groups, SANITIZE_STALL)
        if name == "plain":
            runs[name] = drive(torch, args, cfg, counters, keep_final=True)
            continue
        with sanitized(timed_sanitizer()) as san:
            runs[name] = drive(torch, args, cfg, counters, keep_final=True)
    per_round, want = launches_per_round(cfg, counters)
    rounds = args.rounds
    want_total = {k: n * rounds for k, n in want.items()}
    plain, run = runs["plain"], runs["sanitized"]
    same_hist = plain["history"] == run["history"]
    same_params = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(plain["final"]), tree_leaves(run["final"])))
    rep = san.report()
    retention = run["executor"]["retention"]
    host = {n: [s.plan_s + s.dispatch_s for s in r["round_stats"]]
            for n, r in runs.items()}
    mean = {n: statistics.mean(v) for n, v in host.items()}
    print(f"[sanitize] (a) smollm-135m full width, 30 layers, "
          f"{' '.join(SANITIZE_FLAGS)}, stall {SANITIZE_STALL} then drain: "
          f"histories bit-identical {same_hist}, final params bit-identical "
          f"{same_params} | {rep['events']} events, {rep['n_violations']} "
          f"violations, by kind {rep['by_kind']} | retention {retention}, "
          f"memory spills {run['memory']['spills']} fills "
          f"{run['memory']['fills']} | launches {run['launches']} "
          f"({per_round} a round per attention kernel)", flush=True)
    print(f"[sanitize] (a) host seconds per round, plan + step() dispatch: "
          f"plain {[round(x, 4) for x in host['plain']]} mean "
          f"{mean['plain']:.4f}, sanitized "
          f"{[round(x, 4) for x in host['sanitized']]} mean "
          f"{mean['sanitized']:.4f} (difference "
          f"{mean['sanitized'] - mean['plain']:+.4f}) | the sanitizer's own "
          f"checks {san.seconds / rounds * 1e3:.3f} ms a round "
          f"({rep['events'] / rounds:.1f} events, "
          f"{san.seconds / max(rep['events'], 1) * 1e6:.2f} us an event) | "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    for name, r in runs.items():
        if r["launches"] != want_total:
            raise AssertionError(f"sanitize {name}: launches "
                                 f"{r['launches']}, want {want_total}")
        for m in r["history"]:
            if not all(math.isfinite(m[k]) for k in ("d_loss", "s_loss")):
                raise AssertionError(f"sanitize {name}: non-finite loss "
                                     f"{m}")
    if not (same_hist and same_params):
        raise AssertionError("sanitize: the sanitized pod run differs from "
                             "the plain one")
    if rep["n_violations"]:
        raise AssertionError(f"sanitize: violations {rep['violations']}")
    missing = SANITIZE_POD_KINDS - set(rep["by_kind"])
    if missing:
        raise AssertionError(f"sanitize: the pod run reached no "
                             f"{sorted(missing)} event")
    if not retention["restored"]:
        raise AssertionError(f"sanitize: no plan restored a group "
                             f"({retention})")
    return {"launches": run["launches"], "report": rep,
            "sanitizer_s_per_round": san.seconds / rounds,
            "host_s_per_round": mean}


def sanitize_sim(torch) -> dict:
    """(b): ``run_sim`` on the card under ``SANITIZE_SIM_FLAGS`` with the
    sanitizer attached; the same ``simulate_fedoptima`` call on the host
    with no learner and no sanitizer gives the same event metrics; 0
    violations and departures seen.  (c): FedAsync with its VGG-5 learner
    on the card under phase 10 (c)'s trace, sanitized: 0 violations and
    every ``Metrics`` field equal to the host run's."""
    from repro_torch.analysis.sanitize import sanitized
    from repro_torch.core.baselines import REGISTRY
    from repro_torch.core.learning import ModelAdapter
    from repro_torch.core.simulation import SimModel, heterogeneous_cluster
    from repro_torch.fleet import flaky_trace
    from repro_torch.launch import train
    from repro_torch.models import cnn
    args = train.build_parser().parse_args(SANITIZE_SIM_FLAGS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with sanitized(timed_sanitizer()) as san:
        out = train.run_sim(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    host, _ = host_sim(args)
    diff = [k for k in host if out[k] != host[k]]
    rep = san.report()
    print(f"[sanitize] (b) run_sim {' '.join(SANITIZE_SIM_FLAGS[2:])} on "
          f"{args.device}, sanitized: {rep['events']} events, "
          f"{rep['n_violations']} violations, by kind {rep['by_kind']} | "
          f"event metrics equal to the unsanitized host run with no "
          f"learner: {not diff} | the sanitizer's checks "
          f"{san.seconds:.3f} s of {wall:.3f} s wall", flush=True)
    if diff or rep["n_violations"]:
        raise AssertionError(f"sanitize sim: differs in {diff}, violations "
                             f"{rep['violations']}")
    if not rep["by_kind"].get("sim.device_left"):
        raise AssertionError("sanitize sim: no departure was checked")
    img, K, duration = (SIM_CARD_CPU[k] for k in ("img", "K", "duration"))
    cfg = cnn.vgg5_config(img_size=img)
    trace = flaky_trace(K, duration, interval=duration / 12, **FLEET_TRACE)
    t1 = time.perf_counter()
    with sanitized() as base_san:
        m, _, _ = sim_learner_run(torch, ModelAdapter(cnn, cfg),
                                  _sim_datasets(cfg, K), 1, "cuda", duration,
                                  protocol="fedasync", fleet=trace)
    torch.cuda.synchronize()
    host_m = REGISTRY["fedasync"](SimModel(**SIM_COSTS),
                                  heterogeneous_cluster(K),
                                  duration=duration, H=10, fleet=trace)
    a, b = _metrics_view(m), _metrics_view(host_m)
    base_diff = [k for k in b if a[k] != b[k]]
    brep = base_san.report()
    print(f"[sanitize] (c) fedasync: VGG-5 {img}x{img}, K={K}, {duration} s "
          f"simulated, phase 10 (c)'s flaky trace, sanitized: "
          f"{brep['events']} events, {brep['n_violations']} violations, by "
          f"kind {brep['by_kind']} | every Metrics field equal to the host "
          f"run: {not base_diff} | {time.perf_counter() - t1:.2f} s",
          flush=True)
    if base_diff or brep["n_violations"]:
        raise AssertionError(f"sanitize fedasync: differs in {base_diff}, "
                             f"violations {brep['violations']}")
    return {"sim": rep, "fedasync": brep, "sim_wall_s": wall}


def phase_sanitize(torch, counters) -> dict:
    """(a) the pod round sanitized against plain; (b) run_sim and (c)
    FedAsync sanitized against the host.  (b) and (c) run no kernel of the
    five: their counts must stay 0."""
    t0 = time.perf_counter()
    pod = sanitize_pod(torch, counters)
    for c in counters:
        c.reset_launches()
    sim = sanitize_sim(torch)
    launches = {k: v for c in counters for k, v in c.launches.items()}
    if any(launches.values()):
        raise AssertionError(f"sanitize: a kernel of the five ran in (b) or "
                             f"(c): {launches}")
    print(f"[sanitize] kernel launches over (b) and (c): {launches} | phase "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    return {"pod": pod, "sim": sim}


# Phase 13, checkpoints: smollm's main path (phase 4's config, the
# kernels) under churn at pool 0, a snapshot every CKPT_EVERY rounds into
# CKPT_DIR (gitignored, inside the checkout); CKPT_ROUNDS rounds unbroken
# against CKPT_EVERY rounds and a rerun of the command to CKPT_ROUNDS, for
# each of CKPT_CASES (cut from 4 rounds to 3 to make room for (c) and (d);
# the snapshot at round 2 holds two retained groups).  Windows and flush
# do not change values (phases 4b, 5), so case (b)'s resumed run is held
# against (a)'s unbroken one.
CKPT_FLAGS = ["--p-drop", "0.3"]
CKPT_EVERY = 2
CKPT_ROUNDS = 3
CKPT_CASES = {"a": ["--window", "2"], "b": ["--window", "1", "--ckpt-flush"]}
CKPT_DIR = ROOT / "build" / "ckpt"
# (c): phase 9's pool and stall; the snapshot at round 3 holds both
# spilled slots, and the resumed run's last round fills them back.
CKPT_POOL_ROUNDS = 4
CKPT_POOL_EVERY = 3
# (d): the same pool and stall, a snapshot every round with --ckpt-flush
# (a save finishes before the next boundary, so the crash at round 2's
# boundary follows the torn snapshot of round 2), 3 rounds.
CKPT_FAULT_ROUNDS = 3
CKPT_FAULT_FLAGS = ["--window", "2", "--ckpt-every", "1", "--ckpt-flush"]


def ckpt_fault_schedule():
    """Phase 13 (d)'s dense pod schedule: at round 1 group 1 times out for
    a round, group 2's uploads carry ``inf`` and the snapshot of round 1
    (step 2) is torn by a bit flip; the server crashes at round 2's
    boundary, with step 1 the newest verified snapshot."""
    from repro_torch.faults import FaultEvent, FaultSchedule
    return FaultSchedule(horizon=float(CKPT_FAULT_ROUNDS), events=(
        FaultEvent(1.0, "timeout", device=1, param=1.0),
        FaultEvent(1.0, "corrupt_act", device=2, kind="inf"),
        FaultEvent(1.0, "torn_checkpoint", kind="bitflip"),
        FaultEvent(2.0, "server_crash", param=1.0)))


class CkptTimers:
    """Host seconds of the checkpoint path, by wrapping its parts while
    the phase runs: per save the host copy (``RoundHandle.host_tree``: the
    wait for the staged copy off the card), the leaves to numpy
    (``store._flatten_with_paths``), the CRC32s (``store._checksums``)
    and the rest of ``store.save`` (the npz writes, their fsyncs, the
    rename); per resume the verification (``latest_verified_step``: every
    leaf read and CRC-checked) and the restore onto the card."""

    def __init__(self):
        self.saves, self.resumes = [], []
        self._acc = None

    def _timed(self, fn, part):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                dt = time.perf_counter() - t0
                if self._acc is not None:
                    self._acc[part] = self._acc.get(part, 0.0) + dt
        return wrapped

    def __enter__(self):
        from repro_torch.checkpoint import store
        from repro_torch.core.handles import RoundHandle
        self._orig = [(store, n, getattr(store, n)) for n in (
            "_flatten_with_paths", "_checksums", "save",
            "latest_verified_step", "restore", "restore_extras")] + \
            [(RoundHandle, "host_tree", RoundHandle.host_tree)]
        timers = self
        store._flatten_with_paths = self._timed(store._flatten_with_paths,
                                                "to_numpy")
        store._checksums = self._timed(store._checksums, "crc")
        save, host_tree = store.save, RoundHandle.host_tree

        def timed_save(*a, **kw):
            timers._acc = {}
            t0 = time.perf_counter()
            out = save(*a, **kw)
            acc, timers._acc = timers._acc, None
            acc["save"] = time.perf_counter() - t0
            acc["write_fsync"] = acc["save"] - acc.get("to_numpy", 0.0) - \
                acc.get("crc", 0.0)
            timers.saves[-1].update(acc)
            return out

        def timed_host_tree(handle):
            t0 = time.perf_counter()
            out = host_tree(handle)
            timers.saves.append({"round": handle.round,
                                 "host_copy": time.perf_counter() - t0})
            return out

        def resume_part(fn, part, new=False):
            def wrapped(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                if new:
                    timers.resumes.append({})
                timers.resumes[-1][part] = timers.resumes[-1].get(
                    part, 0.0) + time.perf_counter() - t0
                return out
            return wrapped
        store.save = timed_save
        RoundHandle.host_tree = timed_host_tree
        store.latest_verified_step = resume_part(store.latest_verified_step,
                                                 "verify", new=True)
        store.restore = resume_part(store.restore, "restore")
        store.restore_extras = resume_part(store.restore_extras, "restore")
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._orig:
            setattr(owner, name, fn)
        return False


def _snapshot_facts(d: Path) -> list:
    """Per snapshot in ``d``: its step, bytes on disk, and the retained
    groups it holds."""
    out = []
    for name in sorted(os.listdir(d)):
        snap = d / name
        with open(snap / "tree.json") as f:
            man = json.load(f)
        held = man["metadata"]["control_plane"]["retention"]["versions"]
        out.append({"step": man["step"], "groups_held": sorted(map(int, held)),
                    "disk_bytes": sum(p.stat().st_size
                                      for p in snap.iterdir())})
    return out


def _snapshot_bytes(torch, state) -> int:
    """A snapshot's arrays reckoned from the state's leaves (int64 at the
    int32 the store writes); each retained group adds its dev/aux rows."""
    from repro_torch.models.common import tree_leaves
    return sum(x.numel() * (4 if x.dtype == torch.int64
                            else x.element_size())
               for x in tree_leaves(state))


class _Killed(Exception):
    """Phase 13 (c)'s in-process kill, raised right after a save."""


def _pool_args(extra):
    """(args, cfg) of (c) and (d): smollm's main path with phase 9's pool
    (``STORE_FLAGS``) under its stalled profile (``STORE_STALL``)."""
    args, cfg = main_setup("smollm-135m", STORE_FLAGS + list(extra))
    args.profiles = stalled_profiles(cfg.n_groups, STORE_STALL)
    return args, cfg


def _attempt(torch, args, cfg, counters, expect=None):
    """``train.run_pod(args, cfg)`` with every launch count set to 0 just
    before it and read just after; with ``expect`` the run must raise that
    exception, which comes back in the result as ``"raised"``."""
    from repro_torch.launch import train
    for c in counters:
        c.reset_launches()
    out = {}
    try:
        out = train.run_pod(args, cfg)
    except Exception as err:        # noqa: BLE001 (re-raised unless expected)
        if expect is None or not isinstance(err, expect):
            raise
        out = {"raised": err}
    else:
        if expect is not None:
            raise AssertionError(f"the run did not raise {expect.__name__}")
    torch.cuda.synchronize()
    out["launches"] = {k: v for c in counters for k, v in c.launches.items()}
    return out


def _check_run(tag, out, want, rounds):
    if out["launches"] != {k: n * rounds for k, n in want.items()}:
        raise AssertionError(f"{tag}: launches {out['launches']}, want "
                             f"{rounds} x {want}")
    for m in out.get("history", ()):
        if not all(math.isfinite(m[k]) for k in ("d_loss", "s_loss")):
            raise AssertionError(f"{tag}: non-finite loss {m}")


def ckpt_pool_leg(torch, counters, want, saves, resumes) -> dict:
    """Phase 13 (c): the spilled slots on a snapshot (see the module
    docstring)."""
    import numpy as np

    from repro_torch.checkpoint import store
    from repro_torch.models.common import tree_leaves
    d = CKPT_DIR / "c"
    flags = ["--window", "2", "--rounds", str(CKPT_POOL_ROUNDS)]
    unbroken = _attempt(torch, *_pool_args(flags), counters)
    _check_run("ckpt (c) unbroken", unbroken, want, CKPT_POOL_ROUNDS)
    if unbroken["memory"]["fills"] != 2:
        raise AssertionError(f"ckpt (c): the pool did not spill and fill "
                             f"two slots: {unbroken['memory']}")
    flags += ["--ckpt-dir", str(d), "--ckpt-every", str(CKPT_POOL_EVERY)]
    seen = []
    args, cfg = _pool_args(flags)
    args.on_round = lambda r, m: seen.append(m)
    with CkptTimers() as tm:
        timed_save = store.save

        def save_then_die(*a, **kw):
            raise _Killed(timed_save(*a, **kw))
        store.save = save_then_die
        try:
            killed = _attempt(torch, args, cfg, counters, expect=_Killed)
        finally:
            store.save = timed_save
    saves += tm.saves
    snap = Path(str(killed["raised"]))
    with open(snap / "tree.json") as f:
        man = json.load(f)
    held = man["metadata"]["spill_store"]["entries"]
    with np.load(snap / "extras.npz") as ex:
        spill_bytes = sum(ex[k].nbytes for k in ex.files
                          if k.startswith("spill/"))
    if man["step"] != CKPT_POOL_EVERY or len(held) != 2:
        raise AssertionError(f"ckpt (c): the snapshot at step "
                             f"{man['step']} holds {held}, not two spilled "
                             f"slots at step {CKPT_POOL_EVERY}")
    with CkptTimers() as tm:
        rest = _attempt(torch, *_pool_args(flags), counters)
    saves += tm.saves
    resumes += tm.resumes
    ran = len(rest["history"])
    _check_run("ckpt (c) resumed", rest, want, ran)
    same_hist = seen == unbroken["history"][:len(seen)] and \
        rest["history"] == unbroken["history"][CKPT_POOL_EVERY:]
    la, lb = tree_leaves(rest["state"]), tree_leaves(unbroken["state"])
    same_state = len(la) == len(lb) and all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(la, lb))
    refilled = rest["memory"]["store_fills"]
    print(f"[ckpt] (c) {' '.join(STORE_FLAGS + flags[:2])}, stall "
          f"{STORE_STALL}, {CKPT_POOL_ROUNDS} rounds: killed in-process "
          f"after the snapshot at step {man['step']} ({len(seen)} rounds "
          f"drained), which holds spilled slots {sorted(held)}: "
          f"{spill_bytes} bytes of spill arrays as written "
          f"({spill_bytes / 1e6:.3f} MB; int64 labels at int32); the rerun "
          f"resumed and ran {ran} round(s), filling {refilled} restored "
          f"slot(s): histories bit-identical to the unbroken run without "
          f"checkpoints {same_hist}, every leaf of the final state "
          f"bit-identical {same_state} | launches of the resumed run "
          f"{rest['launches']}", flush=True)
    rest["state"] = unbroken["state"] = None
    if not (same_hist and same_state):
        raise AssertionError("checkpoints (c): the resumed pool run differs "
                             "from the unbroken one")
    if ran != CKPT_POOL_ROUNDS - CKPT_POOL_EVERY or refilled != 2:
        raise AssertionError(f"checkpoints (c): the rerun ran {ran} rounds "
                             f"and filled {refilled} restored slots")
    return {"history": same_hist, "state": same_state,
            "spill_bytes": spill_bytes, "launches": rest["launches"]}


def ckpt_fault_leg(torch, counters, want, saves, resumes) -> dict:
    """Phase 13 (d): crash recovery under a dense fault schedule (see the
    module docstring)."""
    from repro_torch.checkpoint import store
    from repro_torch.faults import InjectedCrash
    d = CKPT_DIR / "d"
    d.mkdir()
    sched = ckpt_fault_schedule()
    path = CKPT_DIR / "faults.json"
    sched.save(str(path))
    flags = CKPT_FAULT_FLAGS + ["--rounds", str(CKPT_FAULT_ROUNDS),
                                "--ckpt-dir", str(d), "--faults", str(path)]
    crash_at = int(sched.by_class("server_crash")[0].t)
    torn_step = int(sched.by_class("torn_checkpoint")[0].t) + 1
    with CkptTimers() as tm:
        crashed = _attempt(torch, *_pool_args(flags), counters,
                           expect=InjectedCrash)
    saves += tm.saves
    _check_run("ckpt (d) crashed", crashed, want, crash_at)
    with open(d / "FAULTS_FIRED.json") as f:
        fired = json.load(f)
    newest, skipped = store.latest_verified_step(str(d))
    if crashed["raised"].round_index != crash_at or fired != [crash_at] or \
            newest != crash_at - 1 or [s for s, _ in skipped] != [torn_step]:
        raise AssertionError(
            f"ckpt (d): crash {crashed['raised']}, fired {fired}, newest "
            f"verified {newest}, skipped {skipped}")
    with CkptTimers() as tm:
        rest = _attempt(torch, *_pool_args(flags), counters)
    saves += tm.saves
    resumes += tm.resumes
    ran = len(rest["history"])
    _check_run("ckpt (d) resumed", rest, want, ran)
    fr = rest["faults"]
    once = {cls: 1 for cls in ("corrupt_act", "timeout", "server_crash",
                               "torn_checkpoint")}
    print(f"[ckpt] (d) {' '.join(STORE_FLAGS + CKPT_FAULT_FLAGS)}, stall "
          f"{STORE_STALL}, {CKPT_FAULT_ROUNDS} rounds, faults "
          f"{sched.to_json()['events']}: crashed at boundary "
          f"{crashed['raised'].round_index} (fired {fired}); the rerun "
          f"skipped {[(s, r[:60]) for s, r in skipped]}, resumed from round "
          f"{newest} and ran {ran} round(s): injected {fr['injected']}, "
          f"recovered {fr['recovered']}, disposition {fr['disposition']}, "
          f"matched {fr['matched']}, gate {fr['gate']} | memory "
          f"{rest['memory']} | losses "
          f"{[(m['d_loss'], m['s_loss']) for m in rest['history']]} | "
          f"launches of the resumed run {rest['launches']}", flush=True)
    rest["state"] = None
    if not (fr["matched"] and fr["injected"] == once
            and fr["recovered"] == once
            and ran == CKPT_FAULT_ROUNDS - newest):
        raise AssertionError(f"checkpoints (d): not every class injected "
                             f"once and recovered: {fr}, {ran} rounds")
    return {"faults": fr, "launches": rest["launches"]}


# (e) and (f), the simulators' fault plane; no kernel of the five runs.
# (e): run_sim at phase 7 (a)'s defaults (8 devices, VGG-5 16x16, ω=8,
# H=10, pool 8) under a density-2 schedule of the six simulator classes
# for 40 simulated s, sanitized (seed 0: 23 faults injected, 8 gate
# rejects).  (f): phase 8 (c)'s size (VGG-5 32x32, K=4, 20 simulated s)
# under a density-2 schedule of the baseline classes; seed 3 is the first
# whose corrupt model upload lands inside 20 s for both protocols, so
# the gate acts in each.
SIM_FAULT_FLAGS = ["--mode", "sim", "--faults", "random:2",
                   "--duration", "40"]
BASE_FAULT_PROTOCOLS = ("fedasync", "splitfed")
BASE_FAULT_SCHEDULE = dict(density=2.0, seed=3)


def _check_faults(tag, fr) -> None:
    """Every injected fault recovered, some injected, the gate acted."""
    if not (fr["matched"] and sum(fr["injected"].values()) > 0
            and fr["gate"]["n_rejected"] > 0):
        raise AssertionError(f"{tag}: fault report {fr}")


def faults_sim(torch) -> dict:
    """(e): ``run_sim`` on the card under ``SIM_FAULT_FLAGS`` with the
    sanitizer attached.  Its ``simulate_fedoptima`` call is wrapped to
    keep the Metrics and time the hooks (``TimedHooks``): every
    ``Metrics`` field, ``faults`` included, equals the same call on the
    host with no learner; the hook counts are the simulator's, the losses
    finite, 0 violations."""
    from repro_torch.analysis.sanitize import sanitized
    from repro_torch.core import simulation
    from repro_torch.launch import train
    args = train.build_parser().parse_args(SIM_FAULT_FLAGS)
    orig, seen = simulation.simulate_fedoptima, {}

    def capture(*a, **kw):
        seen["hooks"] = kw["hooks"] = TimedHooks(torch, kw["hooks"])
        seen["control"] = kw["control"]
        seen["m"] = orig(*a, **kw)
        return seen["m"]
    simulation.simulate_fedoptima = capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with sanitized() as san:
            out = train.run_sim(args)
    finally:
        simulation.simulate_fedoptima = orig
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    host, host_m = host_sim(args)
    m, th = seen["m"], seen["hooks"]
    a, b = _metrics_view(m), _metrics_view(host_m)
    diff = [k for k in host if out[k] != host[k]] + \
        [k for k in b if a[k] != b[k]]
    _check_hook_counts("faults (e)", m, seen["control"], th.learner)
    finite = bool(torch.isfinite(torch.stack(th.losses)).all())
    rep, fr = san.report(), out["faults"]
    n = {k: len(v) for k, v in th.ms.items()}
    print(f"[ckpt] (e) run_sim {' '.join(SIM_FAULT_FLAGS[2:])} on "
          f"{args.device}, sanitized: {args.devices} devices, "
          f"{args.duration} s simulated | faults injected {fr['injected']}, "
          f"recovered {fr['recovered']}, dispositions {fr['disposition']}, "
          f"matched {fr['matched']}, gate rejects {fr['gate']['n_rejected']}"
          f" | {rep['events']} events, {rep['n_violations']} violations, "
          f"flow.quarantine {rep['by_kind'].get('flow.quarantine', 0)} | "
          f"{n['device_iter']} device / {n['server_train']} server steps / "
          f"{n['aggregate']} aggregations, counts equal to the Metrics', "
          f"losses finite {finite} | srv idle {out['srv_idle']:.4f} dev "
          f"idle {out['dev_idle']:.4f} throughput {out['throughput']:.2f} "
          f"accuracy {out['accuracy']:.4f} | every Metrics field equal to "
          f"the host run with no learner: {not diff} | wall {wall:.2f} s",
          flush=True)
    if diff or rep["n_violations"] or not finite:
        raise AssertionError(f"faults (e): differs in {diff}, violations "
                             f"{rep['violations']}, losses finite {finite}")
    _check_faults("faults (e)", fr)
    return {"faults": fr, "wall_s": wall, "calls": n}


def faults_baselines(torch) -> dict:
    """(f): ``BASE_FAULT_PROTOCOLS`` with their VGG-5 learners on the card
    under one ``BASELINE_CLASSES`` schedule (K=4, 20 simulated s); every
    ``Metrics`` field, ``faults`` included, equal to the host run with no
    learner, the hook counts the simulator's, losses finite."""
    from repro_torch.core.baselines import REGISTRY
    from repro_torch.core.learning import ModelAdapter
    from repro_torch.core.simulation import SimModel, heterogeneous_cluster
    from repro_torch.faults import BASELINE_CLASSES, make_fault_schedule
    from repro_torch.models import cnn
    img, K, duration = (SIM_CARD_CPU[k] for k in ("img", "K", "duration"))
    cfg = cnn.vgg5_config(img_size=img)
    adapter = ModelAdapter(cnn, cfg)
    sched = make_fault_schedule(K, duration, classes=BASELINE_CLASSES,
                                **BASE_FAULT_SCHEDULE)
    out = {}
    for protocol in BASE_FAULT_PROTOCOLS:
        timed = {}

        def hooks(learner):
            timed["hooks"] = TimedHooks(torch, learner)
            return timed["hooks"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m, _, learner = sim_learner_run(
            torch, adapter, _sim_datasets(cfg, K), 1, "cuda", duration,
            hooks=hooks, protocol=protocol, faults=sched)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        th = timed["hooks"]
        _check_hook_counts(f"faults (f) {protocol}", m, None, learner, th,
                           protocol)
        finite = bool(torch.isfinite(torch.stack(th.losses)).all())
        host = REGISTRY[protocol](SimModel(**SIM_COSTS),
                                  heterogeneous_cluster(K),
                                  duration=duration, H=10, faults=sched)
        a, b = _metrics_view(m), _metrics_view(host)
        diff = [k for k in b if a[k] != b[k]]
        fr = m.faults
        n = {k: len(v) for k, v in th.ms.items()}
        print(f"[ckpt] (f) {protocol}: VGG-5 {img}x{img}, K={K}, "
              f"{duration} s simulated, schedule {BASE_FAULT_SCHEDULE} of "
              f"{sched.counts()} | injected {fr['injected']}, dispositions "
              f"{fr['disposition']}, matched {fr['matched']}, gate rejects "
              f"{fr['gate']['n_rejected']} | {n['device_iter']} device / "
              f"{n['server_train']} server steps / "
              f"{n['aggregate'] + n['sync_aggregate']} aggregations, counts "
              f"equal to the Metrics', losses finite {finite} | every "
              f"Metrics field equal to the host run with no learner: "
              f"{not diff} | wall {wall:.2f} s", flush=True)
        if diff or not finite:
            raise AssertionError(f"faults (f) {protocol}: differs in {diff}"
                                 f", losses finite {finite}")
        _check_faults(f"faults (f) {protocol}", fr)
        out[protocol] = {"faults": fr, "wall_s": wall, "calls": n}
    return out


def phase_checkpoint(torch, counters) -> dict:
    """Phase 13 (see the module docstring): save, tear down, resume, on
    the card, against the unbroken run."""
    import shutil

    from repro_torch.core import fedopt_step as F
    from repro_torch.models.common import tree_leaves
    t0 = time.perf_counter()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    CKPT_DIR.mkdir(parents=True)
    flags = CKPT_FLAGS + ["--ckpt-every", str(CKPT_EVERY)]
    _, cfg = main_setup("smollm-135m", flags)
    per_round, want = launches_per_round(cfg, counters)
    probe = F.init_train_state(torch.Generator(device="cuda").manual_seed(0),
                               cfg)
    group_bytes = sum(x[0].numel() * x.element_size() for k in ("dev", "aux")
                      for x in tree_leaves(probe[k]))
    state_bytes = _snapshot_bytes(torch, probe)
    del probe
    # a run of (a) or (b) keeps one snapshot, (d) three (the store's
    # retain); at most G - 1 groups are retained (a roster keeps one group
    # at least), and (c) and (d) hold a second ring slot and two spilled
    # ones (2 x 18.94 MB; 0.1 GB is room for them)
    free = shutil.disk_usage(CKPT_DIR).free
    need = 3 * (state_bytes + (cfg.n_groups - 1) * group_bytes + 1e8)
    print(f"[ckpt] {CKPT_DIR}: {free / 1e9:.2f} GB free; a snapshot "
          f"{state_bytes / 1e9:.4f} GB reckoned from the state's leaves + "
          f"{group_bytes / 1e9:.4f} GB a retained group; a run's snapshots "
          f"need up to {need / 1e9:.2f} GB", flush=True)
    if free < need:
        raise RuntimeError(f"checkpoints: {free / 1e9:.2f} GB free under "
                           f"{CKPT_DIR}, {need / 1e9:.2f} GB needed")

    def run(case, d, rounds, keep_state=False):
        args, cfg_ = main_setup("smollm-135m", flags + CKPT_CASES[case] + [
            "--rounds", str(rounds), "--ckpt-dir", str(d)])
        with CkptTimers() as timers:
            out = drive(torch, args, cfg_, counters, keep_state=keep_state)
        ran = len(out["history"])
        if out["launches"] != {k: n * ran for k, n in want.items()}:
            raise AssertionError(f"ckpt ({case}): launches {out['launches']}"
                                 f", want {per_round} a round x {ran}")
        for m in out["history"]:
            if not all(math.isfinite(m[k]) for k in ("d_loss", "s_loss")):
                raise AssertionError(f"ckpt ({case}): non-finite loss {m}")
        return out, timers

    def round_walls(out):
        """Each round's wall (completion gap; round 1 from its planning),
        split by whether a save fell due at it."""
        from repro_torch.core.executor import completion_gap_s
        st = out["round_stats"]
        walls = [st[0].plan_s + st[0].build_s + st[0].round_wall_s] + \
            [completion_gap_s(a, b) for a, b in zip(st, st[1:])]
        due = [(s.round + 1) % CKPT_EVERY == 0 for s in st]
        return walls, due

    results, saves, resumes, walls = {}, [], [], []
    unbroken_dir = CKPT_DIR / "unbroken"
    unbroken, tm = run("a", unbroken_dir, CKPT_ROUNDS, keep_state=True)
    saves += tm.saves
    walls.append(round_walls(unbroken))
    facts = _snapshot_facts(unbroken_dir)
    held = max(len(f["groups_held"]) for f in facts)
    print(f"[ckpt] unbroken (a) {' '.join(CKPT_CASES['a'])}, "
          f"{CKPT_ROUNDS} rounds: snapshots {facts} | handle_bytes_peak "
          f"{unbroken['executor']['handle_bytes_peak']}", flush=True)
    shutil.rmtree(unbroken_dir)
    for case in CKPT_CASES:
        d = CKPT_DIR / case
        first, tm1 = run(case, d, CKPT_EVERY)
        rest, tm2 = run(case, d, CKPT_ROUNDS, keep_state=True)
        saves += tm1.saves + tm2.saves
        resumes += tm2.resumes
        walls += [round_walls(first), round_walls(rest)]
        same_hist = first["history"] + rest["history"] == \
            unbroken["history"]
        la, lb = tree_leaves(rest["state"]), tree_leaves(unbroken["state"])
        same_state = len(la) == len(lb) and all(
            a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(la, lb))
        facts = _snapshot_facts(d)
        results[case] = {"history": same_hist, "state": same_state,
                         "snapshots": facts,
                         "handle_bytes_peak": max(
                             first["executor"]["handle_bytes_peak"],
                             rest["executor"]["handle_bytes_peak"]),
                         "launches": rest["launches"]}
        print(f"[ckpt] ({case}) {' '.join(CKPT_CASES[case])}: "
              f"{CKPT_EVERY} rounds, then the rerun resumed to "
              f"{CKPT_ROUNDS}: histories bit-identical to the unbroken run "
              f"{same_hist}, every leaf of the final state bit-identical "
              f"{same_state} | snapshots {facts} | handle_bytes_peak "
              f"{results[case]['handle_bytes_peak']} | launches of the "
              f"resumed run {rest['launches']}", flush=True)
        del rest
        shutil.rmtree(d)
        if not (same_hist and same_state):
            raise AssertionError(f"checkpoints ({case}): the resumed run "
                                 "differs from the unbroken one")
        if not resumes or "restore" not in resumes[-1]:
            raise AssertionError(f"checkpoints ({case}): the rerun did not "
                                 "restore a snapshot")
    if not any(f["groups_held"] for r in results.values()
               for f in r["snapshots"]):
        raise AssertionError("checkpoints: no snapshot held a retained "
                             "group")
    t1 = time.perf_counter()
    results["c"] = ckpt_pool_leg(torch, counters, want, saves, resumes)
    print(f"[ckpt] (c) {time.perf_counter() - t1:.0f} s", flush=True)
    t1 = time.perf_counter()
    results["d"] = ckpt_fault_leg(torch, counters, want, saves, resumes)
    print(f"[ckpt] (d) {time.perf_counter() - t1:.0f} s", flush=True)
    for c in counters:
        c.reset_launches()
    t1 = time.perf_counter()
    results["e"] = faults_sim(torch)
    print(f"[ckpt] (e) {time.perf_counter() - t1:.0f} s", flush=True)
    t1 = time.perf_counter()
    results["f"] = faults_baselines(torch)
    print(f"[ckpt] (f) {time.perf_counter() - t1:.0f} s", flush=True)
    launches = {k: v for c in counters for k, v in c.launches.items()}
    if any(launches.values()):
        raise AssertionError(f"checkpoints: a kernel of the five ran in (e)"
                             f" or (f): {launches}")
    print(f"[ckpt] kernel launches over (e) and (f): {launches}",
          flush=True)
    mean = lambda xs: statistics.mean(xs) if xs else float("nan")
    parts = ("host_copy", "to_numpy", "crc", "write_fsync", "save")
    per_part = {p: [s[p] for s in saves if p in s] for p in parts}
    # a run's first round includes its warm-up: left out of the means
    due = [w for ws, ds in walls for w, d in zip(ws[1:], ds[1:]) if d]
    not_due = [w for ws, ds in walls for w, d in zip(ws[1:], ds[1:])
               if not d]
    # a save's host seconds land in a later round's wall: with flush in
    # the next round's (the save runs before its dispatch), without it
    # wherever the executor services the deferred save
    after = [w for ws, ds in walls for w, d in zip(ws[1:], ds) if d]
    print("[ckpt] round wall s by run (* a save fell due at the round): "
          + " | ".join(" ".join(f"{w:.3f}{'*' if d else ''}"
                                for w, d in zip(ws, ds))
                       for ws, ds in walls), flush=True)
    print(f"[ckpt] {len(saves)} saves, seconds each: " + ", ".join(
        f"{p} {[round(x, 4) for x in per_part[p]]} mean "
        f"{mean(per_part[p]):.4f}" for p in parts), flush=True)
    print(f"[ckpt] resumes: verify (every leaf read, CRC-checked) "
          f"{[round(r['verify'], 4) for r in resumes]} s, restore onto the "
          f"card {[round(r.get('restore', 0.0), 4) for r in resumes]} s | "
          f"round wall s after the first, a save due "
          f"{[round(x, 3) for x in due]} mean {mean(due):.3f}, none due "
          f"{[round(x, 3) for x in not_due]} mean {mean(not_due):.3f}, "
          f"the round after a due one {[round(x, 3) for x in after]} mean "
          f"{mean(after):.3f} | "
          f"most retained groups in a snapshot {held} | phase "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return {"launches": results["a"]["launches"], "cases": results,
            "saves": saves, "resumes": resumes,
            "snapshot_bytes": state_bytes, "group_bytes": group_bytes}


def _sim_describe(cfg) -> str:
    if hasattr(cfg, "img_size"):
        return (f"{cfg.img_size}x{cfg.img_size}x{cfg.in_channels}, "
                f"{cfg.n_classes} classes, {len(cfg.layers)} layers")
    enc = [s for s in cfg.layers if s["kind"] == "enc"]
    return (f"vocab {cfg.vocab}, seq {cfg.seq_len}, d_model {cfg.d_model}, "
            f"{len(enc)} encoders of {enc[0]['heads']} heads, "
            f"{cfg.n_classes} classes")


def main() -> int:
    # llama-vision's plain rounds peak within ~6 GiB of the card's 79.18:
    # segments that grow in place keep the allocator's freed blocks usable
    # (without them a run has gone out of memory with 4.97 GiB reserved
    # but unallocated)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd as ssd_k

    t0 = time.perf_counter()
    phase_device(torch)
    phase_build(build)
    record = phase_kernels(torch, fa, ref)
    record.update(phase_ssd_kernels(torch, ssd_k, ref))
    phase_ssd_conditioning(torch, ssd_k, ref)
    phase_moe(torch)
    print(f"[time] device, build and kernels: {time.perf_counter() - t0:.0f}"
          " s", flush=True)
    paths, wide = {}, {}
    for arch in MAIN_PATHS:
        t1 = time.perf_counter()
        paths[arch] = phase_main(torch, arch, (fa, ssd_k))
        print(f"[time] {arch} main path and serving: "
              f"{time.perf_counter() - t1:.0f} s", flush=True)
    for arch in WIDE_PATHS:
        t1 = time.perf_counter()
        wide[arch] = phase_wide(torch, arch, (fa, ssd_k))
        print(f"[time] {arch} wide path"
              f"{' and serving' if arch in SERVE else ''}: "
              f"{time.perf_counter() - t1:.0f} s", flush=True)
    t1 = time.perf_counter()
    phase_churn(torch, (fa, ssd_k))
    print(f"[time] churn: {time.perf_counter() - t1:.0f} s", flush=True)
    t1 = time.perf_counter()
    phase_sim(torch, (fa, ssd_k))
    print(f"[time] sim: {time.perf_counter() - t1:.0f} s", flush=True)
    t1 = time.perf_counter()
    phase_baselines(torch, (fa, ssd_k))
    print(f"[time] baselines: {time.perf_counter() - t1:.0f} s", flush=True)
    t1 = time.perf_counter()
    store = phase_store(torch, (fa, ssd_k))
    print(f"[time] tiered store: {time.perf_counter() - t1:.0f} s", flush=True)
    t1 = time.perf_counter()
    fleet = phase_fleet(torch, (fa, ssd_k))
    print(f"[time] fleet: {time.perf_counter() - t1:.0f} s", flush=True)
    t1 = time.perf_counter()
    telemetry = phase_telemetry(torch, (fa, ssd_k))
    print(f"[time] telemetry: {time.perf_counter() - t1:.0f} s", flush=True)
    t1 = time.perf_counter()
    sanitize = phase_sanitize(torch, (fa, ssd_k))
    print(f"[time] sanitizer: {time.perf_counter() - t1:.0f} s", flush=True)
    t1 = time.perf_counter()
    ckpt = phase_checkpoint(torch, (fa, ssd_k))
    print(f"[time] checkpoints: {time.perf_counter() - t1:.0f} s",
          flush=True)
    served = {arch: run["serve"] for arch, run in {**paths, **wide}.items()
              if run["serve"] is not None}
    kernels = []
    for name, (source, replaces, arch) in KERNELS.items():
        rec = record[name]["main-srv"]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": paths[arch]["launches"][name],
                        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                        "plain_ms": rec["plain_ms"],
                        "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"],
                        "bound_simt_ms": rec["bound_simt_ms"],
                        "library_ms": rec["library_ms"],
                        "shape": rec["shape"],
                        "device_shape": record[name]["main-dev"],
                        "launches_by_path": {
                            **{p: run["launches"][name]
                               for p, run in {**paths, **wide}.items()},
                            "smollm-135m tiered store":
                                store["launches"][name],
                            "smollm-135m fleet":
                                fleet["pod"]["runs"][2]["launches"][name],
                            "smollm-135m telemetry":
                                telemetry["pod"]["launches"][name],
                            "smollm-135m sanitizer":
                                sanitize["pod"]["launches"][name],
                            "smollm-135m checkpoints (resumed run)":
                                ckpt["launches"][name]},
                        "serve_launches": {p: n[name]
                                           for p, n in served.items()}})
        if name.startswith("ssd_"):
            kernels[-1]["jamba_row"] = record[name]["jamba"]
        if name.startswith("fa_"):
            kernels[-1]["hd128_rows"] = {c: record[name][c]
                                         for c in WIDE_TIMED}
            kernels[-1]["frontend_rows"] = {c: record[name][c]
                                            for c, *_ in FRONTEND_CASES}
            kernels[-1]["moe_rows"] = {c: record[name][c]
                                       for c in MOE_TIMED}
    print(f"[time] total {time.perf_counter() - t0:.0f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi_name_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
