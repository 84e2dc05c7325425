"""Training driver: the FedOptima pod round on one card, and the paper's
testbed in the event simulator (``--mode sim``).

``--mode pod`` runs the hybrid round (``core/fedopt_step``) for ``--rounds``
rounds through the pipelined ``RoundExecutor`` (``core/executor``), with
``--window`` rounds in flight (default 2, as the JAX driver's; 1 is the
synchronous loop, and the metrics are the same at every window).  Per round
the executor takes the roster (``--p-drop``), plans the round on the host
``ControlPlane``, retires and restores dropped groups through the retention
store, moves the plan's spills and fills between the ring and the host
pool of the tiered activation store (``--pool-cap``, default 0: the hard-ω
ring; ``--spill-quant``, ``--eviction``), builds the batch with the JAX
driver's numpy RNG stream and dispatches the step; each round's ``round N
d_loss … s_loss …`` line is printed when it drains, and a ``memory:`` line
reports the store's traffic at the end (0s unless the server stalls: a
programmatic caller can set ``args.profiles`` to a stalled profile).

The fleet plane (``repro_torch.fleet``) drives the roster in both modes:
``--fleet-trace`` (a trace JSON, or ``diurnal``, ``weibull``, ``flaky``,
``uniform``) maps one trace tick to one round in pod mode (superseding
``--p-drop``) and drives joins and leaves in simulated time in sim mode;
``--fleet-tiers`` (``low:3,high:1``) seeds the pod's straggler profiles
with the sampled relative speeds, or samples the sim cluster;
``--selection`` (``random``, ``refl``, ``score``, optionally
``:fraction``) picks each round's cohort from the available groups.  An
``ElasticRegistry`` mirrors the roster, and a ``fleet:`` line reports its
events at the end.

The telemetry plane (``repro_torch.obs``): ``--trace PATH`` records a span
trace of the run and writes it as Chrome trace-event JSON (pod mode on the
wall clock, the rounds' ``mesh`` spans from CUDA events on the card; sim
mode in simulated seconds); ``python -m repro_torch.obs.trace PATH``
validates it.  ``--metrics-every N`` dumps the metrics registry every N
rounds (pod) or N simulated seconds (sim) and once at the end;
``--metrics-out PATH`` appends the final snapshot as one JSON line.

``--sanitize`` runs either mode under the protocol sanitizer
(``repro_torch.analysis.sanitize``): the control plane's events are
checked online against the seven invariants, a violation aborts the run
with the offending event window, and a ``sanitizer: N events checked, V
violations`` line closes the run.  It composes with ``--trace``.

``--ckpt-dir D`` (pod mode) saves an atomic, CRC-checked snapshot every
``--ckpt-every`` rounds (default 5) in the JAX package's layout
(``repro_torch.checkpoint.store``): the state copied from the card, the
control plane, the retained groups' params, the spilled ring slots of the
host pool (``--pool-cap``), the batch and selection RNGs and the
straggler profiles.  Without ``--ckpt-flush`` the round is captured at
dispatch and saved while later rounds stay in flight; with it the
pipeline drains first.  Rerunning the same command resumes from the
newest verified snapshot (a torn one is skipped and reported) and
continues bit for bit.  Sim mode ignores ``--ckpt-dir``.

``--faults`` (pod mode; ``repro_torch.faults``) plays a fault schedule, a
``fault-schedule-v1`` JSON or ``random[:density]`` over the pod classes,
into the round boundaries: ``corrupt_act`` (the update gate quarantines
the group's uploads for the round), ``timeout`` (the group leaves the
roster and rejoins from its retained params), ``server_crash`` (the run
raises ``InjectedCrash`` at the boundary after writing the fired
boundaries to ``FAULTS_FIRED.json``; rerun the command to resume) and
``torn_checkpoint`` (the snapshot just written is damaged; a resume skips
it).  Crashes and tears need ``--ckpt-dir``.  A ``faults:`` line reports
what was injected and recovered, and whether every injection was matched.

``--arch`` runs at its smoke reduction unless ``--full`` is given.  The
step runs on ``--device`` (default ``cuda``); the CPU runs the kernels'
plain versions.

Examples::

    python -m repro_torch.launch.train --mode pod --full --arch smollm-135m \\
        --use-kernel --groups-per-shard 4 --batch 8 --H 4 --seq-len 1024 \\
        --l-split 3 --omega 1 --rounds 3
    python -m repro_torch.launch.train --mode pod --full --arch mamba2-780m \\
        --use-kernel --groups-per-shard 4 --batch 8 --H 4 --seq-len 1024 \\
        --l-split 6 --omega 1 --rounds 3 --window 1
    python -m repro_torch.launch.train --mode pod --arch gemma2-27b \\
        --use-kernel --device cpu --batch 4 --H 2 --seq-len 16 --rounds 2
    python -m repro_torch.launch.train --mode pod --arch whisper-tiny \\
        --use-kernel --device cpu --batch 4 --H 2 --seq-len 16 --rounds 2
    python -m repro_torch.launch.train --mode pod \\
        --arch qwen3-moe-235b-a22b --use-kernel --device cpu --batch 4 \\
        --H 2 --seq-len 16 --rounds 2
    python -m repro_torch.launch.train --mode pod \\
        --arch jamba-1.5-large-398b --use-kernel --device cpu --batch 4 \\
        --H 2 --seq-len 16 --rounds 2
    python -m repro_torch.launch.train --mode pod --device cpu --batch 4 \\
        --H 2 --seq-len 16 --rounds 4 --ckpt-dir ckpt --ckpt-every 2
    python -m repro_torch.launch.train --mode pod --device cpu --batch 4 \\
        --H 2 --seq-len 16 --rounds 6 --ckpt-dir ckpt2 --ckpt-every 1 \\
        --faults random       # crashes; rerun the same command to resume

``--mode sim`` (``run_sim``) drives a VGG-5 ``FedOptimaLearner`` on the card
through the event simulator over ``--devices`` heterogeneous devices
(default 8) for ``--duration`` simulated seconds (default 300), with ω=8,
H=10 and a spill budget of pool = ω unless ``--omega``, ``--H`` and
``--pool-cap`` say otherwise; it prints the JAX driver's lines, and its
event metrics are the JAX package's::

    python -m repro_torch.launch.train --mode sim
    python -m repro_torch.launch.train --mode sim --device cpu --devices 4 \
        --duration 30
    python -m repro_torch.launch.train --mode sim --device cpu --devices 4 \
        --duration 30 --fleet-trace flaky --selection refl:0.5
    python -m repro_torch.launch.train --mode sim --device cpu --devices 4 \
        --duration 30 --trace sim.json --metrics-every 10

``--arch`` takes ``smollm-135m``, ``mamba2-780m``, ``command-r-plus-104b``,
``qwen3-32b``, ``gemma2-27b``, ``llama-3.2-vision-90b``, ``whisper-tiny``
(whose tok/s counts the decoder's ``--seq-len`` tokens, not the encoder's
frames), ``qwen3-moe-235b-a22b``, ``llama4-maverick-400b-a17b`` and
``jamba-1.5-large-398b``: all ten of the JAX package's archs.  Serving the
trained model is ``repro_torch.launch.serve``.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.configs import registry
from repro_torch.core import fedopt_step as F
from repro_torch.core.control_plane import ControlPlane
from repro_torch.core.executor import (RoundExecutor, StragglerProfiles,
                                       completion_gap_s)
from repro_torch.core.staging import to_device
from repro_torch.data.partitioner import dirichlet_partition
from repro_torch.data.synthetic import lm_dataset
from repro_torch.faults import (POD_CLASSES, FaultSchedule, InjectedCrash,
                                PodFaultInjector, UpdateGate,
                                make_fault_schedule)
from repro_torch.fleet import (FleetTrace, SelectionContext,
                               make_selection_policy, make_trace,
                               sample_cluster)
from repro_torch.memory import ActivationStore
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.runtime.elastic import ElasticRegistry

#: Sim-mode flags whose machinery comes with later items of ROADMAP.md's
#: queue A: flag -> (attribute, the value that means "off", the item that
#: brings it).  Unset (None) is off too.
SIM_LATER = {
    "--faults": ("faults", None, "A7.3a, the fault plane in the simulators"),
}


def _refuse_later_slices(args, table) -> None:
    for flag, (attr, off, later) in table.items():
        value = getattr(args, attr, off)
        if value is not None and value != off:
            raise NotImplementedError(
                f"{flag}={value!r}: not in the torch port yet; it comes with "
                f"ROADMAP item {later}")


def _fleet_trace(args, K: int, horizon: float, interval: float,
                 bw=None) -> FleetTrace | None:
    """Resolve --fleet-trace: a JSON artifact path, or a generator kind
    (diurnal | weibull | flaky | uniform) seeded by --seed with scenario
    scales derived from the run horizon.  ``bw`` (scalar or per-device
    array, e.g. a tier-sampled cluster's dev_bw) sets the generated
    trace's base bandwidths so --fleet-tiers heterogeneity survives."""
    spec = getattr(args, "fleet_trace", None)
    if spec is None:
        return None
    if spec.endswith(".json") or os.path.exists(spec):
        trace = FleetTrace.load(spec)
        if trace.K != K:
            raise ValueError(f"--fleet-trace describes {trace.K} devices, "
                             f"this run has {K}")
        return trace
    kw = {}
    if spec == "diurnal":
        kw = dict(day=horizon / 2.0, on_frac=0.6)   # two "days" per run
    elif spec == "weibull":
        kw = dict(on_scale=horizon / 4.0, off_scale=horizon / 8.0)
    if bw is not None and spec != "flaky":   # flaky re-draws bw per tick
        kw["bw"] = bw
    return make_trace(spec, K, horizon, interval=interval,
                      seed=args.seed, **kw)


def _fault_schedule(args, K: int, horizon: float,
                    classes) -> FaultSchedule | None:
    """Resolve --faults: a JSON artifact path (fault-schedule-v1), or
    ``random[:density]`` — a seeded schedule over the mode's supported
    fault classes (pod: the time axis is the round index)."""
    spec = getattr(args, "faults", None)
    if spec is None:
        return None
    if spec.endswith(".json") or os.path.exists(spec):
        return FaultSchedule.load(spec)
    kind, _, dens = spec.partition(":")
    if kind != "random":
        raise ValueError(f"unknown --faults spec {spec!r}: expected a "
                         "schedule JSON path or 'random[:density]'")
    return make_fault_schedule(K, horizon, seed=args.seed, classes=classes,
                               density=float(dens) if dens else 1.0)


def _pipeline_window(args) -> int:
    """Resolve the pipeline window with explicit validation: an unset
    attribute (programmatic bare Namespace) defaults to 2; anything set
    must be an int >= 1 — ``--window 0`` is an error, not a silent remap
    to the default."""
    w = getattr(args, "window", None)
    if w is None:
        return 2
    w = int(w)
    if w < 1:
        raise ValueError(
            f"--window must be >= 1, got {w}: 1 is the synchronous loop, "
            ">= 2 keeps that many rounds in flight")
    return w


def _group_streams(cfg: F.FedStepConfig, seed: int = 0):
    """Per-group non-IID token streams (distinct synthetic grammars)."""
    return [lm_dataset(200_000, cfg.arch.vocab, seed=seed + g,
                       structure=0.75 + 0.2 * (g % 3) / 2)
            for g in range(cfg.n_groups)]


def _make_batch(cfg: F.FedStepConfig, streams, rng: np.random.Generator,
                plan, device) -> dict:
    """One round's inputs: per-group token windows drawn exactly as the JAX
    driver draws them, plus the plan's schedule and weight fields.  An arch
    with a frontend stub (VLM, enc-dec) gets ``frontend`` embeddings of
    zeros, (G, H, b, frontend_len, d_model), as the JAX driver feeds it."""
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
    batch = {"tokens": to_device(tokens, device),
             "labels": to_device(labels, device)}
    batch.update(plan.batch_fields(device))
    arch = cfg.arch
    if arch.frontend_len:
        batch["frontend"] = torch.zeros(G, H, b, arch.frontend_len,
                                        arch.d_model, dtype=cfg.param_dtype,
                                        device=device)
    return batch


def pod_config(args) -> F.FedStepConfig:
    arch = registry.get(args.arch) if args.full else \
        registry.smoke_config(args.arch)
    return F.FedStepConfig(
        arch=arch, l_split=args.l_split or F.default_l_split(arch),
        n_groups=args.groups_per_shard, seq_len=args.seq_len,
        per_group_batch=args.batch, H=args.H or 4, lr_d=args.lr_d,
        lr_s=args.lr_s, server_opt=args.server_opt, omega=args.omega or 1,
        use_kernel=args.use_kernel)


def run_pod(args, cfg: F.FedStepConfig | None = None) -> dict:
    """Run ``args.rounds`` rounds; returns {"history", "final", "executor",
    "memory", "consumed", "steady_tok_s", "round_stats", "state",
    "fleet", "registry"}.  ``"registry"`` is the snapshot of the metrics
    registry behind the executor and the store.  ``"fleet"`` holds each
    round's available groups and cohort (dispatch order), the registry's
    roster events, the selection policy and the straggler patterns the
    plans used.  A programmatic
    caller may set ``args.on_round(r, metrics)``, called as each round
    drains with its metrics as floats, and ``args.profiles``, seeded
    ``StragglerProfiles`` (uniform by default; ``--fleet-tiers`` seeds
    them from the sampled capabilities; on resume the snapshot's
    ``summary()`` is loaded into them with ``load_summary``), and may pass
    ``cfg`` to run
    in place of ``pod_config(args)`` (e.g. a full-width arch cut in depth
    with ``ArchConfig.scaled``).  With ``args.ckpt_dir`` the run first
    resumes from the newest verified snapshot there, if any, and saves
    every ``args.ckpt_every`` rounds; ``"history"`` then holds the rounds
    this run ran.  With ``args.faults`` the result has ``"faults"``, the
    injector's report, and an injected crash propagates as
    ``InjectedCrash``."""
    window = _pipeline_window(args)
    device = torch.device(args.device)
    cfg = cfg or pod_config(args)
    G = cfg.n_groups
    # tiered-store knobs (pod default: no spill pool, bit for bit the
    # hard-ω ring; raise --pool-cap to admit past the ring)
    pool_cap = getattr(args, "pool_cap", None)
    pool_cap = 0 if pool_cap is None else pool_cap
    spill_quant = bool(getattr(args, "spill_quant", False))
    ckpt_dir = getattr(args, "ckpt_dir", None)
    cplane = ControlPlane(G, cfg.omega, cfg.H, policy=args.policy,
                          max_delay=args.max_delay, pool_cap=pool_cap,
                          eviction=getattr(args, "eviction", None) or "share")
    # one registry backs the executor, the spill store and the fault gate
    reg = MetricsRegistry()
    act_store = ActivationStore(pool_cap, quant=spill_quant, metrics=reg)

    # chaos plane (pod axis: round index) — built before resume so a
    # restarted run replays the SAME schedule, minus already-fired crashes
    faults_sched = _fault_schedule(args, G, float(max(args.rounds, 1)),
                                   POD_CLASSES)
    injector, fired_path = None, None
    if faults_sched is not None:
        needs_store = any(e.cls in ("server_crash", "torn_checkpoint")
                          for e in faults_sched.events)
        if needs_store and not ckpt_dir:
            raise ValueError(
                "--faults schedules server_crash/torn_checkpoint events: "
                "--ckpt-dir is required so fired crash boundaries persist "
                "across restarts and recovery has a store to resume from")
        fired = ()
        if ckpt_dir:
            # a crash can fire before the first snapshot creates the dir
            os.makedirs(ckpt_dir, exist_ok=True)
            fired_path = os.path.join(ckpt_dir, "FAULTS_FIRED.json")
            if os.path.exists(fired_path):
                with open(fired_path) as f:
                    fired = tuple(json.load(f))
        injector = PodFaultInjector(faults_sched,
                                    gate=UpdateGate(metrics=reg),
                                    fired_crashes=fired)

    # the init on the card; on resume only its shapes and dtypes serve, as
    # the template the snapshot is restored into, straight onto the card
    state = F.init_train_state(
        torch.Generator(device=device).manual_seed(args.seed), cfg)
    start_round = 0
    resumed_meta = None
    verified_step = None
    if ckpt_dir:
        verified_step, skipped = store.latest_verified_step(ckpt_dir)
        for bad_step, reason in skipped:
            print(f"resume: skipping torn snapshot step {bad_step}: "
                  f"{reason}")
    if verified_step is not None:
        start_round = verified_step
        like = tree_map(lambda x: x.to("meta"), state)
        del state
        state = store.restore(ckpt_dir, start_round, like, device=device)
        if "act_buf" in state:
            ring = tree_leaves(state["act_buf"])[0].shape[0]
            if ring != cfg.omega:
                raise ValueError(
                    f"checkpoint has an ω={ring} activation ring but "
                    f"--omega={cfg.omega}; out-of-range slot indices would "
                    f"be silently clamped — restart with --omega {ring}")
        meta = store.restore_metadata(ckpt_dir, start_round)
        if "control_plane" in meta:
            # restore the host plan with the ring it describes, or slot
            # occupancy and staleness history silently reset on resume
            cplane.load_state_dict(meta["control_plane"])
            slice_like = {k: tree_map(lambda x: x[0], like[k])
                          for k in ("dev", "aux")}
            if "spill_store" in meta:
                # v3 layout: extras.npz is namespaced {"retention", "spill"}
                # — spilled ring slots ride the snapshot next to the
                # retained per-group params
                act_store.load_meta(meta["spill_store"])
                if sorted(cplane.pool_occupancy) != act_store.keys:
                    raise ValueError(
                        f"snapshot pool bookkeeping "
                        f"({sorted(cplane.pool_occupancy)}) disagrees with "
                        f"its spill store ({act_store.keys})")
                like_extras = {}
                if len(cplane.retention):
                    like_extras["retention"] = {
                        str(g): slice_like for g in cplane.retention.groups}
                if len(act_store):
                    like_extras["spill"] = act_store.like_tree(
                        F.gather_act_slot(like, 0))
                if like_extras:
                    ex = store.restore_extras(ckpt_dir, start_round,
                                              like_extras)
                    if "retention" in like_extras:
                        cplane.retention.load_arrays(ex["retention"])
                    if "spill" in like_extras:
                        # a fill hands each leaf back at the ring's dtype,
                        # on the ring's device
                        ring_slot = F.gather_act_slot(state, 0)
                        act_store.load_arrays(
                            ex["spill"],
                            dtypes=act_store.slot_dtypes(ring_slot),
                            devices=act_store.slot_devices(ring_slot))
            elif len(cplane.retention):
                # v2 layout: extras.npz holds the retention tree bare
                cplane.retention.load_arrays(store.restore_extras(
                    ckpt_dir, start_round,
                    {str(g): slice_like for g in cplane.retention.groups}))
        resumed_meta = meta
        print(f"resumed from round {start_round}")
    streams = _group_streams(cfg, seed=args.seed)
    rng = np.random.default_rng(args.seed + start_round)
    if resumed_meta and "rng_state" in resumed_meta:
        # bit-exact continuation: restore the batch RNG mid-stream instead
        # of reseeding (reseeding resumes a DIFFERENT run than the one
        # that crashed — same distribution, different batches)
        rng.bit_generator.state = resumed_meta["rng_state"]

    # Fleet emulation (repro_torch.fleet): --fleet-trace maps one trace
    # tick to one round (the pod roster for round r is trace row r,
    # wrapping past the horizon); --fleet-tiers samples per-group
    # capabilities whose relative speeds seed the straggler profiles;
    # --selection picks the participating cohort from each round's
    # available groups, fed the live Alg. 3 consumption counters +
    # staleness accounting.
    fleet = _fleet_trace(args, G, horizon=float(max(args.rounds, 1)),
                         interval=1.0)
    sel = make_selection_policy(getattr(args, "selection", None),
                                seed=args.seed)
    caps = None
    if getattr(args, "fleet_tiers", None):
        tier_cluster = sample_cluster(G, args.fleet_tiers, seed=args.seed)
        caps = np.asarray(tier_cluster.dev_flops, float)
    registry_ = ElasticRegistry()
    for g in range(G):       # one pod "device" per group
        registry_.join(flops_per_s=float(caps[g]) if caps is not None
                       else 1.0, bandwidth=1.0)
    # Straggler profiles: the lockstep round can only measure the round's
    # absolute scale, so RELATIVE group speeds come from the seeds —
    # programmatic callers inject a seeded profile via args.profiles, and
    # --fleet-tiers seeds one from the sampled capability mix (step time
    # inversely proportional to flops); the unseeded default is uniform,
    # whose patterns equal the placeholder defaults.
    profiles = getattr(args, "profiles", None)
    if profiles is None and caps is not None:
        profiles = StragglerProfiles(G, step_s=1.0 / caps)
    if profiles is None:
        profiles = StragglerProfiles(G)
    if resumed_meta and "profiles" in resumed_meta:
        # restore the measured EMAs so the resumed run plans the same
        # produce/reads patterns the crashed run would have; into the
        # caller's profile, which may keep state of its own in its summary
        profiles.load_summary(resumed_meta["profiles"])
    executor = RoundExecutor(F.make_train_step(cfg), cplane, window=window,
                             profiles=profiles, gather=F.gather_group_state,
                             scatter=F.scatter_group_state,
                             registry=registry_, store=act_store,
                             gather_slot=F.gather_act_slot,
                             scatter_slot=F.scatter_act_slot,
                             faults=injector, metrics=reg)
    if sel is not None and resumed_meta and "selection_rng" in resumed_meta \
            and hasattr(sel, "_rng"):
        sel._rng.bit_generator.state = resumed_meta["selection_rng"]
    available, cohorts = [], []

    def active_fn(r):
        if fleet is not None:
            roster = fleet.roster(r)
        else:
            roster = rng.random(G) >= args.p_drop
            if not roster.any():
                roster[rng.integers(0, G)] = True
        available.append(np.flatnonzero(roster).tolist())
        if sel is not None and not sel.trivial and roster.any():
            ctx = SelectionContext(t=float(r),
                                   counters=cplane.scheduler.counters,
                                   staleness=cplane.version - cplane.versions,
                                   capability=caps)
            chosen = sel.select(np.flatnonzero(roster), ctx)
            roster = np.zeros(G, bool)
            roster[np.asarray(chosen, int)] = True
        cohorts.append(np.flatnonzero(roster).tolist())
        return roster

    def batch_fn(r, plan):
        return _make_batch(cfg, streams, rng, plan, device)

    on_round = getattr(args, "on_round", None)
    tokens = cfg.global_batch * cfg.seq_len
    prev = None
    metrics_every = int(getattr(args, "metrics_every", 0) or 0)

    def on_metrics(r, m, st):
        nonlocal prev
        if on_round is not None:
            on_round(r, m)
        if (r + 1) % args.log_every == 0:
            # this round's time, from the previous round's completion (the
            # first round's: from the start of its planning to its drain)
            secs = completion_gap_s(prev, st) if prev is not None else \
                st.plan_s + st.build_s + st.round_wall_s
            n_active = int(np.sum(np.asarray(st.plan.bcast_mask) > 0.5))
            print(f"round {r+1:4d}  d_loss {m['d_loss']:.4f}  "
                  f"s_loss {m['s_loss']:.4f}  active {n_active}/{G}"
                  f"  {tokens / secs:,.0f} tok/s", flush=True)
        prev = st
        if metrics_every and (r + 1) % metrics_every == 0:
            print(executor.metrics.dump_line(prefix=f"[round {r+1}]"))

    def capture_fn(r):
        """Dispatch-time host bookkeeping for round r's checkpoint —
        snapshotted at the SAME boundary as the handle's tensors, so the
        eventual (possibly deferred) save describes exactly round r.  The
        extras dict is built fresh here and the payloads it references
        are never changed in place (a retention release pops, a store
        fill pops), so a later save sees round-r values."""
        # v3 extras layout: retention params and spilled ring slots ride
        # the same atomic snapshot under their own namespaces
        extras = {}
        if cplane.retention.arrays():
            extras["retention"] = cplane.retention.arrays()
        if act_store.arrays():
            extras["spill"] = act_store.arrays()
        metadata = {"round": r + 1, "arch": cfg.arch.name,
                    "control_plane": cplane.state_dict(),
                    "spill_store": act_store.meta_dict(),
                    # host-loop continuation state: what a resumed run
                    # needs for bit-exact replay past this snapshot
                    "rng_state": rng.bit_generator.state,
                    "profiles": profiles.summary()}
        if sel is not None and hasattr(sel, "_rng"):
            metadata["selection_rng"] = sel._rng.bit_generator.state
        return {"metadata": metadata, "extras": extras or None}

    def checkpoint_fn(r, handle):
        """Save round r from its RoundHandle: host copies of the captured
        tensors + the dispatch-time metadata.  Without flush this runs
        while rounds r+1..r+window are still in flight; with flush the
        handle wraps the drained live state — the save is the same."""
        meta = handle.meta
        store.save(ckpt_dir, r + 1, handle.host_tree(),
                   metadata=meta["metadata"], extras=meta["extras"])
        if injector is not None:
            injector.on_checkpoint(r, ckpt_dir, r + 1)

    # hand the state over without keeping a reference here: one held
    # would keep the first round's server params alive for the whole run
    held = [state]
    del state
    try:
        state, history = executor.run(
            held.pop(), start_round, args.rounds, active_fn=active_fn,
            batch_fn=batch_fn, on_metrics=on_metrics,
            checkpoint_every=getattr(args, "ckpt_every", 5) if ckpt_dir
            else 0,
            checkpoint_fn=checkpoint_fn if ckpt_dir else None,
            capture_fn=capture_fn if ckpt_dir else None,
            checkpoint_flush=bool(getattr(args, "ckpt_flush", False)))
    except InjectedCrash as crash:
        # persist the fired boundary FIRST, then die: the restarted run
        # resumes from the newest verified snapshot and must not re-fire
        if fired_path is not None:
            with open(fired_path, "w") as f:
                json.dump(sorted(injector.fired_crashes), f)
        print(f"faults: {crash} (fired boundaries "
              f"{sorted(injector.fired_crashes)}) — restart to resume")
        raise
    xs = executor.summary()
    print(f"checkpoints: flush_saves={xs['checkpoints']['flush_saves']} "
          f"noflush_saves={xs['checkpoints']['noflush_saves']}  "
          f"handle_bytes_peak={xs['handle_bytes_peak']}")
    n = len(executor.stats)
    steady = tokens * (n - 1) / completion_gap_s(
        executor.stats[0], executor.stats[-1]) if n > 1 else None
    if steady is not None:
        print(f"throughput: {steady:,.0f} tok/s over rounds 2-{n} (first "
              f"to last round completion), window {window}")
    mem = {**cplane.memory_summary(), **act_store.summary()}
    print(f"memory: spills {mem['spills']}  fills {mem['fills']}  "
          f"evictions {mem['evictions']}  peak pool "
          f"{mem['peak_pool']}/{pool_cap} slots "
          f"({mem['peak_pool_bytes']/1e6:.1f} MB"
          f"{', int8 spill' if spill_quant else ''})")
    consumed = [cplane.consumption.get(g, 0) for g in range(G)]
    print(f"contribution balance: consumed={consumed}")
    absences = sum(i.absences for i in registry_.devices.values())
    if fleet is not None:
        print(f"fleet: trace={fleet.meta.get('kind', 'custom')}  "
              f"roster events={absences}  "
              f"selection={sel.describe() if sel else 'all'}")
    if metrics_every:
        print(executor.metrics.dump_line(prefix="[final]"))
    if getattr(args, "metrics_out", None):
        executor.metrics.write_jsonl(args.metrics_out,
                                     extra={"mode": "pod",
                                            "rounds": args.rounds})
    produce, reads = profiles.produce(cfg.H), profiles.reads(cfg.H)
    out = {"history": history, "final": history[-1] if history else None,
           "executor": xs, "memory": mem, "consumed": consumed,
           "steady_tok_s": steady, "round_stats": executor.stats,
           "state": state, "registry": executor.metrics.snapshot(),
           "fleet": {"available": available, "cohorts": cohorts,
                     "roster_events": absences, "registry": registry_,
                     "selection": sel.describe() if sel else "all",
                     "produce_per_round": produce.sum(axis=0).tolist(),
                     "reads_per_round": int(reads.sum())}}
    if injector is not None:
        fr = injector.report()
        print(f"faults: injected={fr['injected']}  "
              f"recovered={fr['recovered']}  matched={fr['matched']}")
        out["faults"] = fr
    return out


# ---------------------------------------------------------------------------
# sim mode (paper testbed)
# ---------------------------------------------------------------------------

def run_sim(args) -> dict:
    """The JAX driver's ``run_sim``: a VGG-5 FedOptima learner (16x16
    images, 10 classes, l_split 1) on ``args.device`` in the event
    simulator over ``heterogeneous_cluster(args.devices)``, or a cluster
    sampled from ``--fleet-tiers``, under ``--fleet-trace`` and
    ``--selection`` when given.  Prints the reference's lines and returns
    its dict; ``"registry"`` is the port's ``MetricsRegistry``
    snapshot."""
    _refuse_later_slices(args, SIM_LATER)
    from repro_torch.core.learning import FedOptimaLearner, ModelAdapter
    from repro_torch.core.simulation import (SimModel, heterogeneous_cluster,
                                             simulate_fedoptima)
    from repro_torch.data.pipeline import DeviceDataset
    from repro_torch.data.synthetic import classification_dataset
    from repro_torch.models import cnn

    # the paper's lab defaults ω=8, H=10 apply when the flags are unset
    omega = getattr(args, "omega", None) or 8
    H = getattr(args, "H", None) or 10
    policy = getattr(args, "policy", "counter")
    max_delay = getattr(args, "max_delay", 16)
    # sim default pool = ω: the lab testbed's tiered budget (2ω admission)
    pool_cap = getattr(args, "pool_cap", None)
    pool_cap = omega if pool_cap is None else pool_cap

    data = classification_dataset(4096, 10, img_size=16, seed=args.seed)
    parts = dirichlet_partition(data.y, args.devices, alpha=0.5,
                                seed=args.seed)
    mcfg = cnn.vgg5_config(n_classes=10, img_size=16)
    adapter = ModelAdapter(cnn, mcfg)
    datasets = [DeviceDataset(data.x[ix], data.y[ix], batch=32, seed=g)
                for g, ix in enumerate(parts)]
    learner = FedOptimaLearner(adapter, datasets, l_split=1,
                               lr_d=0.05, lr_s=0.05,
                               device=getattr(args, "device", "cuda"))
    sim_model = SimModel(dev_fwd_flops=2e9, dev_bwd_flops=4e9,
                         full_fwd_flops=6e9, srv_flops_per_batch=1.2e10,
                         act_bytes=2e6, dev_model_bytes=1e6,
                         full_model_bytes=4e6, batch_size=32)
    # fleet emulation: --fleet-tiers samples the cluster from a weighted
    # capability mix (default: the paper's 4 uniform speed groups), and
    # --fleet-trace/--selection drive availability + cohort choice
    if getattr(args, "fleet_tiers", None):
        cluster = sample_cluster(args.devices, args.fleet_tiers,
                                 seed=args.seed)
    else:
        cluster = heterogeneous_cluster(args.devices)
    fleet = _fleet_trace(args, args.devices, args.duration,
                         interval=max(args.duration / 12.0, 1.0),
                         bw=cluster.dev_bw)
    control = ControlPlane.for_sim(args.devices, omega, policy=policy,
                                   max_delay=max_delay, pool_cap=pool_cap)
    profiles = StragglerProfiles(args.devices)
    metrics = simulate_fedoptima(sim_model, cluster, duration=args.duration,
                                 omega=omega, H=H, policy=policy,
                                 max_delay=max_delay, pool_cap=pool_cap,
                                 seed=args.seed, fleet=fleet,
                                 selection=getattr(args, "selection", None),
                                 hooks=learner, control=control,
                                 profiles=profiles,
                                 metrics_every=float(
                                     getattr(args, "metrics_every", 0) or 0))
    xte, yte = data.x[:512], data.y[:512]
    acc = learner.eval_accuracy(xte, yte)
    # the measured per-device profiles drive a straggler-aware plan: slow
    # devices are scheduled fewer emissions per round, the server reads at
    # its measured cadence — the same patterns run_pod feeds per round
    produce, reads = profiles.produce(H), profiles.reads(H)
    print(f"sim: {args.devices} devices, {args.duration}s simulated | "
          f"srv idle {metrics.srv_idle_frac:.1%}  dev idle "
          f"{metrics.dev_idle_frac:.1%}  throughput {metrics.throughput:.0f} "
          f"samples/s  train-set acc {acc:.3f}")
    print(f"measured straggler profile: emissions/round "
          f"{produce.sum(axis=0).tolist()} of H={H}, server reads "
          f"{int(reads.sum())}/{H}")
    mem = control.memory_summary()
    print(f"memory: tiered budget ω={omega}+pool={pool_cap}, peak buffered "
          f"{mem['peak_buffered']} batches, spills {mem['spills']}  "
          f"fills {mem['fills']}")
    bal = metrics.contribution_balance()
    print(f"contribution balance: consumed={metrics.dev_consumed.tolist()}  "
          f"gini={bal['gini']:.3f}  cv={bal['cv']:.3f}  "
          f"participants={bal['participants']}/{args.devices}")
    steady = metrics.steady_summary()
    if steady:
        print(f"steady state (post-warmup {steady['warmup_s']:.1f}s): "
              f"srv idle {steady['srv_idle_frac_steady']:.1%}  dev idle "
              f"{steady['dev_idle_frac_steady']:.1%}  throughput "
              f"{steady['throughput_steady']:.0f} samples/s")
    if metrics.registry is not None:
        absences = sum(i.absences
                       for i in metrics.registry.devices.values())
        kind = fleet.meta.get("kind", "custom") if fleet is not None \
            else "identity"     # selection-only runs get an identity trace
        print(f"fleet: trace={kind}  roster events={absences}  active now "
              f"{len(metrics.registry.active_ids)}/{args.devices}")
    reg = metrics.to_registry()
    if getattr(args, "metrics_every", 0):
        print(reg.dump_line(prefix="[final]"))
    if getattr(args, "metrics_out", None):
        reg.write_jsonl(args.metrics_out,
                        extra={"mode": "sim", "duration": args.duration,
                               "devices": args.devices})
    return {"accuracy": acc, "srv_idle": metrics.srv_idle_frac,
            "dev_idle": metrics.dev_idle_frac,
            "throughput": metrics.throughput,
            "profiles": profiles.summary(),
            "produce_per_round": produce.sum(axis=0).tolist(),
            "reads_per_round": int(reads.sum()),
            "memory": mem,
            "consumed": metrics.dev_consumed.tolist(),
            "contribution_balance": bal,
            "steady": steady, "registry": reg.snapshot()}


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
                   help="local iterations per round (pod default 4, sim "
                        "default 10)")
    p.add_argument("--l-split", type=int, default=0)
    p.add_argument("--lr-d", type=float, default=0.05)
    p.add_argument("--lr-s", type=float, default=0.05)
    p.add_argument("--server-opt", default="sgd", choices=("sgd", "adamw"))
    p.add_argument("--omega", type=int, default=None,
                   help="activation cap ω (pod ring default 1, sim "
                        "default 8)")
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
    p.add_argument("--devices", type=int, default=8,
                   help="simulated devices (sim mode)")
    p.add_argument("--duration", type=float, default=300.0,
                   help="simulated seconds (sim mode)")
    p.add_argument("--pool-cap", type=int, default=None,
                   help="host spill-pool depth backing the ω ring (tiered "
                        "activation store, repro_torch.memory): admission "
                        "runs against ω + pool_cap.  Pod default 0 (no "
                        "pool, bit for bit the hard-ω ring), sim default ω")
    p.add_argument("--spill-quant", action="store_true",
                   help="int8-quantise spilled activation slots (per "
                        "tensor, on the card; labels and tokens stay "
                        "exact): pool bytes / ~4 for a bounded "
                        "dequantisation error on refill")
    p.add_argument("--eviction", default="share", choices=("share", "lru"),
                   help="spill-victim policy: 'share' protects the "
                        "contributions of the least-served groups "
                        "(scheduler-aware), 'lru' evicts the least "
                        "recently touched slot")
    p.add_argument("--window", type=int, default=2,
                   help="pipelined rounds in flight: 1 = synchronous host "
                        "loop, 2 = the host plans and builds round r+1 "
                        "while the card runs round r (metric values do "
                        "not depend on the window)")
    p.add_argument("--fleet-trace", default=None, dest="fleet_trace",
                   help="device availability trace (repro_torch.fleet): a "
                        "JSON artifact saved by FleetTrace.save, or a "
                        "generator kind — diurnal | weibull | flaky | "
                        "uniform — seeded by --seed.  Sim mode drives "
                        "join/leave from trace ticks; pod mode maps one "
                        "tick to one round (trace-driven churn exercises "
                        "per-group retention end-to-end, superseding "
                        "--p-drop)")
    p.add_argument("--fleet-tiers", default=None, dest="fleet_tiers",
                   help="capability-tier mix for the fleet, e.g. "
                        "'low,mid,high,premium' or 'low:3,premium:1' "
                        "(repro_torch.fleet.devices).  Sim mode samples "
                        "the cluster from it; pod mode seeds the straggler "
                        "profiles with the sampled relative speeds")
    p.add_argument("--selection", default=None,
                   help="participant-selection policy: random | refl | "
                        "score, optionally ':fraction' (e.g. refl:0.5 "
                        "runs the most-stale half each tick).  Fed the "
                        "Alg. 3 consumption counters + staleness "
                        "accounting; default: every available device")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="record a span trace of the run and export Chrome "
                        "trace-event JSON to PATH (open in Perfetto or "
                        "chrome://tracing).  Pod mode traces the host loop "
                        "on the wall clock (the rounds from CUDA events on "
                        "the card); sim mode traces per-device/server/"
                        "network lanes in simulated time.  Off = "
                        "zero-instrumentation run (bit-identical)")
    p.add_argument("--metrics-every", type=float, default=0,
                   dest="metrics_every", metavar="N",
                   help="periodically dump the unified metrics registry: "
                        "every N rounds (pod) or every N simulated "
                        "seconds (sim); 0 = final summary only")
    p.add_argument("--metrics-out", default=None, dest="metrics_out",
                   metavar="PATH",
                   help="append the final metrics-registry snapshot to "
                        "PATH as one JSON line")
    p.add_argument("--sanitize", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="run under the protocol sanitizer "
                        "(repro_torch.analysis.sanitize): control-plane "
                        "events are checked online against the invariant "
                        "catalogue and any violation aborts the run with "
                        "the offending event window")
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint directory (pod mode): atomic, CRC-checked "
                        "snapshots in the JAX package's layout; a rerun "
                        "resumes from the newest verified one (pod mode; "
                        "sim mode ignores it)")
    p.add_argument("--ckpt-every", type=int, default=5,
                   help="rounds between snapshots")
    p.add_argument("--ckpt-flush", action="store_true",
                   help="drain the round pipeline at each save (the "
                        "synchronous save point); default: capture the "
                        "round at dispatch and save it while later rounds "
                        "stay in flight")
    p.add_argument("--faults", default=None,
                   help="chaos plane (repro_torch.faults), pod mode: a "
                        "fault-schedule JSON path, or 'random[:density]' — "
                        "a seeded schedule of corrupt uploads, group "
                        "timeouts, server crashes and checkpoint tears, "
                        "injected at round boundaries (crash/tear faults "
                        "need --ckpt-dir; an injected crash kills the run — "
                        "rerun the same command to resume).  Sim mode "
                        "refuses it until ROADMAP item A7.3a")
    return p


def _run_traced(run, args) -> dict:
    if not args.trace:
        return run(args)
    from repro_torch.obs.trace import Tracer, traced
    tracer = Tracer(domain="wall" if args.mode == "pod" else "sim")
    with traced(tracer):
        out = run(args)
    tracer.export_chrome(args.trace)
    print(f"trace: {len(tracer.spans)} spans on "
          f"{len(tracer.lanes())} lanes -> {args.trace}")
    return out


def main(argv=None) -> dict:
    """Parse ``argv`` and run the mode; with ``--trace`` the run is traced
    (the wall domain in pod mode, simulated seconds in sim mode) and the
    trace written as Chrome JSON; with ``--sanitize`` it runs under the
    protocol sanitizer, whose report joins the returned dict as
    ``"sanitizer"``.  The two seams compose.  Returns the mode's dict."""
    args = build_parser().parse_args(argv)
    run = run_pod if args.mode == "pod" else run_sim
    if not args.sanitize:
        return _run_traced(run, args)
    from repro_torch.analysis.sanitize import sanitized
    with sanitized() as san:
        out = _run_traced(run, args)
    rep = san.report()
    print(f"sanitizer: {rep['events']} events checked, "
          f"{rep['n_violations']} violations")
    out["sanitizer"] = rep
    return out


if __name__ == "__main__":
    main()
