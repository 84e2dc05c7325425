"""Baseline FL protocols as event simulations (paper §5.2 baselines).

  classic FL [McMahan'17]  — full model on device, synchronous FedAvg
  FedAsync   [Xie'23]      — full model, asynchronous aggregation
  FedBuff    [Nguyen'22]   — full model, buffered async aggregation (Z)
  SplitFed   [Thapa'22]    — offloading, per-iteration grad return, sync agg
  PiPar      [Zhang'24]    — SplitFed + pipeline overlap on the device
  OAFL       (§2.2)        — SplitFed protocol + FedAsync aggregation

All share the Metrics structure of ``simulation.py``, so figures compare
like-for-like.  Server compute is serialized (single accelerator); links
are full-duplex.  hooks objects (optional) drive real training in event
order — see ``core/learning.py`` (``FullModelLearner``, ``SplitLearner``).

Every protocol accepts ``fleet=`` (a ``repro_torch.fleet.FleetTrace``):
device join/leave and bandwidth follow the trace's tick grid through the
single trace-event API (``repro_torch.fleet.traces.install_fleet``), so
FedOptima and all six baselines can be compared under one identical
device population.  ``churn=`` ChurnModels are materialised onto the same
grid (``FleetTrace.from_churn``: identical draws, bit for bit).

A copy of the JAX package's ``core/baselines.py`` with its fleet plane:
the same events, pushed in the same order (``Sim`` breaks ties in time by
push order, so one push more, fewer or out of order would reorder every
later tie), and the same metrics, bit for bit.  With a tracer attached
the busy intervals carry the reference's span names and lanes (PiPar's
overlapped forward on the ``dev/<k>/pipe`` sub-lane) and the churn seams
emit ``leave``/``join`` instants, so the sim-domain traces are equal too.
Every protocol also accepts ``faults=`` (a
``repro_torch.faults.FaultSchedule`` or a prebuilt ``FaultInjector``): the
subset of the chaos taxonomy a full-model protocol can express —
corrupted model uploads, delayed arrivals, device timeouts mid-round
(``repro_torch.faults.BASELINE_CLASSES``) — is injected at the same named
seams as FedOptima's, so clean-vs-faulted degradation is compared
like-for-like, and ``Metrics.faults`` is the reference's report.
``fault_gate`` mirrors ``simulate_fedoptima``: None = default
``UpdateGate``, False = no armor (poison flows into aggregation), an
instance = used as-is.  With a protocol sanitizer attached the async and split loops emit the
reference's ``sim.*`` chain and roster events (chain events in the split
loop only without the sync barrier).  ``seed`` is unused, as in the
reference.
"""
from __future__ import annotations

import numpy as np

from repro_torch.analysis import sanitize as _san
from repro_torch.faults.inject import FaultInjector, install_timeouts
from repro_torch.faults.quarantine import UpdateGate
from repro_torch.fleet.traces import install_fleet, resolve_fleet
from repro_torch.obs import trace as _tr

from .simulation import Metrics, Sim, SimCluster, SimModel


def _resolve_injector(faults, fault_gate) -> FaultInjector | None:
    if faults is None:
        return None
    if isinstance(faults, FaultInjector):
        return faults
    gate = UpdateGate() if fault_gate is None else (fault_gate or None)
    return FaultInjector.for_baseline(faults, gate=gate)


# ---------------------------------------------------------------------------
# Full-model methods: classic FL / FedAsync / FedBuff
# ---------------------------------------------------------------------------

def simulate_classic_fl(model: SimModel, cluster: SimCluster, *,
                        duration: float, H: int = 10, hooks=None,
                        churn=None, fleet=None, seed: int = 0,
                        faults=None, fault_gate=None) -> Metrics:
    sim = Sim()
    K = cluster.K
    m = Metrics(K=K, duration=duration)
    inj = _resolve_injector(faults, fault_gate)
    t_iter = [3 * model.full_fwd_flops / cluster.dev_flops[k] for k in range(K)]
    trace = resolve_fleet(fleet, churn, cluster, duration)
    active = np.ones(K, bool)
    bw = cluster.dev_bw.astype(float).copy()
    if trace is not None:
        trace.apply(active, bw)
    pending = {"n": 0}

    def start_round():
        m.rounds += 1
        expected = [k for k in range(K) if active[k]]
        if not expected:
            sim.after(1.0, start_round)
            return
        pending["n"] = len(expected)
        for k in expected:
            tx = model.full_model_bytes / bw[k]
            m.bytes_down += model.full_model_bytes
            sim.after(tx, dev_train, k, H)

    def dev_train(k, h_left):
        if not active[k]:
            arrive(None)
            return
        start = sim.t

        def done():
            m.note_dev_busy(k, start, sim.t, name="train",
                            samples=model.batch_size)
            if hooks:
                hooks.device_iter(k, False)
            if h_left > 1:
                dev_train(k, h_left - 1)
            else:
                tx = model.full_model_bytes / bw[k]
                m.bytes_up += model.full_model_bytes
                extra, ckind = inj.tag_model_upload(k, sim.t) \
                    if inj is not None else (0.0, "")
                sim.after(tx + extra, arrive, k, ckind, extra > 0.0)
        sim.after(t_iter[k], done)

    def arrive(k, ckind="", delayed=False):
        ok = True
        if inj is not None and k is not None:
            if delayed:
                # sync FL has no staleness machinery: the barrier simply
                # waited — the delay is absorbed as round latency
                inj.note_delayed_arrival()
            if ckind:
                # quarantined contribution is dropped, but its barrier
                # slot must still release (a sync round can't wait on a
                # poisoned update forever)
                ok, _ = inj.model_validate(k, ckind, sim.t)
        if k is not None and ok:
            m.note_contribution(k)
        pending["n"] -= 1
        if pending["n"] <= 0:
            start = sim.t
            m.note_warmup_end(start)
            dt = model.agg_flops * max(1, K) / cluster.srv_flops

            def agg_done():
                m.note_srv_busy(start, sim.t, name="aggregate")
                m.aggregations += 1
                if hooks:
                    hooks.sync_aggregate()
                start_round()
            sim.after(dt, agg_done)

    install_fleet(sim, trace, active, bw)
    install_timeouts(sim, inj, active, trace)
    start_round()
    sim.run(duration)
    if inj is not None:
        inj.finalize(duration)
        m.faults = inj.report()
    return m


def _simulate_async_full(model: SimModel, cluster: SimCluster, *, duration,
                         H, buffer_size, hooks, churn, fleet, seed,
                         faults=None, fault_gate=None) -> Metrics:
    """Shared core of FedAsync (buffer_size=1) and FedBuff (buffer_size=Z)."""
    sim = Sim()
    K = cluster.K
    m = Metrics(K=K, duration=duration)
    inj = _resolve_injector(faults, fault_gate)
    t_iter = [3 * model.full_fwd_flops / cluster.dev_flops[k] for k in range(K)]
    trace = resolve_fleet(fleet, churn, cluster, duration)
    active = np.ones(K, bool)
    bw = cluster.dev_bw.astype(float).copy()
    if trace is not None:
        trace.apply(active, bw)
    srv = {"busy": False, "buffer": 0}
    queue: list[tuple] = []          # (device, chain epoch)
    # per-device chain discipline (as in simulate_fedoptima): a leave
    # bumps the epoch so the dead chain's pending callbacks can't revive
    # alongside the chain on_rejoin starts — without it one off->on flap
    # inside an iteration forks two concurrent chains forever
    running = np.zeros(K, bool)
    epoch = np.zeros(K, np.int64)

    def on_leave(k):
        running[k] = False
        epoch[k] += 1
        if _san.TRACING:
            _san.emit("sim.device_left", sim=sim, device=int(k),
                      epoch=int(epoch[k]))
        if _tr.TRACING:
            _tr.emit_instant(f"dev/{k}", "leave", sim.t)

    def on_rejoin(k):
        if _san.TRACING:
            _san.emit("sim.device_join", sim=sim, device=int(k),
                      epoch=int(epoch[k]))
        if _tr.TRACING:
            _tr.emit_instant(f"dev/{k}", "join", sim.t)
        dev_round(k)

    def dev_round(k):
        if not active[k] or running[k]:
            return
        running[k] = True
        if _san.TRACING:
            _san.emit("sim.chain_start", sim=sim, device=int(k),
                      epoch=int(epoch[k]))
        dev_train(k, H, epoch[k])

    def dev_train(k, h_left, e):
        if not active[k] or epoch[k] != e:
            return
        start = sim.t

        def done():
            if not active[k] or epoch[k] != e:
                return
            m.note_dev_busy(k, start, sim.t, name="train",
                            samples=model.batch_size)
            if hooks:
                hooks.device_iter(k, False)
            if h_left > 1:
                dev_train(k, h_left - 1, e)
            else:
                tx = model.full_model_bytes / bw[k]
                m.bytes_up += model.full_model_bytes
                extra, ckind = inj.tag_model_upload(k, sim.t) \
                    if inj is not None else (0.0, "")
                sim.after(tx + extra, arrive, k, e, ckind, extra > 0.0)
        sim.after(t_iter[k], done)

    def arrive(k, e, ckind="", delayed=False):
        if inj is not None and delayed:
            # async aggregation absorbs stale arrivals by design (FedAsync
            # α-decay / FedBuff buffer mixing)
            inj.note_delayed_arrival()
        if inj is not None and ckind:
            ok, backoff = inj.model_validate(k, ckind, sim.t)
            if not ok:
                # quarantined before the buffer: the device re-downloads
                # the current global after its strike backoff
                tx = model.full_model_bytes / bw[k] if active[k] else 0.0
                m.bytes_down += model.full_model_bytes if active[k] else 0.0
                sim.after(backoff + tx, model_back, k, e)
                return
        queue.append((k, e))
        srv["buffer"] += 1
        kick()

    def kick():
        if srv["busy"] or srv["buffer"] < buffer_size or not queue:
            return
        srv["busy"] = True
        start = sim.t
        m.note_warmup_end(start)
        batch = queue[:buffer_size]
        del queue[:buffer_size]
        srv["buffer"] -= len(batch)
        dt = model.agg_flops * len(batch) / cluster.srv_flops

        def agg_done():
            m.note_srv_busy(start, sim.t, name="aggregate")
            m.aggregations += 1
            for kk, _ in batch:
                m.note_contribution(kk)
            if hooks:
                for kk, _ in batch:
                    hooks.aggregate(kk)
            for kk, e in batch:
                tx = model.full_model_bytes / bw[kk] if active[kk] else 0.0
                m.bytes_down += model.full_model_bytes if active[kk] else 0.0
                sim.after(tx, model_back, kk, e)
            srv["busy"] = False
            kick()
        sim.after(dt, agg_done)

    def model_back(k, e):
        if epoch[k] != e:
            return      # pre-departure round: the live chain owns the device
        if _san.TRACING:
            _san.emit("sim.chain_end", sim=sim, device=int(k), epoch=int(e))
        running[k] = False
        dev_round(k)

    install_fleet(sim, trace, active, bw, on_leave=on_leave,
                  on_rejoin=on_rejoin)
    install_timeouts(sim, inj, active, trace, on_leave=on_leave,
                     on_rejoin=on_rejoin)
    for k in range(K):
        dev_round(k)
    sim.run(duration)
    if inj is not None:
        inj.finalize(duration)
        m.faults = inj.report()
    return m


def simulate_fedasync(model, cluster, *, duration, H=10, hooks=None,
                      churn=None, fleet=None, seed=0,
                      faults=None, fault_gate=None) -> Metrics:
    return _simulate_async_full(model, cluster, duration=duration, H=H,
                                buffer_size=1, hooks=hooks, churn=churn,
                                fleet=fleet, seed=seed, faults=faults,
                                fault_gate=fault_gate)


def simulate_fedbuff(model, cluster, *, duration, H=10, buffer_size=None,
                     hooks=None, churn=None, fleet=None, seed=0,
                     faults=None, fault_gate=None) -> Metrics:
    Z = buffer_size or max(2, cluster.K // 4)
    return _simulate_async_full(model, cluster, duration=duration, H=H,
                                buffer_size=Z, hooks=hooks, churn=churn,
                                fleet=fleet, seed=seed, faults=faults,
                                fault_gate=fault_gate)


# ---------------------------------------------------------------------------
# Offloading methods: SplitFed / PiPar / OAFL
# ---------------------------------------------------------------------------

def _simulate_split(model: SimModel, cluster: SimCluster, *, duration, H,
                    sync_agg: bool, pipeline: bool, hooks, churn, fleet,
                    seed, faults=None, fault_gate=None) -> Metrics:
    """Split-training protocol: per iteration the device sends activations,
    the server trains that device's server-side model and returns gradients.

    sync_agg=True  -> SplitFed/PiPar (round barrier across devices)
    pipeline=True  -> PiPar (device overlaps next fwd while waiting)
    sync_agg=False -> OAFL (async aggregation at round end, no barrier)
    """
    sim = Sim()
    K = cluster.K
    m = Metrics(K=K, duration=duration)
    inj = _resolve_injector(faults, fault_gate)
    trace = resolve_fleet(fleet, churn, cluster, duration)
    active = np.ones(K, bool)
    bw = cluster.dev_bw.astype(float).copy()
    if trace is not None:
        trace.apply(active, bw)
    srv = {"busy": False}
    srv_queue: list[tuple] = []
    barrier = {"n": 0}
    t_fwd = [model.dev_fwd_flops / cluster.dev_flops[k] for k in range(K)]
    t_bwd = [model.dev_bwd_flops / cluster.dev_flops[k] for k in range(K)]
    # chain discipline for the async (OAFL) restart path, mirroring
    # _simulate_async_full; under sync_agg there is no on_leave so epochs
    # stay 0 and the guards are inert (the barrier replays old behavior)
    running = np.zeros(K, bool)
    epoch = np.zeros(K, np.int64)

    def on_leave(k):
        running[k] = False
        epoch[k] += 1
        if _san.TRACING:
            _san.emit("sim.device_left", sim=sim, device=int(k),
                      epoch=int(epoch[k]))
        if _tr.TRACING:
            _tr.emit_instant(f"dev/{k}", "leave", sim.t)

    def on_rejoin(k):
        if _san.TRACING:
            _san.emit("sim.device_join", sim=sim, device=int(k),
                      epoch=int(epoch[k]))
        if _tr.TRACING:
            _tr.emit_instant(f"dev/{k}", "join", sim.t)
        dev_round(k)

    def dev_round(k):
        if not active[k] or running[k]:
            return
        running[k] = True
        # chain events only under async restarts: the sync barrier resets
        # ``running`` wholesale, a round (not chain) discipline that the
        # single-live-chain invariant does not describe
        if not sync_agg and _san.TRACING:
            _san.emit("sim.chain_start", sim=sim, device=int(k),
                      epoch=int(epoch[k]))
        dev_fwd(k, H, epoch[k])

    def dev_fwd(k, h_left, e):
        if not active[k] or epoch[k] != e:
            return
        start = sim.t

        def fwd_done():
            if not active[k] or epoch[k] != e:
                return
            m.note_dev_busy(k, start, sim.t, name="fwd")
            tx = model.act_bytes / bw[k]
            m.bytes_up += model.act_bytes
            if _tr.TRACING:
                _tr.emit_span(f"net/{k}", "act_upload", sim.t, sim.t + tx,
                              clip=True)
            sim.after(tx, srv_request, k, h_left, e)
            # PiPar: overlap — start next microbatch fwd while waiting
            if pipeline and h_left > 1:
                start2 = sim.t

                def fwd2_done():
                    # overlapped fwd rides a pipeline sub-lane: the device
                    # is genuinely busy twice over, which one lane cannot
                    # render without overlap
                    m.note_dev_busy(k, start2, sim.t, name="fwd_overlap",
                                    lane=f"dev/{k}/pipe")
                sim.after(t_fwd[k], fwd2_done)
        sim.after(t_fwd[k], fwd_done)

    def srv_request(k, h_left, e):
        srv_queue.append((k, h_left, e))
        kick()

    def kick():
        if srv["busy"] or not srv_queue:
            return
        srv["busy"] = True
        k, h_left, e = srv_queue.pop(0)
        start = sim.t
        m.note_warmup_end(start)
        dt = model.srv_flops_per_batch / cluster.srv_flops

        def done():
            m.note_srv_busy(start, sim.t, name="train_batch")
            m.srv_batches += 1
            m.note_contribution(k)
            if hooks:
                hooks.server_train(k)
            tx = model.act_bytes / bw[k] if active[k] else 0.0  # gradients back
            m.bytes_down += model.act_bytes if active[k] else 0.0
            sim.after(tx, dev_bwd, k, h_left, e)
            srv["busy"] = False
            kick()
        sim.after(dt, done)

    def dev_bwd(k, h_left, e):
        if not active[k] or epoch[k] != e:
            if sync_agg:
                barrier_arrive()
            return
        start = sim.t

        def bwd_done():
            if not active[k] or epoch[k] != e:
                if sync_agg:
                    barrier_arrive()
                return
            # PiPar already accounted the overlapped fwd busy time
            m.note_dev_busy(k, start, sim.t, name="bwd",
                            samples=model.batch_size)
            if hooks:
                hooks.device_iter(k, True)
            if h_left > 1:
                if pipeline:
                    # fwd of next batch already ran; go straight to upload
                    tx = model.act_bytes / bw[k]
                    m.bytes_up += model.act_bytes
                    sim.after(tx, srv_request, k, h_left - 1, e)
                else:
                    dev_fwd(k, h_left - 1, e)
            else:
                tx = model.dev_model_bytes / bw[k]
                m.bytes_up += model.dev_model_bytes
                extra, ckind = inj.tag_model_upload(k, sim.t) \
                    if inj is not None else (0.0, "")
                sim.after(tx + extra, model_arrive, k, e, ckind,
                          extra > 0.0)
        sim.after(t_bwd[k], bwd_done)

    def model_arrive(k, e, ckind="", delayed=False):
        if inj is not None and delayed:
            inj.note_delayed_arrival()
        if inj is not None and ckind:
            ok, backoff = inj.model_validate(k, ckind, sim.t)
            if not ok:
                if sync_agg:
                    # quarantined: the contribution is dropped but the
                    # barrier slot still releases
                    barrier_arrive()
                else:
                    # OAFL: skip aggregation; the device re-syncs after
                    # its strike backoff
                    tx = model.dev_model_bytes / bw[k] if active[k] else 0.0
                    m.bytes_down += model.dev_model_bytes \
                        if active[k] else 0.0
                    sim.after(backoff + tx, model_back, k, e)
                return
        if sync_agg:
            barrier_arrive()
        else:
            # OAFL: async aggregation immediately (serialized on server)
            start = sim.t
            m.note_warmup_end(start)
            dt = model.agg_flops / cluster.srv_flops

            def agg_done():
                m.note_srv_busy(start, sim.t, name="aggregate")
                m.aggregations += 1
                if hooks:
                    hooks.aggregate(k)
                tx = model.dev_model_bytes / bw[k] if active[k] else 0.0
                m.bytes_down += model.dev_model_bytes if active[k] else 0.0
                sim.after(tx, model_back, k, e)
            sim.after(dt, agg_done)

    def model_back(k, e):
        if epoch[k] != e:
            return      # pre-departure round: the live chain owns the device
        if _san.TRACING:
            _san.emit("sim.chain_end", sim=sim, device=int(k), epoch=int(e))
        running[k] = False
        dev_round(k)

    def barrier_arrive():
        barrier["n"] -= 1
        if barrier["n"] <= 0:
            start = sim.t
            m.note_warmup_end(start)
            dt = model.agg_flops * K / cluster.srv_flops

            def agg_done():
                m.note_srv_busy(start, sim.t, name="aggregate")
                m.aggregations += 1
                m.rounds += 1
                if hooks:
                    hooks.sync_aggregate()
                start_round()
            sim.after(dt, agg_done)

    def start_round():
        # the barrier owns round starts: no chain is outstanding here, so
        # every roster member begins fresh (running is a per-chain flag)
        running[:] = False
        expected = [k for k in range(K) if active[k]]
        if not expected:
            sim.after(1.0, start_round)
            return
        barrier["n"] = len(expected)
        for k in expected:
            tx = model.dev_model_bytes / bw[k]
            m.bytes_down += model.dev_model_bytes
            sim.after(tx, dev_round, k)

    install_fleet(sim, trace, active, bw,
                  on_leave=None if sync_agg else on_leave,
                  on_rejoin=None if sync_agg else on_rejoin)
    install_timeouts(sim, inj, active, trace,
                     on_leave=None if sync_agg else on_leave,
                     on_rejoin=None if sync_agg else on_rejoin)
    if sync_agg:
        start_round()
    else:
        for k in range(K):
            dev_round(k)
    sim.run(duration)
    if inj is not None:
        inj.finalize(duration)
        m.faults = inj.report()
    return m


def simulate_splitfed(model, cluster, *, duration, H=10, hooks=None,
                      churn=None, fleet=None, seed=0,
                      faults=None, fault_gate=None) -> Metrics:
    return _simulate_split(model, cluster, duration=duration, H=H,
                           sync_agg=True, pipeline=False, hooks=hooks,
                           churn=churn, fleet=fleet, seed=seed,
                           faults=faults, fault_gate=fault_gate)


def simulate_pipar(model, cluster, *, duration, H=10, hooks=None,
                   churn=None, fleet=None, seed=0,
                   faults=None, fault_gate=None) -> Metrics:
    return _simulate_split(model, cluster, duration=duration, H=H,
                           sync_agg=True, pipeline=True, hooks=hooks,
                           churn=churn, fleet=fleet, seed=seed,
                           faults=faults, fault_gate=fault_gate)


def simulate_oafl(model, cluster, *, duration, H=10, hooks=None,
                  churn=None, fleet=None, seed=0,
                  faults=None, fault_gate=None) -> Metrics:
    return _simulate_split(model, cluster, duration=duration, H=H,
                           sync_agg=False, pipeline=False, hooks=hooks,
                           churn=churn, fleet=fleet, seed=seed,
                           faults=faults, fault_gate=fault_gate)


REGISTRY = {
    "fl": simulate_classic_fl,
    "fedasync": simulate_fedasync,
    "fedbuff": simulate_fedbuff,
    "splitfed": simulate_splitfed,
    "pipar": simulate_pipar,
    "oafl": simulate_oafl,
}
