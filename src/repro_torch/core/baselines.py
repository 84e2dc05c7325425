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

A copy of the JAX package's ``core/baselines.py`` on the path with no plane
attached: the same events, pushed in the same order (``Sim`` breaks ties
in time by push order, so one push more, fewer or out of order would
reorder every later tie), and the same metrics, bit for bit.  The
``churn=``, ``fleet=``, ``faults=`` and ``fault_gate=`` planes are refused
with the ROADMAP item that brings them (A7), as ``simulate_fedoptima``
refuses them; their sanitizer and trace emits come with them.  The
departure state (``active``, ``epoch``, ``running``) and its guards are
kept as the reference has them: with no plane no device ever leaves, so
they never fire.  ``seed`` is unused, as in the reference.
"""
from __future__ import annotations

import numpy as np

from . import simulation
from .simulation import Metrics, Sim, SimCluster, SimModel, refuse_later

#: baseline arguments whose planes come with ROADMAP item A7:
#: argument -> (the value that means "off", the item that brings it).
LATER = {name: simulation.LATER[name]
         for name in ("churn", "fleet", "faults", "fault_gate")}


# ---------------------------------------------------------------------------
# Full-model methods: classic FL / FedAsync / FedBuff
# ---------------------------------------------------------------------------

def simulate_classic_fl(model: SimModel, cluster: SimCluster, *,
                        duration: float, H: int = 10, hooks=None,
                        churn=None, fleet=None, seed: int = 0,
                        faults=None, fault_gate=None) -> Metrics:
    refuse_later(LATER, "simulate_classic_fl", churn=churn, fleet=fleet,
                 faults=faults, fault_gate=fault_gate)
    sim = Sim()
    K = cluster.K
    m = Metrics(K=K, duration=duration)
    t_iter = [3 * model.full_fwd_flops / cluster.dev_flops[k] for k in range(K)]
    active = np.ones(K, bool)
    bw = cluster.dev_bw.astype(float).copy()
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
            m.note_dev_busy(k, start, sim.t, samples=model.batch_size)
            if hooks:
                hooks.device_iter(k, False)
            if h_left > 1:
                dev_train(k, h_left - 1)
            else:
                tx = model.full_model_bytes / bw[k]
                m.bytes_up += model.full_model_bytes
                sim.after(tx, arrive, k)
        sim.after(t_iter[k], done)

    def arrive(k):
        if k is not None:
            m.note_contribution(k)
        pending["n"] -= 1
        if pending["n"] <= 0:
            start = sim.t
            m.note_warmup_end(start)
            dt = model.agg_flops * max(1, K) / cluster.srv_flops

            def agg_done():
                m.note_srv_busy(start, sim.t)
                m.aggregations += 1
                if hooks:
                    hooks.sync_aggregate()
                start_round()
            sim.after(dt, agg_done)

    start_round()
    sim.run(duration)
    return m


def _simulate_async_full(model: SimModel, cluster: SimCluster, *, duration,
                         H, buffer_size, hooks, churn, fleet, seed,
                         faults=None, fault_gate=None) -> Metrics:
    """Shared core of FedAsync (buffer_size=1) and FedBuff (buffer_size=Z)."""
    refuse_later(LATER, "_simulate_async_full", churn=churn, fleet=fleet,
                 faults=faults, fault_gate=fault_gate)
    sim = Sim()
    K = cluster.K
    m = Metrics(K=K, duration=duration)
    t_iter = [3 * model.full_fwd_flops / cluster.dev_flops[k] for k in range(K)]
    active = np.ones(K, bool)
    bw = cluster.dev_bw.astype(float).copy()
    srv = {"busy": False, "buffer": 0}
    queue: list[tuple] = []          # (device, chain epoch)
    # per-device chain discipline (as in simulate_fedoptima): a departure
    # (A7's planes) bumps the epoch so the dead chain's pending callbacks
    # cannot revive beside the chain a rejoin starts
    running = np.zeros(K, bool)
    epoch = np.zeros(K, np.int64)

    def dev_round(k):
        if not active[k] or running[k]:
            return
        running[k] = True
        dev_train(k, H, epoch[k])

    def dev_train(k, h_left, e):
        if not active[k] or epoch[k] != e:
            return
        start = sim.t

        def done():
            if not active[k] or epoch[k] != e:
                return
            m.note_dev_busy(k, start, sim.t, samples=model.batch_size)
            if hooks:
                hooks.device_iter(k, False)
            if h_left > 1:
                dev_train(k, h_left - 1, e)
            else:
                tx = model.full_model_bytes / bw[k]
                m.bytes_up += model.full_model_bytes
                sim.after(tx, arrive, k, e)
        sim.after(t_iter[k], done)

    def arrive(k, e):
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
            m.note_srv_busy(start, sim.t)
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
        running[k] = False
        dev_round(k)

    for k in range(K):
        dev_round(k)
    sim.run(duration)
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
    refuse_later(LATER, "_simulate_split", churn=churn, fleet=fleet,
                 faults=faults, fault_gate=fault_gate)
    sim = Sim()
    K = cluster.K
    m = Metrics(K=K, duration=duration)
    active = np.ones(K, bool)
    bw = cluster.dev_bw.astype(float).copy()
    srv = {"busy": False}
    srv_queue: list[tuple] = []
    barrier = {"n": 0}
    t_fwd = [model.dev_fwd_flops / cluster.dev_flops[k] for k in range(K)]
    t_bwd = [model.dev_bwd_flops / cluster.dev_flops[k] for k in range(K)]
    # chain discipline for OAFL's restarts, as in _simulate_async_full;
    # under sync_agg the barrier owns round starts and the epochs stay 0
    running = np.zeros(K, bool)
    epoch = np.zeros(K, np.int64)

    def dev_round(k):
        if not active[k] or running[k]:
            return
        running[k] = True
        dev_fwd(k, H, epoch[k])

    def dev_fwd(k, h_left, e):
        if not active[k] or epoch[k] != e:
            return
        start = sim.t

        def fwd_done():
            if not active[k] or epoch[k] != e:
                return
            m.note_dev_busy(k, start, sim.t)
            tx = model.act_bytes / bw[k]
            m.bytes_up += model.act_bytes
            sim.after(tx, srv_request, k, h_left, e)
            # PiPar: overlap — start next microbatch fwd while waiting
            if pipeline and h_left > 1:
                start2 = sim.t

                def fwd2_done():
                    # the overlapped forward counts as device busy time on
                    # top of the waiting forward's, as in the reference
                    m.note_dev_busy(k, start2, sim.t)
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
            m.note_srv_busy(start, sim.t)
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
            m.note_dev_busy(k, start, sim.t, samples=model.batch_size)
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
                sim.after(tx, model_arrive, k, e)
        sim.after(t_bwd[k], bwd_done)

    def model_arrive(k, e):
        if sync_agg:
            barrier_arrive()
        else:
            # OAFL: async aggregation immediately (serialized on server)
            start = sim.t
            m.note_warmup_end(start)
            dt = model.agg_flops / cluster.srv_flops

            def agg_done():
                m.note_srv_busy(start, sim.t)
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
        running[k] = False
        dev_round(k)

    def barrier_arrive():
        barrier["n"] -= 1
        if barrier["n"] <= 0:
            start = sim.t
            m.note_warmup_end(start)
            dt = model.agg_flops * K / cluster.srv_flops

            def agg_done():
                m.note_srv_busy(start, sim.t)
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

    if sync_agg:
        start_round()
    else:
        for k in range(K):
            dev_round(k)
    sim.run(duration)
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
