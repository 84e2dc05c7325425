"""Host control plane: Alg. 2–4 driving the hybrid step.

The bridge between the paper's host-side algorithms — the Task Scheduler
(Alg. 2/3), memory-bounded flow control (§3.4.1) and staleness-weighted
aggregation (Alg. 4) — and ``fedopt_step.make_train_step``.  Everything
data-dependent is planned here on the host and shipped into the step as
small dense fields.  Per round, :meth:`ControlPlane.plan_round` emits a
:class:`RoundPlan`:

    read_slot[h]    ring slot the server trains on at micro-iteration h
                    (Alg. 3: the least-served group's contribution)
    write_slot[h]   slot the devices' emission lands in
    send_mask[h,g]  1 if group g holds a token and ships its rows
    agg_weight[g]   α_g = (staleness_g + 1)^-alpha_power, 0 beyond the
                    staleness cap D or for inactive groups
    bcast_mask[g]   1 if group g receives the aggregated model back

plus the ``retire``/``restore`` group lists for dropped and rejoining
groups, whose dev/aux params the driver moves through the
:class:`RetentionStore`.

Tiered memory (``repro_torch.memory``): with ``pool_cap > 0`` the ω-ring is
tier 0 of a two-tier store.  When every ring slot holds unconsumed
contributions, ``plan_round`` no longer gates all sends: it plans an
eviction (a policy-chosen victim slot goes to the host spill pool) so the
write can land, and fills pooled entries back into free slots at the next
round boundary.  The moves ride the plan as ``spill``/``fill`` lists (slot
and pool-key pairs); the executor performs them against an
:class:`~repro_torch.memory.store.ActivationStore` BEFORE the round is
dispatched, so every spill holds pre-round ring content (a slot written
this round is never a victim).  Flow control admits against the total
tiered budget ω + pool_cap, so Σ buffered ≤ (ω + pool_cap) · units is the
``within_cap`` invariant; with ``pool_cap == 0`` every path is the hard-ω
behaviour, bit for bit.

The same class fronts the event simulator (``simulation.py``): there the
scheduler and flow units are per-device activation batches, which the
simulator drives in event order, with the per-arrival staleness hooks
(``aggregate_arrival``, ``device_synced``); :meth:`ControlPlane.for_sim`
builds that configuration, whose spill budget is the flow controller's
arithmetic alone.

A copy of the JAX package's control plane, its sanitizer and trace emits
included, without its plan checkpointing (``state_dict``) and its advisory
prefetch (``plan_round(lookahead=)``, ``RoundPlan.prefetch``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.analysis import sanitize as _san
from repro_torch.memory.policy import make_eviction_policy
from repro_torch.obs import trace as _tr
from repro_torch.obs.clock import now as _now

from .aggregator import staleness_weight
from .flow_control import FlowController
from .scheduler import Message, TaskScheduler
from .staging import to_device


@dataclass(frozen=True)
class RoundPlan:
    """One round's host-planned schedule, consumed by the step."""
    read_slot: np.ndarray    # (H,) int32
    write_slot: np.ndarray   # (H,) int32
    send_mask: np.ndarray    # (H, G) float32
    agg_weight: np.ndarray   # (G,) float32
    bcast_mask: np.ndarray = None   # (G,) float32; None -> all receive
    retire: tuple = ()       # groups that just dropped: gather to retention
    restore: tuple = ()      # rejoining groups: scatter retained state back
    # tiered-store moves, performed by the executor at the round boundary
    # (fills BEFORE spills, so the pool never transiently exceeds its cap)
    fill: tuple = ()         # (pool_key, slot): pool entry -> free ring slot
    spill: tuple = ()        # (slot, pool_key): evicted ring slot -> pool

    def batch_fields(self, device) -> dict:
        """The plan as step batch fields: the masks and weights as tensors
        on ``device`` (copied through pinned buffers, so no stream sync),
        the slot indices as host tensors, which the step reads on the
        host."""
        bcast = self.bcast_mask if self.bcast_mask is not None else \
            np.ones(self.send_mask.shape[1], np.float32)
        host = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int64)
        return {"read_slot": host(self.read_slot),
                "write_slot": host(self.write_slot),
                "send_mask": to_device(self.send_mask, device, torch.float32),
                "agg_weight": to_device(self.agg_weight, device,
                                        torch.float32),
                "bcast_mask": to_device(bcast, device, torch.float32)}


class RetentionStore:
    """Host-side per-group dev/aux retention for dropped groups (§3.4.2):
    a group rejoins from its OWN last-synced params at its recorded
    staleness instead of being resynced by the aggregation broadcast."""

    def __init__(self):
        self._held: dict[int, dict] = {}

    def retain(self, g: int, params, version: int):
        self._held[int(g)] = {"params": params, "version": int(version)}

    def release(self, g: int) -> dict:
        return self._held.pop(int(g))

    def __contains__(self, g) -> bool:
        return int(g) in self._held

    def __len__(self) -> int:
        return len(self._held)

    @property
    def groups(self) -> list[int]:
        return sorted(self._held)

    def version_of(self, g: int) -> int:
        return self._held[int(g)]["version"]

    def params_of(self, g: int):
        return self._held[int(g)]["params"]


class ControlPlane:
    """TaskScheduler + FlowController + staleness accounting, round-planned.

    ``unit`` is the flow-control granularity: "group" for the pod path
    (one unit = one group's rows in a slot; token budget ω·G) and "device"
    for the event simulator (one unit = one device activation batch;
    budget ω, the paper's strict Eq. 3 bookkeeping, tiered by pool_cap).
    """

    def __init__(self, n_groups: int, omega: int, H: int = 1, *,
                 policy: str = "counter", max_delay: int = 16,
                 alpha_power: float = 1.0, unit: str = "group",
                 pool_cap: int = 0, eviction: str = "share"):
        if omega < 1 or n_groups < 1:
            raise ValueError(
                f"need omega >= 1 and n_groups >= 1, got omega={omega}, "
                f"n_groups={n_groups} (ω is the Eq. 3 activation cap)")
        if pool_cap < 0:
            raise ValueError(f"pool_cap must be >= 0, got {pool_cap}")
        if unit not in ("group", "device"):
            raise ValueError(
                f"unknown flow unit {unit!r}; expected 'group' (pod path) "
                "or 'device' (event simulator)")
        self.G = n_groups
        self.omega = omega
        self.H = H
        self.max_delay = max_delay
        self.alpha_power = alpha_power
        self.unit = unit
        self.pool_cap = pool_cap
        self.mem_policy = make_eviction_policy(eviction)
        self.scheduler = TaskScheduler(n_groups, policy=policy)
        per_unit = n_groups if unit == "group" else 1
        self.flow = FlowController(omega=omega * per_unit,
                                   pool_cap=pool_cap * per_unit)
        for g in range(n_groups):
            self.flow.register(g)
        self.versions = np.zeros(n_groups, np.int64)   # t_g
        self.version = 0                               # t (global model)
        self.retention = RetentionStore()
        self.prev_active = np.ones(n_groups, bool)     # last round's roster
        self.n_accepted = 0
        self.n_rejected = 0
        self.peak_buffered = 0        # peak Σ|Q_act| in flow units
        self.peak_live_slots = 0      # peak occupied ring slots (pod path)
        self._slot_groups = [set() for _ in range(omega)]
        self._next_write = 0
        self._last_read = 0
        # -- spill tier (pod path; slot granularity) --
        self._pool: dict[int, tuple] = {}   # pool key -> contributor groups
        self._next_pool_key = 0
        self._slot_touch = [0] * omega      # last tick written/filled (LRU)
        self._tick = 0
        self.n_spills = 0
        self.n_fills = 0
        self.peak_pool = 0                  # peak occupied pool entries

    @classmethod
    def for_sim(cls, n_devices: int, omega: int, **kw):
        """Control plane for the event simulator: per-device flow units so
        Σ_k |Q_k^act| ≤ ω holds exactly as written in Eq. 3."""
        return cls(n_devices, omega, unit="device", **kw)

    # ------------------------------------------------------------------
    # plan one round of H micro-iterations
    # ------------------------------------------------------------------

    def plan_round(self, active=None, produce=None, reads=None) -> RoundPlan:
        """Plan H micro-iterations and commit the bookkeeping.

        active : (G,) bool — groups participating in this round.
        produce : (H, G) bool — which groups emit at each micro-iteration;
            default: every active group every h.
        reads : (H,) bool — micro-iterations at which the server consumes a
            new scheduled batch; default all.  A False entry replays an
            already-consumed slot.
        """
        tp0 = _now() if _tr.TRACING else 0.0
        G, H = self.G, self.H
        active = np.ones(G, bool) if active is None else \
            np.asarray(active, bool)
        produce = np.tile(active, (H, 1)) if produce is None else \
            np.asarray(produce, bool) & active[None, :]
        reads = np.ones(H, bool) if reads is None else np.asarray(reads, bool)

        retire = tuple(int(g)
                       for g in np.flatnonzero(self.prev_active & ~active))
        restore = tuple(int(g)
                        for g in np.flatnonzero(~self.prev_active & active)
                        if int(g) in self.retention)
        self.prev_active = active.copy()

        # tiered store: round-boundary moves.  Fills first (pooled entries
        # return to free ring slots, scheduler-priority order); spills are
        # planned by _plan_write when the ring is full.  Both run before
        # dispatch, so only pre-round ring content may spill
        self._tick += 1
        fill = self._plan_fills()
        self._round_filled = {s for _, s in fill}
        self._round_written: set[int] = set()
        self._round_spills: list[tuple[int, int]] = []

        read_slot = np.zeros(H, np.int32)
        write_slot = np.zeros(H, np.int32)
        send_mask = np.zeros((H, G), np.float32)
        for h in range(H):
            # the server reads the ring from before this iteration's write
            read_slot[h] = self._plan_read(consume=bool(reads[h]))
            write_slot[h] = self._plan_write(produce[h], send_mask[h])

        plan = RoundPlan(read_slot=read_slot, write_slot=write_slot,
                         send_mask=send_mask,
                         agg_weight=self.agg_weights(active),
                         bcast_mask=active.astype(np.float32),
                         retire=retire, restore=restore,
                         fill=fill, spill=tuple(self._round_spills))
        if _san.TRACING:
            _san.emit("cp.plan", cp=self, plan=plan,
                      version=int(self.version),
                      live_slots=self.live_slots, pool_live=self.pool_live)
        if _tr.TRACING:
            _tr.emit_span("host/control", "plan_round", tp0, _now(),
                          version=int(self.version))
        return plan

    def retain_group(self, g: int, params):
        """Hold a dropped group's dev/aux params at its last-synced version."""
        self.retention.retain(g, params, version=int(self.versions[g]))

    def release_group(self, g: int) -> dict:
        """Pop a rejoining group's retained entry ({"params", "version"})."""
        return self.retention.release(g)

    def _plan_read(self, consume: bool) -> int:
        """Pick the slot the server trains on (Alg. 3 at slot granularity)."""
        if not consume or not self.scheduler.has_activation:
            # cold start or a stalled tick: replay a slot with no live
            # contributions, else the last consumed one
            for d in range(self.omega):
                s = (self._last_read + d) % self.omega
                if not self._slot_groups[s]:
                    return s
            return self._last_read
        msg = self.scheduler.get()
        s = msg.content
        contributors = sorted(self._slot_groups[s])
        self.scheduler.drain_slot(s, [g for g in contributors
                                      if g != msg.origin])
        for g in contributors:
            self.flow.on_dequeue(g)
        self._slot_groups[s].clear()
        self._last_read = s
        return s

    def _plan_write(self, offer: np.ndarray, mask_row: np.ndarray) -> int:
        """Allocate a free ring slot and grant sends into it.  When every
        slot holds unconsumed contributions and the spill pool has room, a
        policy-chosen victim slot is evicted to the host tier so the write
        can land; only when the total tiered budget is spent does nobody
        send (a masked no-op write: the ω + pool_cap cap)."""
        order = [int(g) for g in
                 sorted(np.flatnonzero(offer),
                        key=lambda g: (self.scheduler.counters.get(g, 0), g))
                 if self.flow.can_send(g)]
        w = self._free_slot()
        if w is None and order:
            w = self._spill_for_write()      # evict to the host tier
        if w is None:
            return int(self._next_write)
        for g in order:
            self.flow.mark_sent(g)
            self.flow.on_enqueue(g)          # lockstep: arrival is immediate
            self.scheduler.put(Message("activation", g, content=w))
            self._slot_groups[w].add(g)
            mask_row[g] = 1.0
        if self._slot_groups[w]:
            self._next_write = (w + 1) % self.omega
            self._round_written.add(w)
            self._slot_touch[w] = self._tick
        self.peak_buffered = max(self.peak_buffered, self.flow.buffered)
        self.peak_live_slots = max(self.peak_live_slots, self.live_slots)
        return w

    def _free_slot(self) -> int | None:
        for d in range(self.omega):
            s = (self._next_write + d) % self.omega
            if not self._slot_groups[s]:
                return s
        return None

    # ------------------------------------------------------------------
    # tiered store planning (repro_torch.memory; pod path, slot granularity)
    # ------------------------------------------------------------------

    def _plan_fills(self) -> tuple:
        """Move pooled entries back into free ring slots at the round
        boundary, the policy's ``fill_order`` first; re-``put`` each
        contribution so Alg. 3 can serve it this round."""
        if not self._pool:
            return ()
        free = [s for s in range(self.omega) if not self._slot_groups[s]]
        if not free:
            # a stalled full ring is the pool's steady state: skip the
            # policy's ranking when nothing could be filled anyway
            return ()
        order = self.mem_policy.fill_order(
            list(self._pool), groups_of=lambda k: self._pool[k],
            share=self.consumption_share)
        moves = []
        for key, s in zip(order, free):
            groups = self._pool.pop(key)
            self._slot_groups[s] = set(groups)
            self._slot_touch[s] = self._tick
            for g in groups:
                self.scheduler.put(Message("activation", int(g),
                                           content=int(s)))
            moves.append((int(key), int(s)))
            self.n_fills += 1
        return tuple(moves)

    def _spill_for_write(self) -> int | None:
        """Evict one live ring slot to the host pool, freeing it for this
        write.  Victims must hold PRE-round content (the spill happens
        before dispatch): slots written this round are not eligible; slots
        filled this round only as a last resort (the executor runs fills
        before spills, so the round trip is consistent, just wasted
        bandwidth the policies avoid)."""
        if len(self._pool) >= self.pool_cap:
            return None
        live = [s for s in range(self.omega)
                if self._slot_groups[s] and s not in self._round_written]
        candidates = [s for s in live if s not in self._round_filled] or live
        if not candidates:
            return None
        s = self.mem_policy.victim(
            candidates, groups_of=lambda t: self._slot_groups[t],
            share=self.consumption_share, touch=self._slot_touch)
        key = self._next_pool_key
        self._next_pool_key += 1
        groups = tuple(sorted(self._slot_groups[s]))
        # the buffered contributions follow the payload to the host tier:
        # withdrawn from the scheduler (no consumption counted), re-put on
        # fill; their flow budget stays held, as they are still buffered
        self.scheduler.withdraw_slot(s, groups)
        self._pool[key] = groups
        self._slot_groups[s].clear()
        self._round_spills.append((int(s), int(key)))
        self.n_spills += 1
        self.peak_pool = max(self.peak_pool, len(self._pool))
        return s

    # ------------------------------------------------------------------
    # staleness-weighted aggregation bookkeeping (Alg. 4)
    # ------------------------------------------------------------------

    def agg_weights(self, active=None) -> np.ndarray:
        """Per-group α from real staleness counters (Alg. 4 lines 13/16);
        may be all-zero, which the step treats as "keep current params"."""
        active = np.ones(self.G, bool) if active is None else \
            np.asarray(active, bool)
        return np.array([staleness_weight(self.version - int(self.versions[g]),
                                          self.max_delay, self.alpha_power)
                         if active[g] else 0.0 for g in range(self.G)],
                        np.float32)

    def finish_round(self, active=None):
        """End-of-round accounting: one round is one aggregation event;
        every participant syncs to the new global model (Alg. 4 l. 12-20)."""
        tf0 = _now() if _tr.TRACING else 0.0
        active = np.ones(self.G, bool) if active is None else \
            np.asarray(active, bool)
        t = self.version
        accepted = [g for g in np.flatnonzero(active)
                    if staleness_weight(t - int(self.versions[g]),
                                        self.max_delay,
                                        self.alpha_power) > 0.0]
        self.n_accepted += len(accepted)
        self.n_rejected += int(active.sum()) - len(accepted)
        if not accepted:
            # every update rejected: no aggregation event, nobody resyncs
            if _san.TRACING:
                _san.emit("cp.finish", cp=self, version_before=int(t),
                          version_after=int(t), n_accepted=0)
            if _tr.TRACING:
                _tr.emit_span("host/control", "finish_round", tf0, _now(),
                              n_accepted=0)
            return
        self.version = t + 1
        for g in np.flatnonzero(active):
            self.versions[g] = self.version
        if _san.TRACING:
            _san.emit("cp.finish", cp=self, version_before=int(t),
                      version_after=int(self.version),
                      n_accepted=len(accepted))
        if _tr.TRACING:
            _tr.emit_span("host/control", "finish_round", tf0, _now(),
                          n_accepted=len(accepted))

    # -- event-simulator staleness hooks (per arrival; the version always
    #    advances: the simulator counts every aggregation event) --
    def aggregate_arrival(self, k: int, t_k: int) -> float:
        """One device model arrived (sim path): returns its α (0 =
        rejected as too stale, Alg. 4 line 13)."""
        t = self.version
        w = staleness_weight(t - int(t_k), self.max_delay,
                             self.alpha_power)
        if w > 0.0:
            self.n_accepted += 1
        else:
            self.n_rejected += 1
        self.version = t + 1
        if _san.TRACING:
            _san.emit("cp.arrival", cp=self, device=int(k), t_k=int(t_k),
                      weight=float(w), version_before=int(t))
        return w

    def device_synced(self, k: int):
        """Device k received the global model back (Alg. 4 line 20)."""
        self.versions[k] = self.version
        if _san.TRACING:
            _san.emit("cp.synced", cp=self, device=int(k),
                      version=int(self.version))

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    @property
    def live_slots(self) -> int:
        return sum(1 for s in self._slot_groups if s)

    @property
    def slot_occupancy(self) -> list[list[int]]:
        """Per-ring-slot live contributions (group ids), slot order."""
        return [sorted(s) for s in self._slot_groups]

    @property
    def consumption(self) -> dict[int, int]:
        return dict(self.scheduler.counters)

    def consumption_share(self, g: int) -> float:
        total = sum(self.scheduler.counters.values())
        return self.scheduler.counters.get(g, 0) / max(total, 1)

    @property
    def pool_live(self) -> int:
        """Occupied host spill-pool entries (pod path)."""
        return len(self._pool)

    @property
    def pool_occupancy(self) -> dict:
        """Pool key -> contributor groups, key order."""
        return {k: list(self._pool[k]) for k in sorted(self._pool)}

    @property
    def within_cap(self) -> bool:
        """Σ|Q_act| ≤ ω + pool_cap in flow units, live ring slots ≤ ω and
        occupied pool entries ≤ pool_cap (the tiered Eq. 3)."""
        return (self.flow.within_cap and self.live_slots <= self.omega
                and len(self._pool) <= self.pool_cap)

    def note_buffered(self, n: int):
        """Record an externally observed buffer occupancy (sim path)."""
        self.peak_buffered = max(self.peak_buffered, n)

    def memory_summary(self) -> dict:
        """JSON-able tier accounting: spill/fill/eviction counts + peaks.
        The pod path counts at slot granularity (one spill = one ring slot
        of all its contributions); the event simulator has no ring, so its
        counts come from the flow controller, one per device activation
        batch admitted past ω."""
        out = {"omega": self.omega, "pool_cap": self.pool_cap,
               "eviction": self.mem_policy.name,
               "peak_buffered": int(self.peak_buffered)}
        if self.unit == "group":
            # every pod-path spill IS a victim selection, so evictions is
            # derived, not a second counter to keep in step
            out.update(spills=self.n_spills, fills=self.n_fills,
                       evictions=self.n_spills,
                       pool_live=len(self._pool),
                       peak_pool=int(self.peak_pool),
                       peak_live_slots=int(self.peak_live_slots))
        else:
            out.update(spills=self.flow.n_spilled, fills=self.flow.n_filled,
                       evictions=0)
        return out
