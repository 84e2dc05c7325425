"""Tiered server activation store: the host spill tier behind the ω-ring.

The activation ring on the card (``fedopt_step`` ``state["act_buf"]``, ω
slots) is tier 0, a cache.  :class:`ActivationStore` is tier 1: a host
pool of up to ``pool_cap`` spilled ring slots, optionally int8-quantised
(per tensor, with ``_quant``/``_dequant`` from ``core/fedopt_step.py``;
integer leaves such as labels and tokens are stored verbatim, only float
activations quantise).

Division of labour: the :class:`~repro_torch.core.control_plane.ControlPlane`
plans WHICH logical slots move between tiers (``RoundPlan.spill`` /
``RoundPlan.fill`` and the contributor bookkeeping); this store owns the
host copies and the byte accounting per tier.  The
:class:`~repro_torch.core.executor.RoundExecutor` bridges the two at round
boundaries, inside the in-flight window.

On the card every move stays on the stream.  A spill quantises a slot's
float leaves on the card (under ``quant``) and copies the result into
pinned host memory with ``non_blocking=True``; a fill copies the stored
form back to the device the slot came from, again without blocking, and
dequantises there.  The host never reads a payload's values: the byte
accounting uses shapes and dtypes only.  Off the card the same code makes
plain host copies.

The torch form of the JAX package's ``memory/store.py``.  Its advisory
prefetch and its checkpoint riding are not ported.
"""
from __future__ import annotations

import torch

from repro_torch.analysis import sanitize as _san
from repro_torch.obs import trace as _tr
from repro_torch.obs.clock import now as _now
from repro_torch.obs.metrics import MetricsRegistry


def _to_host(x: torch.Tensor) -> torch.Tensor:
    """A host copy of ``x`` that later writes to ``x`` do not reach: from
    the card into pinned memory, enqueued on the current stream (no host
    sync); on the host a plain clone."""
    x = x.detach()
    if not x.is_cuda:
        return x.clone()
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return out.copy_(x, non_blocking=True)


def _to_device(x: torch.Tensor, device) -> torch.Tensor:
    """``x`` on ``device``; from pinned memory without blocking."""
    if device is None or torch.device(device) == x.device:
        return x
    return x.to(device, non_blocking=True)


def _quant_leaf(x: torch.Tensor) -> dict:
    """Per-tensor int8 spill encoding (fedopt_step's aggregation quant),
    computed where ``x`` lies and then copied to the host."""
    from repro_torch.core.fedopt_step import _quant
    q, scale = _quant(x.detach())
    return {"q": _to_host(q), "scale": _to_host(scale)}


def _is_quant_leaf(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def _dequant_leaf(e: dict, dtype=torch.float32, device=None) -> torch.Tensor:
    """Copy an int8 leaf to ``device`` (default: leave it on the host) and
    dequantise it there."""
    from repro_torch.core.fedopt_step import _dequant
    return _dequant((_to_device(e["q"], device),
                     _to_device(e["scale"], device))).to(dtype)


def _encode(payload: dict, quant: bool) -> dict:
    out = {}
    for k, v in payload.items():
        if quant and v.is_floating_point():
            out[k] = _quant_leaf(v)
        else:
            out[k] = _to_host(v)
    return out


def _decode(stored: dict, dtypes: dict | None = None,
            devices: dict | None = None) -> dict:
    out = {}
    for k, v in stored.items():
        device = (devices or {}).get(k)
        if _is_quant_leaf(v):
            out[k] = _dequant_leaf(v, (dtypes or {}).get(k, torch.float32),
                                   device)
        else:
            out[k] = _to_device(v, device)
    return out


def _nbytes(tree: dict) -> int:
    """Bytes held, from shapes and dtypes alone (never the values, which
    may still be on their way from the card)."""
    total = 0
    for v in tree.values():
        for x in (v["q"], v["scale"]) if _is_quant_leaf(v) else (v,):
            total += x.numel() * x.element_size()
    return int(total)


class ActivationStore:
    """Host pool of spilled ring slots, with per-tier byte accounting.

    Entries are keyed by the control plane's monotone pool keys.  The
    stored form is int8 + scale for quantised float leaves; :meth:`fill`
    hands each leaf back on the device it was spilled from, dequantised
    there, with its original dtype.
    """

    def __init__(self, pool_cap: int, *, quant: bool = False,
                 metrics=None):
        if pool_cap < 0:
            raise ValueError(f"pool_cap must be >= 0, got {pool_cap}")
        self.pool_cap = pool_cap
        self.quant = quant
        self._pool: dict[int, dict] = {}   # key -> {"payload", "quant",
                                           #   "dtypes", "devices"}
        # registry-backed accounting (the legacy counter names below are
        # read-only properties over these instruments)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._c_spills = self.metrics.counter("store.spills")
        self._c_fills = self.metrics.counter("store.fills")
        self._g_pool_bytes = self.metrics.gauge("store.pool_bytes")
        self._g_entries = self.metrics.gauge("store.entries")

    # legacy counter names, read-only over the registry instruments
    @property
    def n_spills(self) -> int:
        return int(self._c_spills.value)

    @property
    def n_fills(self) -> int:
        return int(self._c_fills.value)

    @property
    def pool_bytes(self) -> int:
        return int(self._g_pool_bytes.value)

    @property
    def peak_pool_bytes(self) -> int:
        return int(self._g_pool_bytes.peak)

    @property
    def peak_entries(self) -> int:
        return int(self._g_entries.peak)

    def __len__(self) -> int:
        return len(self._pool)

    def __contains__(self, key) -> bool:
        return int(key) in self._pool

    @property
    def keys(self) -> list[int]:
        return sorted(self._pool)

    # ------------------------------------------------------------------
    # tier transfers
    # ------------------------------------------------------------------

    def spill(self, key: int, payload: dict) -> None:
        """Admit one gathered ring slot (a flat dict of tensors, on the
        card or the host, or numpy arrays)."""
        key = int(key)
        if key in self._pool:
            raise KeyError(f"pool key {key} already holds a spilled slot")
        if len(self._pool) >= self.pool_cap:
            raise RuntimeError(
                f"spill pool full ({len(self._pool)}/{self.pool_cap} "
                f"slots): the control plane planned a spill past pool_cap")
        payload = {k: torch.as_tensor(v) for k, v in payload.items()}
        stored = _encode(payload, self.quant)
        self._pool[key] = {"payload": stored, "quant": self.quant,
                           "dtypes": {k: v.dtype for k, v in payload.items()},
                           "devices": {k: v.device
                                       for k, v in payload.items()}}
        self._c_spills.inc()
        self._g_pool_bytes.add(_nbytes(stored))
        self._g_entries.set(len(self._pool))
        if _san.TRACING:
            _san.emit("store.spill", store=self, key=key,
                      entries=len(self._pool))
        if _tr.TRACING:
            _tr.emit_instant("host/memory", "spill", _now(), key=key,
                             entries=len(self._pool))

    def fill(self, key: int) -> dict:
        """Pop one entry, each leaf on the device it was spilled from,
        dequantised, ready to scatter back into the ring."""
        e = self._pool.pop(int(key))
        self._c_fills.inc()
        self._g_pool_bytes.add(-_nbytes(e["payload"]))
        self._g_entries.set(len(self._pool))
        if _san.TRACING:
            _san.emit("store.fill", store=self, key=int(key),
                      entries=len(self._pool))
        if _tr.TRACING:
            _tr.emit_instant("host/memory", "fill", _now(), key=int(key),
                             entries=len(self._pool))
        return _decode(e["payload"], e["dtypes"], e["devices"])

    # ------------------------------------------------------------------

    def summary(self) -> dict:
        """JSON-able accounting for logs and records."""
        return {"pool_cap": self.pool_cap, "spill_quant": self.quant,
                "pool_entries": len(self._pool),
                "peak_pool_entries": self.peak_entries,
                "pool_bytes": int(self.pool_bytes),
                "peak_pool_bytes": int(self.peak_pool_bytes),
                "store_spills": self.n_spills, "store_fills": self.n_fills}
