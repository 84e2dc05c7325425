"""Round handles: one round's state, kept safe from the next round's
in-place updates.

The port's step updates ``dev``, ``aux`` and the activation ring in place
(the JAX step donates its state instead).  Any reference the driver keeps
into round r's state therefore reads round r+1's values once round r+1's
kernels have run.  A :class:`RoundHandle` keeps round r's values:

* **a copy on the card, in stream order** — one ``clone`` per captured
  tensor, enqueued on the current stream right after round r's step.  It
  runs after round r and before round r+1's in-place updates.  An event
  recorded after the clones marks them done.
* **a staged copy to the host** — ``to_host`` copies the clones into
  pinned memory with ``non_blocking=True``, on a side stream that first
  waits on that event.  ``ready()`` queries the handle's own events, never
  the device, and ``host_tree()`` waits on them alone, never on the
  rounds dispatched after it.
* **slices** — ``group_state(g)`` stages one group's rows and waits on
  that copy alone: the retention gather of a dropped group.

A :class:`HandleRing` keeps the last ``depth`` handles, with byte
accounting.  The torch form of the JAX package's ``core/handles.py``,
without its activation-slot slice (``act_slot``): the port's spill reads
the live ring in stream order (``fedopt_step.gather_act_slot``).
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from repro_torch.models.common import tree_leaves, tree_map


def _on_card(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_cuda


def _card_of(tree):
    return next((x.device for x in tree_leaves(tree) if _on_card(x)), None)


def _after_current(tree):
    """An event on the current stream, after everything enqueued so far;
    None when no leaf is on the card."""
    device = _card_of(tree)
    if device is None:
        return None
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    return done


def _leaf_copy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, np.ndarray):
        return np.array(x, copy=True)
    return x


def snapshot_tree(tree):
    """A copy of ``tree`` that later in-place updates do not reach: one
    ``clone`` per tensor, enqueued on the current stream (so in stream
    order after the work that wrote it), numpy leaves copied on the host,
    scalars passed through."""
    return tree_map(_leaf_copy, tree)


def _to_host(tree, after):
    """Host copies of ``tree``: its card tensors copied into pinned memory
    on the side stream once ``after`` has completed; returns (host tree,
    event after those copies, or None when nothing was on the card)."""
    device = _card_of(tree)
    if device is None:
        return tree_map(_leaf_copy, tree), None
    side = torch.cuda.Stream(device=device)    # from PyTorch's stream pool
    side.wait_event(after)

    def leaf(x):
        if not _on_card(x):
            return _leaf_copy(x)
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        x.record_stream(side)       # the allocator keeps x until side reads it
        return host

    with torch.cuda.stream(side):
        host = tree_map(leaf, tree)
        done = torch.cuda.Event()
        done.record(side)
    return host, done


def _tree_nbytes(tree) -> int:
    total = 0
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, np.ndarray):
            total += x.nbytes
    return total


class RoundHandle:
    """One round's captured state, plus dispatch-time metadata for its
    eventual consumer (a checkpoint saver, a retention gather).

    ``meta`` is host bookkeeping taken at the same dispatch point as the
    tensors, so both always describe the same round.
    """

    def __init__(self, round_: int, tree, *, meta=None, copied=None):
        self.round = int(round_)
        self.tree = tree
        self.meta = meta
        self._copied = copied     # event after the clones (None: none on card)
        self._staged = None       # (pinned tree, event) once staged
        self._host = None

    @classmethod
    def capture(cls, round_: int, state, *, keys=None, meta=None,
                copy: bool = True, to_host: bool = False) -> "RoundHandle":
        """Snapshot ``state`` (or the ``keys`` subset of a dict state) at
        dispatch.  ``copy=False`` wraps the live tree without copying: safe
        only when the pipeline is drained and the handle is consumed before
        the next dispatch (the flush path).  ``to_host`` starts the staged
        copy to pinned host memory at once."""
        src = state
        if keys is not None and isinstance(state, dict):
            src = {k: state[k] for k in keys if k in state}
        tree = snapshot_tree(src) if copy else src
        handle = cls(round_, tree, meta=meta, copied=_after_current(tree))
        if to_host:
            handle._stage()
        return handle

    def _stage(self):
        if self._staged is None:
            self._staged = _to_host(self.tree, self._copied)
        return self._staged

    # -- readiness / materialization ------------------------------------
    def ready(self) -> bool:
        """True when this handle's copies (and any staged host copy) have
        completed; queries its own events only."""
        events = [self._copied, self._staged and self._staged[1]]
        return all(e.query() for e in events if e is not None)

    def host_tree(self):
        """Host copies of the captured tree (CPU tensors; numpy leaves and
        scalars as captured).  Waits on this handle's own copies only;
        cached after the first call."""
        if self._host is None:
            tree, done = self._stage()
            if done is not None:
                done.synchronize()
            self._host = tree
        return self._host

    # -- slices for the retention gather ---------------------------------
    def has(self, key: str) -> bool:
        return isinstance(self.tree, dict) and key in self.tree

    def group_state(self, g: int) -> dict:
        """Group ``g``'s dev/aux rows as host copies (the retention-gather
        payload), copying only those rows off the card."""
        src = self._host if self._host is not None else self.tree
        rows = {k: tree_map(lambda x: x[g], src[k]) for k in ("dev", "aux")}
        host, done = _to_host(rows, self._copied)
        if done is not None:
            done.synchronize()
        return host

    @property
    def nbytes(self) -> int:
        return _tree_nbytes(self.tree)


class HandleRing:
    """Bounded ring of the last ``depth`` per-round handles.

    Eviction is positional (oldest round out); dropping a handle releases
    its copies to the allocator.  ``peak_bytes`` is the high-water mark of
    the bytes held at once: the pipeline's memory cost.
    """

    def __init__(self, depth: int):
        if depth < 1:
            raise ValueError(f"need depth >= 1, got {depth}")
        self.depth = depth
        self._ring: OrderedDict[int, RoundHandle] = OrderedDict()
        self.n_captured = 0
        self.peak_bytes = 0

    def push(self, handle: RoundHandle) -> None:
        self._ring[handle.round] = handle
        self._ring.move_to_end(handle.round)
        while len(self._ring) > self.depth:
            self._ring.popitem(last=False)
        self.n_captured += 1
        self.peak_bytes = max(self.peak_bytes, self.nbytes)

    def get(self, round_: int) -> RoundHandle | None:
        return self._ring.get(int(round_))

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def nbytes(self) -> int:
        return sum(h.nbytes for h in self._ring.values())

    def summary(self) -> dict:
        return {"depth": self.depth, "held": len(self._ring),
                "captured": self.n_captured,
                "bytes": int(self.nbytes),
                "peak_bytes": int(self.peak_bytes)}
