"""Cost counter over the torch dispatcher: FLOPs / HBM bytes of one call.

The JAX package counts a step from its optimized HLO (``analysis/hlo.py``:
``analyze_compiled``).  The port has no HLO: it runs eagerly, one aten op
at a time, so this module takes that role by running the call under one
``TorchDispatchMode`` and counting every op that reaches it:

  * flops            — the FLOPs of the matmul-like ops (mm, addmm, bmm,
                       baddbmm, convolution and their backward), from
                       ``torch.utils.flop_counter``'s formula registry, as
                       ``hlo.py`` counts dot and convolution only, and of
                       the five kernel ops (below)
  * bytes            — each non-free op's input and output tensor bytes (an
                       HBM-traffic estimate: in eager mode each op is one
                       kernel and one round trip).  Views, ``detach``,
                       ``alias`` and ``empty*`` move nothing, as
                       ``_FREE_OPS`` there; ``copy_``'s destination and an
                       ``out=`` tensor count as writes, not reads; a write
                       into a view counts the view's bytes, not its
                       base's
  * collective_bytes — per-collective-kind bytes; empty, since nothing in
                       the port runs a collective yet

Autograd's backward ops and the in-place optimizer updates reach the mode
like any other op; each is counted once, where it runs.  The count is the
same on the CPU, on the card and on the ``meta`` device, where it needs no
memory: a full-width round is counted on ``meta``.

The five hand-written kernels reach the dispatcher as the custom ops that
``kernels/ops.py`` launches them through (``repro_torch::fa_fwd`` ...).
Each is one op: its bytes are its inputs and outputs (the scores and
decays stay on chip), its FLOPs the products of the work its function
needs (:func:`attention_flops`, :func:`ssd_flops`: the (query, key) pairs
the mask leaves visible, the s <= t pairs of each SSD chunk).  So a step
built with ``use_kernel=True`` is counted as the card runs it, and the
plain step as it runs.  ``analyze_call`` refuses a ``repro_torch`` op it
has no formula for, and a kernel launched past the dispatcher (a wrapper
called directly on the card moves its ``launches`` count, no op).
"""
from __future__ import annotations

import functools
from collections import defaultdict
from dataclasses import dataclass, field

__all__ = ["Cost", "analyze_call", "attention_flops", "ssd_flops",
           "visible_pairs"]

#: ops that allocate or reshape without moving bytes (beside every op whose
#: schema returns an alias it does not write: the views, ``detach`` and
#: ``alias`` among them)
_FREE_NAMES = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                         "new_empty_strided", "_unsafe_view"})


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: dict = field(default_factory=lambda: defaultdict(float))

    def __iadd__(self, other: "Cost"):
        self.flops += other.flops
        self.bytes += other.bytes
        for k, v in other.collective_bytes.items():
            self.collective_bytes[k] += v
        return self

    def scaled(self, m: float) -> "Cost":
        out = Cost(self.flops * m, self.bytes * m)
        out.collective_bytes = defaultdict(
            float, {k: v * m for k, v in self.collective_bytes.items()})
        return out

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _tensors(tree):
    """The tensors of a nested args/kwargs/output structure."""
    import torch
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


@functools.cache
def _is_free(func) -> bool:
    """An op that moves no bytes: a view (its schema returns an alias of
    an input that it does not write) or one of ``_FREE_NAMES``."""
    view = any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)
    return view or func.overloadpacket.__name__ in _FREE_NAMES


@functools.cache
def visible_pairs(S: int, Skv: int, causal: bool, window) -> int:
    """The (query, key) pairs of one (batch, head) that the mask of
    ``kernels/ref.visible`` leaves visible."""
    from repro_torch.kernels.ref import visible
    return int(visible(S, Skv, causal=causal, window=window,
                       device="cpu").sum())


def attention_flops(name: str, B: int, H: int, S: int, Skv: int, hd: int,
                    *, causal: bool, window=None) -> float:
    """FLOPs (2 a multiply-add) of one flash-attention kernel over the
    visible pairs: the forward's QKᵀ and PV; dq's QKᵀ again, dO·Vᵀ and
    dS·K; dk/dv's QKᵀ, dO·Vᵀ, Pᵀ·dO and dSᵀ·Q."""
    products = {"fa_fwd": 2, "fa_bwd_dq": 3, "fa_bwd_dkv": 4}[name]
    return 2.0 * products * hd * B * H * visible_pairs(S, Skv, causal,
                                                       window)


def ssd_flops(name: str, B: int, T: int, H: int, P: int, G: int, N: int,
              chunk: int) -> float:
    """FLOPs (2 a multiply-add) of one SSD kernel over T steps (a multiple
    of ``chunk``): only the chunk's Q (Q + 1) / 2 pairs s <= t, and the
    score product C·Bᵀ once per (batch, group, chunk), since every head of
    a group shares it."""
    nc, Q = T // chunk, chunk
    blocks, pairs = B * H * nc, Q * (Q + 1) // 2
    scores = B * G * nc * pairs * N
    if name == "ssd_fwd":
        macs = scores + blocks * (pairs * P + 2 * Q * N * P)
    else:
        macs = scores + blocks * (pairs * (2 * N + 2 * P) + 4 * Q * N * P)
    return 2.0 * macs


def _kernel_flops(func, args, kwargs) -> float:
    """FLOPs of a ``repro_torch`` kernel op, from its arguments."""
    a = {**{s.name: v for s, v in zip(func._schema.arguments, args)},
         **kwargs}
    name = func.overloadpacket.__name__
    if name.startswith("fa_"):
        B, H, S, hd = a["q"].shape
        return attention_flops(name, B, H, S, a["k"].shape[2], hd,
                               causal=a["causal"], window=a["window"])
    if name.startswith("ssd_"):
        B, T, H, P = a["x"].shape
        return ssd_flops(name, B, T, H, P, a["Bm"].shape[2],
                         a["Bm"].shape[3], a["chunk"])
    raise ValueError(f"analyze_call has no cost formula for the kernel op "
                     f"{func}")


def _launched() -> int:
    """Kernel launches so far, over every wrapper's count."""
    from repro_torch.kernels import flash_attention, ssd
    return sum(flash_attention.launches.values()) + \
        sum(ssd.launches.values())


def analyze_call(fn, *args, exclude_fn=None, by_op=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` and count it: returns ``(out, Cost)``.

    ``exclude_fn(dims)``: tensors whose shape matches count as ZERO bytes
    (the FLOPs are unchanged) — the role ``HloModule.cost``'s gives it,
    modelling a fused kernel whose tiles (attention scores, SSD decays)
    never round-trip HBM.  ``by_op``: a dict that gets each op's FLOPs
    added under its name (``"mm"``, ``"fa_fwd"``)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    cost = Cost()
    kernel_ops = [0]          # kernel ops that reached the mode

    def nbytes(t) -> float:
        if exclude_fn is not None and exclude_fn(tuple(t.shape)):
            return 0.0
        return float(t.numel() * t.element_size())

    class _CostMode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if func.namespace == "repro_torch":
                kernel_ops[0] += 1
                flops = _kernel_flops(func, args, kwargs)
            else:
                formula = flop_registry.get(func.overloadpacket)
                flops = 0.0 if formula is None else \
                    formula(*args, **kwargs, out_val=out)
            cost.flops += flops
            if by_op is not None and flops:
                name = func.overloadpacket.__name__
                by_op[name] = by_op.get(name, 0.0) + flops
            if not _is_free(func):
                # copy_ writes its first argument and never reads it
                reads = args[1:] if func.overloadpacket.__name__ == "copy_" \
                    else args
                ins = {k: v for k, v in kwargs.items() if k != "out"}
                cost.bytes += sum(nbytes(t) for t in _tensors((reads, ins)))
                cost.bytes += sum(nbytes(t) for t in _tensors(out))
            return out

    launched = _launched()
    with _CostMode():
        out = fn(*args, **kwargs)
    if _launched() - launched > kernel_ops[0]:
        raise ValueError(
            f"{_launched() - launched} kernel launches but {kernel_ops[0]} "
            "kernel ops reached the dispatcher: a wrapper of "
            "kernels/flash_attention.py or kernels/ssd.py was called past "
            "kernels/ops.py, so its work is not counted")
    return out, cost
