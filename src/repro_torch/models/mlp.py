"""Feed-forward blocks: the dense gated SwiGLU and GeGLU and the plain GELU
FFN (no ``w_gate``), and the capacity-bounded mixture of experts
(``moe_apply_grouped``, the JAX package's single-host dispatch).  The
projections and the expert products stay ``torch.matmul`` / ``bmm``.

The MoE dispatch keeps fixed shapes and makes no host sync: the capacity
``C = max(1, int(cf * T * k / E))`` follows from shapes, a sentinel row
stands in for empty and dropped slots, and the slot maps come from a
stable sort, ``searchsorted`` and gathers (no op whose output shape
depends on the data, and no read of a value back to the host).  Top-k is
a stable descending sort, so tied router probabilities (an all-zero ring
row ties every expert) pick the lower expert ids first, as
``jax.lax.top_k`` does; ``torch.topk`` breaks such ties in another order.
The dispatch and the combine are autograd functions whose backwards are
gathers and sums in a fixed order over k, never a float accumulation
through atomics, so two runs on the card are bit-identical."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .common import dense_init, gelu, silu

GATED = ("swiglu", "geglu")


def _act(name: str):
    return silu if name == "swiglu" else gelu


@dataclass(frozen=True)
class MlpConfig:
    d_model: int
    d_ff: int
    activation: str = "swiglu"   # "swiglu" | "geglu" | "gelu"


@dataclass(frozen=True)
class MoeConfig:
    d_model: int
    d_ff: int                    # per-expert hidden dim
    n_experts: int
    top_k: int
    activation: str = "swiglu"


def mlp_init(gen: torch.Generator, cfg: MlpConfig, *,
             dtype=torch.float32) -> dict:
    if cfg.activation in GATED:
        return {"w_gate": dense_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype),
                "w_up": dense_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype),
                "w_down": dense_init(gen, cfg.d_ff, cfg.d_model, dtype=dtype)}
    return {"w_up": dense_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype),
            "w_down": dense_init(gen, cfg.d_ff, cfg.d_model, dtype=dtype)}


def mlp_apply(params: dict, cfg: MlpConfig, x):
    if cfg.activation in GATED:
        h = _act(cfg.activation)(x @ params["w_gate"]) * (x @ params["w_up"])
        return h @ params["w_down"]
    return gelu(x @ params["w_up"]) @ params["w_down"]


# ---------------------------------------------------------------------------
# Mixture of experts
# ---------------------------------------------------------------------------

def moe_init(gen: torch.Generator, cfg: MoeConfig, *,
             dtype=torch.float32) -> dict:
    E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
    mk = lambda *s: torch.randn(*s, generator=gen, device=gen.device,
                                dtype=dtype)
    p = {"router": dense_init(gen, D, E, dtype=dtype),
         "we_gate": mk(E, D, F) / D ** 0.5,
         "we_up": mk(E, D, F) / D ** 0.5,
         "we_down": mk(E, F, D) / F ** 0.5}
    if cfg.activation not in GATED:
        del p["we_gate"]
    return p


def _top_k_route(params: dict, cfg: MoeConfig, xt):
    """xt (T, D) -> (top_idx (T, k) int64, top_w (T, k) f32, aux scalar):
    the top-k experts by a stable descending sort (ties to the lower id),
    their softmax weights renormalised over the k, and the Switch-style
    load-balance loss ``E * sum_e f_e p_e`` on the full distribution."""
    E, k = cfg.n_experts, cfg.top_k
    logits = xt.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_idx = top_w[:, :k], top_idx[:, :k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    experts = torch.arange(E, device=xt.device)
    routed = (top_idx[..., None] == experts).float().sum(1)      # (T, E)
    f = routed.mean(0) / k
    aux = E * torch.sum(f * probs.mean(0))
    return top_idx, top_w, aux


def _pad(x):
    """x with one zero row appended at index len(x): the sentinel row that
    empty slots and dropped assignments point at."""
    return torch.cat([x, x.new_zeros(1, x.shape[1])])


class _Dispatch(torch.autograd.Function):
    """xe = xt_pad[slot_token]: each of the E·C slots takes its token's row
    (the zero sentinel row for an empty slot).  Backward: each token sums
    the gradients of its kept slots, gathered through its (T, k) slot map,
    over k in order."""

    @staticmethod
    def forward(ctx, xt, slot_token, tok_slot):
        ctx.save_for_backward(tok_slot)
        return _pad(xt)[slot_token]

    @staticmethod
    def backward(ctx, dxe):
        (tok_slot,) = ctx.saved_tensors
        dxe = _pad(dxe)
        dx = dxe[tok_slot[:, 0]]
        for j in range(1, tok_slot.shape[1]):
            dx = dx + dxe[tok_slot[:, j]]
        return dx, None, None


class _Combine(torch.autograd.Function):
    """y[t] = sum_j w[t, j] · ye_pad[tok_slot[t, j]], summed over k in
    order (a dropped assignment points at the zero sentinel row and its
    weight is 0).  Backward: each slot gathers ``w · dy[token]`` through
    its token and assignment maps; the weights' gradient is the
    per-assignment dot product ``<dy[t], ye[slot]>``."""

    @staticmethod
    def forward(ctx, ye, w, tok_slot, slot_token, slot_asg):
        ctx.save_for_backward(ye, w, tok_slot, slot_token, slot_asg)
        ye = _pad(ye)
        y = ye[tok_slot[:, 0]] * w[:, :1]
        for j in range(1, tok_slot.shape[1]):
            y = y + ye[tok_slot[:, j]] * w[:, j:j + 1]
        return y

    @staticmethod
    def backward(ctx, dy):
        ye, w, tok_slot, slot_token, slot_asg = ctx.saved_tensors
        w_slot = torch.cat([w.reshape(-1), w.new_zeros(1)])[slot_asg]
        dye = _pad(dy)[slot_token] * w_slot[:, None]
        ye = _pad(ye)
        dw = torch.stack([(dy * ye[tok_slot[:, j]]).sum(-1)
                          for j in range(tok_slot.shape[1])], dim=1)
        return dye, dw, None, None, None


def moe_capacity(cfg: MoeConfig, n_tokens: int,
                 capacity_factor: float = 1.0) -> int:
    """Slots per expert: ``max(1, int(cf · T · k / E))``."""
    return max(1, int(capacity_factor * n_tokens * cfg.top_k
                      / cfg.n_experts))


def moe_apply_grouped(params: dict, cfg: MoeConfig, x, *,
                      capacity_factor: float = 1.0):
    """Capacity-bounded grouped-matmul MoE, x (B, S, D) -> (y, aux).

    Assignments are stable-sorted by expert; an assignment's place in its
    expert's run is its slot, and those past the capacity C are dropped
    (GShard/Switch semantics; earlier tokens first).  The experts run as
    batched products (E, C, D) x (E, D, F); each token then sums its kept
    slots' outputs, weighted by its renormalised router weights."""
    B, S, D = x.shape
    T, E, k = B * S, cfg.n_experts, cfg.top_k
    N, C = T * k, moe_capacity(cfg, B * S, capacity_factor)
    dev = x.device
    xt = x.reshape(T, D)
    top_idx, top_w, aux = _top_k_route(params, cfg, xt)

    eflat = top_idx.reshape(N)                    # expert per assignment
    order = torch.argsort(eflat, stable=True)     # by expert, earlier first
    e_sorted = eflat[order]
    experts = torch.arange(E + 1, device=dev)
    bounds = torch.searchsorted(e_sorted, experts)   # (E + 1,) run starts
    starts, counts = bounds[:E], bounds[1:] - bounds[:E]
    # slot -> assignment, token (sentinels N and T where the slot is empty)
    c = torch.arange(C, device=dev)
    src = (starts[:, None] + c).reshape(E * C)
    filled = (c < counts[:, None]).reshape(E * C)
    slot_asg = torch.where(filled, order[torch.clamp(src, max=N - 1)], N)
    slot_token = torch.div(slot_asg, k, rounding_mode="floor")
    # assignment -> slot (sentinel E·C where dropped)
    pos = torch.arange(N, device=dev) - bounds[e_sorted]
    slot_sorted = torch.where(pos < C, e_sorted * C + pos, E * C)
    tok_slot = slot_sorted[torch.argsort(order)].reshape(T, k)
    keep = tok_slot < E * C
    w = torch.where(keep, top_w, 0.0).to(x.dtype)

    xe = _Dispatch.apply(xt, slot_token, tok_slot).reshape(E, C, D)
    if cfg.activation in GATED:
        h = _act(cfg.activation)(torch.bmm(xe, params["we_gate"])) * \
            torch.bmm(xe, params["we_up"])
    else:
        h = gelu(torch.bmm(xe, params["we_up"]))
    ye = torch.bmm(h, params["we_down"]).reshape(E * C, D)
    y = _Combine.apply(ye, w, tok_slot, slot_token, slot_asg)
    return y.reshape(B, S, D), aux
