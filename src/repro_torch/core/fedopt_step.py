"""The FedOptima hybrid round on one card: device groups train the front
layers on auxiliary-head losses, the server trains the back layers on the
ω-deep activation ring, and every H micro-iterations the groups meet at
staleness-weighted aggregation.

Port of the JAX package's ``core/fedopt_step.py`` without its sharding.
The JAX ``lax.scan`` over the H micro-iterations is a Python loop; inside
it the device half is a Python loop over the G groups, one autograd graph
per group on its slice of the group-stacked ``dev``/``aux`` params.  Then
the server reads its host-scheduled ring slot, the groups' emissions land
in the written slot (rows of groups without a send grant keep the slot's
old content), and the server half trains on the slot it read.  The
slot indices are host values, so the step makes no host sync: the host
can plan the next round while this one runs (``core/executor``).

State layout is the JAX one: ``dev``/``aux`` leaves ``(G, ...)``, block
leaves ``(..., n_periods, ...)``, ``act_buf`` leaves ``(ω, ...)``.  The
step updates ``dev``, ``aux`` and ``act_buf`` in place (the JAX step
donates its state instead), so a caller that needs the old state keeps a
copy (``core/handles``).  It sets
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False: float32 stays float32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.api import ArchConfig
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim.optimizers import make_optimizer

from .staging import copy_into


@dataclass(frozen=True)
class FedStepConfig:
    arch: ArchConfig
    l_split: int                      # device-side periods (split point)
    n_groups: int                     # FL device groups
    seq_len: int
    per_group_batch: int              # sequences per group per round
    H: int = 8                        # local iterations per round (Alg. 1)
    lr_d: float = 0.05
    lr_s: float = 0.05
    server_opt: str = "sgd"           # paper Alg. 4 line 10 (adamw optional)
    param_dtype: Any = torch.float32
    pipeline_acts: bool = True        # server trains on ring-scheduled acts
    omega: int = 1                    # activation-ring depth (Eq. 3 cap ω)
    remat: Any = "selective"          # True | False | "selective"
    use_kernel: bool = False          # attention/SSD kernels, both halves
    agg_compress: bool = False        # int8 aggregation payload
    server_accum: bool = False        # one server optimizer step per round

    @property
    def global_batch(self) -> int:
        return self.n_groups * self.per_group_batch

    @property
    def micro_batch(self) -> int:
        """Sequences per group per local iteration (Alg. 1 line 4)."""
        if self.per_group_batch % self.H != 0:
            raise ValueError(
                f"per_group_batch={self.per_group_batch} is not divisible "
                f"by H={self.H}; Alg. 1 consumes per_group_batch/H "
                "sequences per local iteration")
        return self.per_group_batch // self.H


def default_l_split(arch: ArchConfig) -> int:
    """1/8 of the periods on the device side, clamped to a valid boundary."""
    return max(1, min(arch.n_periods - 1, arch.n_periods // 8))


# ---------------------------------------------------------------------------
# State construction
# ---------------------------------------------------------------------------

def init_train_state(gen: torch.Generator, cfg: FedStepConfig) -> dict:
    """Fresh training state on ``gen``'s device, drawn from ``gen``."""
    arch, G = cfg.arch, cfg.n_groups
    full = tfm.init_params(gen, arch, cfg.param_dtype)
    dev1, srv = tfm.split_params(full, arch, cfg.l_split)
    aux1 = tfm.make_aux_params(gen, arch, cfg.param_dtype,
                               regression=bool(arch.n_decoder_layers))
    stack = lambda t: tree_map(lambda x: x.expand(G, *x.shape).clone(), t)
    srv = tree_map(torch.clone, srv)           # own storage, not views of full
    s_init, _ = make_optimizer(cfg.server_opt)
    zero = torch.zeros((), dtype=torch.int64, device=gen.device)
    state = {"dev": stack(dev1), "aux": stack(aux1), "srv": srv,
             "srv_opt": s_init(srv), "step": zero, "version": zero.clone()}
    if cfg.pipeline_acts:
        state["act_buf"] = _empty_act_buf(cfg, gen.device)
    return state


def abstract_train_state(cfg: FedStepConfig) -> dict:
    """The training state on the ``meta`` device: every leaf's shape and
    dtype, no storage (a full-width round is counted on it,
    ``analysis.cost``).  Drawn under fake tensors, which allocate nothing,
    from the init's own code."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = init_train_state(torch.Generator().manual_seed(0), cfg)
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device="meta"), fake)


def _ring_fields(arch: ArchConfig) -> tuple:
    """The batch fields a ring slot carries beside the acts: the labels, an
    enc-dec arch's decoder tokens and a VLM's frontend embeddings."""
    return ("labels",) + (("tokens",) if arch.n_decoder_layers else ()) + \
        (("frontend",) if arch.family == "vlm" else ())


def _empty_act_slot(cfg: FedStepConfig, device) -> dict:
    """One scheduled activation batch (one micro-iteration's output); an
    encoder prefix's acts are ``frontend_len`` frames long."""
    arch = cfg.arch
    B = cfg.n_groups * cfg.micro_batch
    S = arch.frontend_len if arch.n_decoder_layers else cfg.seq_len
    buf = {"acts": torch.zeros(B, S, arch.d_model, dtype=cfg.param_dtype,
                               device=device)}
    for k in _ring_fields(arch):
        buf[k] = torch.zeros(B, arch.frontend_len, arch.d_model,
                             dtype=cfg.param_dtype, device=device) \
            if k == "frontend" else \
            torch.zeros(B, cfg.seq_len, dtype=torch.int64, device=device)
    return buf


def _empty_act_buf(cfg: FedStepConfig, device) -> dict:
    """ω-deep ring of scheduled activation batches."""
    return tree_map(lambda x: x.expand(cfg.omega, *x.shape).clone(),
                    _empty_act_slot(cfg, device))


def identity_schedule(cfg: FedStepConfig, device) -> dict:
    """Every group sends every iteration; slot h % ω is consumed, then
    overwritten.  The slot indices stay on the host."""
    slots = torch.arange(cfg.H, dtype=torch.int64) % max(cfg.omega, 1)
    return {"read_slot": slots, "write_slot": slots.clone(),
            "send_mask": torch.ones(cfg.H, cfg.n_groups, dtype=torch.float32,
                                    device=device)}


# ---------------------------------------------------------------------------
# Input specs (meta tensors for every model input)
# ---------------------------------------------------------------------------

#: Per-group (G,) control fields consumed once per round (not scanned over
#: the H micro-iterations): aggregation weights + broadcast receive mask.
PER_GROUP_KEYS = ("agg_weight", "bcast_mask")


def train_input_specs(cfg: FedStepConfig) -> dict:
    """Batch stand-ins on the ``meta`` device (shape and dtype, no
    storage): tokens/labels per group per local iteration (one round = H
    micro-iterations); agg weights + the activation-ring schedule from the
    host control plane.  The JAX package's specs, with int64 where it has
    int32."""
    arch = cfg.arch
    G, H, b, S = cfg.n_groups, cfg.H, cfg.micro_batch, cfg.seq_len
    spec = lambda *shape, dtype: torch.empty(shape, dtype=dtype,
                                             device="meta")
    batch = {"tokens": spec(G, H, b, S, dtype=torch.int64),
             "labels": spec(G, H, b, S, dtype=torch.int64),
             "agg_weight": spec(G, dtype=torch.float32),
             "bcast_mask": spec(G, dtype=torch.float32),
             "read_slot": spec(H, dtype=torch.int64),
             "write_slot": spec(H, dtype=torch.int64),
             "send_mask": spec(H, G, dtype=torch.float32)}
    if arch.frontend_len:
        batch["frontend"] = spec(G, H, b, arch.frontend_len, arch.d_model,
                                 dtype=cfg.param_dtype)
    return batch


def concrete_train_batch(gen: torch.Generator, cfg: FedStepConfig,
                         device=None) -> dict:
    """One round's batch on ``device`` (``gen``'s by default): the identity
    schedule (slot indices on the host), ones for the per-group fields,
    tokens and labels drawn uniformly from ``[0, vocab)`` and a frontend
    drawn from the standard normal, both from ``gen``."""
    device = torch.device(gen.device if device is None else device)
    out = dict(identity_schedule(cfg, device))
    for k, s in train_input_specs(cfg).items():
        if k in out:
            continue
        if k in PER_GROUP_KEYS:
            out[k] = torch.ones(s.shape, dtype=s.dtype, device=device)
        elif s.dtype == torch.int64:
            out[k] = torch.randint(0, cfg.arch.vocab, s.shape, generator=gen,
                                   dtype=s.dtype, device=device)
        else:
            out[k] = torch.randn(s.shape, generator=gen, dtype=s.dtype,
                                 device=device)
    return out


def _quant(x):
    """Per-tensor int8 quantization of the aggregation payload; also the
    tiered store's int8 spill encoding (``repro_torch.memory.store``)."""
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), \
        scale


def _dequant(qs):
    q, scale = qs
    return q.float() * scale


# ---------------------------------------------------------------------------
# The hybrid train step
# ---------------------------------------------------------------------------

def _host_ints(x, name: str) -> list:
    """Slot indices as Python ints, from a host value only: reading a
    tensor on the card would wait for every round in flight."""
    if isinstance(x, torch.Tensor) and x.device.type != "cpu":
        raise ValueError(f"{name} must be a host value (a CPU tensor or "
                         f"numpy), got a tensor on {x.device}")
    return torch.as_tensor(x).tolist()


#: The batch's per-group data fields, (G, H, b, ...) each.
DATA_FIELDS = ("tokens", "labels", "frontend")


def _unflatten_like(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def make_train_step(cfg: FedStepConfig):
    """Returns step(state, batch) -> (state, metrics): one FL round of H
    micro-iterations and the end-of-round aggregation.

    ``batch``: ``tokens``/``labels`` (G, H, b, S) int64, for a VLM or an
    enc-dec arch ``frontend`` (G, H, b, frontend_len, d_model), ``send_mask``
    (H, G), ``agg_weight`` and ``bcast_mask`` (G,) on the state's device,
    and ``read_slot``/``write_slot`` (H,) as host values — a CPU tensor or
    numpy — read with no device sync (see ``RoundPlan.batch_fields``).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch = cfg.arch
    _, s_update = make_optimizer(cfg.server_opt)
    kw = dict(use_kernel=cfg.use_kernel, remat=cfg.remat)

    def device_half(dev, aux, g, batch_gh):
        """Group g's local-loss training (Alg. 1 lines 3-12), in place on
        its rows of the stacked params.  An encoder prefix (whisper) trains
        on the frame stub, which is its aux labels too; a VLM's cross
        blocks read the group's frontend."""
        if arch.n_decoder_layers:
            inputs = labels = batch_gh["frontend"]
        else:
            inputs, labels = batch_gh["tokens"], batch_gh["labels"]
        frontend = batch_gh["frontend"] if arch.family == "vlm" else None
        rows = [x[g] for x in tree_leaves(dev) + tree_leaves(aux)]
        leaves = [x.detach().requires_grad_() for x in rows]
        d = _unflatten_like(dev, leaves[:len(tree_leaves(dev))])
        a = _unflatten_like(aux, leaves[len(tree_leaves(dev)):])
        loss, acts = tfm.device_train_loss(d, a, arch, inputs, labels,
                                           frontend=frontend, **kw)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for p, gr in zip(rows, grads):
                p.sub_(cfg.lr_d * gr.to(p.dtype))
        return loss.detach(), acts.detach()

    def server_grads(srv, buf):
        """Loss and grads of one server iteration on a scheduled batch."""
        leaves = [x.detach().requires_grad_() for x in tree_leaves(srv)]
        s = _unflatten_like(srv, leaves)
        if arch.n_decoder_layers:
            loss = tfm.server_encdec_loss(s, arch, buf["acts"], buf["tokens"],
                                          buf["labels"], **kw)
        else:
            loss = tfm.server_forward_loss(s, arch, buf["acts"], buf["labels"],
                                           frontend=buf.get("frontend"), **kw)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), _unflatten_like(srv, grads)

    def aggregate(tree, weights, recv_mask):
        """Staleness-weighted average over the group axis, broadcast to the
        groups in ``recv_mask``; all-zero weights keep every group's params
        (Alg. 4 lines 12-20).  In place: a second copy of every group's
        params does not fit beside a full-width model's (gemma2-27b's dev
        and aux are 24 GB at G=2)."""
        w_sum = torch.sum(weights)
        w = weights / torch.clamp(w_sum, min=1e-9)
        take = (recv_mask > 0.5) & (w_sum > 0)     # (G,) on the device

        def mean_bcast(x):
            xw = _dequant(_quant(x)) if cfg.agg_compress else x.float()
            g = torch.tensordot(w, xw, dims=1).to(x.dtype)
            rows = take.reshape((-1,) + (1,) * (x.ndim - 1))
            return torch.where(rows, g, x, out=x)

        with torch.no_grad():
            return tree_map(mean_bcast, tree)

    def step(state, batch):
        G, H, b = cfg.n_groups, cfg.H, cfg.micro_batch
        dev, aux, ring = state["dev"], state["aux"], state.get("act_buf")
        srv, srv_opt = state["srv"], state["srv_opt"]
        read_slot = _host_ints(batch["read_slot"], "read_slot")
        write_slot = _host_ints(batch["write_slot"], "write_slot")
        srv_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), srv) \
            if cfg.server_accum else None
        d_losses, s_losses = [], []
        for h in range(H):
            outs = [device_half(dev, aux, g, {k: batch[k][g, h] for k in
                                              DATA_FIELDS if k in batch})
                    for g in range(G)]
            d_losses.append(torch.mean(torch.stack([o[0] for o in outs])))
            new_buf = {"acts": torch.cat([o[1] for o in outs]),
                       **{k: batch[k][:, h].flatten(0, 1)
                          for k in _ring_fields(arch)}}

            if cfg.pipeline_acts:
                # the server reads its scheduled slot from before this
                # iteration's write; groups with a send grant refresh their
                # rows of the written slot
                train_buf = {k: v[read_slot[h]].clone()
                             for k, v in ring.items()}
                keep = torch.repeat_interleave(batch["send_mask"][h] > 0.5, b)
                for k, v in ring.items():
                    rows = keep.reshape((-1,) + (1,) * (v.ndim - 2))
                    v[write_slot[h]] = torch.where(rows, new_buf[k],
                                                   v[write_slot[h]])
            else:
                train_buf = new_buf

            if cfg.server_accum:
                s_loss, gs = server_grads(state["srv"], train_buf)
                srv_acc = tree_map(lambda a, g: a + g.float(), srv_acc, gs)
            else:
                s_loss, gs = server_grads(srv, train_buf)
                srv, srv_opt = s_update(srv, gs, srv_opt, cfg.lr_s)
            # the server's gradients go before the next iteration's device
            # halves: llama-3.2-vision's (10.3 GiB) beside a group's
            # (13.7 GiB) and three copies of the server's params ran the
            # card out of memory
            del gs
            s_losses.append(s_loss)

        if cfg.server_accum:
            gs = tree_map(lambda a, p: (a / H).to(p.dtype), srv_acc,
                          state["srv"])
            srv, srv_opt = s_update(state["srv"], gs, state["srv_opt"],
                                    cfg.lr_s)

        dev, aux = aggregate((dev, aux), batch["agg_weight"],
                             batch["bcast_mask"])
        new_state = dict(state, dev=dev, aux=aux, srv=srv, srv_opt=srv_opt,
                         step=state["step"] + 1,
                         version=state["version"] + 1)
        metrics = {"d_loss": torch.mean(torch.stack(d_losses)),
                   "s_loss": torch.mean(torch.stack(s_losses))}
        return new_state, metrics

    return step


# ---------------------------------------------------------------------------
# Tiered activation store: ring slots to and from the host pool
# ---------------------------------------------------------------------------

def gather_act_slot(state: dict, s: int) -> dict:
    """Ring slot ``s`` for the host pool (spill path of the tiered store,
    ``repro_torch.memory``): one scheduled batch, acts, labels and any
    tokens/frontend leaves, as views into the ring.  The executor calls it
    at a boundary, before the next round is dispatched, and the store
    copies the views at once (quantised on the card under
    ``--spill-quant``, then into pinned host memory without blocking), so
    the copies read in stream order what the previous round left: no host
    sync, and the next round's in-place writes cannot reach them."""
    return {k: v[s] for k, v in state["act_buf"].items()}


def scatter_act_slot(state: dict, s: int, payload: dict) -> dict:
    """Write one filled slot's payload back into ring slot ``s``, in place
    (fill path): leaves already on the ring's device, as
    ``ActivationStore.fill`` hands them back, are copied there on the
    stream; host leaves through pinned buffers.  No host sync."""
    with torch.no_grad():
        for k, v in payload.items():
            copy_into(state["act_buf"][k][s], v)
    return state


# ---------------------------------------------------------------------------
# Per-group state retention (dropped groups — §3.4.2)
# ---------------------------------------------------------------------------

def gather_group_state(state: dict, g: int) -> dict:
    """Host copies of one group's dev/aux slices for the retention store,
    from the live state.  On the card the copy waits for the rounds
    already enqueued; the executor calls it at a boundary, before the
    next round is dispatched, so it reads the previous round's output."""
    take = lambda tree: tree_map(lambda x: x[g].to("cpu", copy=True), tree)
    return {"dev": take(state["dev"]), "aux": take(state["aux"])}


def scatter_group_state(state: dict, g: int, retained: dict) -> dict:
    """Write one group's retained dev/aux slices back into the stacked
    state (rejoin path), in place, through pinned buffers on the card."""
    with torch.no_grad():
        for key in ("dev", "aux"):
            tree_map(lambda x, v: copy_into(x[g], v), state[key],
                     retained[key])
    return state
