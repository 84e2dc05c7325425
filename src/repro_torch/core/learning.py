"""Learning executors: real training on the card driven by the event
simulator.

The simulator (``simulation.py``) calls hook methods in event order; these
classes do the actual math, so accuracy experiments (Table 2, Fig. 6/7,
14/15) reflect genuine non-IID learning dynamics — staleness, imbalance,
scheduling effects and all.

A ``ModelAdapter`` abstracts over layer-list models (``cnn.py``,
``text_classifier.py``): both expose forward/split/aux/ce with the same
signatures, so one adapter class serves VGG-5, MobileNetV3ish and
Transformer-6/12.

A copy of the JAX package's ``core/learning.py``: FedOptima's learner,
driven by ``simulation.simulate_fedoptima``, and the baselines' two
learners, driven by ``baselines.py`` (``FullModelLearner`` for classic FL,
FedAsync and FedBuff; ``SplitLearner`` for SplitFed, PiPar and OAFL).  The
steps run eagerly with autograd and update the params in place (the
reference's jitted steps return new arrays), so every hand-over between
devices, the global model, the aggregator and the server is a copy.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.data.pipeline import DeviceDataset
from repro_torch.models.common import tree_leaves, tree_lerp, tree_map

from .aggregator import AsyncAggregator
from .staging import to_device


@dataclass(frozen=True)
class ModelAdapter:
    """Bundles a layer-list model module (cnn / text_classifier) + config."""
    module: Any
    cfg: Any

    def init(self, gen: torch.Generator):
        return self.module.init_params(gen, self.cfg)

    def split(self, params, l):
        return self.module.split_params(params, l)

    def make_aux(self, gen: torch.Generator, l, variant="default"):
        """Returns (aux_params, aux_spec) — params are tensor trees; the
        spec (layer kinds, pooling) is static metadata."""
        return self.module.make_aux_params(gen, self.cfg, l, variant)

    def full_loss(self, params, x, y):
        return self.module.loss_fn(params, self.cfg, x, y)

    def accuracy(self, params, x, y):
        return float(self.module.accuracy(params, self.cfg, x, y))

    def device_forward(self, dev, x, l):
        return self.module.forward(dev, self.cfg, x, upto=l)

    def aux_loss(self, aux, aux_spec, acts, y):
        if self.module.__name__.endswith("cnn"):
            return self.module.aux_head_loss(aux, aux_spec, acts, y)
        return self.module.aux_head_loss(aux, aux_spec, self.cfg, acts, y)

    def server_loss(self, srv, acts, y, l):
        return self.module.server_forward_loss(srv, self.cfg, acts, y, l)


def _exact_matmuls():
    """TF32 off for matmuls and cuDNN's convolutions, as the pod step does."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _to(device, x, y):
    """A numpy batch as tensors on ``device`` (tokens and labels int64)."""
    x = to_device(x, device, None if x.dtype.kind == "f" else torch.int64)
    return x, to_device(y, device, torch.int64)


def _mean(trees):
    """The elementwise mean of same-shaped trees, summed in list order as
    the reference's ``sum(xs) / K``."""
    K = len(trees)
    return tree_map(lambda *xs: sum(xs) / K, *trees)


def _copy(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def _grad_view(tree):
    """(tree of grad-tracking aliases of ``tree``'s leaves, the aliases):
    the step differentiates the aliases and updates the leaves."""
    live = [t.detach().requires_grad_() for t in tree_leaves(tree)]
    it = iter(live)
    return tree_map(lambda _: next(it), tree), live


def _sgd(leaves, grads, lr):
    """p <- p - lr * g on every leaf, in place (lr * g first, as the
    reference computes it)."""
    with torch.no_grad():
        torch._foreach_sub_(leaves, torch._foreach_mul(grads, lr))


# ---------------------------------------------------------------------------
# FedOptima learner
# ---------------------------------------------------------------------------

class FedOptimaLearner:
    """Implements Alg. 1 (device) + Alg. 4 (server) math.

    Device k: one local iteration = fwd device block -> aux loss -> SGD on
    (θ_dk, θ̃_dk).  Activations ship to the server only when the simulator's
    flow control granted a token (send=True).  The server trains a single
    θ_s on scheduled activation batches; device blocks aggregate per
    FedAsync with staleness cap D.

    ``consumed[k]`` counts the batches the server actually trained on per
    device — the learner-side mirror of the ControlPlane's TaskScheduler
    counters (Alg. 3).

    The params live on ``device`` (default the card) and are drawn from a
    ``torch.Generator`` seeded with ``seed``, or, with ``init``, start from
    a given ``(dev0, srv, aux0)`` (e.g. the JAX learner's, carried across by
    ``convert.state_from_numpy``), which are copied.  TF32 is turned off for
    matmuls and cuDNN's convolutions, as the pod step does.  The activation
    queues hold the detached activations on the card.
    """

    def __init__(self, adapter: ModelAdapter, datasets: list[DeviceDataset],
                 l_split: int, *, lr_d=0.05, lr_s=0.05, max_delay=16,
                 aux_variant="default", seed=0, max_queue=64,
                 device="cuda", init=None):
        _exact_matmuls()
        self.a = adapter
        self.l = l_split
        self.lr_d, self.lr_s = lr_d, lr_s
        self.datasets = datasets
        self.device = torch.device(device)
        K = len(datasets)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if init is None:
            dev0, srv = adapter.split(adapter.init(gen), l_split)
            aux0, aux_spec = adapter.make_aux(gen, l_split, aux_variant)
        else:
            dev0, srv, aux0 = init
            _, aux_spec = adapter.make_aux(gen, l_split, aux_variant)
        self.aux_spec = aux_spec
        self.dev = [_copy(dev0) for _ in range(K)]
        self.aux = [_copy(aux0) for _ in range(K)]
        self.srv = _copy(srv)
        self.versions = [0] * K
        self.agg = AsyncAggregator(theta_d=_copy(dev0), theta_aux=_copy(aux0),
                                   max_delay=max_delay)
        self.act_queues: list[deque] = [deque(maxlen=max_queue)
                                        for _ in range(K)]
        self.srv_steps = 0
        self.dev_steps = 0
        self.consumed = {k: 0 for k in range(K)}   # server batches per device
        # the last step's losses, as tensors on the card (read them without
        # a sync per step)
        self.dev_loss = self.srv_loss = None

    def _dev_step(self, k: int, x, y):
        dev, dlive = _grad_view(self.dev[k])
        aux, alive = _grad_view(self.aux[k])
        acts = self.a.device_forward(dev, x, self.l)
        loss = self.a.aux_loss(aux, self.aux_spec, acts, y)
        grads = torch.autograd.grad(loss, dlive + alive)
        _sgd(tree_leaves(self.dev[k]) + tree_leaves(self.aux[k]), grads,
             self.lr_d)
        return acts.detach(), loss.detach()

    def _srv_step(self, acts, y):
        srv, slive = _grad_view(self.srv)
        loss = self.a.server_loss(srv, acts, y, self.l)
        _sgd(tree_leaves(self.srv), torch.autograd.grad(loss, slive),
             self.lr_s)
        return loss.detach()

    # --- hooks ---
    def device_iter(self, k: int, send: bool):
        x, y = _to(self.device, *self.datasets[k].next_batch())
        acts, self.dev_loss = self._dev_step(k, x, y)
        self.dev_steps += 1
        if send:
            self.act_queues[k].append((acts, y))

    def server_train(self, k: int):
        if not self.act_queues[k]:
            return
        acts, y = self.act_queues[k].popleft()
        self.srv_loss = self._srv_step(acts, y)
        self.srv_steps += 1
        self.consumed[k] = self.consumed.get(k, 0) + 1

    def aggregate(self, k: int):
        self.agg.aggregate(self.dev[k], self.aux[k], self.versions[k])
        theta_d, theta_aux, t = self.agg.snapshot()
        self.dev[k] = _copy(theta_d)
        self.aux[k] = _copy(theta_aux)
        self.versions[k] = t

    # --- evaluation: merged global model ---
    def eval_accuracy(self, x, y) -> float:
        params = list(self.agg.theta_d) + list(self.srv)
        with torch.no_grad():
            return self.a.accuracy(params, *_to(self.device, x, y))


# ---------------------------------------------------------------------------
# Full-model learner (classic FL / FedAsync / FedBuff)
# ---------------------------------------------------------------------------

class FullModelLearner:
    """One global model and K device copies of the whole model.  Each device
    iteration is one SGD step of the full loss on the device's copy;
    ``aggregate(k)`` is FedAsync's (α = 1/(staleness + 1), skipped past
    ``max_delay``), ``sync_aggregate`` FedAvg's mean; both hand the global
    model back to the device(s).

    The params live on ``device`` (default the card) and are drawn from a
    ``torch.Generator`` seeded with ``seed``, or, with ``init``, start from
    the given full-model params (e.g. the JAX learner's, carried across by
    ``convert.state_from_numpy``), which are copied.  TF32 is off."""

    def __init__(self, adapter: ModelAdapter, datasets: list[DeviceDataset], *,
                 lr=0.05, max_delay=16, seed=0, device="cuda", init=None):
        _exact_matmuls()
        self.a = adapter
        self.datasets = datasets
        self.device = torch.device(device)
        K = len(datasets)
        if init is None:
            init = adapter.init(
                torch.Generator(device=self.device).manual_seed(seed))
        self.global_params = _copy(init)
        self.dev = [_copy(init) for _ in range(K)]
        self.versions = [0] * K
        self.version = 0
        self.max_delay = max_delay
        self.lr = lr
        self.dev_steps = 0
        self.dev_loss = None      # the last step's loss, on the card

    def device_iter(self, k: int, _send: bool):
        x, y = _to(self.device, *self.datasets[k].next_batch())
        params, live = _grad_view(self.dev[k])
        loss = self.a.full_loss(params, x, y)
        _sgd(tree_leaves(self.dev[k]), torch.autograd.grad(loss, live),
             self.lr)
        self.dev_loss = loss.detach()
        self.dev_steps += 1

    def aggregate(self, k: int):
        staleness = self.version - self.versions[k]
        if staleness <= self.max_delay:
            alpha = 1.0 / (staleness + 1.0)
            self.global_params = tree_lerp(self.global_params, self.dev[k],
                                           alpha)
            self.version += 1
        self.dev[k] = _copy(self.global_params)
        self.versions[k] = self.version

    def sync_aggregate(self):
        self.global_params = _mean(self.dev)
        self.version += 1
        for k in range(len(self.dev)):
            self.dev[k] = _copy(self.global_params)
            self.versions[k] = self.version

    def server_train(self, k: int):
        pass

    def eval_accuracy(self, x, y) -> float:
        with torch.no_grad():
            return self.a.accuracy(self.global_params,
                                   *_to(self.device, x, y))


# ---------------------------------------------------------------------------
# Split learner (SplitFed / PiPar / OAFL)
# ---------------------------------------------------------------------------

class SplitLearner:
    """Split training with gradient return.  The simulator calls
    server_train(k) (server fwd/bwd on device k's activations, producing
    ∂loss/∂acts) *before* device_iter(k) (device-side VJP + SGD), matching
    the wire protocol.  SplitFed keeps one server-side model per device;
    sync_aggregate averages device and server halves each round; OAFL
    aggregates asynchronously (α-weighted) per arriving device.

    Params, ``device``, ``seed`` and ``init`` (the full model's params,
    split at ``l_split``) as ``FullModelLearner``'s.  The pending gradient
    stays a tensor on the card (the reference copies it to the host)."""

    def __init__(self, adapter: ModelAdapter, datasets: list[DeviceDataset],
                 l_split: int, *, lr=0.05, max_delay=16, seed=0,
                 device="cuda", init=None):
        _exact_matmuls()
        self.a = adapter
        self.l = l_split
        self.lr = lr
        self.datasets = datasets
        self.device = torch.device(device)
        K = len(datasets)
        if init is None:
            init = adapter.init(
                torch.Generator(device=self.device).manual_seed(seed))
        dev0, srv0 = adapter.split(init, l_split)
        self.dev = [_copy(dev0) for _ in range(K)]
        self.srv = [_copy(srv0) for _ in range(K)]
        self.g_dev = _copy(dev0)
        self.g_srv = _copy(srv0)
        self.versions = [0] * K
        self.version = 0
        self.max_delay = max_delay
        self._pending: dict[int, tuple] = {}
        self.dev_steps = 0
        self.srv_loss = None      # the last server step's loss, on the card

    def server_train(self, k: int):
        x, y = _to(self.device, *self.datasets[k].next_batch())
        with torch.no_grad():
            acts = self.a.device_forward(self.dev[k], x, self.l)
        srv, live = _grad_view(self.srv[k])
        acts.requires_grad_()
        loss = self.a.server_loss(srv, acts, y, self.l)
        *g_srv, g_acts = torch.autograd.grad(loss, live + [acts],
                                             allow_unused=True)
        if g_acts is None:
            # the server loss stops the gradient at the activations, as the
            # reference's does, so ∂loss/∂acts is zero there too and the
            # device halves never move (ROADMAP §C)
            g_acts = torch.zeros_like(acts)
        _sgd(tree_leaves(self.srv[k]), g_srv, self.lr)
        self.srv_loss = loss.detach()
        self._pending[k] = (x, g_acts)

    def device_iter(self, k: int, _send: bool):
        if k not in self._pending:
            return
        x, g_acts = self._pending.pop(k)
        dev, live = _grad_view(self.dev[k])
        acts = self.a.device_forward(dev, x, self.l)
        _sgd(tree_leaves(self.dev[k]),
             torch.autograd.grad(acts, live, grad_outputs=g_acts), self.lr)
        self.dev_steps += 1

    def sync_aggregate(self):
        K = len(self.dev)
        self.g_dev = _mean(self.dev)
        self.g_srv = _mean(self.srv)
        self.version += 1
        for k in range(K):
            self.dev[k] = _copy(self.g_dev)
            self.srv[k] = _copy(self.g_srv)
            self.versions[k] = self.version

    def aggregate(self, k: int):  # OAFL: async α-weighted
        staleness = self.version - self.versions[k]
        if staleness <= self.max_delay:
            alpha = 1.0 / (staleness + 1.0)
            self.g_dev = tree_lerp(self.g_dev, self.dev[k], alpha)
            self.g_srv = tree_lerp(self.g_srv, self.srv[k], alpha)
            self.version += 1
        self.dev[k] = _copy(self.g_dev)
        self.srv[k] = _copy(self.g_srv)
        self.versions[k] = self.version

    def eval_accuracy(self, x, y) -> float:
        params = list(self.g_dev) + list(self.g_srv)
        with torch.no_grad():
            return self.a.accuracy(params, *_to(self.device, x, y))
