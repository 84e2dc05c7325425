"""CNNs from the paper's own experiments (Table 4): VGG-5 and a
MobileNetV3-style bottleneck CNN, with the FedOptima split API.

A copy of the JAX package's ``models/cnn.py``.  Its layouts are kept in the
params and at every layer boundary: conv weights are HWIO (the depthwise
one ``(k, k, 1, C)``) and activations NHWC, so params cross from the JAX
package leaf for leaf (``convert.state_from_numpy``) and the activations
shipped at the split, and ``flatten``'s order, equal the reference's.
Inside a conv the activations are viewed as NCHW (channels-last strides,
no copy) and the weight as OIHW.  ``"SAME"`` padding is XLA's: with
stride s the total is max((ceil(in/s) - 1)·s + k - in, 0), the low side
gets half of it rounded down, so a stride-2 conv on an even size pads one
more on the high side than on the low (``F.conv2d``'s own ``padding``
is symmetric, and ``"same"`` refuses stride > 1).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from .common import hardswish

Params = Any


def conv_init(gen: torch.Generator, kh, kw, cin, cout, *,
              dtype=torch.float32):
    fan_in = kh * kw * cin
    return torch.randn(kh, kw, cin, cout, generator=gen, device=gen.device,
                       dtype=dtype) / math.sqrt(fan_in)


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial axis: (low, high)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x, w, stride=1, groups=1):
    """x (N, H, W, C), w (kh, kw, C / groups, Cout) -> (N, H', W', Cout)."""
    (hlo, hhi), (wlo, whi) = (_same_pads(x.shape[1], w.shape[0], stride),
                              _same_pads(x.shape[2], w.shape[1], stride))
    xc = x.permute(0, 3, 1, 2)
    if (hlo, wlo) == (hhi, whi):
        padding = (hlo, wlo)
    else:
        xc = F.pad(xc, (wlo, whi, hlo, hhi))
        padding = 0
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, padding=padding,
                 groups=groups)
    return y.permute(0, 2, 3, 1)


def _max_pool2(x):
    """2x2 max pool, stride 2, "VALID" (NHWC)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Layer descriptors: each layer is a spec dict
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CnnConfig:
    name: str
    layers: tuple            # tuple of layer spec dicts
    n_classes: int
    in_channels: int = 3
    img_size: int = 32


def vgg5_config(n_classes=10, img_size=32) -> CnnConfig:
    """VGG-5 (Table 4): CONV-3-32, CONV-3-64 x2, FC-128, FC-X."""
    return CnnConfig(name="vgg5", n_classes=n_classes, img_size=img_size,
                     layers=(
        {"kind": "conv", "k": 3, "cout": 32, "pool": True},
        {"kind": "conv", "k": 3, "cout": 64, "pool": True},
        {"kind": "conv", "k": 3, "cout": 64, "pool": True},
        {"kind": "flatten"},
        {"kind": "fc", "dout": 128},
        {"kind": "fc", "dout": n_classes, "logits": True},
    ))


def mobilenetv3ish_config(n_classes=200, img_size=64) -> CnnConfig:
    """MobileNetV3-Large-style stack (Table 4): stem conv + BNECK residual
    blocks (expand -> depthwise -> project, SE omitted) + head convs +
    classifier."""
    plan = [  # (kernel, cout, stride, expand)
        (3, 16, 1, 1), (3, 24, 2, 4), (3, 24, 1, 3),
        (5, 40, 2, 3), (5, 40, 1, 3), (5, 40, 1, 3),
        (3, 80, 2, 6), (3, 80, 1, 2.5), (3, 80, 1, 2.3), (3, 80, 1, 2.3),
        (3, 112, 1, 6), (3, 112, 1, 6),
        (5, 160, 2, 6), (5, 160, 1, 6), (5, 160, 1, 6),
    ]
    bnecks = [{"kind": "bneck", "k": k, "cout": cout, "stride": s,
               "expand": e} for k, cout, s, e in plan]
    return CnnConfig(name="mobilenetv3ish", n_classes=n_classes,
                     img_size=img_size, layers=(
        {"kind": "conv", "k": 3, "cout": 16, "stride": 2, "act": "hswish"},
        *bnecks,
        {"kind": "conv", "k": 1, "cout": 960, "act": "hswish"},
        {"kind": "gap"},
        {"kind": "fc", "dout": 1280, "act": "hswish"},
        {"kind": "fc", "dout": n_classes, "logits": True},
    ))


# ---------------------------------------------------------------------------
# Init / apply
# ---------------------------------------------------------------------------

def _layer_out(spec, cin, hw):
    """(channels or features, spatial size) after a layer."""
    kind = spec["kind"]
    if kind == "conv":
        hw //= spec.get("stride", 1)
        return spec["cout"], hw // 2 if spec.get("pool") else hw
    if kind == "bneck":
        return spec["cout"], hw // spec.get("stride", 1)
    if kind == "flatten":
        return cin * hw * hw, 1
    if kind == "gap":
        return cin, 1
    if kind == "fc":
        return spec["dout"], hw
    raise ValueError(kind)


def _layer_init(gen, spec, cin, hw, dtype):
    """Returns (params, cout, hw_out)."""
    kind = spec["kind"]
    dev = gen.device
    if kind == "conv":
        p = {"w": conv_init(gen, spec["k"], spec["k"], cin, spec["cout"],
                            dtype=dtype),
             "b": torch.zeros(spec["cout"], device=dev, dtype=dtype)}
    elif kind == "bneck":
        ce = int(round(cin * spec["expand"]))
        p = {"w_exp": conv_init(gen, 1, 1, cin, ce, dtype=dtype),
             "w_dw": conv_init(gen, spec["k"], spec["k"], 1, ce, dtype=dtype),
             "w_proj": conv_init(gen, 1, 1, ce, spec["cout"], dtype=dtype),
             "b": torch.zeros(spec["cout"], device=dev, dtype=dtype)}
    elif kind == "fc":
        p = {"w": torch.randn(cin, spec["dout"], generator=gen, device=dev,
                              dtype=dtype) / math.sqrt(cin),
             "b": torch.zeros(spec["dout"], device=dev, dtype=dtype)}
    else:
        p = {}
    return (p, *_layer_out(spec, cin, hw))


def init_params(gen: torch.Generator, cfg: CnnConfig, *,
                dtype=torch.float32) -> list:
    params, cin, hw = [], cfg.in_channels, cfg.img_size
    for spec in cfg.layers:
        p, cin, hw = _layer_init(gen, spec, cin, hw, dtype)
        params.append(p)
    return params


def _layer_apply(p, spec, x):
    kind = spec["kind"]
    if kind == "conv":
        x = conv2d(x, p["w"], stride=spec.get("stride", 1)) + p["b"]
        x = hardswish(x) if spec.get("act") == "hswish" else torch.relu(x)
        return _max_pool2(x) if spec.get("pool") else x
    if kind == "bneck":
        s = spec.get("stride", 1)
        h = hardswish(conv2d(x, p["w_exp"]))
        h = hardswish(conv2d(h, p["w_dw"], stride=s, groups=h.shape[-1]))
        h = conv2d(h, p["w_proj"]) + p["b"]
        if s == 1 and x.shape[-1] == h.shape[-1]:
            h = h + x
        return h
    if kind == "flatten":
        return x.reshape(x.shape[0], -1)
    if kind == "gap":
        return torch.mean(x, dim=(1, 2))
    if kind == "fc":
        x = x @ p["w"] + p["b"]
        if spec.get("logits"):
            return x
        return hardswish(x) if spec.get("act") == "hswish" else torch.relu(x)
    raise ValueError(kind)


def forward(params: list, cfg: CnnConfig, x, *, upto: int | None = None,
            from_layer: int = 0):
    """Apply layers [from_layer, upto).  Default: whole network -> logits."""
    hi = len(cfg.layers) if upto is None else upto
    for i in range(from_layer, hi):
        x = _layer_apply(params[i], cfg.layers[i], x)
    return x


def ce_loss(logits, labels):
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    return torch.mean(lse - gold)


def loss_fn(params: list, cfg: CnnConfig, x, labels):
    return ce_loss(forward(params, cfg, x), labels)


def accuracy(params: list, cfg: CnnConfig, x, labels):
    return torch.mean((torch.argmax(forward(params, cfg, x), -1)
                       == labels).float())


# ---------------------------------------------------------------------------
# FedOptima split API for CNNs
# ---------------------------------------------------------------------------

def split_params(params: list, l_split: int):
    return params[:l_split], params[l_split:]


def make_aux_params(gen: torch.Generator, cfg: CnnConfig, l_split: int,
                    variant: str = "default", *,
                    dtype=torch.float32) -> tuple[Params, dict]:
    """Aux network (§3.2.2): layer(s) of the same type as the last device
    layer + dense classifier.  Variants for the §6.5.1 ablation:
       default          — one aux layer + classifier
       classifier_only  — classifier directly on (pooled) activations
       deep             — two aux layers + classifier
    """
    spec = cfg.layers[l_split - 1]
    cin, hw = cfg.in_channels, cfg.img_size
    for s in cfg.layers[:l_split]:
        cin, hw = _layer_out(s, cin, hw)
    conv_like = spec["kind"] in ("conv", "bneck")
    n_layers = {"default": 1, "classifier_only": 0, "deep": 2}[variant]
    if conv_like:
        aux_spec = {"kind": "conv", "k": 3, "cout": cin}
    else:
        aux_spec = {"kind": "fc", "dout": cin}
    layers = [_layer_init(gen, aux_spec, cin, hw, dtype)[0]
              for _ in range(n_layers)]
    head = {"w": torch.randn(cin, cfg.n_classes, generator=gen,
                             device=gen.device, dtype=dtype) / math.sqrt(cin),
            "b": torch.zeros(cfg.n_classes, device=gen.device, dtype=dtype)}
    return {"layers": layers, "head": head}, \
        {"layer_spec": aux_spec, "pool": conv_like}


def aux_head_loss(aux_params: Params, spec: dict, acts, labels):
    h = acts
    for p in aux_params["layers"]:
        h = _layer_apply(p, spec["layer_spec"], h)
    if spec["pool"] and h.ndim == 4:
        h = torch.mean(h, dim=(1, 2))
    logits = h @ aux_params["head"]["w"] + aux_params["head"]["b"]
    return ce_loss(logits, labels)


def device_train_loss(dev_params: list, aux_params: Params, aux_spec: dict,
                      cfg: CnnConfig, x, labels, l_split: int):
    acts = forward(dev_params, cfg, x, upto=l_split)
    return aux_head_loss(aux_params, aux_spec, acts, labels), acts


def server_forward_loss(srv_params: list, cfg: CnnConfig, acts, labels,
                        l_split: int):
    logits = forward([None] * l_split + srv_params, cfg, acts.detach(),
                     from_layer=l_split)
    return ce_loss(logits, labels)
