"""Transformer text classifiers from the paper (Table 4): Transformer-6
(EMB-100, ENC-100-5-100 x6, FC-X) and Transformer-12.

A copy of the JAX package's ``models/text_classifier.py``.  The layer list
mirrors ``cnn.py`` so the FedOptima learner treats CNNs and transformers
alike: layers are ("emb" | "enc" | "pool" | "fc"), split points are layer
indices, and the aux network is one layer of the same type as the last
device layer + a dense classifier (§3.2.2).  An encoder layer is pre-norm
attention (non-causal, RoPE, the plain ``sdpa_chunked``) and a GELU MLP.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from .attention import AttentionConfig, attention_apply, attention_init
from .common import embed_init, layernorm_apply, layernorm_init
from .mlp import MlpConfig, mlp_apply, mlp_init

Params = Any


@dataclass(frozen=True)
class TextClassifierConfig:
    name: str
    layers: tuple
    vocab: int
    n_classes: int
    seq_len: int
    d_model: int


def transformer6_config(vocab=8000, n_classes=2, seq_len=64, d_model=100,
                        n_heads=5, d_ff=100,
                        n_layers=6) -> TextClassifierConfig:
    return TextClassifierConfig(
        name=f"transformer{n_layers}", vocab=vocab, n_classes=n_classes,
        seq_len=seq_len, d_model=d_model,
        layers=({"kind": "emb"},
                *({"kind": "enc", "heads": n_heads, "d_ff": d_ff},) * n_layers,
                {"kind": "pool"},
                {"kind": "fc", "dout": n_classes, "logits": True}))


def transformer12_config(vocab=12000, n_classes=2, seq_len=128, d_model=100,
                         n_heads=50, d_ff=100) -> TextClassifierConfig:
    return transformer6_config(vocab, n_classes, seq_len, d_model, n_heads,
                               d_ff, n_layers=12)


def _attn_cfg(spec, cfg: TextClassifierConfig) -> AttentionConfig:
    return AttentionConfig(d_model=cfg.d_model, n_heads=spec["heads"],
                           n_kv_heads=spec["heads"], causal=False)


def _layer_init(gen, spec, cfg: TextClassifierConfig, din, dtype):
    kind = spec["kind"]
    dev = gen.device
    if kind == "emb":
        return {"tok": embed_init(gen, cfg.vocab, cfg.d_model, dtype=dtype),
                "pos": embed_init(gen, cfg.seq_len, cfg.d_model,
                                  dtype=dtype)}, cfg.d_model
    if kind == "enc":
        return {"attn": attention_init(gen, _attn_cfg(spec, cfg), dtype=dtype),
                "ln1": layernorm_init(cfg.d_model, device=dev, dtype=dtype),
                "mlp": mlp_init(gen, MlpConfig(cfg.d_model, spec["d_ff"],
                                               "gelu"), dtype=dtype),
                "ln2": layernorm_init(cfg.d_model, device=dev, dtype=dtype)}, \
            cfg.d_model
    if kind == "pool":
        return {}, din
    if kind == "fc":
        return {"w": torch.randn(din, spec["dout"], generator=gen, device=dev,
                                 dtype=dtype) / math.sqrt(din),
                "b": torch.zeros(spec["dout"], device=dev, dtype=dtype)}, \
            spec["dout"]
    raise ValueError(kind)


def init_params(gen: torch.Generator, cfg: TextClassifierConfig, *,
                dtype=torch.float32) -> list:
    params, d = [], cfg.d_model
    for spec in cfg.layers:
        p, d = _layer_init(gen, spec, cfg, d, dtype)
        params.append(p)
    return params


def _layer_apply(p, spec, cfg: TextClassifierConfig, x):
    kind = spec["kind"]
    if kind == "emb":
        return p["tok"][x] + p["pos"][None, :x.shape[1]]
    if kind == "enc":
        h = x + attention_apply(p["attn"], _attn_cfg(spec, cfg),
                                layernorm_apply(p["ln1"], x))
        return h + mlp_apply(p["mlp"], MlpConfig(cfg.d_model, spec["d_ff"],
                                                 "gelu"),
                             layernorm_apply(p["ln2"], h))
    if kind == "pool":
        return torch.mean(x, dim=1)
    if kind == "fc":
        return x @ p["w"] + p["b"]
    raise ValueError(kind)


def forward(params: list, cfg: TextClassifierConfig, x, *, upto=None,
            from_layer: int = 0):
    hi = len(cfg.layers) if upto is None else upto
    for i in range(from_layer, hi):
        x = _layer_apply(params[i], cfg.layers[i], cfg, x)
    return x


def ce_loss(logits, labels):
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    return torch.mean(lse - gold)


def loss_fn(params, cfg, x, labels):
    return ce_loss(forward(params, cfg, x), labels)


def accuracy(params, cfg, x, labels):
    return torch.mean((torch.argmax(forward(params, cfg, x), -1)
                       == labels).float())


# --- FedOptima split API (mirrors cnn.py) ---

def split_params(params: list, l_split: int):
    return params[:l_split], params[l_split:]


def make_aux_params(gen: torch.Generator, cfg: TextClassifierConfig,
                    l_split: int, variant: str = "default", *,
                    dtype=torch.float32) -> tuple[Params, dict]:
    """Aux-network variants for the §6.5.1 ablation:
       default          — one enc layer + dense classifier
       classifier_only  — dense classifier only
       deep             — two enc layers + dense classifier"""
    spec = {"kind": "enc", "heads": 5 if cfg.d_model % 5 == 0 else 4,
            "d_ff": cfg.d_model}
    n_enc = {"default": 1, "classifier_only": 0, "deep": 2}[variant]
    layers = [_layer_init(gen, spec, cfg, cfg.d_model, dtype)[0]
              for _ in range(n_enc)]
    head = {"w": torch.randn(cfg.d_model, cfg.n_classes, generator=gen,
                             device=gen.device, dtype=dtype)
            / math.sqrt(cfg.d_model),
            "b": torch.zeros(cfg.n_classes, device=gen.device, dtype=dtype)}
    return {"layers": layers, "head": head}, {"layer_spec": spec}


def aux_head_loss(aux_params: Params, spec: dict, cfg: TextClassifierConfig,
                  acts, labels):
    h = acts
    for p in aux_params["layers"]:
        h = _layer_apply(p, spec["layer_spec"], cfg, h)
    h = torch.mean(h, dim=1) if h.ndim == 3 else h
    logits = h @ aux_params["head"]["w"] + aux_params["head"]["b"]
    return ce_loss(logits, labels)


def device_train_loss(dev_params, aux_params, aux_spec, cfg, x, labels,
                      l_split):
    acts = forward(dev_params, cfg, x, upto=l_split)
    return aux_head_loss(aux_params, aux_spec, cfg, acts, labels), acts


def server_forward_loss(srv_params, cfg, acts, labels, l_split):
    logits = forward([None] * l_split + srv_params, cfg, acts.detach(),
                     from_layer=l_split)
    return ce_loss(logits, labels)
