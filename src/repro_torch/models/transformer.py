"""Backbone assembly, the FedOptima split API and serving, for stacks built
of the ("attn", "dense"), ("local", "dense"), ("mamba", "none"), ("cross",
"dense"), ("attn", "none"), ("attn", "moe"), ("mamba", "moe") and
("mamba", "dense") blocks: global and sliding-window attention (with
qk-norm and logit soft-caps where the arch sets them) before a dense FFN,
the Mamba2 mixer alone, gated cross-attention to the frontend (``h +
tanh(gate) * cross_attn(ln1(h), frontend)``, then the FFN),
self-attention with no FFN (whisper's decoder pattern), self-attention
before the mixture of experts, and the Mamba2 mixer before the mixture of
experts or a dense FFN (jamba's hybrid period: attention at position 0,
MoE on the odd positions).

Every block returns ``(h, aux)``: ``aux`` is a MoE block's load-balance
loss, a 0-d tensor, and the float 0.0 elsewhere (no device op for the
blocks without experts), summed over the stack.  Each half adds
``MOE_AUX_WEIGHT`` times its stack's sum to its loss; the aux block's own
is dropped, as in the JAX package.

The DNN is split at a period boundary ``l_split``.  The device half is
``embed + blocks[:l_split]`` plus an auxiliary network (one block of the
last pattern position's type and a factorized classifier head); the server
half is ``blocks[l_split:] + final_norm`` and the head — the tied
``embed_out`` or the untied ``lm_head`` — trained on detached activations.
The head's logits take the arch's ``final_softcap`` before the softmax.
A VLM (llama-3.2-vision) passes the frontend stub's embeddings to every
cross block on both halves.  An encoder-decoder (whisper) runs the encoder
prefix on the device from frame embeddings (no device ``embed``; the aux
head regresses the next frame), and the server finishes the encoder and
runs the whole decoder (``dec_blocks``, ``dec_norm``), which cross-attends
to the final encoder states (``server_encdec_loss``).

``remat`` (per period, ``torch.utils.checkpoint`` without reentrancy):
``False`` keeps every activation; ``True`` recomputes each period in the
backward; ``"selective"`` recomputes too but saves the forward kernels'
outputs (flash attention's (out, lse), SSD's (y, states)), so the backward
never launches a forward kernel again.  ``remat`` changes memory, never
values.

Serving runs the merged model (``merge_params``): ``prefill`` runs the
prompt through the stack and primes the decode caches
(``init_decode_state``'s layout: K/V per attention block, a ring of the
window's length for a local block, the Mamba state, the frontend's K/V per
cross block), and ``decode_step`` / ``serve_decode_step`` take one token a
step, updating the caches in place.  With ``use_kernel``, prefill's
self-attention takes the flash-attention forward kernel and its Mamba
blocks the SSD forward kernel (``ops.ssd_prefill``); decode takes none.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as Fn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .api import ArchConfig
from .attention import (attention_apply, attention_decode, attention_init,
                        kv_cache_init, sdpa_reference)
from .common import (dense_init, embed_init, rmsnorm_apply, rmsnorm_init,
                     softcap, tree_map)
from .mamba import mamba_apply, mamba_decode, mamba_init, mamba_state_init
from .mlp import mlp_apply, mlp_init, moe_apply_grouped, moe_init

#: (mixer, ffn) blocks the port runs: all that the JAX package's archs use.
BLOCKS = (("attn", "dense"), ("local", "dense"), ("mamba", "none"),
          ("cross", "dense"), ("attn", "none"), ("attn", "moe"),
          ("mamba", "moe"), ("mamba", "dense"))
#: Weight of the stack's MoE load-balance loss in both halves' losses.
MOE_AUX_WEIGHT = 0.01


def _check_pattern(cfg: ArchConfig) -> None:
    for block in cfg.pattern:
        if block not in BLOCKS:
            raise NotImplementedError(
                f"{cfg.name}: block {block!r} — the torch port runs "
                f"{BLOCKS} blocks so far")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _block_init(gen: torch.Generator, cfg: ArchConfig, mixer: str, ffn: str,
                dtype) -> dict:
    dev = gen.device
    p = {"ln1": rmsnorm_init(cfg.d_model, device=dev, dtype=dtype)}
    if mixer == "mamba":
        p["mixer"] = mamba_init(gen, cfg.mamba_cfg(), dtype=dtype)
    elif mixer == "cross":
        p["mixer"] = attention_init(gen, cfg.cross_cfg(), dtype=dtype)
        p["gate"] = torch.zeros((), device=dev, dtype=dtype)   # zero-init
    else:
        p["mixer"] = attention_init(gen, cfg.attn_cfg(mixer), dtype=dtype)
    if ffn == "dense":
        p["ln2"] = rmsnorm_init(cfg.d_model, device=dev, dtype=dtype)
        p["ffn"] = mlp_init(gen, cfg.mlp_cfg(), dtype=dtype)
    elif ffn == "moe":
        p["ln2"] = rmsnorm_init(cfg.d_model, device=dev, dtype=dtype)
        p["ffn"] = moe_init(gen, cfg.moe_cfg(), dtype=dtype)
    return p


def _stack_init(gen: torch.Generator, cfg: ArchConfig, n_periods: int,
                dtype) -> list:
    """Per-position-in-period param stacks, leaves shaped (n_periods, ...)."""
    stacks = []
    for mixer, ffn in cfg.pattern:
        per = [_block_init(gen, cfg, mixer, ffn, dtype)
               for _ in range(n_periods)]
        stacks.append(tree_map(lambda *xs: torch.stack(xs), *per))
    return stacks


def init_params(gen: torch.Generator, cfg: ArchConfig,
                dtype=torch.float32) -> dict:
    _check_pattern(cfg)
    params = {"embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype=dtype),
              "blocks": _stack_init(gen, cfg, cfg.n_periods, dtype),
              "final_norm": rmsnorm_init(cfg.d_model, device=gen.device,
                                         dtype=dtype)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab,
                                       dtype=dtype)
    if cfg.n_decoder_layers:          # enc-dec: the decoder stack
        dec_cfg = _decoder_cfg(cfg)
        params["dec_blocks"] = _stack_init(gen, dec_cfg, dec_cfg.n_periods,
                                           dtype)
        params["dec_norm"] = rmsnorm_init(cfg.d_model, device=gen.device,
                                          dtype=dtype)
    return params


def _decoder_cfg(cfg: ArchConfig) -> ArchConfig:
    """Decoder stack of an enc-dec model: self-attention, then
    cross-attention to the encoder and the FFN."""
    return cfg.scaled(n_layers=cfg.n_decoder_layers,
                      pattern=(("attn", "none"), ("cross", "dense")),
                      n_decoder_layers=0)


# ---------------------------------------------------------------------------
# Blocks and the stack
# ---------------------------------------------------------------------------

def _apply_block(p: dict, cfg: ArchConfig, mixer: str, ffn: str, h, *,
                 positions, frontend=None, use_kernel: bool = False,
                 return_state: bool = False):
    """One block: (h, aux), aux the MoE load-balance loss (0.0 without).
    With ``return_state`` (prefill), (h, aux, state): the mixer's state
    for the decode caches (the rotated k and v, the frontend's k and v, or
    the Mamba state)."""
    aux, state = 0.0, {}
    x = rmsnorm_apply(p["ln1"], h)
    if mixer == "mamba":
        y = mamba_apply(p["mixer"], cfg.mamba_cfg(), x, use_kernel=use_kernel,
                        return_state=return_state)
    elif mixer == "cross":
        # never the kernel: the JAX package's cross call takes none either
        y = attention_apply(p["mixer"], cfg.cross_cfg(), x, xkv=frontend,
                            return_kv=return_state)
    else:
        y = attention_apply(p["mixer"], cfg.attn_cfg(mixer), x,
                            positions=positions, use_kernel=use_kernel,
                            return_kv=return_state)
    if return_state:
        y, state = y
    h = h + (torch.tanh(p["gate"]) * y if mixer == "cross" else y)
    if ffn == "dense":
        h = h + mlp_apply(p["ffn"], cfg.mlp_cfg(), rmsnorm_apply(p["ln2"], h))
    elif ffn == "moe":
        y, aux = moe_apply_grouped(p["ffn"], cfg.moe_cfg(),
                                   rmsnorm_apply(p["ln2"], h),
                                   capacity_factor=cfg.moe_capacity_factor)
        h = h + y
    if return_state:
        return h, aux, state
    return h, aux


def _save_kernel_out(ctx, op, *args, **kwargs):
    """Selective-remat policy: keep the forward kernels' outputs (O(S·hd)
    and O(nc·N·P) each, never an S×S or Q×Q tile), recompute everything
    else."""
    from repro_torch.kernels.ops import SAVED_OPS
    return CheckpointPolicy.MUST_SAVE if op in SAVED_OPS else \
        CheckpointPolicy.PREFER_RECOMPUTE


_selective_context = functools.partial(create_selective_checkpoint_contexts,
                                       _save_kernel_out)


def _periods(blocks: list) -> int:
    return blocks[0]["ln1"]["scale"].shape[0]


def _run_stack(blocks: list, cfg: ArchConfig, h, *, positions,
               frontend=None, use_kernel: bool = False, remat=True):
    """(h, aux): the stack's output and its blocks' summed MoE loss."""
    _check_pattern(cfg)

    def period_fn(h, stacks_slice):
        aux_total = 0.0
        for pos, (mixer, ffn) in enumerate(cfg.pattern):
            h, aux = _apply_block(stacks_slice[pos], cfg, mixer, ffn, h,
                                  positions=positions, frontend=frontend,
                                  use_kernel=use_kernel)
            aux_total = aux_total + aux
        return h, aux_total

    aux_sum = 0.0
    for i in range(_periods(blocks)):
        stacks_slice = [tree_map(lambda x: x[i], s) for s in blocks]
        if remat == "selective":
            h, aux = checkpoint(period_fn, h, stacks_slice,
                                use_reentrant=False,
                                context_fn=_selective_context)
        elif remat:
            h, aux = checkpoint(period_fn, h, stacks_slice,
                                use_reentrant=False)
        else:
            h, aux = period_fn(h, stacks_slice)
        aux_sum = aux_sum + aux
    return h, aux_sum


# ---------------------------------------------------------------------------
# Chunked cross-entropy
# ---------------------------------------------------------------------------

def _chunked_ce(logits_fn, h, labels, mask, s_chunk: int):
    """Sequence-chunked CE on (B, S, D) hidden states: each chunk's
    (B, sc, V) logits are recomputed in the backward instead of kept."""
    S = h.shape[1]
    sc = min(s_chunk, S)

    def chunk_loss(hc, lc, mc):
        logits = logits_fn(hc).float()                       # (B, sc, V)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc[..., None])[..., 0]
        return torch.sum((lse - gold) * mc), torch.sum(mc)

    loss = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, sc):
        l, c = checkpoint(chunk_loss, h[:, i:i + sc], labels[:, i:i + sc],
                          mask[:, i:i + sc], use_reentrant=False)
        loss, cnt = loss + l, cnt + c
    return loss / torch.clamp(cnt, min=1.0)


def chunked_ce_loss(params: dict, cfg: ArchConfig, h, labels, mask=None):
    """Next-token CE without materialising the full (B, S, V) logits; the
    arch's ``final_softcap`` caps each chunk's logits before the softmax."""
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    w = params["lm_head"] if not cfg.tie_embeddings else params["embed"].T

    def logits_fn(hc):
        logits = hc @ w
        if cfg.final_softcap is not None:
            logits = softcap(logits, cfg.final_softcap)
        return logits

    return _chunked_ce(logits_fn, h, labels, mask.float(), cfg.ce_chunk)


# ---------------------------------------------------------------------------
# FedOptima split API
# ---------------------------------------------------------------------------

def _slice_stacks(blocks: list, lo: int, hi: int) -> list:
    return [tree_map(lambda x: x[lo:hi], s) for s in blocks]


def make_aux_params(gen: torch.Generator, cfg: ArchConfig,
                    dtype=torch.float32, *, regression: bool = False) -> dict:
    """Auxiliary network: one block of the last pattern position's type and
    a factorized dense classifier (d_model -> aux_dim -> vocab).  With
    ``regression`` (continuous inputs: whisper's encoder) the head goes
    back to d_model (``head_reg``) for the next-frame MSE."""
    mixer, ffn = cfg.pattern[-1]
    p = {"block": _block_init(gen, cfg, mixer, ffn, dtype),
         "norm": rmsnorm_init(cfg.d_model, device=gen.device, dtype=dtype),
         "head_in": dense_init(gen, cfg.d_model, cfg.aux_dim, dtype=dtype)}
    if regression:
        p["head_reg"] = dense_init(gen, cfg.aux_dim, cfg.d_model, dtype=dtype)
    else:
        p["head_out"] = dense_init(gen, cfg.aux_dim, cfg.vocab, dtype=dtype)
    return p


def split_params(params: dict, cfg: ArchConfig, l_split: int):
    """Split at period boundary l_split in [1, n_periods - 1].  Enc-dec:
    the device half is the encoder prefix, fed frame embeddings, so it has
    no ``embed``; the decoder stays on the server, since it cross-attends
    to the final encoder states."""
    dev = {"blocks": _slice_stacks(params["blocks"], 0, l_split)}
    if not cfg.n_decoder_layers:
        dev["embed"] = params["embed"]
    srv = {"blocks": _slice_stacks(params["blocks"], l_split, cfg.n_periods),
           "final_norm": params["final_norm"]}
    if cfg.tie_embeddings:
        srv["embed_out"] = params["embed"]      # tied head lives server-side
    else:
        srv["lm_head"] = params["lm_head"]
    if cfg.n_decoder_layers:
        srv["dec_blocks"] = params["dec_blocks"]
        srv["dec_norm"] = params["dec_norm"]
    return dev, srv


def merge_params(dev: dict, srv: dict, cfg: ArchConfig) -> dict:
    blocks = [tree_map(lambda a, b: torch.cat([a, b]), d, s)
              for d, s in zip(dev["blocks"], srv["blocks"])]
    out = {"embed": dev.get("embed", srv.get("embed_out")), "blocks": blocks,
           "final_norm": srv["final_norm"]}
    for key in ("lm_head", "dec_blocks", "dec_norm"):
        if key in srv:
            out[key] = srv[key]
    return out


def _positions(x):
    return torch.arange(x.shape[1], device=x.device)[None, :]


def device_forward(dev_params: dict, cfg: ArchConfig, tokens, *,
                   frontend=None, use_kernel: bool = False, remat=True):
    """The device-side block; returns (activations (B, S, D), the stack's
    MoE loss).  ``tokens`` is (B, S) ids, or (B, F, D) frame embeddings for
    an encoder prefix; ``frontend`` (B, F, D) feeds the VLM's cross
    blocks."""
    h = dev_params["embed"][tokens] if tokens.ndim == 2 else tokens
    return _run_stack(dev_params["blocks"], cfg, h, positions=_positions(h),
                      frontend=frontend, use_kernel=use_kernel, remat=remat)


def aux_head_loss(aux_params: dict, cfg: ArchConfig, acts, labels, *,
                  frontend=None):
    """Local loss f_d through the auxiliary network (Alg. 1 lines 7-8):
    CE on the local labels, or, when ``labels`` is the (B, F, D) frame
    stream (whisper's encoder), the MSE of the next frame.  The aux block
    never takes the kernels, and its own MoE loss is dropped, as in the
    JAX package."""
    mixer, ffn = cfg.pattern[-1]
    h, _ = _apply_block(aux_params["block"], cfg, mixer, ffn, acts,
                     positions=_positions(acts), frontend=frontend)
    h = rmsnorm_apply(aux_params["norm"], h)
    if labels.ndim == 3:
        pred = (h @ aux_params["head_in"]) @ aux_params["head_reg"]
        target = torch.roll(labels, -1, dims=1)
        return torch.mean(torch.square(
            (pred[:, :-1] - target[:, :-1]).float()))
    return _chunked_ce(
        lambda hc: (hc @ aux_params["head_in"]) @ aux_params["head_out"],
        h, labels, torch.ones(labels.shape, dtype=torch.float32,
                              device=labels.device), cfg.ce_chunk)


def device_train_loss(dev_params: dict, aux_params: dict, cfg: ArchConfig,
                      tokens, labels, *, frontend=None,
                      use_kernel: bool = False, remat=True):
    """Device-side objective F_d (Eq. 4) plus the device stack's MoE loss.
    Returns (loss, activations)."""
    acts, moe_aux = device_forward(dev_params, cfg, tokens,
                                   frontend=frontend, use_kernel=use_kernel,
                                   remat=remat)
    loss = aux_head_loss(aux_params, cfg, acts, labels, frontend=frontend)
    return loss + MOE_AUX_WEIGHT * moe_aux, acts


def _guard_dead_rows(h, *rows):
    """Zero the input gradient of the ring's unwritten rows at ``h``, the
    output of a stack fed ``rows`` (the acts, and a VLM's frontend).  Such
    a row is all zero in every input and stays zero through every block,
    so its share of every param gradient is exactly 0.  Its input
    gradient, though, grows by rsqrt(eps) = 1e3 per RMSNorm; past ~13
    blocks it overflows f32 and 0 * inf turns every param gradient into
    NaN (the JAX reference does so at smollm's full depth).  Zeroing it
    keeps every gradient the reference computes where it stays finite."""
    if h.requires_grad:
        live = torch.stack([r.flatten(1).ne(0).any(dim=1) for r in rows]) \
            .any(dim=0).to(h.dtype)[:, None, None]
        h.register_hook(lambda g: g * live)
    return h


def _head(srv_params: dict) -> dict:
    return {"lm_head": srv_params["lm_head"]} if "lm_head" in srv_params \
        else {"embed": srv_params["embed_out"]}


def server_forward_loss(srv_params: dict, cfg: ArchConfig, acts, labels, *,
                        frontend=None, use_kernel: bool = False, remat=True):
    """Server-side objective F_s (Eq. 5) on detached activations: no
    gradient ever flows back to the devices.  ``frontend`` feeds the VLM's
    server-side cross blocks.  The server stack's MoE loss is added."""
    acts = acts.detach()
    h, moe_aux = _run_stack(srv_params["blocks"], cfg, acts, positions=_positions(acts),
                   frontend=frontend, use_kernel=use_kernel, remat=remat)
    h = _guard_dead_rows(h, acts, *(() if frontend is None else (frontend,)))
    h = rmsnorm_apply(srv_params["final_norm"], h)
    return chunked_ce_loss(_head(srv_params), cfg, h, labels) + \
        MOE_AUX_WEIGHT * moe_aux


def server_encdec_loss(srv_params: dict, cfg: ArchConfig, acts, tokens,
                       labels, *, use_kernel: bool = False, remat=True):
    """Server-side objective of an enc-dec arch (whisper): finish the
    encoder on the devices' detached activations, then run the decoder on
    ``tokens`` with cross-attention to the final encoder states, and take
    the next-token CE against ``labels``."""
    acts = acts.detach()
    enc, aux_e = _run_stack(srv_params["blocks"], cfg, acts,
                     positions=_positions(acts), use_kernel=use_kernel,
                     remat=remat)
    enc = rmsnorm_apply(srv_params["final_norm"], _guard_dead_rows(enc, acts))
    head = _head(srv_params)
    h = head["embed"][tokens] if "embed" in head else head["lm_head"].T[tokens]
    h, aux_d = _run_stack(srv_params["dec_blocks"], _decoder_cfg(cfg), h,
                          positions=_positions(h), frontend=enc,
                          use_kernel=use_kernel, remat=remat)
    h = rmsnorm_apply(srv_params["dec_norm"], h)
    return chunked_ce_loss(head, cfg, h, labels) + \
        MOE_AUX_WEIGHT * (aux_e + aux_d)


# ---------------------------------------------------------------------------
# Serving: prefill and cached decode of the merged model
# ---------------------------------------------------------------------------

def forward(params: dict, cfg: ArchConfig, tokens, *, frontend=None,
            use_kernel: bool = False, remat=True):
    """The whole stack: (final hidden states (B, S, D), the MoE loss).
    ``tokens`` is (B, S) ids, or (B, F, D) frame embeddings for an
    encoder."""
    h = params["embed"][tokens] if tokens.ndim == 2 else tokens
    h, aux = _run_stack(params["blocks"], cfg, h, positions=_positions(h),
                        frontend=frontend, use_kernel=use_kernel, remat=remat)
    return rmsnorm_apply(params["final_norm"], h), aux


def _lm_logits(params: dict, cfg: ArchConfig, h):
    w = params["lm_head"] if not cfg.tie_embeddings else params["embed"].T
    logits = h @ w
    if cfg.final_softcap is not None:
        logits = softcap(logits, cfg.final_softcap)
    return logits


def _decoder_params(params: dict) -> dict:
    """An enc-dec model's decoder as a stack of its own."""
    dec = {"embed": params["embed"], "blocks": params["dec_blocks"],
           "final_norm": params["dec_norm"]}
    if "lm_head" in params:
        dec["lm_head"] = params["lm_head"]
    return dec


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      dtype=torch.float32, frontend_len: int | None = None,
                      *, device=None) -> list:
    """Per pattern position, the caches of its mixer stacked over the
    periods (leaves (n_periods, ...)): K/V of ``max_len`` positions (of
    ``min(max_len, window)`` for a local block), the Mamba state, the
    frontend's K/V for a cross block, {} for a block with no state."""
    n = cfg.n_periods
    caches = []
    for mixer, _ in cfg.pattern:
        if mixer in ("attn", "local"):
            L = min(max_len, cfg.window) \
                if (mixer == "local" and cfg.window) else max_len
            c = kv_cache_init(cfg.attn_cfg(mixer), batch, L, dtype,
                              device=device)
        elif mixer == "mamba":
            c = mamba_state_init(cfg.mamba_cfg(), batch, dtype, device=device)
        elif mixer == "cross":
            c = kv_cache_init(cfg.cross_cfg(), batch,
                              frontend_len or cfg.frontend_len, dtype,
                              device=device)
        else:
            c = {}
        caches.append(tree_map(lambda x: x.expand(n, *x.shape).clone(), c))
    return caches


def decode_step(params: dict, cfg: ArchConfig, caches: list, token,
                position: int, *, frontend=None):
    """token: (B, 1) ids; ``position`` (a host int) its index.  Returns
    (logits (B, V), caches), the caches updated in place.  An enc-dec
    model goes through ``serve_decode_step``.  ``frontend`` is unused (the
    cross blocks read their primed caches) and kept only to match the
    JAX package's signature."""
    h = params["embed"][token]
    for i in range(_periods(params["blocks"])):
        for pos, (mixer, ffn) in enumerate(cfg.pattern):
            p = tree_map(lambda x: x[i], params["blocks"][pos])
            c = tree_map(lambda x: x[i], caches[pos])     # views: written
            x = rmsnorm_apply(p["ln1"], h)
            if mixer in ("attn", "local"):
                ring = mixer == "local" and cfg.window is not None
                y, _ = attention_decode(p["mixer"], cfg.attn_cfg(mixer), x,
                                        c, position, ring=ring)
                h = h + y
            elif mixer == "mamba":
                y, new = mamba_decode(p["mixer"], cfg.mamba_cfg(), x, c)
                for key, t in new.items():
                    c[key].copy_(t)
                h = h + y
            elif mixer == "cross":
                # cached cross K/V (from the frontend, at prefill)
                h = h + torch.tanh(p["gate"]) * _cross_decode(
                    p["mixer"], cfg.cross_cfg(), x, c)
            if ffn == "dense":
                h = h + mlp_apply(p["ffn"], cfg.mlp_cfg(),
                                  rmsnorm_apply(p["ln2"], h))
            elif ffn == "moe":
                y, _ = moe_apply_grouped(
                    p["ffn"], cfg.moe_cfg(), rmsnorm_apply(p["ln2"], h),
                    capacity_factor=max(4.0, cfg.moe_capacity_factor))
                h = h + y
    h = rmsnorm_apply(params["final_norm"], h)
    return _lm_logits(params, cfg, h)[:, 0], caches


def _cross_decode(p: dict, acfg, q_in, cache: dict):
    """Cross-attention during decode: K/V from the (static) frontend
    cache."""
    B = q_in.shape[0]
    q = (q_in @ p["wq"]).reshape(B, 1, acfg.n_heads, acfg.hd)
    out = sdpa_reference(q, cache["k"], cache["v"], causal=False,
                         window=None, logit_cap=None)
    return out.reshape(B, 1, acfg.n_heads * acfg.hd) @ p["wo"]


def _state_to_cache(cfg: ArchConfig, mixer: str, st: dict, S: int,
                    max_len: int) -> dict:
    """A block's prefill state in ``init_decode_state``'s layout, so decode
    goes on at position S.  Where S >= W, the cache's length, the last W
    positions lie on the ring: slot j holds the position p with
    p % W == j."""
    if mixer in ("attn", "local"):
        W = min(max_len, cfg.window) \
            if (mixer == "local" and cfg.window) else max_len

        def place(x):
            if S >= W:
                idx = torch.remainder(
                    torch.arange(W, device=x.device) - S % W, W)
                return x[:, S - W:][:, idx]
            return Fn.pad(x, (0, 0, 0, 0, 0, W - S))
        return {"k": place(st["k"]), "v": place(st["v"])}
    if mixer in ("mamba", "cross"):
        return st
    return {}


def prefill(params: dict, cfg: ArchConfig, tokens, *, max_len=None,
            frontend=None, use_kernel: bool = False):
    """Run the prompt through the stack and prime the decode caches:
    (last-position logits (B, V), caches in ``init_decode_state``'s layout
    for ``max_len`` positions), so decode goes on at position S.  An
    enc-dec model runs the encoder on ``frontend`` and prefills its decoder
    on ``tokens``, with the cross caches from the encoder's output.  With
    ``use_kernel`` the self-attention blocks take the flash-attention
    forward kernel and the Mamba blocks the SSD forward kernel; the cross
    blocks never take one."""
    if cfg.n_decoder_layers:
        enc, _ = forward(params, cfg, frontend, use_kernel=use_kernel,
                         remat=False)
        return prefill(_decoder_params(params), _decoder_cfg(cfg), tokens,
                       max_len=max_len, frontend=enc, use_kernel=use_kernel)
    h = params["embed"][tokens] if tokens.ndim == 2 else tokens
    S = h.shape[1]
    L = max_len or S
    positions = _positions(h)
    per = [[] for _ in cfg.pattern]
    for i in range(_periods(params["blocks"])):
        for pos, (mixer, ffn) in enumerate(cfg.pattern):
            p = tree_map(lambda x: x[i], params["blocks"][pos])
            h, _, st = _apply_block(p, cfg, mixer, ffn, h,
                                    positions=positions, frontend=frontend,
                                    use_kernel=use_kernel, return_state=True)
            per[pos].append(_state_to_cache(cfg, mixer, st, S, L))
    caches = [tree_map(lambda *xs: torch.stack(xs), *c) for c in per]
    h = rmsnorm_apply(params["final_norm"], h[:, -1:])
    return _lm_logits(params, cfg, h)[:, 0], caches


def serve_decode_step(params: dict, cfg: ArchConfig, caches: list, token,
                      position: int):
    """``decode_step``, through the decoder stack for an enc-dec model
    (its cross caches primed by ``prefill``)."""
    if cfg.n_decoder_layers:
        return decode_step(_decoder_params(params), _decoder_cfg(cfg),
                           caches, token, position)
    return decode_step(params, cfg, caches, token, position)


def init_serve_state(cfg: ArchConfig, batch: int, max_len: int,
                     dtype=torch.float32, *, device=None) -> list:
    """``init_decode_state``, of the decoder stack for an enc-dec model."""
    if cfg.n_decoder_layers:
        return init_decode_state(_decoder_cfg(cfg), batch, max_len, dtype,
                                 frontend_len=cfg.frontend_len, device=device)
    return init_decode_state(cfg, batch, max_len, dtype,
                             frontend_len=cfg.frontend_len or None,
                             device=device)


def prefill_cross_cache(params: dict, cfg: ArchConfig, frontend) -> list:
    """Per pattern position, the cross blocks' K/V of the frontend
    embeddings (B, F, D), stacked over the periods; None elsewhere."""
    B, F, _ = frontend.shape
    hd = cfg.cross_cfg().hd
    caches = []
    for pos, (mixer, _) in enumerate(cfg.pattern):
        if mixer != "cross":
            caches.append(None)
            continue
        w = params["blocks"][pos]["mixer"]
        caches.append({
            name: torch.stack([(frontend @ wi).reshape(B, F, cfg.n_kv_heads,
                                                       hd) for wi in w[key]])
            for name, key in (("k", "wk"), ("v", "wv"))})
    return caches
