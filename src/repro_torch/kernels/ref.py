"""Plain PyTorch versions of the five kernels, and the sequential SSD
oracle.

Each kernel's plain version has its kernel's exact semantics and layout,
so the CPU tests run them in the kernels' place and ``chip_smoke.py``
holds each CUDA kernel against them on the card.

Flash attention: q, o, do (B, H, S, hd), k, v (B, Hkv, Skv, hd), lse and
delta (B, H, S) float32.  A fully-masked row gives out 0 and lse
``NEG_INF`` (the JAX oracle ``ref.flash_attention_reference`` gives -inf
there; the kernels, and these, follow the Pallas kernels).

SSD (Mamba2): x (B, T, H, P), dt (B, T, H), A (H,), Bm and Cm (B, T, G, N)
with head h reading group h // (H // G), T a multiple of the chunk Q;
``states`` (B, H, nc, N, P) holds the state *entering* each chunk.  The
decay e^{L_t - L_s} is taken only where s <= t: the difference is masked
to -inf before ``exp``, so no inf arises for s > t (the JAX plain path's
``where(tri, exp(diff), 0)`` overflows there at large decay, and its
gradient turns 0 · inf into NaN).  They compute in float32, or in float64
when x is float64: the tests measure float32's own rounding that way.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def visible(S: int, Skv: int, *, causal: bool, window: int | None,
            device) -> torch.Tensor:
    """(S, Skv) bool: may query qpos attend to key kpos (top-left causal,
    sliding window ``kpos > qpos - window``)."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones(S, Skv, dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _logits(q, k, *, logit_cap):
    """z = softcap(scale · q kᵀ) with the kv heads repeated over each GQA
    group: (B, H, S, Skv) float32."""
    group = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    s = (q.float() @ kf.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    if logit_cap is not None:
        s = logit_cap * torch.tanh(s / logit_cap)
    return s


def fa_fwd(q, k, v, *, causal: bool, window: int | None = None,
           logit_cap: float | None = None):
    """Returns (out like q, lse (B, H, S) float32)."""
    group = q.shape[1] // k.shape[1]
    mask = visible(q.shape[2], k.shape[2], causal=causal, window=window,
                   device=q.device)
    s = _logits(q, k, logit_cap=logit_cap).masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1)
    vf = v.float().repeat_interleave(group, dim=1)
    out = (p @ vf) / torch.where(l > 0, l, 1.0)[..., None]
    lse = torch.where(l > 0, m[..., 0] + torch.log(torch.where(l > 0, l, 1.0)),
                      NEG_INF)
    return out.to(q.dtype), lse


def _p_ds(q, k, v, do, lse, delta, *, causal, window, logit_cap):
    """Recomputed probabilities p and logit gradients dS, (B, H, S, Skv)."""
    group = q.shape[1] // k.shape[1]
    mask = visible(q.shape[2], k.shape[2], causal=causal, window=window,
                   device=q.device)
    z = _logits(q, k, logit_cap=logit_cap)
    p = torch.where(mask, torch.exp(z - lse[..., None]), 0.0)
    vf = v.float().repeat_interleave(group, dim=1)
    dp = do.float() @ vf.transpose(-1, -2)
    ds = p * (dp - delta[..., None])
    if logit_cap is not None:
        ds = ds * (1.0 - torch.square(z / logit_cap))
    return p, ds


def fa_bwd_dq(q, k, v, do, lse, delta, *, causal: bool,
              window: int | None = None, logit_cap: float | None = None):
    """dq = scale · Σ_j dS_ij k_j, float32 (B, H, S, hd)."""
    group = q.shape[1] // k.shape[1]
    _, ds = _p_ds(q, k, v, do, lse, delta, causal=causal, window=window,
                  logit_cap=logit_cap)
    kf = k.float().repeat_interleave(group, dim=1)
    return (ds @ kf) * (1.0 / math.sqrt(q.shape[-1]))


def fa_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool,
               window: int | None = None, logit_cap: float | None = None):
    """(dk, dv), float32 (B, Hkv, Skv, hd): Σ over the GQA group's query
    heads of scale · dSᵀ q and pᵀ dO."""
    B, H, S, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    p, ds = _p_ds(q, k, v, do, lse, delta, causal=causal, window=window,
                  logit_cap=logit_cap)
    dk = (ds.transpose(-1, -2) @ q.float()) * (1.0 / math.sqrt(hd))
    dv = p.transpose(-1, -2) @ do.float()
    fold = lambda t: t.reshape(B, Hkv, H // Hkv, Skv, hd).sum(dim=2)
    return fold(dk), fold(dv)


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------

def _wide(x) -> torch.dtype:
    """The SSD plain versions compute in float32, or in float64 when x is
    float64 (the tests' float64 evaluations)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def ssd_reference(x, dt, A, B, C):
    """Naive sequential SSD scan (Mamba2 §3), the oracle of the chunked
    forms: h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_tᵀ, y_t = C_t · h_t.
    Returns (y (b, T, H, P), final state (b, H, N, P)), float32."""
    H, wide = x.shape[2], _wide(x)
    rep = H // B.shape[2]
    x, dt, A = x.to(wide), dt.to(wide), A.to(wide)
    Bf = B.to(wide).repeat_interleave(rep, dim=2)         # (b, T, H, N)
    Cf = C.to(wide).repeat_interleave(rep, dim=2)
    h = x.new_zeros(x.shape[0], H, B.shape[3], x.shape[3])
    ys = []
    for t in range(x.shape[1]):
        a = torch.exp(dt[:, t] * A[None, :])              # (b, H)
        h = h * a[..., None, None] + torch.einsum(
            "bhn,bh,bhp->bhnp", Bf[:, t], dt[:, t], x[:, t])
        ys.append(torch.einsum("bhn,bhnp->bhp", Cf[:, t], h))
    return torch.stack(ys, dim=1), h


def pad_steps(t, pad: int):
    """Zero-pad the step axis (dim 1) of an SSD input by ``pad``: zero dt
    is an identity decay and zero x leaves the state unchanged."""
    if not pad:
        return t
    return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))


def _chunk(x, dt, Bm, Cm, c: int, chunk: int):
    """Chunk c in the head-major layout: x (b, H, Q, P), dt (b, H, Q),
    B and C expanded to their heads (b, H, Q, N), all float32."""
    sl, wide = slice(c * chunk, (c + 1) * chunk), _wide(x)
    rep = x.shape[2] // Bm.shape[2]
    heads = lambda m: m[:, sl].to(wide).repeat_interleave(rep, dim=2) \
        .transpose(1, 2)
    return (x[:, sl].to(wide).transpose(1, 2),
            dt[:, sl].to(wide).transpose(1, 2), heads(Bm), heads(Cm))


def _chunk_tiles(dt, A, Bh, Ch):
    """Log-decay cumsum L (b, H, Q), its total, the scores C_t · B_s and
    the masked decay e^{L_t - L_s} [s <= t] (b, H, Q, Q)."""
    Lcum, Ltot = _log_decay(dt, A)
    Q = Lcum.shape[-1]
    tri = torch.ones(Q, Q, dtype=torch.bool, device=Lcum.device).tril()
    diff = (Lcum[..., :, None] - Lcum[..., None, :]).masked_fill(
        ~tri, float("-inf"))
    return Lcum, Ltot, Ch @ Bh.transpose(-1, -2), torch.exp(diff)


def _log_decay(dt, A):
    """A chunk's log-decay cumsum L (b, H, Q) and its total L_Q."""
    Lcum = torch.cumsum(dt * A.to(dt.dtype)[None, :, None], dim=-1)
    return Lcum, Lcum[..., -1]


def _next_state(h, Lcum, Ltot, Bh, xb):
    """The state after a chunk: h <- e^{L_Q} h + (B ⊙ e^{L_Q - L})ᵀ xb,
    with xb = dt ⊙ x."""
    w = torch.exp(Ltot[..., None] - Lcum)
    return torch.exp(Ltot)[..., None, None] * h + \
        (Bh * w[..., None]).transpose(-1, -2) @ xb


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int):
    """The chunked SSD forward: per chunk, Y = (C Bᵀ ⊙ decay)(dt ⊙ x) +
    (C ⊙ e^L) h_prev and h ← e^{L_Q} h + (B ⊙ e^{L_Q - L})ᵀ (dt ⊙ x).
    Differentiable.  Returns (y (b, T, H, P) float32, entry states
    (b, H, nc, N, P), final state (b, H, N, P))."""
    b, T, H, P = x.shape
    h = x.new_zeros(b, H, Bm.shape[3], P, dtype=_wide(x))
    ys, states = [], []
    for c in range(T // chunk):
        xh, dth, Bh, Ch = _chunk(x, dt, Bm, Cm, c, chunk)
        Lcum, Ltot, scores, decay = _chunk_tiles(dth, A, Bh, Ch)
        xb = xh * dth[..., None]
        states.append(h)
        ys.append((scores * decay) @ xb +
                  (Ch * torch.exp(Lcum)[..., None]) @ h)
        h = _next_state(h, Lcum, Ltot, Bh, xb)
    y = torch.cat(ys, dim=2).transpose(1, 2).contiguous()
    return y, torch.stack(states, dim=2), h


def ssd_fwd(x, dt, A, Bm, Cm, *, chunk: int):
    """Forward kernel: (y, entry states (B, H, nc, N, P)), float32."""
    return ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)[:2]


def ssd_final_state(x, dt, A, Bm, states, *, chunk: int):
    """The state after the last chunk, from the state entering it
    (``states[:, :, -1]``), by ``ssd_scan``'s own update (``_next_state``)
    over that chunk.  (b, H, N, P)."""
    # the update reads no C: B stands in its place
    xh, dth, Bh, _ = _chunk(x, dt, Bm, Bm, x.shape[1] // chunk - 1, chunk)
    return _next_state(states[:, :, -1].to(xh.dtype), *_log_decay(dth, A),
                       Bh, xh * dth[..., None])


def ssd_bwd(x, dt, A, Bm, Cm, states, dy, *, chunk: int):
    """Backward kernel: the reverse chunk scan carrying dh (N × P).
    Returns (dx, ddt, dA (H,), dBm, dCm), float32, with dA summed over the
    batch and dB/dC over each group's heads."""
    b, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc, wide = T // chunk, _wide(x)
    A = A.to(wide)
    dh = x.new_zeros(b, H, N, P, dtype=wide)
    dA = x.new_zeros(b, H, dtype=wide)
    dxs, ddts, dBs, dCs = [None] * nc, [None] * nc, [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        xh, dth, Bh, Ch = _chunk(x, dt, Bm, Cm, c, chunk)
        dyh = dy[:, c * chunk:(c + 1) * chunk].to(wide).transpose(1, 2)
        hp = states[:, :, c].to(wide)
        Lcum, Ltot, scores, decay = _chunk_tiles(dth, A, Bh, Ch)
        xb = xh * dth[..., None]
        expL, eLtot = torch.exp(Lcum), torch.exp(Ltot)
        w = torch.exp(Ltot[..., None] - Lcum)
        # y = (scores ⊙ decay) xb + (C ⊙ e^L) h_prev
        dM = dyh @ xb.transpose(-1, -2)                       # (b, H, Q, Q)
        dxb = (scores * decay).transpose(-1, -2) @ dyh
        dscores = dM * decay
        dC = dscores @ Bh
        dB = dscores.transpose(-1, -2) @ Ch
        ddiff = dscores * scores
        dLcum = ddiff.sum(-1) - ddiff.sum(-2)
        dyhp = dyh @ hp.transpose(-1, -2)                     # (b, H, Q, N)
        dC = dC + dyhp * expL[..., None]
        dLcum = dLcum + (dyhp * Ch).sum(-1) * expL
        dh_prev = (Ch * expL[..., None]).transpose(-1, -2) @ dyh
        # h = e^{Ltot} h_prev + (B ⊙ w)ᵀ xb
        dxb = dxb + (Bh * w[..., None]) @ dh
        dBw = xb @ dh.transpose(-1, -2)
        dB = dB + dBw * w[..., None]
        dw = (dBw * Bh).sum(-1)
        dLtot = eLtot * (dh * hp).sum((-1, -2)) + (dw * w).sum(-1)
        dLcum = dLcum - dw * w
        dh = dh_prev + eLtot[..., None, None] * dh
        # L = cumsum(la), Ltot = L[-1]: dla_s = Σ_{t≥s} dL_t + dLtot
        dla = torch.flip(torch.cumsum(torch.flip(dLcum, [-1]), -1), [-1]) \
            + dLtot[..., None]
        ddts[c] = dla * A[None, :, None] + (dxb * xh).sum(-1)
        dA = dA + (dla * dth).sum(-1)
        dxs[c], dBs[c], dCs[c] = dxb * dth[..., None], dB, dC
    seq = lambda ts: torch.cat(ts, dim=2).transpose(1, 2).contiguous()
    group = lambda t: t.reshape(b, T, G, H // G, N).sum(dim=3)
    return (seq(dxs), seq(ddts), dA.sum(dim=0), group(seq(dBs)),
            group(seq(dCs)))


SSD_HEAD_AXIS = {"y": 2, "states": 1, "dx": 2, "ddt": 2, "dB": 2, "dC": 2}


def ssd_scales(x, dt, A, outs: dict) -> dict:
    """The size against which each SSD output's rounding error is judged,
    per head, shaped to broadcast against the output: a check reads
    |got - ref| <= atol · scale + rtol · |ref|.  ``outs`` maps names of
    :data:`SSD_HEAD_AXIS` and "dA" to reference outputs.

    The heads' decays (A from -1 to -48) give outputs of very different
    sizes, so the scale is the largest |ref| of the element's own head (of
    its group for dB and dC, which have no head axis).  dA_h = Σ_{b,t}
    dt·dla is a sum whose terms cancel: its scale is Σ_{b,t} |dt·dla|, with
    dt·dla = (dt·ddt - <dx, x>) / A (x enters only as dt·x)."""
    scales = {}
    for name, t in outs.items():
        if name == "dA":
            dla_dt = (dt * outs["ddt"] - (outs["dx"] * x).sum(-1)) / A
            scales[name] = dla_dt.abs().sum(dim=(0, 1))
        else:
            dims = [d for d in range(t.dim()) if d != SSD_HEAD_AXIS[name]]
            scales[name] = t.abs().amax(dim=dims, keepdim=True)
    return scales
