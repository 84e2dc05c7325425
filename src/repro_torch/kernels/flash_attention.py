"""The three flash-attention kernels: binding and launch wrappers.

The kernels (``csrc/fa_*.cu``) live in the library that ``build.py``
compiles at first use.  Each wrapper takes the kernels' layout — q, o, do
(B, H, S, hd), k, v (B, Hkv, Skv, hd), lse and delta (B, H, S) float32 —
and checks device, dtype, shape and contiguity.  On CPU tensors it runs
the plain version in ``ref.py``; on CUDA tensors it launches its kernel on
the current stream without synchronising, raises if the launch failed,
and adds one to its entry of :data:`launches`.  There is no fallback from
one to the other.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build, ref

HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches per wrapper since the last :func:`reset_launches`.
launches = {"fa_fwd": 0, "fa_bwd_dq": 0, "fa_bwd_dkv": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@functools.cache
def _fn(name: str):
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    n_ptr = {"fa_fwd": 5, "fa_bwd_dq": 7, "fa_bwd_dkv": 8}[name]
    # pointers, dtype..window, cap, scale, stream
    return build.function(name, [vp] * n_ptr + [i32] * 9 + [f32, f32, vp])


# ---------------------------------------------------------------------------
# Checks and launch
# ---------------------------------------------------------------------------

def _check(q, k, v, *, window, logit_cap, do=None, lse=None, delta=None):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B, H, S, hd) and k, v (B, Hkv, Skv, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, S, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[1]:
        raise ValueError(f"k, v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (batch, head dim, H % Hkv == 0)")
    if min(B, H, S, k.shape[2]) < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of "
                         f"{list(_DTYPE_CODE)}, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if logit_cap is not None and not logit_cap > 0:
        raise ValueError(f"logit_cap must be > 0 or None, got {logit_cap}")
    if do is not None and (do.shape != q.shape or do.dtype != q.dtype):
        raise ValueError(f"do must match q: {tuple(do.shape)} {do.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t is not None and (t.shape != q.shape[:3] or
                              t.dtype != torch.float32):
            raise ValueError(f"{name} must be float32 {tuple(q.shape[:3])}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    tensors = [t for t in (q, k, v, do, lse, delta) if t is not None]
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must lie on one device")
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for {q.device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} has no kernel; built for "
                         f"{HEAD_DIMS}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernels take contiguous tensors")
    return True


def _launch(name: str, ptrs, q, k, *, causal, window, logit_cap) -> None:
    B, H, S, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _fn(name)(
            *[t.data_ptr() for t in ptrs], _DTYPE_CODE[q.dtype], hd, B, H,
            Hkv, S, Skv, int(causal), int(window or 0),
            float(logit_cap or 0.0), 1.0 / math.sqrt(hd), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}"
                           f" (q {tuple(q.shape)} {q.dtype}, k "
                           f"{tuple(k.shape)})")
    launches[name] += 1


def fa_fwd(q, k, v, *, causal: bool, window: int | None = None,
           logit_cap: float | None = None):
    """Forward: (out like q, lse (B, H, S) float32)."""
    opts = dict(causal=causal, window=window, logit_cap=logit_cap)
    if not _check(q, k, v, window=window, logit_cap=logit_cap):
        return ref.fa_fwd(q, k, v, **opts)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("fa_fwd", (q, k, v, out, lse), q, k, **opts)
    return out, lse


def fa_bwd_dq(q, k, v, do, lse, delta, *, causal: bool,
              window: int | None = None, logit_cap: float | None = None):
    """dq, float32 (B, H, S, hd)."""
    opts = dict(causal=causal, window=window, logit_cap=logit_cap)
    if not _check(q, k, v, window=window, logit_cap=logit_cap, do=do,
                  lse=lse, delta=delta):
        return ref.fa_bwd_dq(q, k, v, do, lse, delta, **opts)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch("fa_bwd_dq", (q, k, v, do, lse, delta, dq), q, k, **opts)
    return dq


def fa_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool,
               window: int | None = None, logit_cap: float | None = None):
    """(dk, dv), float32 (B, Hkv, Skv, hd)."""
    opts = dict(causal=causal, window=window, logit_cap=logit_cap)
    if not _check(q, k, v, window=window, logit_cap=logit_cap, do=do,
                  lse=lse, delta=delta):
        return ref.fa_bwd_dkv(q, k, v, do, lse, delta, **opts)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    _launch("fa_bwd_dkv", (q, k, v, do, lse, delta, dk, dv), q, k, **opts)
    return dk, dv
