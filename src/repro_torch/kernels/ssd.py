"""The two Mamba2 SSD kernels: binding and launch wrappers.

The kernels (``csrc/ssd_fwd.cu``, ``csrc/ssd_bwd.cu``) live in the library
that ``build.py`` compiles at first use.  Layouts are the JAX package's:
x (B, T, H, P), dt (B, T, H), A (H,), Bm and Cm (B, T, G, N) with head h
reading group h // (H // G), T a multiple of ``chunk``; the forward's
``states`` (B, H, nc, N, P) are the states entering each chunk, the
backward's residual.  Everything is float32.

Each wrapper checks device, dtype, shape and contiguity.  On CPU tensors
it runs the plain version in ``ref.py``; on CUDA tensors it launches its
kernel on the current stream without synchronising, raises if the launch
failed, and adds one to its entry of :data:`launches`.  There is no
fallback from one to the other.  The backward kernel emits dB/dC per head
and dA per (batch, head); the wrapper sums them to the inputs' shapes as
torch ops, as the JAX wrapper does (``ssd.py:268-271``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, ref

#: Kernel launches per wrapper since the last :func:`reset_launches`.
launches = {"ssd_fwd": 0, "ssd_bwd": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@functools.cache
def _fn(name: str):
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    n_ptr = {"ssd_fwd": 7, "ssd_bwd": 12}[name]
    # pointers, B, T, H, P, G, N, Q, stream
    return build.function(name, [vp] * n_ptr + [i32] * 7 + [vp])


def _check(x, dt, A, Bm, Cm, *, chunk, states=None, dy=None) -> bool:
    """Validate the inputs; True where the kernel runs (CUDA), False where
    the plain version does (CPU)."""
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"want x (B, T, H, P) and Bm, Cm (B, T, G, N), got "
                         f"{tuple(x.shape)}, {tuple(Bm.shape)}")
    b, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if dt.shape != (b, T, H) or A.shape != (H,) or \
            Bm.shape[:2] != (b, T) or Cm.shape != Bm.shape or H % G:
        raise ValueError(f"inconsistent SSD shapes: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(Bm.shape)}, C {tuple(Cm.shape)} (H % G "
                         "must be 0)")
    if chunk < 1 or T % chunk or min(b, T, P, N) < 1:
        raise ValueError(f"T={T} must be a positive multiple of chunk={chunk}"
                         f" (ops.ssd pads)")
    nc = T // chunk
    if states is not None and states.shape != (b, H, nc, N, P):
        raise ValueError(f"states must be {(b, H, nc, N, P)}, got "
                         f"{tuple(states.shape)}")
    if dy is not None and dy.shape != x.shape:
        raise ValueError(f"dy must match x: {tuple(dy.shape)}")
    tensors = [t for t in (x, dt, A, Bm, Cm, states, dy) if t is not None]
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"the SSD kernels take float32, got "
                         f"{[t.dtype for t in tensors]}")
    if any(t.device != x.device for t in tensors):
        raise ValueError("all inputs must lie on one device")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no SSD kernel for {x.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernels take contiguous tensors")
    return True


def _launch(name: str, ptrs, x, Bm, chunk: int) -> None:
    b, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _fn(name)(*[t.data_ptr() for t in ptrs], b, T, H, P, G, N,
                       chunk, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}"
                           f" (x {tuple(x.shape)}, B {tuple(Bm.shape)}, "
                           f"chunk {chunk}; csrc/ssd_common.cuh bounds N "
                           "and P)")
    launches[name] += 1


def ssd_fwd(x, dt, A, Bm, Cm, *, chunk: int):
    """Forward: (y (B, T, H, P), states (B, H, nc, N, P)), float32."""
    if not _check(x, dt, A, Bm, Cm, chunk=chunk):
        return ref.ssd_fwd(x, dt, A, Bm, Cm, chunk=chunk)
    b, T, H, P = x.shape
    y = torch.empty_like(x)
    states = x.new_empty(b, H, T // chunk, Bm.shape[3], P)
    _launch("ssd_fwd", (x, dt, A, Bm, Cm, y, states), x, Bm, chunk)
    return y, states


def ssd_bwd(x, dt, A, Bm, Cm, states, dy, *, chunk: int):
    """Backward: (dx, ddt, dA (H,), dBm, dCm), float32, shaped like the
    inputs."""
    if not _check(x, dt, A, Bm, Cm, chunk=chunk, states=states, dy=dy):
        return ref.ssd_bwd(x, dt, A, Bm, Cm, states, dy, chunk=chunk)
    b, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dBh, dCh = x.new_empty(b, T, H, N), x.new_empty(b, T, H, N)
    dAbh = x.new_empty(b, H)
    _launch("ssd_bwd", (x, dt, A, Bm, Cm, states, dy, dx, ddt, dBh, dCh, dAbh),
            x, Bm, chunk)
    group = lambda t: t.reshape(b, T, G, H // G, N).sum(dim=3)
    return dx, ddt, dAbh.sum(dim=0), group(dBh), group(dCh)
