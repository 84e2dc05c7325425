"""Host-to-card copies that do not wait for the rounds in flight.

A copy from pageable host memory synchronises the whole CUDA stream: at
``--window 2`` it would wait for the round in flight and serialise the
pipeline again.  These helpers copy through pinned buffers with
``non_blocking=True``.  The buffers come from PyTorch's caching host
allocator, which records an event on the stream at each such copy and
hands a buffer out again only once that event has completed, so dropping
the buffer right after the copy is safe.  Off the card they are plain
copies.
"""
from __future__ import annotations

import numpy as np
import torch


def copy_into(dst: torch.Tensor, src) -> torch.Tensor:
    """``dst.copy_(src)``, enqueued on the current stream when ``dst`` is on
    the card: a pageable host ``src`` (numpy or a CPU tensor) through a
    pinned buffer, a pinned or card ``src`` directly."""
    src = torch.as_tensor(src)
    if dst.device.type != "cuda":
        return dst.copy_(src)
    if src.is_cuda or src.is_pinned():
        return dst.copy_(src, non_blocking=True)
    pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    pinned.copy_(src)
    return dst.copy_(pinned, non_blocking=True)


def to_device(x, device, dtype=None) -> torch.Tensor:
    """``x`` (numpy or a CPU tensor) as a ``dtype`` tensor on ``device``;
    on the CPU it may share ``x``'s memory, as ``torch.as_tensor`` does."""
    src = torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x),
                          dtype=dtype)
    device = torch.device(device)
    if device.type != "cuda":
        return src.to(device)
    return copy_into(torch.empty(src.shape, dtype=src.dtype, device=device),
                     src)
