"""Device resolution shared by every entry point of the port.

``device=None`` means the CUDA card and raises when there is none; the
CPU runs only when the caller asks for it with ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; the CPU only when asked for."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return device


def upload(a, device, dtype=None) -> torch.Tensor:
    """A host array as a tensor on ``device``.

    To a CUDA card the copy goes through pinned memory and is enqueued
    asynchronously on the current stream, so the calling thread never
    waits for the card: cycles built on a background fold thread, while
    the serving thread enqueues beats, make no synchronising copy.  The
    tensor is always a copy of its own, on the CPU too (it never shares
    the array's memory): each shard of a row mesh holds its own
    constants."""
    t = torch.as_tensor(np.asarray(a), dtype=dtype)
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device, copy=True)
    return t.pin_memory().to(device, non_blocking=True)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a tensor placed on a device mesh)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)
