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


def one_draw():
    """The context of a draw made once for every rank: under
    ``LocalTensorMode`` (every rank of a mesh simulated in this process)
    the mode paused, so that factories make plain tensors and a seeded
    generator is read once, not once a rank; else nothing."""
    import contextlib
    from torch.distributed._local_tensor import local_tensor_mode
    mode = local_tensor_mode()
    return contextlib.nullcontext() if mode is None else mode.disable()


def local_shards(t) -> list:
    """The plain tensors that hold ``t`` on this process: a DTensor's
    local shard, and under ``LocalTensorMode`` every simulated rank's;
    a plain tensor itself."""
    if is_dtensor(t):
        t = t._local_tensor
    per_rank = getattr(t, "_local_tensors", None)
    return [t] if per_rank is None else list(per_rank.values())


def host_tensor(t) -> torch.Tensor:
    """A device value as a plain CPU tensor: a DTensor's full value, and
    under ``LocalTensorMode`` the ranks' common value (raises if their
    bits differ)."""
    if is_dtensor(t):
        t = t.full_tensor()
    vals = local_shards(t.detach())
    bits = [v.reshape(-1).view(torch.uint8) for v in vals]
    if any(not torch.equal(bits[0], b) for b in bits[1:]):
        raise RuntimeError("host_tensor: the ranks disagree")
    return vals[0].cpu()


def host_numpy(t) -> np.ndarray:
    """``host_tensor(t)`` as a numpy array."""
    return host_tensor(t).numpy()
