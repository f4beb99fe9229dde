"""Sharded, atomic checkpointing of trees of tensors, in the reference's
on-disk format (``repro.checkpoint.checkpoint``): the two packages read
each other's checkpoints.

Layout per step:
    <dir>/step_00000100.tmp/        written first
        shard_<host>.npz            this host's leaves, one array a leaf
        manifest.json               step, host, per leaf its shape, dtype
                                    string and crc32, and ``extra``
    <dir>/step_00000100/            atomic rename on completion (commit)

A leaf's key is its path in the tree (``"0/g0/attn/wq"`` for a ``(params,
opt)`` tuple; ``core/pytree``), bfloat16 is stored as its uint16 bits
under the dtype string ``"bfloat16"``, and the crc is over the leaf's
bytes.

Sharded trees: a DTensor leaf is stored whole, at its full shape (under
``LocalTensorMode`` the ranks' common value), as the reference's
``np.asarray`` gathers a global array; so a checkpoint written on one
mesh restores unsharded, on another mesh, or through the reference.
``load_pytree`` places each leaf as its template leaf is placed: a
DTensor template's mesh and placements, a ``Placed`` leaf's (an
analytic template, ``ModelApi.state_template``: nothing allocated
before the restore), a plain tensor's device.

Fault-tolerance contract (runtime/):
  * a crash mid-write leaves only a .tmp dir -> ignored on restore;
  * restore picks the newest COMMITTED step;
  * every leaf carries a crc so silent corruption fails loudly;
  * per-host shards: a host writes and restores only what it owns.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core import pytree
from repro_torch.core.device import host_tensor, is_dtensor

# numpy cannot hold bfloat16: its bits travel as uint16 (torch's int16
# view, the same bytes) under the dtype string "bfloat16"
_BF16 = "bfloat16"


@dataclasses.dataclass(frozen=True)
class Placed:
    """An analytic template leaf: a tensor of ``shape`` and ``dtype`` on
    ``device``, on ``mesh`` with ``placements`` when a mesh is given."""
    shape: tuple
    dtype: torch.dtype
    device: torch.device
    mesh: Any = None
    placements: tuple = ()


def _to_numpy(leaf) -> tuple:
    """(the array as stored, its dtype string)."""
    if isinstance(leaf, torch.Tensor):
        t = host_tensor(leaf).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str, like):
    """The stored array as ``like``'s kind: a tensor on its device and
    dtype (a DTensor or ``Placed`` template: placed on its mesh), else
    an array (bfloat16 comes back as a CPU tensor: numpy has no such
    dtype)."""
    if dtype == _BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    elif isinstance(like, (torch.Tensor, Placed)):
        t = torch.from_numpy(arr)
    else:
        return arr
    if is_dtensor(like):
        like = Placed(tuple(like.shape), like.dtype, like.device,
                      like.device_mesh, tuple(like.placements))
    if isinstance(like, (torch.Tensor, Placed)):
        t = t.to(device=like.device, dtype=like.dtype, copy=True)
    if isinstance(like, Placed) and like.mesh is not None:
        from torch.distributed.tensor import distribute_tensor
        t = distribute_tensor(t, like.mesh, list(like.placements))
    return t


def save_pytree(tree, directory: str, step: int, host_id: int = 0,
                extra: Optional[Dict[str, Any]] = None) -> str:
    tmp = os.path.join(directory, f"step_{step:08d}.tmp")
    final = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(tmp, exist_ok=True)
    stored, leaves = {}, {}
    for path, leaf in pytree.flatten_with_path(tree):
        key = pytree.path_key(path)
        arr, dtype = _to_numpy(leaf)
        stored[key] = arr
        leaves[key] = {"shape": list(arr.shape), "dtype": dtype,
                       "crc": zlib.crc32(np.ascontiguousarray(arr).tobytes())}
    np.savez(os.path.join(tmp, f"shard_{host_id}.npz"), **stored)
    manifest = {"step": step, "host": host_id, "leaves": leaves,
                "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, final)  # atomic commit
    return final


def load_pytree(template, directory: str, step: Optional[int] = None,
                host_id: int = 0):
    """Restore into the structure of ``template`` (a tree of tensors,
    DTensors, ``Placed`` leaves or arrays): each leaf on its template's
    device and dtype, and mesh and placements.  Returns (tree,
    manifest); IOError on a crc mismatch, ValueError when a stored leaf's
    shape is not its template's."""
    step_dir = _resolve_step(directory, step)
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(step_dir, f"shard_{host_id}.npz"))
    out = []
    for path, like in pytree.flatten_with_path(template):
        key = pytree.path_key(path)
        arr = data[key]
        meta = manifest["leaves"][key]
        if zlib.crc32(np.ascontiguousarray(arr).tobytes()) != meta["crc"]:
            raise IOError(f"checkpoint corruption in leaf {key}")
        shape = getattr(like, "shape", None)
        if shape is not None and tuple(shape) != arr.shape:
            raise ValueError(f"checkpoint leaf {key} has shape {arr.shape}, "
                             f"the template {tuple(shape)}")
        out.append(_from_numpy(arr, meta["dtype"], like))
    return pytree.unflatten(template, out), manifest


def _steps(directory: str):
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def _resolve_step(directory: str, step: Optional[int]) -> str:
    if step is not None:
        p = os.path.join(directory, f"step_{step:08d}")
        if not os.path.isdir(p):
            raise FileNotFoundError(p)
        return p
    steps = _steps(directory)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoints in {directory}")
    return os.path.join(directory, f"step_{steps[-1]:08d}")


class CheckpointManager:
    """Keep-last-k manager with garbage collection of stale .tmp dirs."""

    def __init__(self, directory: str, keep: int = 3, host_id: int = 0):
        self.dir = directory
        self.keep = keep
        self.host_id = host_id
        os.makedirs(directory, exist_ok=True)
        # crash recovery: drop half-written checkpoints
        for d in os.listdir(directory):
            if d.endswith(".tmp"):
                shutil.rmtree(os.path.join(directory, d),
                              ignore_errors=True)

    def save(self, tree, step: int, extra: Optional[Dict] = None) -> str:
        path = save_pytree(tree, self.dir, step, self.host_id, extra)
        self._gc()
        return path

    def restore(self, template, step: Optional[int] = None):
        return load_pytree(template, self.dir, step, self.host_id)

    def latest_step(self) -> Optional[int]:
        steps = _steps(self.dir)
        return steps[-1] if steps else None

    def _gc(self):
        for s in _steps(self.dir)[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)
