"""Production mesh construction (``repro.launch.mesh``).

A FUNCTION (not a module-level constant) so that importing this module
touches no device.  Single pod: 16 x 16 = 256 ranks ("data", "model").
Multi-pod: 2 x 16 x 16 = 512 ranks ("pod", "data", "model"): the pod
axis composes with data parallelism, so batch and gradient reductions
shard across pods with no new code paths.

The mesh is a torch ``DeviceMesh`` over the default process group,
which must have exactly that many ranks: a real job's, one rank a card,
or the dry-run's fake group (``launch/dryrun.py``), whose ranks are
simulated.  Without such a group it raises, as the reference does
without that many devices.  ``make_axes`` gives the reference's logical
axis bundle (``MeshAxes``) for a mesh.
"""
from __future__ import annotations

from repro_torch.models.common import MeshAxes


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """The production ``DeviceMesh`` over the default process group.
    ``device_type``: the mesh's device type (default: "cuda" where a
    card is, else "cpu")."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 512 if multi_pod else 256
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n:
        raise RuntimeError(
            f"need {n} devices for the production mesh: a process group "
            f"of {n} ranks, have {have} (cards here: "
            f"{torch.cuda.device_count()}); the dry-run "
            f"(repro_torch.launch.dryrun) makes a fake one")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_axes(mesh) -> MeshAxes:
    """Logical axis bundle for a production mesh (None: no sharding)."""
    if mesh is None:
        return MeshAxes()
    if "pod" in mesh.mesh_dim_names:
        return MeshAxes(mesh=mesh, dp=("pod", "data"), fsdp="data",
                        tp="model")
    return MeshAxes(mesh=mesh, dp=("data",), fsdp="data", tp="model")
