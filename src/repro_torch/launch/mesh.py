"""Production mesh construction (``repro.launch.mesh``).

A FUNCTION (not a module-level constant) so that importing this module
touches no device.  Single pod: 16 x 16 = 256 chips ("data", "model").
Multi-pod: 2 x 16 x 16 = 512 chips ("pod", "data", "model").  Without
that many CUDA cards it raises, as the reference does without that many
devices; the port's LM runs on one device, and an LM over many cards
would need them and ``torch.distributed``.

The reference's ``make_axes`` (the ``MeshAxes`` sharding constraints of
its models) has no counterpart: the port's models take no ``MeshAxes``.
"""
from __future__ import annotations

from repro_torch.runtime.elastic import DeviceMesh, alive_devices


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 512 if multi_pod else 256
    devices = alive_devices()[:n]
    if len(devices) < n:
        raise RuntimeError(
            f"need {n} devices for the production mesh, have "
            f"{len(devices)}; the port's LM runs on one device")
    return DeviceMesh(shape, axes, tuple(devices))
