"""Runtime machinery of the port (``repro.runtime``'s counterpart)."""
from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    FaultTolerantLoop, StragglerPolicy)
from repro_torch.runtime.elastic import ElasticMeshManager  # noqa: F401
