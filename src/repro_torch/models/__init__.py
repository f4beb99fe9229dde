"""Language models of the port (``repro.models``'s serving half: the dense
and MoE attention programs).

Entry point: :func:`repro_torch.models.registry.get_model`.
"""
from repro_torch.models.registry import get_model  # noqa: F401
