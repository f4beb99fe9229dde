"""Language models of the port (``repro.models``'s dense serving half).

Entry point: :func:`repro_torch.models.registry.get_model`.
"""
from repro_torch.models.registry import get_model  # noqa: F401
