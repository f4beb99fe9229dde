"""Serving front ends of the port (``repro.serving``'s counterpart).

Only the SharedDB query server is here; the LM ``CycleServer`` belongs
to the port's LM stack."""
from repro_torch.serving.query_server import QueryCycleServer  # noqa: F401
