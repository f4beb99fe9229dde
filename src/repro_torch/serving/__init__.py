"""Serving front ends of the port (``repro.serving``'s counterpart): the
LM heartbeat server (``CycleServer``) and the SharedDB query server."""
from repro_torch.serving.scheduler import CycleServer, Request  # noqa: F401
from repro_torch.serving.query_server import QueryCycleServer  # noqa: F401
