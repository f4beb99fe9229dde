"""Checkpoints of the port (``repro.checkpoint``'s counterpart)."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointManager, Placed, load_pytree, save_pytree)
