"""The optimizer of the port (``repro.optim``'s counterpart)."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init,  # noqa: F401
                                     adamw_update, compress_grads)
from repro_torch.optim.schedules import cosine_schedule  # noqa: F401
