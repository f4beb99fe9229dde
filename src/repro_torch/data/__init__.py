"""The training-data pipeline of the port (``repro.data``'s counterpart)."""
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: F401
