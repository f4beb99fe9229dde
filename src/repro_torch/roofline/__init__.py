"""Roofline terms of the port on the H100 (``repro.roofline``'s port)."""
from repro_torch.roofline.analysis import (  # noqa: F401
    HW, collective_schedule, fused_delta_footprint, int32_ops_per_s,
    model_flops, roofline_terms)
