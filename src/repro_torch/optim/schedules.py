"""LR schedules (pure functions of the step), as ``repro.optim.schedules``."""
import math

import torch


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    """Linear warmup to ``peak_lr``, then a cosine down to ``floor`` x
    ``peak_lr`` at ``total``; ``step`` a tensor, the result float32."""
    step = torch.as_tensor(step).float()
    warm = peak_lr * step / max(warmup, 1)
    frac = torch.clip((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5
                     * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)
