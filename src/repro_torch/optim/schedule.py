"""Learning-rate schedules (counterpart of ``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``min_frac`` of it at ``total``; an f32 scalar on ``step``'s
    device (a tensor or a number)."""
    step = torch.as_tensor(step).float()
    warm = peak_lr * step / max(warmup, 1)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (min_frac + (1 - min_frac) * 0.5 *
                     (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup, warm, cos)
