"""Learning-rate schedules, pure functions of the step (the port of the
reference's `repro/optim/schedules.py`).

Each takes the step as an integer tensor (or an int) and returns a
float32 0-d tensor, computed in float32 as the reference computes it.
"""
from __future__ import annotations

import math

import torch

__all__ = ["cosine_with_warmup", "linear_warmup_constant"]


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_with_warmup(step, *, peak_lr: float, warmup_steps: int,
                       total_steps: int, min_ratio: float = 0.1):
    """Linear warmup to `peak_lr` over `warmup_steps`, then a cosine
    decay to `min_ratio * peak_lr` at `total_steps`."""
    step = _step(step)
    warm = peak_lr * step / max(warmup_steps, 1)
    frac = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio)
                     * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup_steps, warm, cos)


def linear_warmup_constant(step, *, peak_lr: float, warmup_steps: int):
    """Linear warmup to `peak_lr` over `warmup_steps`, then constant."""
    step = _step(step)
    return peak_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
