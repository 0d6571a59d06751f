"""LR schedules as plain functions of the step.

Counterpart of ``repro.optim.schedule``. ``step`` is a Python number or a
tensor: a Python step gives a Python float (in double precision, where the
reference computes in fp32), a tensor step a tensor.
"""
from __future__ import annotations

import math

import torch


def _is_tensor(step) -> bool:
    return isinstance(step, torch.Tensor)


def cosine_schedule(step, *, base_lr: float, total_steps: int, min_frac: float = 0.1):
    t = step / max(total_steps, 1)
    if _is_tensor(t):
        cos = 0.5 * (1 + torch.cos(math.pi * torch.clamp(t, 0.0, 1.0)))
    else:
        cos = 0.5 * (1 + math.cos(math.pi * min(max(t, 0.0), 1.0)))
    return base_lr * (min_frac + (1 - min_frac) * cos)


def linear_warmup_cosine(
    step, *, base_lr: float, warmup: int, total_steps: int, min_frac: float = 0.1
):
    frac = step / max(warmup, 1)
    warm = base_lr * (torch.clamp_max(frac, 1.0) if _is_tensor(frac) else min(frac, 1.0))
    cos = cosine_schedule(step - warmup, base_lr=base_lr,
                          total_steps=max(total_steps - warmup, 1), min_frac=min_frac)
    if _is_tensor(step):
        return torch.where(step < warmup, warm, cos)
    return warm if step < warmup else cos
