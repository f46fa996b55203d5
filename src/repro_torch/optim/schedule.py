"""LR schedules (the port of ``repro.optim.schedule``), in f32 on the
step's device, as the reference computes them."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, base_lr: float, warmup: int, total: int,
                  final_frac: float = 0.1):
    """step: an int tensor -> the f32 learning rate (a tensor on its
    device): linear warmup to ``base_lr``, then a cosine down to
    ``final_frac * base_lr`` at ``total``."""
    step = step.float()
    warm = base_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (final_frac + (1 - final_frac) * 0.5 *
                     (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)
