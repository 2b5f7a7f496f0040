"""LR schedules (paper §B.1: cosine annealing from 0.05). Port of
``repro.optim.schedule``; the rate is an f32 scalar tensor, computed in
f32 as the reference computes it."""
from __future__ import annotations

import math

import torch

from repro_torch.config import TrainConfig


def cosine_schedule(step, base_lr: float, total_steps: int, warmup: int = 0,
                    final_frac: float = 0.0) -> torch.Tensor:
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = (torch.clamp(step / max(warmup, 1), max=1.0) if warmup > 0
            else 1.0)
    t = torch.clamp((step - warmup) / max(total_steps - warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return base_lr * warm * (final_frac + (1 - final_frac) * cos)


def make_schedule(cfg: TrainConfig):
    if cfg.schedule == "constant":
        return lambda step: torch.tensor(cfg.lr, dtype=torch.float32)
    return lambda step: cosine_schedule(step, cfg.lr, cfg.steps, cfg.warmup)
