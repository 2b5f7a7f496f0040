"""Gradient clipping (paper §B.1: L2 clip at 2.0). Port of
``repro.optim.clip``; gradients are a {name: tensor} dict."""
from __future__ import annotations

import torch


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    leaves = [torch.sum(torch.square(g.float())) for g in grads.values()]
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads: dict, max_norm: float):
    """Returns (clipped grads, pre-clip norm). Each leaf is scaled in f32
    and cast back to its own dtype."""
    n = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-12), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, n
