"""Rotary position embeddings (half-rotation convention). Port of
``repro.nn.rotary``."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S) (an int, a
    (S,) vector, or (B, 1) per-row positions)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, device=x.device)
    positions = torch.as_tensor(positions, device=x.device)
    ang = positions[..., None].float() * inv            # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                  # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
