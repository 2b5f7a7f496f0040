"""Rotary position embeddings (half-rotation convention) and the fixed
sinusoidal table of the encoder-decoder family. Port of
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


def sinusoidal_angles(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """(len(positions), dim) Whisper-style sinusoidal table rows at the
    given integer positions, f32: sin of ``pos * inv`` then cos, ``inv``
    exp(-log(10000) i / max(dim // 2 - 1, 1)) (the reference's
    denominator, 1 for dim 2 or 3)."""
    dev = positions.device
    inv = torch.exp(-torch.log(torch.tensor(10000.0, device=dev))
                    * torch.arange(dim // 2, dtype=torch.float32, device=dev)
                    / max(dim // 2 - 1, 1))
    ang = positions.float()[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_embedding(seq: int, dim: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal position table (seq, dim), rows 0 to
    seq - 1; extrapolates past any trained length."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)
    return sinusoidal_angles(pos, dim).to(dtype)
