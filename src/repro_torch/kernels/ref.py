"""Plain PyTorch versions of the kernels: what each kernel computes, in
f32. ``ops`` routes CPU tensors here, the tests hold the JAX package's
oracles (``repro.kernels.ref``) against them, and ``chip_smoke.py`` holds
each kernel against them on the card."""
from __future__ import annotations

import torch


def lowrank_matmul_ref(x: torch.Tensor, r_factor: torch.Tensor,
                       l_factor: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """y = (x @ R^T) @ L^T; x (..., I), R (K, I), L (O, K) -> (..., O).
    Both products in f32 (the rank-K ``h`` stays f32), then a cast to
    ``out_dtype`` (default x's dtype)."""
    h = torch.matmul(x.float(), r_factor.float().T)
    y = torch.matmul(h, l_factor.float().T)
    return y.to(out_dtype or x.dtype)
