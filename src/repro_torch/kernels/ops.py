"""Dispatch between the kernels and their plain versions, plus the launch
counters.

A CPU tensor takes the plain PyTorch version (``ref.py``); a CUDA tensor
launches the kernel or raises. There is no fallback from one to the other:
the device of the input decides, and nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.lowrank import LAUNCHES, lowrank_fused

__all__ = ["LAUNCHES", "lowrank_matmul", "reset_launches"]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def lowrank_matmul(x: torch.Tensor, r_factor: torch.Tensor,
                   l_factor: torch.Tensor) -> torch.Tensor:
    """WASI factored linear (Eq. 8): y = (x @ R^T) @ L^T, the entry every
    factored linear routes through. x (..., I), R (K, I), L (O, K) ->
    (..., O), leading dims flattened as the reference's fused wrapper
    does. CUDA: the fused kernel (``kernels/lowrank.py``). CPU: the plain
    f32 version (``ref.lowrank_matmul_ref``)."""
    if x.device.type == "cpu":
        return ref.lowrank_matmul_ref(x, r_factor, l_factor)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    y = lowrank_fused(x2, r_factor.contiguous(), l_factor.contiguous())
    return y.reshape(*lead, l_factor.shape[0])
