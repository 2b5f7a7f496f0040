"""Wrapper of the Gram kernel ``csrc/gram.cu``: G = Y^T Y in f32, batched
over leading stack dims. It replaces ``repro/kernels/gram.py::_gram_kernel``
and is phase 0 of the CholeskyQR refresh (``kernels/qr.py``).

``gram`` takes CUDA tensors only and launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lowrank import (
    TRAIN_LAUNCHES,
    check_cuda,
    dtype_code,
    splits,
)


def _lib() -> ctypes.CDLL:
    lib = _build.library("gram.cu")
    if lib.gram.argtypes is None:
        lib.gram.restype = ctypes.c_int
        lib.gram.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
    return lib


def gram(y: torch.Tensor) -> torch.Tensor:
    """G (..., K, K) f32 = Y^T Y for y (..., M, K), bf16 or f32; one
    launch over every leading stack index, on the current stream."""
    check_cuda("gram", y=y)
    code = dtype_code("gram", y)
    if y.dim() < 2:
        raise ValueError(f"gram: y must be at least 2-D, got {tuple(y.shape)}")
    lead, (m, k) = y.shape[:-2], y.shape[-2:]
    b = math.prod(lead)
    g = torch.empty((*lead, k, k), dtype=torch.float32, device=y.device)
    if b == 0 or k == 0:
        return g
    # a short stack (a single 2-D Y) is few tiles: split the M reduction
    s = splits(k, k, m, batch=b)
    ws = torch.empty((b * s * k * k if s > 1 else 1,), dtype=torch.float32,
                     device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = _lib().gram(y.data_ptr(), g.data_ptr(), ws.data_ptr(), b, m, k,
                          code, s, stream)
    if err != 0:
        raise RuntimeError(f"gram launch failed: CUDA error {err} "
                           f"(B={b} M={m} K={k} splits={s})")
    TRAIN_LAUNCHES["gram"] += 1
    return g
