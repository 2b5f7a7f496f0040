"""Wrapper of the Gram kernel ``csrc/gram.cu``: G = Y^T Y in f32, batched
over leading stack dims. It replaces ``repro/kernels/gram.py::_gram_kernel``
and is phase 0 of the CholeskyQR refresh (``kernels/qr.py``).

Which kernel takes a call is ``gram_route``'s rule on dtype, K and the
base address: ``"tensor_core"`` (bf16 Y, K a multiple of 8, 16-byte
aligned: ``gram_bf16``, the upper-triangle 64 x 64 tiles of G on the bf16
tensor cores, splits of the M reduction from ``gram_plan``) or ``"fma"`` (``gram``, f32
FMAs). ``gram`` takes CUDA tensors only and launches a kernel or raises;
a call counts one ``gram`` launch whatever it launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lowrank import (
    MIN_SPLIT_STEPS,
    SMS,
    STEP,
    TRAIN_LAUNCHES,
    GemmPlan,
    _cdiv,
    aligned,
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
        lib.gram_bf16.restype = ctypes.c_int
        lib.gram_bf16.argtypes = [ctypes.c_void_p] * 3 \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib


def gram_route(dtype: torch.dtype, k: int, tensors) -> str:
    """``"tensor_core"`` for bf16 Y whose rows the 16-byte copies read (K a
    multiple of 8, every base in ``tensors`` 16-byte aligned), else
    ``"fma"`` (f32 Y, other bf16 widths)."""
    if dtype == torch.bfloat16 and aligned((k,), tensors):
        return "tensor_core"
    return "fma"


def tri_tiles(k: int, tile: int) -> int:
    """Upper-triangle tiles (i <= j) of a K x K output cut into tiles."""
    t = _cdiv(k, tile)
    return t * (t + 1) // 2


def gram_plan(b: int, m: int, k: int) -> GemmPlan:
    """Tile and split of the tensor-core Gram of a (b, m, k) stack: 64 x
    64 tiles (4 warps, three blocks an SM; the only tile ``gram_bf16``
    instantiates), upper-triangle ones only; the M reduction split into
    up to ~1 block an SM where the stack gives fewer than half a wave of
    tiles (a single 2-D Y), each range keeping >= MIN_SPLIT_STEPS steps of
    64 rows. At the refresh's stacks (>= 72 tiles) it is unsplit: on an
    H100, 128 x 128 tiles and splits were slower at every stack, a split's
    pass over the partials costing more than its extra blocks gain."""
    tiles = b * tri_tiles(k, 64)
    if tiles >= SMS // 2:
        return GemmPlan(64, 1)
    most = max(1, _cdiv(m, STEP) // MIN_SPLIT_STEPS)
    return GemmPlan(64, max(1, min(SMS // tiles, most)))


def gram(y: torch.Tensor) -> torch.Tensor:
    """G (..., K, K) f32 = Y^T Y for y (..., M, K), bf16 or f32; every
    leading stack index in one launch (plus a split pass), on the current
    stream."""
    check_cuda("gram", y=y)
    code = dtype_code("gram", y)
    if y.dim() < 2:
        raise ValueError(f"gram: y must be at least 2-D, got {tuple(y.shape)}")
    lead, (m, k) = y.shape[:-2], y.shape[-2:]
    b = math.prod(lead)
    g = torch.empty((*lead, k, k), dtype=torch.float32, device=y.device)
    if b == 0 or k == 0:
        return g
    route = gram_route(y.dtype, k, (y,))
    if route == "tensor_core":
        tile, s = gram_plan(b, m, k)
    else:
        # a short stack (a single 2-D Y) is few tiles: split the M reduction
        tile, s = 64, splits(k, k, m, batch=b)
    ws = torch.empty((b * s * k * k if s > 1 else 1,), dtype=torch.float32,
                     device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        if route == "tensor_core":
            err = _lib().gram_bf16(y.data_ptr(), g.data_ptr(), ws.data_ptr(),
                                   b, m, k, s, stream)
        else:
            err = _lib().gram(y.data_ptr(), g.data_ptr(), ws.data_ptr(), b,
                              m, k, code, s, stream)
    if err != 0:
        raise RuntimeError(f"gram ({route}) launch failed: CUDA error {err} "
                           f"(B={b} M={m} K={k} tile={tile} splits={s})")
    TRAIN_LAUNCHES["gram"] += 1
    return g
