"""Wrapper of the CholeskyQR kernel ``csrc/choleskyqr.cu``: (Q, mix) of a
stack of tall-skinny Y, Q = Y C^-T with C C^T = Y^T Y + shift I and
mix = C^-1 Y^T Y = Q^T Y. It replaces ``repro/kernels/qr.py::
_choleskyqr_kernel`` with its ``_masked_cholesky`` and ``_tril_inverse``.

Phase 0 is the Gram launch (``kernels/gram.py``, counted as ``gram``);
then one call of ``choleskyqr`` factors, inverts and applies. A stack
index whose first factorization fails is factored again with a 1e4-times
larger shift, the ladder of ``repro/core/orthogonal.py::_shifted_cholesky``
(``with_retry=True`` also returns which indices took it). CUDA tensors
only; the wrapper launches or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gram import gram
from repro_torch.kernels.lowrank import TRAIN_LAUNCHES, check_cuda, dtype_code


def _lib() -> ctypes.CDLL:
    lib = _build.library("choleskyqr.cu")
    if lib.choleskyqr.argtypes is None:
        lib.choleskyqr.restype = ctypes.c_int
        lib.choleskyqr.argtypes = [ctypes.c_void_p] * 6 \
            + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    return lib


def choleskyqr(y: torch.Tensor, shift: float = 1e-6, *,
               with_retry: bool = False):
    """(Q (..., M, K) in y's dtype, mix (..., K, K) f32) for y (..., M, K),
    bf16 or f32, every leading stack index in the same launches. With
    ``with_retry`` also a bool (...,) tensor: True where the first
    factorization failed and the 1e4-times larger shift was taken."""
    check_cuda("choleskyqr", y=y)
    code = dtype_code("choleskyqr", y)
    if y.dim() < 2:
        raise ValueError("choleskyqr: y must be at least 2-D, got "
                         f"{tuple(y.shape)}")
    lead, (m, k) = y.shape[:-2], y.shape[-2:]
    b = math.prod(lead)
    g = gram(y)
    q = torch.empty_like(y)
    mix = torch.empty((*lead, k, k), dtype=torch.float32, device=y.device)
    retried = torch.empty(lead, dtype=torch.int32, device=y.device)
    if b == 0 or k == 0:
        return (q, mix, retried.bool()) if with_retry else (q, mix)
    ws = torch.empty((3 * b * k * k,), dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = _lib().choleskyqr(y.data_ptr(), g.data_ptr(), q.data_ptr(),
                                mix.data_ptr(), ws.data_ptr(),
                                retried.data_ptr(), b, m, k, code, shift,
                                stream)
    if err != 0:
        raise RuntimeError(f"choleskyqr launch failed: CUDA error {err} "
                           f"(B={b} M={m} K={k})")
    TRAIN_LAUNCHES["choleskyqr"] += 1
    return (q, mix, retried.bool()) if with_retry else (q, mix)
