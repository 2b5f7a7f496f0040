"""Wrappers of the CholeskyQR kernels: (Q, mix) of a stack of tall-skinny
Y, Q = Y C^-T with C C^T = Y^T Y + shift I and mix = C^-1 Y^T Y = Q^T Y.
They replace ``repro/kernels/qr.py::_choleskyqr_kernel`` with its
``_masked_cholesky`` and ``_tril_inverse``.

Phase 0 is the Gram launch (``kernels/gram.py``, counted as ``gram``);
then one call of ``choleskyqr`` factors, inverts and applies, by
``qr_route``'s kernels:

* factor ``"blocked"`` (K <= 288, the ranks whose packed lower triangle of
  32 x 32 f32 blocks fits one block's shared memory;
  ``csrc/choleskyqr_blocked.cu``): a blocked Cholesky and inverse in shared
  memory, one block per stack index; the apply Q = Y X^T on the tensor
  cores over two bf16 pieces of X (``"tensor_core"``: bf16 Y whose rows
  the 16-byte copies read, tiles and splits ``lowrank.gemm_plan``), else
  on the f32 FMA product (``"fma"``);
* factor ``"global"`` (larger K; ``csrc/choleskyqr.cu``): a column step
  at a time from global memory, the apply on the f32 FMA product.

A stack index whose first factorization fails is factored again with a
1e4-times larger shift, the ladder of
``repro/core/orthogonal.py::_shifted_cholesky`` (``with_retry=True`` also
returns which indices took it). CUDA tensors only; the wrapper launches or
raises. A call counts one ``choleskyqr`` launch whatever its route.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gram import gram
from repro_torch.kernels.lowrank import (
    PIECES_BF16_OUT,
    SMEM_LIMIT,
    TRAIN_LAUNCHES,
    GemmPlan,
    check_cuda,
    dtype_code,
    gemm_plan,
)

BLOCK = 32       # edge of a factor block (csrc: T)
BLOCK_LD = 33    # its padded row stride in floats (csrc: LD)
#: static shared memory of the blocked factor (its 256-float tree and flag)
BLOCKED_STATIC_SMEM = 256 * 4 + 16


def blocked_smem_bytes(k: int) -> int:
    """Mirror of ``choleskyqr_blocked_smem_bytes``: the packed lower
    triangle of nb = ceil(K / 32) blocks, nb (nb + 1) / 2 of them, and the
    inverses of the nb diagonal blocks, 32 x 33 f32 each."""
    nb = -(-k // BLOCK)
    return (nb * (nb + 1) // 2 + nb) * BLOCK * BLOCK_LD * 4


def qr_route(k: int, dtype: torch.dtype, tensors) -> tuple[str, str]:
    """(factor, apply) of a call at rank K: factor ``"blocked"`` where the
    blocked factor's shared memory fits one block (K <= 288), else
    ``"global"``; apply ``"tensor_core"`` on the blocked route for bf16 Y
    with K a multiple of 8 and 16-byte aligned bases (``tensors``: Y and
    Q), else ``"fma"``."""
    if blocked_smem_bytes(k) + BLOCKED_STATIC_SMEM > SMEM_LIMIT:
        return "global", "fma"
    if dtype == torch.bfloat16 and k % 8 == 0 and \
            all(t.data_ptr() % 16 == 0 for t in tensors):
        return "blocked", "tensor_core"
    return "blocked", "fma"


def _lib() -> ctypes.CDLL:
    lib = _build.library("choleskyqr.cu")
    if lib.choleskyqr.argtypes is None:
        lib.choleskyqr.restype = ctypes.c_int
        lib.choleskyqr.argtypes = [ctypes.c_void_p] * 6 \
            + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    return lib


def _blocked_lib() -> ctypes.CDLL:
    lib = _build.library("choleskyqr_blocked.cu")
    if lib.choleskyqr_blocked.argtypes is None:
        lib.choleskyqr_blocked.restype = ctypes.c_int
        lib.choleskyqr_blocked.argtypes = [ctypes.c_void_p] * 9 \
            + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p]
        lib.choleskyqr_blocked_smem_bytes.restype = ctypes.c_int
        lib.choleskyqr_blocked_smem_bytes.argtypes = [ctypes.c_int]
    return lib


def _blocked(y, g, q, mix, retried, b, m, k, code, shift, tc) -> int:
    """The blocked factor and its apply; X, and X's pieces (tensor cores)
    or X^T (f32 FMA), are scratch of this call."""
    dev = y.device
    x = torch.empty((b * k * k,), dtype=torch.float32, device=dev)
    if tc:
        # Q (M, K) = sum_p Y X_p^T over two pieces, b products in a launch
        plan = gemm_plan(m, k, k, PIECES_BF16_OUT, batch=b)
        xp = torch.empty((b * PIECES_BF16_OUT * k * k,), dtype=torch.bfloat16,
                         device=dev)
        ws = torch.empty((max(plan.splits * b * m * k if plan.splits > 1
                              else 0, 1),), dtype=torch.float32, device=dev)
        xt = None
    else:
        plan = GemmPlan(0, 1)
        xt = torch.empty_like(x)
        xp = ws = None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        return _blocked_lib().choleskyqr_blocked(
            y.data_ptr(), g.data_ptr(), q.data_ptr(), mix.data_ptr(),
            x.data_ptr(), ptr(xt), ptr(xp), ptr(ws), retried.data_ptr(), b,
            m, k, code, int(tc), shift, plan.tile, plan.splits, stream)


def _global(y, g, q, mix, retried, b, m, k, code, shift) -> int:
    ws = torch.empty((3 * b * k * k,), dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        return _lib().choleskyqr(y.data_ptr(), g.data_ptr(), q.data_ptr(),
                                 mix.data_ptr(), ws.data_ptr(),
                                 retried.data_ptr(), b, m, k, code, shift,
                                 stream)


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
    factor, apply = qr_route(k, y.dtype, (y, q))
    if factor == "blocked":
        err = _blocked(y, g, q, mix, retried, b, m, k, code, shift,
                       apply == "tensor_core")
    else:
        err = _global(y, g, q, mix, retried, b, m, k, code, shift)
    if err != 0:
        raise RuntimeError(f"choleskyqr ({factor}, {apply}) launch failed: "
                           f"CUDA error {err} (B={b} M={m} K={k})")
    TRAIN_LAUNCHES["choleskyqr"] += 1
    return (q, mix, retried.bool()) if with_retry else (q, mix)
