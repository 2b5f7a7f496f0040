"""Wrapper of the tiled matmul kernel ``csrc/matmul_tiled.cu``: C = A B
with f32 sums, written in A's dtype (or ``out_dtype``). It replaces
``repro/kernels/matmul_tiled.py::_matmul_kernel``, which ``ops.matmul`` and
the two-launch ``ops.lowrank_matmul_unfused`` reach (the Table 2 baseline
that the fused kernel #1 is held against).

``matmul_tiled`` takes CUDA tensors only and launches the kernel or raises.
A must be row-major (unit stride along K; any row stride); B may have any
strides, so a transposed view (``R.T``) is read in place, not copied.
Which kernel of the source takes a call is ``matmul_route``'s rule on
dtype, widths, strides and addresses: the tensor-core product of
``csrc/gemm_bf16.cuh`` with one piece, tiled and split by
``lowrank.gemm_plan``, or the tiled kernel that takes f32 and any
strides.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lowrank import LAUNCHES, dtype_code, gemm_plan


def _lib() -> ctypes.CDLL:
    lib = _build.library("matmul_tiled.cu")
    if lib.matmul_tiled.argtypes is None:
        lib.matmul_tiled.restype = ctypes.c_int
        lib.matmul_tiled.argtypes = [ctypes.c_void_p] * 3 \
            + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 4 \
            + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.matmul_bf16_tc.restype = ctypes.c_int
        lib.matmul_bf16_tc.argtypes = [ctypes.c_void_p] * 3 \
            + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 2
    return lib


def b_layout(b: torch.Tensor) -> str | None:
    """How the tensor-core copies read B (K, N): ``"n_major"`` (row-major,
    unit stride along N) or ``"k_major"`` (a view such as ``R.T``, unit
    stride along K), each with the other stride a multiple of 8; None
    where neither holds."""
    if b.stride(1) == 1 and b.stride(0) % 8 == 0:
        return "n_major"
    if b.stride(0) == 1 and b.stride(1) % 8 == 0:
        return "k_major"
    return None


def matmul_route(a: torch.Tensor, b: torch.Tensor) -> str:
    """The kernel a call takes: ``"tensor_core"`` (``matmul_bf16_tc``) for
    bf16 A and B whose rows the 16-byte copies can read: K and N multiples
    of 8, A with unit stride along K and a row stride that is a multiple of
    8, B as ``b_layout`` admits, both bases 16-byte aligned; the output may
    be bf16 or f32. Everything else (f32, other strides) takes
    ``"tiled"``, the kernel of ``matmul_tiled``."""
    k, n = b.shape
    if (a.dtype == b.dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0
            and a.stride(1) == 1 and a.stride(0) % 8 == 0
            and b_layout(b) is not None and a.data_ptr() % 16 == 0
            and b.data_ptr() % 16 == 0):
        return "tensor_core"
    return "tiled"


def _matmul_tc(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> int:
    """Launch the tensor-core route into c; the split partials are scratch
    of this call."""
    m, k = a.shape
    n = b.shape[1]
    plan = gemm_plan(m, n, k)
    kmajor = b_layout(b) == "k_major"
    ws = torch.empty((plan.splits * m * n if plan.splits > 1 else 1,),
                     dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    return _lib().matmul_bf16_tc(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, a.stride(0),
        b.stride(1) if kmajor else b.stride(0), int(kmajor),
        int(c.dtype == torch.bfloat16), plan.tile, plan.splits, ws.data_ptr(),
        stream)


def check_operands(a: torch.Tensor, b: torch.Tensor, out_dtype) -> None:
    """The operands the kernel takes: 2-D CUDA tensors on one device, one
    dtype (bf16 or f32), A (M, K) with unit stride along K, B (K, N) with
    non-negative strides, sizes and offsets within 32-bit element
    counts."""
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda":
            raise ValueError(f"matmul_tiled: {name} is on {t.device}, the "
                             "kernel takes CUDA tensors only")
        if t.dim() != 2:
            raise ValueError(f"matmul_tiled: {name} must be 2-D, got "
                             f"{tuple(t.shape)}")
        if min(t.stride()) < 0:
            raise ValueError(f"matmul_tiled: {name} has a negative stride")
        span = sum((n - 1) * s for n, s in zip(t.shape, t.stride())) + 1
        if span >= 2 ** 31:
            raise ValueError(f"matmul_tiled: {name} too large for 32-bit "
                             "sizes")
    if a.device != b.device:
        raise ValueError("matmul_tiled: a and b on different devices")
    if a.dtype != b.dtype:
        raise ValueError(f"matmul_tiled: a is {a.dtype}, b is {b.dtype}; "
                         "the kernel takes one dtype")
    dtype_code("matmul_tiled", a)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"matmul_tiled: out_dtype {out_dtype} not "
                         "supported (bfloat16 or float32)")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul_tiled: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not chain")
    if a.shape[1] > 1 and a.stride(1) != 1:
        raise ValueError("matmul_tiled: a must have unit stride along K "
                         f"(strides {a.stride()})")


def matmul_tiled(a: torch.Tensor, b: torch.Tensor,
                 out_dtype=None) -> torch.Tensor:
    """C (M, N) = A (M, K) B (K, N), f32 sums, C in ``out_dtype`` (default
    A's dtype), on the current stream by ``matmul_route``'s kernel (one
    launch, or two where the plan splits K); one call counts one launch."""
    out_dtype = out_dtype or a.dtype
    check_operands(a, b, out_dtype)
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return c
    route = matmul_route(a, b)
    with torch.cuda.device(a.device):
        if route == "tensor_core":
            err = _matmul_tc(a, b, c)
        else:
            stream = torch.cuda.current_stream(a.device).cuda_stream
            err = _lib().matmul_tiled(
                a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                a.stride(0), b.stride(0), b.stride(1), c.stride(0),
                dtype_code("matmul", a), dtype_code("matmul", c), stream)
    if err != 0:
        raise RuntimeError(f"matmul_tiled ({route}) launch failed: CUDA "
                           f"error {err} (M={m} N={n} K={k})")
    LAUNCHES["matmul_tiled"] += 1
    return c
