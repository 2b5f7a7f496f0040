"""Wrapper of the fused int8 low-rank kernel ``csrc/lowrank_q8.cu``:
y = ((x Rq^T) * sR) Lq^T * sL in one launch, int8 factors converted on
chip, f32 sums, no dequantized weight ever written. It replaces
``repro/kernels/quant.py::_lowrank_q8_kernel``.

2-D CUDA tensors only; the wrapper launches or raises, never falls back.
The grid is kernel #1's (``lowrank.launch_config``): the kernel keeps its
shared-memory layout and cluster split.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lowrank import (
    _DTYPES,
    LAUNCHES,
    check_cuda,
    dtype_code,
    launch_config,
)


def _lib() -> ctypes.CDLL:
    lib = _build.library("lowrank_q8.cu")
    if lib.lowrank_q8.argtypes is None:
        lib.lowrank_q8.restype = ctypes.c_int
        lib.lowrank_q8.argtypes = [ctypes.c_void_p] * 6 \
            + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        lib.lowrank_q8_smem_bytes.restype = ctypes.c_int
        lib.lowrank_q8_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


def _check(x, rq, rs, lq, ls) -> None:
    op = "lowrank_q8"
    check_cuda(op, x=x, Rq=rq, sR=rs, Lq=lq, sL=ls)
    for name, t, nd in (("x", x, 2), ("Rq", rq, 2), ("sR", rs, 1),
                        ("Lq", lq, 2), ("sL", ls, 1)):
        if t.dim() != nd:
            raise ValueError(f"{op}: {name} must be {nd}-D, got "
                             f"{tuple(t.shape)}")
    dtype_code(op, x)
    for name, t, want in (("Rq", rq, torch.int8), ("Lq", lq, torch.int8),
                          ("sR", rs, torch.float32),
                          ("sL", ls, torch.float32)):
        if t.dtype != want:
            raise ValueError(f"{op}: {name} must be {want}, got {t.dtype}")
    k, i = rq.shape
    o = lq.shape[0]
    if x.shape[1] != i or lq.shape[1] != k or rs.shape != (k,) \
            or ls.shape != (o,):
        raise ValueError(f"{op}: shapes x {tuple(x.shape)}, Rq "
                         f"{tuple(rq.shape)}, sR {tuple(rs.shape)}, Lq "
                         f"{tuple(lq.shape)}, sL {tuple(ls.shape)} do not "
                         "chain")


def lowrank_q8(x: torch.Tensor, rq: torch.Tensor, rs: torch.Tensor,
               lq: torch.Tensor, ls: torch.Tensor) -> torch.Tensor:
    """y (M, O) in x's dtype = ((x (M, I) Rq^T) * sR) Lq^T * sL, one launch
    on the current stream. x bf16 or f32; Rq (K, I) and Lq (O, K) int8;
    sR (K,) and sL (O,) f32."""
    _check(x, rq, rs, lq, ls)
    m, i = x.shape
    k, o = rq.shape[0], lq.shape[0]
    y = torch.empty((m, o), dtype=x.dtype, device=x.device)
    if m == 0 or o == 0:
        return y
    if k == 0 or i == 0:
        return y.zero_()
    cfg = launch_config(m, k, o)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().lowrank_q8(x.data_ptr(), rq.data_ptr(), rs.data_ptr(),
                                lq.data_ptr(), ls.data_ptr(), y.data_ptr(),
                                m, i, k, o, _DTYPES[x.dtype], cfg.bm, cfg.ks,
                                cfg.oc, cfg.groups, stream)
    if err != 0:
        raise RuntimeError(f"lowrank_q8 launch failed: CUDA error {err} "
                           f"(M={m} I={i} K={k} O={o} {cfg})")
    LAUNCHES["lowrank_q8"] += 1
    return y
