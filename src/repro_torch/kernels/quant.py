"""Wrappers of the int8 low-rank kernel #6: y = ((x Rq^T) * sR) Lq^T * sL,
int8 factors converted on chip (exactly), f32 sums, no dequantized weight
ever written, x never quantized. It replaces
``repro/kernels/quant.py::_lowrank_q8_kernel``.

A call takes one of three routes (``q8_route``), kernel #1's designs with
int8 factors:

* ``decode`` (M <= Q8_DECODE_MAX_M): ``csrc/lowrank_q8_routes.cu``'s
  ``lowrank_q8_decode``, the two skinny products of
  ``csrc/lowrank_decode.cuh`` with the int8 weight loaded 16 bytes a lane
  into registers; grid ``lowrank.decode_plan`` with 64-deep slices;
* ``tensor_core`` (larger bf16 M): ``lowrank_q8_tc``, two products of
  ``gemm_bf16.cuh`` with an int8 B operand, h sR stored as two bf16
  pieces in scratch; tiles and splits ``lowrank.sketch_plan``;
* ``fused``: the one launch of ``csrc/lowrank_q8.cu`` (f32 x above the
  threshold, widths the 16-byte loads cannot read), kernel #1's old grid
  (``lowrank.launch_config``).

2-D CUDA tensors only; the wrapper launches or raises, never falls back.
A call counts one ``lowrank_q8`` launch whatever its route.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lowrank import (
    _DTYPES,
    DECODE_STATIC_SMEM,
    LAUNCHES,
    PIECES_BF16_OUT,
    SMEM_LIMIT,
    check_cuda,
    check_factor,
    counted_copy,
    decode_plan,
    decode_smem_bytes,
    dtype_code,
    launch_config,
    n8_tiles,
    sketch_plan,
)

#: the decode route takes M up to this many rows: the largest M of a sweep
#: (M = 1, 4, 8, 12, 16, 24, 32) at which it beat the tensor-core route at
#: every qwen2-0.5b site shape on an H100 (``chip_smoke.py`` phase 9,
#: "q8-sweep"; at 24 mlp/gate|up went to the tensor cores, 0.0185 against
#: 0.0225 ms)
Q8_DECODE_MAX_M = 16
#: reduction depth of a warp's lane loads on the decode route: 4 lanes x 16
#: int8 (csrc: 4 lane_values<int8_t>())
Q8_SLICE = 64


def _lib() -> ctypes.CDLL:
    lib = _build.library("lowrank_q8.cu")
    if lib.lowrank_q8.argtypes is None:
        lib.lowrank_q8.restype = ctypes.c_int
        lib.lowrank_q8.argtypes = [ctypes.c_void_p] * 6 \
            + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        lib.lowrank_q8_smem_bytes.restype = ctypes.c_int
        lib.lowrank_q8_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


def _routes_lib() -> ctypes.CDLL:
    lib = _build.library("lowrank_q8_routes.cu")
    if lib.lowrank_q8_decode.argtypes is None:
        lib.lowrank_q8_decode.restype = ctypes.c_int
        lib.lowrank_q8_decode.argtypes = [ctypes.c_void_p] * 7 \
            + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        lib.lowrank_q8_decode_smem_bytes.restype = ctypes.c_int
        lib.lowrank_q8_decode_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.lowrank_q8_tc.restype = ctypes.c_int
        lib.lowrank_q8_tc.argtypes = [ctypes.c_void_p] * 8 \
            + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    return lib


def q8_route(m: int, i: int, k: int, o: int, dtype: torch.dtype,
             tensors) -> str:
    """The kernel a call of #6 takes: ``"decode"`` for M <= Q8_DECODE_MAX_M
    rows of bf16 or f32 x where I and K are multiples of 16 and every base
    16-byte aligned and row stride a multiple of 16 (so each 16-byte load
    of an int8 or x row lies wholly inside or outside it; a rank draft's
    Lq view has the full rank's stride) and the staged h fits in shared
    memory; else
    ``"tensor_core"`` for bf16 x whose widths the 16-byte copies read (I, K
    multiples of 16, O of 8, aligned bases); else ``"fused"``
    (``lowrank_q8.cu``)."""
    rows16 = i % 16 == 0 and k % 16 == 0 and \
        all(t.data_ptr() % 16 == 0 and t.stride(0) % 16 == 0
            for t in tensors)
    nt = n8_tiles(m)
    if m <= Q8_DECODE_MAX_M and rows16 and dtype in _DTYPES and \
            decode_smem_bytes(nt, k, Q8_SLICE) + DECODE_STATIC_SMEM * nt \
            <= SMEM_LIMIT:
        return "decode"
    if dtype == torch.bfloat16 and rows16 and o % 8 == 0:
        return "tensor_core"
    return "fused"


def _check(x, rq, rs, lq, ls) -> None:
    op = "lowrank_q8"
    check_cuda(op, x=x, Rq=rq, sR=rs, sL=ls)
    check_factor(op, "Lq", lq, x)
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


def _decode(x, rq, rs, lq, ls, y) -> int:
    """Launch the decode route into y, Lq read where it lies (rows
    ``lq.stride(0)`` apart); h (M, K) f32 is scratch."""
    m, i = x.shape
    k, o = rq.shape[0], lq.shape[0]
    plan = decode_plan(m, i, k, o, Q8_SLICE)
    h = torch.empty((m, k), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        return _routes_lib().lowrank_q8_decode(
            x.data_ptr(), rq.data_ptr(), rs.data_ptr(), lq.data_ptr(),
            ls.data_ptr(), y.data_ptr(), h.data_ptr(), m, i, k, o,
            lq.stride(0), _DTYPES[x.dtype], *plan, stream)


def _tensor_core(x, rq, rs, lq, ls, y) -> int:
    """Launch the tensor-core route into y; the two bf16 pieces of h sR
    and the split workspace are scratch."""
    m, i = x.shape
    k, o = rq.shape[0], lq.shape[0]
    plan = sketch_plan(m, i, k, o)
    hp = torch.empty((PIECES_BF16_OUT, m, k), dtype=torch.bfloat16,
                     device=x.device)
    ws = torch.empty((max(plan.ws, 1),), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        return _routes_lib().lowrank_q8_tc(
            x.data_ptr(), rq.data_ptr(), rs.data_ptr(), lq.data_ptr(),
            ls.data_ptr(), y.data_ptr(), hp.data_ptr(), ws.data_ptr(), m, i,
            k, o, PIECES_BF16_OUT, *plan.h, *plan.y, stream)


def _fused(x, rq, rs, lq, ls, y) -> int:
    m, i = x.shape
    k, o = rq.shape[0], lq.shape[0]
    cfg = launch_config(m, k, o)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        return _lib().lowrank_q8(x.data_ptr(), rq.data_ptr(), rs.data_ptr(),
                                 lq.data_ptr(), ls.data_ptr(), y.data_ptr(),
                                 m, i, k, o, _DTYPES[x.dtype], cfg.bm, cfg.ks,
                                 cfg.oc, cfg.groups, stream)


_ROUTES = {"decode": _decode, "tensor_core": _tensor_core, "fused": _fused}


def lowrank_q8(x: torch.Tensor, rq: torch.Tensor, rs: torch.Tensor,
               lq: torch.Tensor, ls: torch.Tensor) -> torch.Tensor:
    """y (M, O) in x's dtype = ((x (M, I) Rq^T) * sR) Lq^T * sL on the
    current stream, by ``q8_route``'s kernel. x bf16 or f32; Rq (K, I) and
    Lq (O, K) int8; sR (K,) and sL (O,) f32. Lq may be a ``row_view`` (a
    rank draft's leading columns of an int8 L): the decode route reads it
    in place, any other route a counted copy (``lowrank.counted_copy``)."""
    _check(x, rq, rs, lq, ls)
    m, i = x.shape
    k, o = rq.shape[0], lq.shape[0]
    y = torch.empty((m, o), dtype=x.dtype, device=x.device)
    if m == 0 or o == 0:
        return y
    if k == 0 or i == 0:
        return y.zero_()
    route = q8_route(m, i, k, o, x.dtype, (x, rq, lq))
    if route != "decode" and not lq.is_contiguous():
        lq = counted_copy(lq, "lowrank_q8")
        route = q8_route(m, i, k, o, x.dtype, (x, rq, lq))
    err = _ROUTES[route](x, rq, rs, lq, ls, y)
    if err != 0:
        raise RuntimeError(f"lowrank_q8 ({route}) launch failed: CUDA error "
                           f"{err} (M={m} I={i} K={k} O={o})")
    LAUNCHES["lowrank_q8"] += 1
    return y
