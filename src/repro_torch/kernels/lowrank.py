"""Wrapper of the fused low-rank forward kernel ``csrc/lowrank_fwd.cu``:
y = (x R^T) L^T in one launch, the rank-K ``h`` kept in f32 in shared
memory. It replaces ``repro/kernels/lowrank.py::_lowrank_kernel``.

``lowrank_fused`` takes 2-D CUDA tensors only and launches the kernel or
raises; it never falls back. The grid shape is chosen here, in Python,
where the CPU tests can check it (``launch_config``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

#: kernel name -> launches made by its wrapper (plain ints; a run sets them
#: to 0 and reads them to show the main path went through the kernel)
LAUNCHES: dict[str, int] = {"lowrank_fwd": 0}

CLUSTER = 8           # CTAs per thread-block cluster (csrc: CL)
TARGET_CTAS = 264     # about two CTAs per SM of an H100 (132 SMs)
MIN_COLS_PER_CTA = 16
SMEM_LIMIT = 232448   # bytes of shared memory one block can use on sm_90

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class LaunchConfig(NamedTuple):
    bm: int      # rows per CTA (16 or 64)
    ks: int      # k-slice width per cluster rank (multiple of 8)
    oc: int      # output columns per CTA
    groups: int  # clusters along O
    smem: int    # dynamic shared memory bytes per CTA


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(bm: int, ks: int) -> int:
    """Mirror of ``lowrank_fwd_smem_bytes`` in the CUDA source."""
    kp2 = _cdiv(CLUSTER * ks, 32) * 32
    region = max(8 * bm * 32, kp2 * (bm + 4))
    return 4 * (region + bm * ks + 32 * 68)


@functools.lru_cache(maxsize=256)
def launch_config(m: int, k: int, o: int) -> LaunchConfig:
    """Tile and grid choice for x (m, .), R (k, .), L (o, k).

    Rows: 16 per CTA when a decode step's few rows fit, else 64. The rank
    is split over the 8 CTAs of a cluster (each computes one k-slice of h).
    Clusters along O: enough that the grid holds ~2 CTAs per SM, but never
    fewer than 16 output columns per CTA, since each cluster recomputes h.
    """
    bm = 16 if m <= 16 else 64
    ks = _cdiv(_cdiv(k, CLUSTER), 8) * 8
    smem = smem_bytes(bm, ks)
    if smem > SMEM_LIMIT and bm == 64:
        bm = 16
        smem = smem_bytes(bm, ks)
    if smem > SMEM_LIMIT:
        raise ValueError(f"rank {k} needs {smem} B of shared memory per CTA "
                         f"(limit {SMEM_LIMIT}); the fused kernel keeps all "
                         "of h on chip")
    row_blocks = _cdiv(m, bm)
    g_cols = max(1, _cdiv(o, CLUSTER * MIN_COLS_PER_CTA))
    g_fill = max(1, _cdiv(TARGET_CTAS, CLUSTER * row_blocks))
    groups = min(g_cols, g_fill)
    oc = _cdiv(o, CLUSTER * groups)
    return LaunchConfig(bm, ks, oc, groups, smem)


def _lib() -> ctypes.CDLL:
    lib = _build.library("lowrank_fwd.cu")
    if lib.lowrank_fwd.argtypes is None:
        lib.lowrank_fwd.restype = ctypes.c_int
        lib.lowrank_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        lib.lowrank_fwd_smem_bytes.restype = ctypes.c_int
        lib.lowrank_fwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


def _check(x: torch.Tensor, r: torch.Tensor, l: torch.Tensor) -> None:
    for name, t in (("x", x), ("R", r), ("L", l)):
        if t.device.type != "cuda":
            raise ValueError(f"lowrank_fused: {name} is on {t.device}, "
                             "the kernel takes CUDA tensors only")
        if t.dim() != 2:
            raise ValueError(f"lowrank_fused: {name} must be 2-D, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"lowrank_fused: {name} must be contiguous")
        if t.dtype not in _DTYPES:
            raise ValueError(f"lowrank_fused: dtype {t.dtype} not supported "
                             "(bfloat16 or float32)")
    if not (x.dtype == r.dtype == l.dtype):
        raise ValueError(f"lowrank_fused: dtypes differ ({x.dtype}, "
                         f"{r.dtype}, {l.dtype})")
    if not (x.device == r.device == l.device):
        raise ValueError("lowrank_fused: tensors on different devices")
    if x.shape[1] != r.shape[1] or r.shape[0] != l.shape[1]:
        raise ValueError(f"lowrank_fused: shapes x {tuple(x.shape)}, R "
                         f"{tuple(r.shape)}, L {tuple(l.shape)} do not chain")
    if max(t.numel() for t in (x, r, l)) >= 2 ** 31:
        raise ValueError("lowrank_fused: tensor too large for 32-bit sizes")


def lowrank_fused(x: torch.Tensor, r_factor: torch.Tensor,
                  l_factor: torch.Tensor) -> torch.Tensor:
    """y (M, O) = x (M, I) R^T (I, K) L^T (K, O), one launch of the CUDA
    kernel on the current stream. bf16 or f32; all three of one dtype."""
    _check(x, r_factor, l_factor)
    m, i = x.shape
    k, o = r_factor.shape[0], l_factor.shape[0]
    y = torch.empty((m, o), dtype=x.dtype, device=x.device)
    if m == 0 or o == 0:
        return y
    cfg = launch_config(m, k, o)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.lowrank_fwd(x.data_ptr(), r_factor.data_ptr(),
                              l_factor.data_ptr(), y.data_ptr(), m, i, k, o,
                              _DTYPES[x.dtype], cfg.bm, cfg.ks, cfg.oc,
                              cfg.groups, stream)
    if err != 0:
        raise RuntimeError(f"lowrank_fwd launch failed: CUDA error {err} "
                           f"(M={m} I={i} K={k} O={o} {cfg})")
    LAUNCHES["lowrank_fwd"] += 1
    return y
