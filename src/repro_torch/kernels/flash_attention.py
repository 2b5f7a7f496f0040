"""Wrapper of the flash attention kernel ``csrc/flash_attn.cu``: online-
softmax attention with a causal, a sliding-window or no mask, grouped-query
heads, in one launch. It replaces
``repro/kernels/flash_attention.py::_flash_kernel``.

q (B, Sq, H, dh), k and v (B, Sk, KVH, dh) are read through their strides
(only dh must have unit stride), so a slice or a permuted view goes in
without a copy; query head h reads KV head ``h // (H // KVH)``. The output
is a new contiguous (B, Sq, H, dh) tensor in q's dtype. CUDA tensors only:
``flash_attention_cuda`` launches the kernel or raises, it never falls
back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lowrank import LAUNCHES, dtype_code

MAX_HEAD_DIM = 256
_MAX_GRID_YZ = 65535   # gridDim.y (heads) and gridDim.z (batch) limits


def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_attn.cu")
    if lib.flash_attn.argtypes is None:
        lib.flash_attn.restype = ctypes.c_int
        lib.flash_attn.argtypes = [ctypes.c_void_p] * 4 \
            + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9 \
            + [ctypes.c_int] * 2 + [ctypes.c_float] \
            + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    return lib


def check_operands(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> None:
    """What the kernel takes: 4-D CUDA tensors on one device, one dtype
    (bf16 or f32), q (B, Sq, H, dh), k and v (B, Sk, KVH, dh), H a
    multiple of KVH, dh a multiple of 8 up to 256, unit stride along dh,
    non-negative strides, B and H within the grid's limits."""
    op = "flash_attention"
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{op}: {name} is on {t.device}, the kernel "
                             "takes CUDA tensors only")
        if t.dim() != 4:
            raise ValueError(f"{op}: {name} must be 4-D (B, S, heads, dh), "
                             f"got {tuple(t.shape)}")
        if t.stride(-1) != 1 or min(t.stride()) < 0:
            raise ValueError(f"{op}: {name} needs unit stride along dh and "
                             f"non-negative strides, got {t.stride()}")
        if t.dtype != q.dtype:
            raise ValueError(f"{op}: {name} is {t.dtype}, q is {q.dtype}; "
                             "the kernel takes one dtype")
        if t.device != q.device:
            raise ValueError(f"{op}: q and {name} on different devices")
    dtype_code(op, q)
    b, sq, h, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"{op}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    kvh = k.shape[2]
    if kvh == 0 or h % kvh:
        raise ValueError(f"{op}: {h} query heads are not a multiple of "
                         f"{kvh} KV heads")
    if dh % 8 or not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"{op}: head dim {dh} must be a multiple of 8 "
                         f"up to {MAX_HEAD_DIM}")
    if k.shape[1] == 0:
        raise ValueError(f"{op}: no keys (Sk = 0)")
    if b > _MAX_GRID_YZ or h > _MAX_GRID_YZ:
        raise ValueError(f"{op}: batch {b} or heads {h} above "
                         f"{_MAX_GRID_YZ}")


def _aligned_rows(*ts: torch.Tensor) -> bool:
    """Does every row of every tensor start on a 16-byte boundary, so the
    kernel loads 16 bytes at a time?"""
    return all(t.data_ptr() % 16 == 0 and all(
        s % (16 // t.element_size()) == 0 for s in t.stride()[:3])
        for t in ts)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """o (B, Sq, H, dh) = softmax(q k^T dh^-0.5 + mask) v, f32 scores and
    softmax, o in q's dtype; one launch on the current stream."""
    check_operands(q, k, v)
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    o = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    if b == 0 or sq == 0 or h == 0:
        return o
    vec = _aligned_rows(q, k, v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().flash_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq,
            sk, h, kvh, dh, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], int(causal), int(window), dh ** -0.5, int(vec),
            dtype_code("flash_attention", q), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}"
                           f" (B={b} Sq={sq} Sk={sk} H={h} KVH={kvh} "
                           f"dh={dh} {q.dtype})")
    LAUNCHES["flash_attention"] += 1
    return o
