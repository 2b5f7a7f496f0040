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

One kernel design takes both dtypes (``csrc/flash_attn.cu``: mma.sync on
the bf16 tensor cores, K/V tiles through a cp.async ring, fragments by
ldmatrix); the route is the dtype: ``"bf16"``, or ``"f32_pieces"`` (q, k,
v and p as 3 exact bf16 pieces, ``PIECES``). ``flash_plan`` picks the
query tile, the key groups and the ring depth from the shapes, a rule
pinned by the CPU tests and set by the sweep ``chip_smoke.py`` phase 13
prints.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lowrank import LAUNCHES, SMS, _cdiv, dtype_code

MAX_HEAD_DIM = 256
_MAX_GRID_YZ = 65535   # gridDim.y (batch) and gridDim.z (query tiles)
#: bf16 pieces of each f32 operand on the f32 route; the products keep the
#: pairs of pieces whose indices sum to < PIECES (csrc: PIECES)
PIECES = 3
#: bf16 64-row tiles take two key groups (8 warps) where they give fewer
#: blocks than this, 1.5 a card's SMs: on an H100 (phase 13's sweep) two
#: groups won at qwen2-0.5b's prefill buckets of 2 and 3 x 256 (112 and
#: 168 blocks) and lost at 4 and 5 x 256 (224, 280) and every larger grid
KS2_MAX_BLOCKS = 3 * SMS // 2


class FlashPlan(NamedTuple):
    dp: int       # dh padded to 32, 64, 128 or 256 (the instantiation)
    bq: int       # query rows a block: 64 (4 warps a key group); f32 128
    ks: int       # key groups (bf16, bq 64: 2 walk the even and odd tiles)
    stages: int   # bf16: steps of ks K/V tiles in the cp.async ring; f32: 1
    bk: int       # keys a tile


def padded_dim(dh: int) -> int:
    """The head dim the kernel is instantiated at: 32, 64, 128 or 256 (the
    k-steps and n-tiles past dh are skipped, their columns zero)."""
    return next(p for p in (32, 64, 128, 256) if dh <= p)


def block_keys(dp: int, dtype: torch.dtype) -> int:
    """Keys a tile (csrc: Geo::BK): 64, and on the f32 route 32 at dp 128
    and 16 at dp 256 (six piece tiles and q's pieces must fit)."""
    if dtype == torch.bfloat16 or dp <= 64:
        return 64
    return 32 if dp == 128 else 16


def q_in_registers(dp: int, dtype: torch.dtype) -> bool:
    """Whether q's fragments stay in registers (csrc: Geo::QREG): where
    they take at most 48 registers a thread (f32 dp <= 64, bf16 dp <=
    128); else q's pieces stay in shared memory."""
    return (PIECES if dtype == torch.float32 else 1) * dp <= 192


def flash_smem_bytes(dp: int, dtype: torch.dtype, bq: int, stages: int,
                     ks: int = 1) -> int:
    """Mirror of ``flash_attn_smem_bytes``: bf16, ``stages`` steps of ks
    K/V tiles of bk rows of dp + 8 bf16 (q staged in the last; the key
    groups merge through the ring); f32, the raw f32 K and V tiles and
    their 6 bf16 pieces (q's pieces staged there); plus q's pieces where
    they stay in shared memory (``q_in_registers``)."""
    f32 = dtype == torch.float32
    pieces = PIECES if f32 else 1
    bk, st = block_keys(dp, dtype), dp + 8
    qs = 0 if q_in_registers(dp, dtype) else pieces * bq * st
    elems = (4 * bk * dp + 6 * bk * st if f32
             else stages * ks * 2 * bk * st)
    return 2 * (elems + qs)


def plans(dh: int, dtype: torch.dtype) -> list[FlashPlan]:
    """Every plan instantiated at ``dh`` (the sweep's candidates): bq 64
    and one key group; f32 at dp <= 64 also bq 128, with one raw tile;
    bf16 rings of 2 or 3 steps (dp 256: 2) and, at dp <= 128, also two
    key groups."""
    dp, f32 = padded_dim(dh), dtype == torch.float32
    bk = block_keys(dp, dtype)
    rings = (1,) if f32 else ((2, 3) if dp <= 128 else (2,))
    shapes = [(64, 1)] + ([(128, 1)] if f32 and dp <= 64 else []) \
        + ([(64, 2)] if not f32 and dp <= 128 else [])
    return [FlashPlan(dp, bq, ks, st, bk) for bq, ks in shapes
            for st in rings]


def flash_plan(b: int, sq: int, sk: int, h: int, dh: int,
               dtype: torch.dtype) -> FlashPlan:
    """The kernel's plan for q (b, sq, h, dh) against sk keys: 64-row
    query tiles, except f32 at dp <= 64 takes 128-row tiles (8 warps; half
    the K/V tile loads and conversions per query: faster at every f32
    grid phase 13 sweeps on an H100, 32 to 1,536 blocks); bf16 at dp <=
    128 takes two key groups (8 warps) where 64-row tiles give fewer than
    ``KS2_MAX_BLOCKS`` blocks; a bf16 ring of 3 steps at dp <= 128, 2 at
    256; f32 one raw tile in flight beside the converted pieces. bf16
    takes 64-row tiles at every shape: 128 lost at each bf16 shape swept,
    up to a 4,096-token prompt."""
    dp = padded_dim(dh)
    f32 = dtype == torch.float32
    stages = 1 if f32 else (3 if dp <= 128 else 2)
    bq, ks = 64, 1
    if f32 and dp <= 64:
        bq = 128
    elif not f32 and dp <= 128 and b * h * _cdiv(sq, 64) < KS2_MAX_BLOCKS:
        ks = 2
    return FlashPlan(dp, bq, ks, stages, block_keys(dp, dtype))


def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_attn.cu")
    if lib.flash_attn.argtypes is None:
        lib.flash_attn.restype = ctypes.c_int
        lib.flash_attn.argtypes = [ctypes.c_void_p] * 4 \
            + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9 \
            + [ctypes.c_int] * 2 + [ctypes.c_float] \
            + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.flash_attn_smem_bytes.restype = ctypes.c_int
        lib.flash_attn_smem_bytes.argtypes = [ctypes.c_int] * 5
    return lib


def check_operands(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> None:
    """What the kernel takes: 4-D CUDA tensors on one device, one dtype
    (bf16 or f32), q (B, Sq, H, dh), k and v (B, Sk, KVH, dh), H a
    multiple of KVH, dh a multiple of 8 up to 256, unit stride along dh,
    non-negative strides, B and the query tiles within the grid's
    limits."""
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
    if b > _MAX_GRID_YZ or _cdiv(sq, 64) > _MAX_GRID_YZ:
        raise ValueError(f"{op}: batch {b} or {sq} queries (in tiles of "
                         f"64) above {_MAX_GRID_YZ}")


def _aligned_rows(*ts: torch.Tensor) -> bool:
    """Does every row of every tensor start on a 16-byte boundary, so the
    kernel loads 16 bytes at a time?"""
    return all(t.data_ptr() % 16 == 0 and all(
        s % (16 // t.element_size()) == 0 for s in t.stride()[:3])
        for t in ts)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         plan: FlashPlan | None = None) -> torch.Tensor:
    """o (B, Sq, H, dh) = softmax(q k^T dh^-0.5 + mask) v, f32 scores and
    softmax, o in q's dtype; one launch on the current stream. ``plan``
    (one of ``plans``) replaces ``flash_plan``'s choice (the sweep)."""
    check_operands(q, k, v)
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    o = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    if b == 0 or sq == 0 or h == 0:
        return o
    plan = plan or flash_plan(b, sq, sk, h, dh, q.dtype)
    if plan not in plans(dh, q.dtype):
        raise ValueError(f"flash_attention: {plan} is not a plan of dh {dh} "
                         f"{q.dtype}")
    vec = _aligned_rows(q, k, v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().flash_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq,
            sk, h, kvh, dh, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], int(causal), int(window), dh ** -0.5, int(vec),
            dtype_code("flash_attention", q), plan.dp, plan.bq, plan.ks,
            plan.stages, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}"
                           f" (B={b} Sq={sq} Sk={sk} H={h} KVH={kvh} "
                           f"dh={dh} {q.dtype} {plan})")
    LAUNCHES["flash_attention"] += 1
    return o
