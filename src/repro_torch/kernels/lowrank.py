"""Wrappers of the fused low-rank kernels:

* ``lowrank_fused`` -> y = (x R^T) L^T with h = x R^T in f32, replacing
  ``repro/kernels/lowrank.py::_lowrank_kernel``. The serving forward takes
  one of three routes (``forward_route``): ``csrc/lowrank_decode.cu`` for a
  decode step's few rows (two byte-bound products on the tensor cores,
  f32 operands in exact bf16 pieces); for larger bf16 M the two
  tensor-core products of ``csrc/lowrank_sketch.cu`` (h, then y over bf16
  pieces of h); otherwise ``csrc/lowrank_fwd.cu``, one launch that keeps h
  in shared memory. With ``save_sketch`` it also writes ``h`` (M, K) f32
  once and replaces ``_lowrank_sketch_kernel``: ``lowrank_sketch.cu`` on
  bf16 inputs that ``tensor_core_route`` admits, else ``lowrank_fwd.cu``.
* ``lowrank_bwd`` -> ``csrc/lowrank_bwd.cu``: (dx, dL, dR) from the saved
  sketch, replacing ``_lowrank_bwd_kernel``; tensor-core products over bf16
  pieces (``lowrank_bwd_bf16``) where ``tensor_core_route`` admits the
  inputs, the f32 FMA products (``lowrank_bwd``) otherwise.

Both take 2-D CUDA tensors only and launch a kernel or raise; they never
fall back. Which kernel takes a call is a rule on dtype, widths and
addresses (``forward_route``, ``tensor_core_route``), never a retry. Grid
shapes and reduction splits are chosen here, in Python, where the CPU
tests can check them (``launch_config``, ``decode_plan``, ``splits``,
``gemm_plan``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

#: kernel name -> launches made by its wrapper (plain ints; a run sets them
#: to 0 and reads them to show the main path went through the kernel).
#: ``LAUNCHES`` counts the forwards (``lowrank_fwd``, ``lowrank_q8`` of an
#: int8 deployment, kernels/quant.py, ``matmul_tiled`` of the two-launch
#: baseline, kernels/matmul_tiled.py, ``flash_attention``,
#: kernels/flash_attention.py, and ``ssd_scan``, kernels/ssd_scan.py); the
#: kernels that only training reaches count in ``TRAIN_LAUNCHES``.
LAUNCHES: dict[str, int] = {"lowrank_fwd": 0, "lowrank_q8": 0,
                            "matmul_tiled": 0, "flash_attention": 0,
                            "ssd_scan": 0}
TRAIN_LAUNCHES: dict[str, int] = {"lowrank_fwd_sketch": 0, "lowrank_bwd": 0,
                                  "gram": 0, "choleskyqr": 0}
#: copies of an L that the route taking a call cannot read where it lies,
#: per wrapper: ``lowrank_fused`` and ``quant.lowrank_q8`` read a row view
#: (``row_view``) in place on their decode routes and copy it, counted
#: here, on any other route; ``ops.reset_launches`` zeroes them beside the
#: launch counts, ``ops.copy_counts`` reads them
COPIES: dict[str, int] = {"lowrank_fwd": 0, "lowrank_q8": 0}

CLUSTER = 8           # CTAs per thread-block cluster (csrc: CL)
SMS = 132             # streaming multiprocessors of an H100 SXM
TARGET_CTAS = 2 * SMS  # about two CTAs per SM
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
        lib.lowrank_fwd_sketch.restype = ctypes.c_int
        lib.lowrank_fwd_sketch.argtypes = [ctypes.c_void_p] * 5 \
            + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    return lib


def check_cuda(op: str, **tensors: torch.Tensor) -> None:
    """Device, layout and size checks every kernel wrapper makes."""
    device = None
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{op}: {name} is on {t.device}, the kernel "
                             "takes CUDA tensors only")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{op}: {name} too large for 32-bit sizes")
        if device is not None and t.device != device:
            raise ValueError(f"{op}: tensors on different devices")
        device = t.device


def dtype_code(op: str, t: torch.Tensor) -> int:
    if t.dtype not in _DTYPES:
        raise ValueError(f"{op}: dtype {t.dtype} not supported "
                         "(bfloat16 or float32)")
    return _DTYPES[t.dtype]


def row_view(t: torch.Tensor) -> bool:
    """A 2-D tensor of unit-stride rows that lie at least its width apart:
    a contiguous matrix, or the leading columns of one (a rank draft's
    ``L[:, :K']``, rows K apart)."""
    return t.dim() == 2 and (t.shape[0] <= 1 or t.stride(0) >= t.shape[1]) \
        and (t.shape[1] <= 1 or t.stride(1) == 1)


def check_factor(op: str, name: str, t: torch.Tensor, like: torch.Tensor
                 ) -> None:
    """The checks ``check_cuda`` makes, for a factor the decode routes may
    read as a ``row_view`` in place of a contiguous matrix."""
    if t.device != like.device:
        raise ValueError(f"{op}: {name} is on {t.device}, x on "
                         f"{like.device}")
    if not row_view(t):
        raise ValueError(f"{op}: {name} must be 2-D with unit-stride rows "
                         f"at least its width apart, got shape "
                         f"{tuple(t.shape)} strides {t.stride()}")
    if t.shape[0] * max(t.stride(0), 1) >= 2 ** 31:
        raise ValueError(f"{op}: {name} too large for 32-bit sizes")


def counted_copy(l: torch.Tensor, counter: str) -> torch.Tensor:
    """A contiguous copy of an L view for a route that cannot read it where
    it lies (any route but the decode routes), made in the open and
    counted in ``COPIES[counter]``: the copy goes to a kernel, whose route
    the caller decides again; nothing falls back to the plain version."""
    COPIES[counter] += 1
    return l.contiguous()


def _check(x: torch.Tensor, r: torch.Tensor, l: torch.Tensor) -> None:
    check_cuda("lowrank_fused", x=x, R=r)
    check_factor("lowrank_fused", "L", l, x)
    for name, t in (("x", x), ("R", r), ("L", l)):
        if t.dim() != 2:
            raise ValueError(f"lowrank_fused: {name} must be 2-D, got "
                             f"{tuple(t.shape)}")
        dtype_code("lowrank_fused", t)
    if not (x.dtype == r.dtype == l.dtype):
        raise ValueError(f"lowrank_fused: dtypes differ ({x.dtype}, "
                         f"{r.dtype}, {l.dtype})")
    if x.shape[1] != r.shape[1] or r.shape[0] != l.shape[1]:
        raise ValueError(f"lowrank_fused: shapes x {tuple(x.shape)}, R "
                         f"{tuple(r.shape)}, L {tuple(l.shape)} do not chain")


def lowrank_fused(x: torch.Tensor, r_factor: torch.Tensor,
                  l_factor: torch.Tensor, *, save_sketch: bool = False):
    """y (M, O) = x (M, I) R^T (I, K) L^T (K, O) on the current stream.
    bf16 or f32; all three of one dtype. L may be a ``row_view`` (a rank
    draft's leading columns): the decode route reads it in place, any
    other route a counted copy (``counted_copy``). Without
    ``save_sketch`` the route
    is ``forward_route``'s: the two launches of ``lowrank_decode.cu``, the
    two tensor-core launches of ``lowrank_sketch.cu`` (no h stored), or
    one launch of ``lowrank_fwd.cu``; a call counts one launch of
    ``lowrank_fwd`` whatever its route. With ``save_sketch`` returns ``(y,
    h)``, h (M, K) = x R^T in f32 (the training forward): where
    ``tensor_core_route`` admits bf16 inputs by ``lowrank_sketch.cu``, else
    by ``lowrank_fwd.cu``'s one launch; one call counts one launch of
    ``lowrank_fwd_sketch``."""
    _check(x, r_factor, l_factor)
    m, i = x.shape
    k, o = r_factor.shape[0], l_factor.shape[0]
    y = torch.empty((m, o), dtype=x.dtype, device=x.device)
    h = (torch.empty((m, k), dtype=torch.float32, device=x.device)
         if save_sketch else None)
    if save_sketch and o == 0 and m > 0:
        raise ValueError("lowrank_fused: the sketch needs O >= 1 (h is "
                         "written by the CTAs that compute y)")
    if m == 0 or o == 0:
        return (y, h) if save_sketch else y
    route = ("sketch" if save_sketch else
             forward_route(m, i, k, o, x.dtype, (x, r_factor, l_factor)))
    if route != "decode" and not l_factor.is_contiguous():
        l_factor = counted_copy(l_factor, "lowrank_fwd")
        if not save_sketch:
            route = forward_route(m, i, k, o, x.dtype,
                                  (x, r_factor, l_factor))
    if route in ("decode", "tensor_core"):
        if route == "decode":
            _decode(x, r_factor, l_factor, y)
        else:
            _sketch_bf16(x, r_factor, l_factor, y, None)
        LAUNCHES["lowrank_fwd"] += 1
        return y
    if save_sketch and tensor_core_route(x.dtype, (i, k, o),
                                         (x, r_factor, l_factor)):
        _sketch_bf16(x, r_factor, l_factor, y, h)
        TRAIN_LAUNCHES["lowrank_fwd_sketch"] += 1
        return y, h
    cfg = launch_config(m, k, o)
    lib = _lib()
    args = (m, i, k, o, _DTYPES[x.dtype], cfg.bm, cfg.ks, cfg.oc, cfg.groups)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if save_sketch:
            err = lib.lowrank_fwd_sketch(x.data_ptr(), r_factor.data_ptr(),
                                         l_factor.data_ptr(), y.data_ptr(),
                                         h.data_ptr(), *args, stream)
        else:
            err = lib.lowrank_fwd(x.data_ptr(), r_factor.data_ptr(),
                                  l_factor.data_ptr(), y.data_ptr(), *args,
                                  stream)
    name = "lowrank_fwd_sketch" if save_sketch else "lowrank_fwd"
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"(M={m} I={i} K={k} O={o} {cfg})")
    if save_sketch:
        TRAIN_LAUNCHES[name] += 1
        return y, h
    LAUNCHES[name] += 1
    return y


# ---------------------------------------------------------------------------
# Backward: csrc/lowrank_bwd.cu (and the tiled f32 product of gemm_f32.cuh
# that gram.cu and choleskyqr.cu share)
# ---------------------------------------------------------------------------

TILE = 64   # output tile edge of the product kernel (csrc: gemm::BM, BN)


def splits(rows: int, cols: int, red: int, batch: int = 1) -> int:
    """Contiguous ranges to cut a product's reduction into, so that an
    output with few 64 x 64 tiles still fills about TARGET_CTAS blocks;
    each range keeps at least 256 terms. 1 when the tiles alone fill the
    card (132 SMs)."""
    tiles = batch * _cdiv(rows, TILE) * _cdiv(cols, TILE)
    if tiles == 0 or tiles >= TARGET_CTAS // 2:
        return 1
    return max(1, min(TARGET_CTAS // tiles, red // 256))


class BwdConfig(NamedTuple):
    dh: int   # reduction splits of dh = dy L   (over O)
    dx: int   # ... of dx = dh R                 (over K)
    dl: int   # ... of dL = dy^T h               (over M)
    dr: int   # ... of dR = dh^T x               (over M)
    ws: int   # f32 workspace the split partials need


@functools.lru_cache(maxsize=256)
def bwd_config(m: int, i: int, k: int, o: int) -> BwdConfig:
    shapes = {"dh": (m, k, o), "dx": (m, i, k), "dl": (o, k, m),
              "dr": (k, i, m)}
    s = {n: splits(*sh) for n, sh in shapes.items()}
    ws = max([s[n] * shapes[n][0] * shapes[n][1] for n in s if s[n] > 1],
             default=0)
    return BwdConfig(ws=ws, **s)


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.library("lowrank_bwd.cu")
    if lib.lowrank_bwd.argtypes is None:
        lib.lowrank_bwd.restype = ctypes.c_int
        lib.lowrank_bwd.argtypes = [ctypes.c_void_p] * 10 \
            + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        lib.lowrank_bwd_bf16.restype = ctypes.c_int
        lib.lowrank_bwd_bf16.argtypes = [ctypes.c_void_p] * 11 \
            + [ctypes.c_int] * 15 + [ctypes.c_void_p]
    return lib


def lowrank_bwd(dy: torch.Tensor, x: torch.Tensor, h: torch.Tensor,
                l_factor: torch.Tensor, r_factor: torch.Tensor):
    """(dx, dL, dR) of y = (x R^T) L^T from the forward's saved sketch,
    one call of the CUDA backward on the current stream. dy (M, O) and
    x (M, I) in one dtype (bf16 or f32) with L (O, K) and R (K, I);
    h (M, K) f32. Returns dx (M, I) in x's dtype, dL (O, K) and dR (K, I)
    in f32 (the reference's argument order, ``lowrank_bwd_tiled``)."""
    op = "lowrank_bwd"
    check_cuda(op, dy=dy, x=x, h=h, L=l_factor, R=r_factor)
    for name, t in (("dy", dy), ("x", x), ("h", h), ("L", l_factor),
                    ("R", r_factor)):
        if t.dim() != 2:
            raise ValueError(f"{op}: {name} must be 2-D, got "
                             f"{tuple(t.shape)}")
    code = dtype_code(op, x)
    if not (dy.dtype == x.dtype == l_factor.dtype == r_factor.dtype):
        raise ValueError(f"{op}: dtypes differ ({dy.dtype}, {x.dtype}, "
                         f"{l_factor.dtype}, {r_factor.dtype})")
    if h.dtype != torch.float32:
        raise ValueError(f"{op}: the sketch h must be float32, got {h.dtype}")
    m, o = dy.shape
    i = x.shape[1]
    k = h.shape[1]
    if (x.shape[0], h.shape[0]) != (m, m) or l_factor.shape != (o, k) \
            or r_factor.shape != (k, i):
        raise ValueError(f"{op}: shapes dy {tuple(dy.shape)}, x "
                         f"{tuple(x.shape)}, h {tuple(h.shape)}, L "
                         f"{tuple(l_factor.shape)}, R "
                         f"{tuple(r_factor.shape)} do not chain")
    dev = x.device
    dx = torch.empty((m, i), dtype=x.dtype, device=dev)
    dl = torch.empty((o, k), dtype=torch.float32, device=dev)
    dr = torch.empty((k, i), dtype=torch.float32, device=dev)
    if min(m, i, k, o) == 0:
        return dx.zero_(), dl.zero_(), dr.zero_()
    if tensor_core_route(x.dtype, (i, k, o), (dy, x, h, l_factor, r_factor)):
        _bwd_bf16(dy, x, h, l_factor, r_factor, dx, dl, dr)
        TRAIN_LAUNCHES[op] += 1
        return dx, dl, dr
    cfg = bwd_config(m, i, k, o)
    dh = torch.empty((m, k), dtype=torch.float32, device=dev)
    ws = torch.empty((max(cfg.ws, 1),), dtype=torch.float32, device=dev)
    lib = _bwd_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lowrank_bwd(dy.data_ptr(), x.data_ptr(), h.data_ptr(),
                              l_factor.data_ptr(), r_factor.data_ptr(),
                              dx.data_ptr(), dl.data_ptr(), dr.data_ptr(),
                              dh.data_ptr(), ws.data_ptr(), m, i, k, o, code,
                              cfg.dh, cfg.dx, cfg.dl, cfg.dr, stream)
    if err != 0:
        raise RuntimeError(f"{op} launch failed: CUDA error {err} "
                           f"(M={m} I={i} K={k} O={o} {cfg})")
    TRAIN_LAUNCHES[op] += 1
    return dx, dl, dr


# ---------------------------------------------------------------------------
# The bf16 route of #2 and #3: tensor-core products over bf16 pieces
# (csrc/gemm_bf16.cuh, csrc/lowrank_sketch.cu, csrc/lowrank_bwd.cu)
# ---------------------------------------------------------------------------

STEP = 64             # reduction depth of one step (csrc: gemm16::BK)
MIN_SPLIT_STEPS = 4   # a split range keeps >= 4 steps (256 terms)
#: bf16 pieces of an f32 operand (h, dh): two where the output is bf16 (y,
#: dx; their error, 2^-17 of each term, is far below the output's one
#: rounding), three where it is f32 (dL, dR; exact, so the products are the
#: plain version's and only the order of the f32 sums differs)
PIECES_BF16_OUT = 2
PIECES_F32_OUT = 3


def aligned(widths, tensors) -> bool:
    """Every width a multiple of 8, every base 16-byte aligned and every
    2-D tensor's rows a multiple of 8 elements apart (a rank draft's L
    view: its row stride ldl, the full rank): what the 16-byte copies of
    the tensor-core and decode kernels need."""
    return (all(w % 8 == 0 for w in widths)
            and all(t.data_ptr() % 16 == 0 for t in tensors)
            and all(t.stride(0) % 8 == 0 for t in tensors if t.dim() == 2))


def tensor_core_route(dtype: torch.dtype, widths, tensors) -> bool:
    """Whether the bf16 tensor-core kernels take a call whose operands are
    of ``dtype``: bf16, and the widths (I, K, O) and bases ``aligned``,
    since the kernels copy rows 16 bytes at a time. Other calls go to the
    f32 FMA kernels (lowrank_fwd.cu, lowrank_bwd.cu on gemm_f32.cuh)."""
    return dtype == torch.bfloat16 and aligned(widths, tensors)


class GemmPlan(NamedTuple):
    tile: int     # output tile edge: 128 (8 warps) or 64 (4 warps)
    splits: int   # contiguous ranges of the reduction's steps


def gemm_plan(rows: int, cols: int, red: int, pieces: int = 1,
              batch: int = 1) -> GemmPlan:
    """Tile and split of one product C (rows, cols) over ``pieces`` x
    ceil(red / 64) steps (``batch`` such products in one launch: their
    tiles count together). 128 x 128 tiles (two blocks an SM) unsplit
    where there are >= 96 of them; else 128 x 128 tiles split up to ~2
    blocks an SM where that gives >= 128 blocks; else 64 x 64 tiles split
    up to ~1 block an SM. Each range keeps >= MIN_SPLIT_STEPS steps. The
    thresholds reproduce the fastest choice of a sweep of tile shapes,
    depths and splits over the main path's products on an H100 (a split
    costs a pass over splits x rows x cols partials, and a grid past a
    whole wave of blocks costs a second wave). Range s covers steps [s T /
    splits, (s + 1) T / splits) of T (the kernel's rule)."""
    steps = pieces * _cdiv(red, STEP)
    most = max(1, steps // MIN_SPLIT_STEPS)
    tiles = batch * _cdiv(rows, 128) * _cdiv(cols, 128)
    if tiles >= 96:
        return GemmPlan(128, 1)
    splits = max(1, min(TARGET_CTAS // tiles, most))
    if tiles * splits >= 128:
        return GemmPlan(128, splits)
    tiles = batch * _cdiv(rows, 64) * _cdiv(cols, 64)
    return GemmPlan(64, max(1, min(SMS // tiles, most)))


def _workspace(*products) -> int:
    """f32 values the split partials of (plan, rows, cols) products need;
    the products run in order on one stream and share it."""
    return max((p.splits * r * c for p, r, c in products if p.splits > 1),
               default=0)


class SketchPlan(NamedTuple):
    h: GemmPlan   # h (M, K) = x R^T over I
    y: GemmPlan   # y (M, O) = sum_p h_p L^T over PIECES_BF16_OUT x K
    ws: int       # f32 workspace


@functools.lru_cache(maxsize=256)
def sketch_plan(m: int, i: int, k: int, o: int) -> SketchPlan:
    h, y = gemm_plan(m, k, i), gemm_plan(m, o, k, PIECES_BF16_OUT)
    return SketchPlan(h, y, _workspace((h, m, k), (y, m, o)))


class BwdPlan(NamedTuple):
    dh: GemmPlan  # dh (M, K) = dy L over O, one piece
    dx: GemmPlan  # dx (M, I) = sum_p dh_p R, PIECES_BF16_OUT pieces
    dl: GemmPlan  # dL (O, K) = sum_p dy^T h_p over M, PIECES_F32_OUT
    dr: GemmPlan  # dR (K, I) = sum_p dh_p^T x over M, PIECES_F32_OUT
    ws: int       # f32 workspace


@functools.lru_cache(maxsize=256)
def bwd_plan(m: int, i: int, k: int, o: int) -> BwdPlan:
    p = {"dh": (gemm_plan(m, k, o), m, k),
         "dx": (gemm_plan(m, i, k, PIECES_BF16_OUT), m, i),
         "dl": (gemm_plan(o, k, m, PIECES_F32_OUT), o, k),
         "dr": (gemm_plan(k, i, m, PIECES_F32_OUT), k, i)}
    return BwdPlan(ws=_workspace(*p.values()),
                   **{n: v[0] for n, v in p.items()})


def _sketch_lib() -> ctypes.CDLL:
    lib = _build.library("lowrank_sketch.cu")
    if lib.lowrank_sketch_bf16.argtypes is None:
        lib.lowrank_sketch_bf16.restype = ctypes.c_int
        lib.lowrank_sketch_bf16.argtypes = [ctypes.c_void_p] * 7 \
            + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    return lib


def _sketch_bf16(x, r_factor, l_factor, y, h) -> None:
    """Launch #2's bf16 route into y and h (None: h is not stored, as in
    #1's tensor-core route); the pieces of h and the split workspace are
    scratch of this call."""
    m, i = x.shape
    k, o = r_factor.shape[0], l_factor.shape[0]
    plan = sketch_plan(m, i, k, o)
    hp = torch.empty((PIECES_BF16_OUT, m, k), dtype=torch.bfloat16,
                     device=x.device)
    ws = torch.empty((max(plan.ws, 1),), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _sketch_lib().lowrank_sketch_bf16(
            x.data_ptr(), r_factor.data_ptr(), l_factor.data_ptr(),
            y.data_ptr(), None if h is None else h.data_ptr(),
            hp.data_ptr(), ws.data_ptr(), m, i,
            k, o, PIECES_BF16_OUT, *plan.h, *plan.y, stream)
    if err != 0:
        raise RuntimeError(f"lowrank_sketch_bf16 launch failed: CUDA error "
                           f"{err} (M={m} I={i} K={k} O={o} {plan})")


def _bwd_bf16(dy, x, h, l_factor, r_factor, dx, dl, dr) -> None:
    """Launch #3's bf16 route into dx, dL and dR; the pieces of dh and h
    and the split workspace are scratch of this call."""
    m, o = dy.shape
    i, k = x.shape[1], h.shape[1]
    plan = bwd_plan(m, i, k, o)
    dev = x.device
    dhp = torch.empty((PIECES_F32_OUT, m, k), dtype=torch.bfloat16,
                      device=dev)
    hp = torch.empty((PIECES_F32_OUT, m, k), dtype=torch.bfloat16,
                     device=dev)
    ws = torch.empty((max(plan.ws, 1),), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _bwd_lib().lowrank_bwd_bf16(
            dy.data_ptr(), x.data_ptr(), h.data_ptr(), l_factor.data_ptr(),
            r_factor.data_ptr(), dx.data_ptr(), dl.data_ptr(), dr.data_ptr(),
            dhp.data_ptr(), hp.data_ptr(), ws.data_ptr(), m, i, k, o,
            *plan.dh, *plan.dx, PIECES_BF16_OUT, *plan.dl, PIECES_F32_OUT,
            *plan.dr, PIECES_F32_OUT, stream)
    if err != 0:
        raise RuntimeError(f"lowrank_bwd_bf16 launch failed: CUDA error "
                           f"{err} (M={m} I={i} K={k} O={o} {plan})")


# ---------------------------------------------------------------------------
# Routes of the serving forward (#1 without the sketch): csrc/lowrank_decode.cu
# for a decode step's few rows, the tensor-core products of
# csrc/lowrank_sketch.cu for larger bf16 M, csrc/lowrank_fwd.cu otherwise
# ---------------------------------------------------------------------------

#: the decode route takes M up to this many rows: the largest M of a sweep
#: (M = 1, 4, 8, 12, 16, 24, 32) at which it beat the tensor-core route at
#: every site shape of qwen2-0.5b and zamba2-7b on an H100 (``chip_smoke.py``
#: phase 3, "route sweep"; at 12 and 16 zamba2's mlp/down, whose x R^T
#: reads 25.7 MB of R, went to the tensor cores by 5%)
DECODE_MAX_M = 8
DECODE_SLICE = 32     # reduction depth of a warp's lane loads: 4 lanes x 8
                      # bf16 or f32 values (csrc: 4 lane_values<W>())
DECODE_WARPS = 8      # warps of a block (csrc: WARPS)
DECODE_MAX_CLUSTER = 8
#: static shared memory of a decode launch per n8 tile (csrc: STATIC_SMEM)
DECODE_STATIC_SMEM = 8192


def n8_tiles(m: int) -> int:
    """mma n8 tiles the decode route covers M rows with (1, 2 or 4)."""
    return 1 if m <= 8 else 2 if m <= 16 else 4


def decode_smem_bytes(nt: int, k: int, slice_: int = DECODE_SLICE) -> int:
    """Mirror of ``lowrank_decode_smem_bytes`` (and, with ``slice_`` 64, of
    ``lowrank_q8_decode_smem_bytes``): three bf16 pieces of h, 8 nt rows of
    ``staged_stride(K)``, whose pad is 32 for 32-deep slices and 8 for the
    64-deep slices of int8 weights."""
    return 3 * 8 * nt * (_cdiv(k, 64) * 64 + (32 if slice_ == 32 else 8)) * 2


def forward_route(m: int, i: int, k: int, o: int, dtype: torch.dtype,
                  tensors) -> str:
    """The kernel a serving call of #1 (no sketch) takes: ``"decode"``
    (``lowrank_decode.cu``) for M <= DECODE_MAX_M rows of either dtype
    whose widths and bases ``aligned`` admits (and whose staged h fits in
    shared memory); else ``"tensor_core"`` (``lowrank_sketch.cu`` without
    h) where ``tensor_core_route`` admits bf16 inputs; else ``"fused"``
    (``lowrank_fwd.cu`` through ``launch_config``)."""
    nt = n8_tiles(m)
    if m <= DECODE_MAX_M and aligned((i, k, o), tensors) and \
            decode_smem_bytes(nt, k) + DECODE_STATIC_SMEM * nt <= SMEM_LIMIT:
        return "decode"
    if tensor_core_route(dtype, (i, k, o), tensors):
        return "tensor_core"
    return "fused"


class DecodePlan(NamedTuple):
    nt: int        # mma n8 tiles covering M (8 nt >= M)
    wk_h: int      # warps along I in a block of h = x R^T
    cluster: int   # blocks of a cluster along I, summed in rank order
    wk_y: int      # warps along K in a block of y = h L^T


def _warps_along(rows: int) -> int:
    """Warps a block puts along the reduction (the rest take 16-row tiles
    of the weight): the fewest that still give >= SMS blocks, so that
    blocks share their staged operand among as many rows as they can; 8
    (one row tile a block) where none does."""
    tiles = _cdiv(rows, 16)
    for wk in (1, 2, 4):
        if _cdiv(tiles, DECODE_WARPS // wk) >= SMS:
            return wk
    return DECODE_WARPS


@functools.lru_cache(maxsize=256)
def decode_plan(m: int, i: int, k: int, o: int,
                slice_: int = DECODE_SLICE) -> DecodePlan:
    """The decode route's grid. h = x R^T: where K's row tiles give fewer
    than SMS blocks, I is also cut over a cluster of up to 8 blocks, as
    many as bring the grid to one block an SM, each warp keeping >= 2
    slices (``slice_`` deep: 32 for bf16 and f32 weights, 64 for int8).
    y = h L^T: O's row tiles alone."""
    wk_h = _warps_along(k)
    blocks = _cdiv(_cdiv(k, 16), DECODE_WARPS // wk_h)
    cluster = 1
    if blocks < SMS:
        cluster = max(1, min(DECODE_MAX_CLUSTER, _cdiv(SMS, blocks),
                             _cdiv(i, slice_) // (2 * wk_h)))
    return DecodePlan(n8_tiles(m), wk_h, cluster, _warps_along(o))


def _decode_lib() -> ctypes.CDLL:
    lib = _build.library("lowrank_decode.cu")
    if lib.lowrank_decode.argtypes is None:
        lib.lowrank_decode.restype = ctypes.c_int
        lib.lowrank_decode.argtypes = [ctypes.c_void_p] * 5 \
            + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        lib.lowrank_decode_smem_bytes.restype = ctypes.c_int
        lib.lowrank_decode_smem_bytes.argtypes = [ctypes.c_int] * 2
    return lib


def _decode(x, r_factor, l_factor, y) -> None:
    """Launch the decode route into y, L read where it lies (rows
    ``l_factor.stride(0)`` apart); h (M, K) f32 is scratch of this
    call."""
    m, i = x.shape
    k, o = r_factor.shape[0], l_factor.shape[0]
    plan = decode_plan(m, i, k, o)
    h = torch.empty((m, k), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _decode_lib().lowrank_decode(
            x.data_ptr(), r_factor.data_ptr(), l_factor.data_ptr(),
            y.data_ptr(), h.data_ptr(), m, i, k, o, l_factor.stride(0),
            _DTYPES[x.dtype], *plan, stream)
    if err != 0:
        raise RuntimeError(f"lowrank_decode launch failed: CUDA error {err} "
                           f"(M={m} I={i} K={k} O={o} {plan})")
