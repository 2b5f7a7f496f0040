"""Wrapper of the Mamba-2 SSD chunked-scan kernels. They replace
``repro/kernels/ssd_scan.py::_ssd_kernel``.

u (Bz, S, H, dh), dt (Bz, S, H), A (H,), B and C (Bz, S, N) go in; y (Bz,
S, H, dh) without the D.u skip term and the final state (Bz, H, dh, N)
come out as new contiguous f32 tensors. A ragged last chunk is masked
inside the kernels, so nothing is padded. Two routes, chosen by
``ssd_route`` from dtypes, dims, strides and alignment:

* ``tensor_core`` (``csrc/ssd_scan_tc.cu``): bf16 u, B and C, read as
  stored (B and C may be row views of one (Bz, S, 2 N) tensor), dh and N
  multiples of 16. Chunk-parallel, three launches from one call: C B^T
  once per (batch, chunk) beside each head's chunk-local state, the state
  pass over the chunks (only with more than one), and the outputs per
  64-row query tile; products on the bf16 tensor cores, each f32 operand
  as ``PIECES`` bf16 pieces. dt and A stay f32.
* ``fma`` (``csrc/ssd_scan.cu``): everything else, on f32 contiguous
  copies: one CTA per (batch, head) walks the chunks in order on the f32
  CUDA cores.

CUDA tensors only: ``ssd_scan_cuda`` launches a route or raises, it never
falls back. Each call counts one ``ssd_scan``, whatever it launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lowrank import LAUNCHES, SMEM_LIMIT, _cdiv, aligned

MAX_DIM = 64          # largest dh and N (csrc: T)
_MAX_GRID_YZ = 65535  # gridDim.y and gridDim.z
#: bf16 pieces of each f32 operand of the tensor-core route (G, w_j u_j,
#: S_prev; csrc/ssd_scan_tc.cu: P): they sum to it within 2^-17 of its
#: magnitude; one piece misses ``ssd_tol`` (tests/test_torch_ssd_routes.py)
PIECES = 2
TILE = 64             # query and key tile rows of the tensor-core route
STAGES = 2            # its cp.async ring of key tiles (csrc: STAGES)
_TILE_BYTES = TILE * (TILE + 8) * 2


def smem_bytes(chunk: int) -> int:
    """Mirror of ``ssd_scan_smem_bytes`` (the fma route's kernel)."""
    t, tp = MAX_DIM, MAX_DIM + 4
    return 4 * (t * t + 4 * t * tp + 2 * chunk)


def tc_smem_bytes(kernel: str, chunk: int) -> int:
    """Mirror of ``ssd_scan_tc_smem_bytes``: cum and dt (or the weights)
    over the chunk padded to 64 steps, in f32, then bf16 tiles of 64 rows
    of 72: ``chunk`` (C B^T and the chunk-local states) a ring of STAGES
    (u, B) tiles; ``out`` a ring of STAGES u tiles, C's query tile and
    PIECES tiles of S_prev."""
    qp = _cdiv(chunk, TILE) * TILE
    tiles = {"chunk": 2 * STAGES, "out": STAGES + 1 + PIECES}[kernel]
    return 8 * qp + tiles * _TILE_BYTES


def _rows_aligned(t: torch.Tensor) -> bool:
    """Unit stride along the last dim, and every row where a 16-byte copy
    reads it: the strides of the other dims (those longer than 1) in
    multiples of 8 bf16 and the base on 16 bytes (``lowrank.aligned``)."""
    strides = [st for n, st in zip(t.shape[:-1], t.stride()[:-1]) if n > 1]
    return (t.stride(-1) == 1 or t.shape[-1] == 1) and aligned(strides, [t])


def ssd_route(u: torch.Tensor, B: torch.Tensor, C: torch.Tensor) -> str:
    """``"tensor_core"`` where u, B and C are bf16, dh and N multiples of
    16 (the mma tiles' depth; both are also at most 64) and every row
    lies where 16-byte copies read it (``_rows_aligned``); else ``"fma"``.
    dt and A take any float dtype (they go in as f32)."""
    dh, n = u.shape[-1], B.shape[-1]
    if not all(t.dtype == torch.bfloat16 for t in (u, B, C)):
        return "fma"
    if dh % 16 or n % 16 or dh > MAX_DIM or n > MAX_DIM:
        return "fma"
    return "tensor_core" if all(map(_rows_aligned, (u, B, C))) else "fma"


def _lib() -> ctypes.CDLL:
    lib = _build.library("ssd_scan.cu")
    if lib.ssd_scan.argtypes is None:
        lib.ssd_scan.restype = ctypes.c_int
        lib.ssd_scan.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        lib.ssd_scan_smem_bytes.restype = ctypes.c_int
        lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int]
    return lib


def _tc_lib() -> ctypes.CDLL:
    lib = _build.library("ssd_scan_tc.cu")
    if lib.ssd_scan_tc.argtypes is None:
        lib.ssd_scan_tc.restype = ctypes.c_int
        lib.ssd_scan_tc.argtypes = [ctypes.c_void_p] * 11 \
            + [ctypes.c_longlong] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.ssd_scan_tc_smem_bytes.restype = ctypes.c_int
        lib.ssd_scan_tc_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.ssd_scan_tc_pieces.restype = ctypes.c_int
        lib.ssd_scan_tc_pieces.argtypes = []
    return lib


def check_operands(u, dt, A, B, C, chunk: int) -> str:
    """What the kernels take: CUDA tensors on one device, u (Bz, S, H,
    dh), dt (Bz, S, H), A (H,), B and C (Bz, S, N), dh and N up to 64, a
    chunk whose shared memory fits the route's kernels, grids within
    their limits. Returns the route (``ssd_route``)."""
    op = "ssd_scan"
    names = (("u", u, 4), ("dt", dt, 3), ("A", A, 1), ("B", B, 3),
             ("C", C, 3))
    for name, t, nd in names:
        if t.device.type != "cuda":
            raise ValueError(f"{op}: {name} is on {t.device}, the kernel "
                             "takes CUDA tensors only")
        if t.device != u.device:
            raise ValueError(f"{op}: u and {name} on different devices")
        if t.dim() != nd:
            raise ValueError(f"{op}: {name} must be {nd}-D, got "
                             f"{tuple(t.shape)}")
        if not t.is_floating_point():
            raise ValueError(f"{op}: {name} is {t.dtype}, not floating")
    bz, s, h, dh = u.shape
    n = B.shape[-1]
    if (tuple(dt.shape) != (bz, s, h) or tuple(A.shape) != (h,)
            or tuple(B.shape) != (bz, s, n) or tuple(C.shape) != (bz, s, n)):
        raise ValueError(f"{op}: shapes u {tuple(u.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)} do not "
                         "match")
    if not (0 < dh <= MAX_DIM and 0 < n <= MAX_DIM):
        raise ValueError(f"{op}: head dim {dh} and state dim {n} must be "
                         f"in 1..{MAX_DIM}")
    route = ssd_route(u, B, C)
    if route == "fma":
        need = smem_bytes(chunk) if chunk >= 1 else 0
        if bz > _MAX_GRID_YZ:
            raise ValueError(f"{op}: batch {bz} above {_MAX_GRID_YZ}")
    else:
        q = min(chunk, s)
        need = max(tc_smem_bytes(k, q) for k in ("chunk", "out")) \
            if q >= 1 else 0
        if bz * _cdiv(s, max(q, 1)) > _MAX_GRID_YZ:
            raise ValueError(f"{op}: batch {bz} x chunks above "
                             f"{_MAX_GRID_YZ}")
    if chunk < 1 or need > SMEM_LIMIT:
        raise ValueError(f"{op}: chunk {chunk} needs {need} B of shared "
                         f"memory (limit {SMEM_LIMIT})")
    return route


def _fma(u, dt, A, B, C, q, y, state, stream) -> int:
    bz, s, h, dh = u.shape
    return _lib().ssd_scan(u.data_ptr(), dt.data_ptr(), A.data_ptr(),
                           B.data_ptr(), C.data_ptr(), y.data_ptr(),
                           state.data_ptr(), bz, s, h, dh, B.shape[-1], q,
                           stream)


def _tensor_core(u, dt, A, B, C, q, y, state, stream) -> int:
    """One workspace of f32: C B^T (Bz, chunks, QP, QP), cum and dt (Bz,
    chunks, H, 2, QP), and with more than one chunk S_c (Bz, chunks, H,
    dh, N) and S_prev's bf16 pieces (Bz, chunks, H, PIECES, dh, N)."""
    bz, s, h, dh = u.shape
    n = B.shape[-1]
    nc, qp = _cdiv(s, q), _cdiv(q, TILE) * TILE
    sizes = [bz * nc * qp * qp, bz * nc * h * 2 * qp]
    if nc > 1:
        sizes += [bz * nc * h * dh * n, bz * nc * h * PIECES * dh * n // 2]
    ws = torch.empty(sum(sizes), dtype=torch.float32, device=u.device)
    ptrs, off = [], 0
    for size in sizes:
        ptrs.append(ws.data_ptr() + 4 * off)
        off += size
    cb, cw = ptrs[:2]
    sc, sp = ptrs[2:] if nc > 1 else (None, None)
    return _tc_lib().ssd_scan_tc(
        u.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), state.data_ptr(), cb, cw, sc, sp,
        *u.stride()[:3], *B.stride()[:2], *C.stride()[:2], bz, s, h, dh, n,
        q, stream)


def ssd_scan_cuda(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, chunk: int):
    """(y (Bz, S, H, dh), final state (Bz, H, dh, N)), f32, without D.u;
    the route's launches on the current stream."""
    route = check_operands(u, dt, A, B, C, chunk)
    if route == "fma":
        u, B, C = (t.float().contiguous() for t in (u, B, C))
    dt, A = dt.float().contiguous(), A.float().contiguous()
    bz, s, h, dh = u.shape
    n = B.shape[-1]
    y = torch.empty((bz, s, h, dh), dtype=torch.float32, device=u.device)
    if bz == 0 or s == 0 or h == 0:
        return y, torch.zeros((bz, h, dh, n), dtype=torch.float32,
                              device=u.device)
    state = torch.empty((bz, h, dh, n), dtype=torch.float32, device=u.device)
    q = min(chunk, s)
    launch = _fma if route == "fma" else _tensor_core
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = launch(u, dt, A, B, C, q, y, state, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan ({route}) launch failed: CUDA error "
                           f"{err} (Bz={bz} S={s} H={h} dh={dh} N={n} "
                           f"chunk={q})")
    LAUNCHES["ssd_scan"] += 1
    return y, state
