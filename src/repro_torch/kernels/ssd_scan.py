"""Wrapper of the Mamba-2 SSD chunked-scan kernel ``csrc/ssd_scan.cu``. It
replaces ``repro/kernels/ssd_scan.py::_ssd_kernel``.

u (Bz, S, H, dh), dt (Bz, S, H), A (H,), B and C (Bz, S, N) go in as f32
(converted and made contiguous here if they are not); y (Bz, S, H, dh)
without the D.u skip term and the final state (Bz, H, dh, N) come out as
new contiguous f32 tensors. One CTA per (batch, head) walks the chunks in
order and keeps the state on chip; a ragged last chunk is masked inside
the kernel, so nothing is padded. CUDA tensors only: ``ssd_scan_cuda``
launches the kernel or raises, it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lowrank import LAUNCHES, SMEM_LIMIT

MAX_DIM = 64          # largest dh and N (csrc: T)
_MAX_GRID_Y = 65535   # gridDim.y (batch)


def smem_bytes(chunk: int) -> int:
    """Mirror of ``ssd_scan_smem_bytes`` in the CUDA source."""
    t, tp = MAX_DIM, MAX_DIM + 4
    return 4 * (t * t + 4 * t * tp + 2 * chunk)


def _lib() -> ctypes.CDLL:
    lib = _build.library("ssd_scan.cu")
    if lib.ssd_scan.argtypes is None:
        lib.ssd_scan.restype = ctypes.c_int
        lib.ssd_scan.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        lib.ssd_scan_smem_bytes.restype = ctypes.c_int
        lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int]
    return lib


def check_operands(u, dt, A, B, C, chunk: int) -> None:
    """What the kernel takes: CUDA tensors on one device, u (Bz, S, H, dh),
    dt (Bz, S, H), A (H,), B and C (Bz, S, N), dh and N up to 64, a
    chunk whose shared memory fits, Bz within the grid's limit."""
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
    if chunk < 1 or smem_bytes(chunk) > SMEM_LIMIT:
        raise ValueError(f"{op}: chunk {chunk} needs {smem_bytes(chunk)} B "
                         f"of shared memory (limit {SMEM_LIMIT})")
    if bz > _MAX_GRID_Y:
        raise ValueError(f"{op}: batch {bz} above {_MAX_GRID_Y}")


def ssd_scan_cuda(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, chunk: int):
    """(y (Bz, S, H, dh), final state (Bz, H, dh, N)), f32, without D.u;
    one launch on the current stream."""
    check_operands(u, dt, A, B, C, chunk)
    u, dt, A, B, C = (t.float().contiguous() for t in (u, dt, A, B, C))
    bz, s, h, dh = u.shape
    n = B.shape[-1]
    y = torch.empty((bz, s, h, dh), dtype=torch.float32, device=u.device)
    state = torch.zeros((bz, h, dh, n), dtype=torch.float32, device=u.device)
    if bz == 0 or s == 0 or h == 0:
        return y, state
    q = min(chunk, s)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = _lib().ssd_scan(u.data_ptr(), dt.data_ptr(), A.data_ptr(),
                              B.data_ptr(), C.data_ptr(), y.data_ptr(),
                              state.data_ptr(), bz, s, h, dh, n, q, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err} "
                           f"(Bz={bz} S={s} H={h} dh={dh} N={n} chunk={q})")
    LAUNCHES["ssd_scan"] += 1
    return y, state
