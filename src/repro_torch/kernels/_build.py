"""Build of the CUDA kernels: ``nvcc`` on first use, into a git-ignored
directory of the checkout, one shared library with a plain C interface per
source, loaded with ``ctypes``.

Each library's file name carries a hash of its source, the shared headers
of ``csrc/`` and the flags, so an edited source or header is rebuilt and a
stale library is never loaded. A build
writes a temporary file and renames it into place, so processes that build
at the same time never load a half-written library. ``build_all`` starts
one ``nvcc`` per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("lowrank_fwd.cu", "lowrank_decode.cu", "lowrank_sketch.cu",
           "lowrank_q8_routes.cu", "choleskyqr_blocked.cu",
           "lowrank_bwd.cu", "gram.cu", "choleskyqr.cu", "lowrank_q8.cu",
           "matmul_tiled.cu", "flash_attn.cu", "ssd_scan.cu",
           "ssd_scan_tc.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: dict[str, float] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels build only where the CUDA "
                           "toolkit is installed")
    return path


def _target(source: str) -> Path:
    text = (CSRC / source).read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        text += header.read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:12]}.so"


def _compile(source: str) -> Path:
    out = _target(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp,
                               str(CSRC / source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_SECONDS[source] = time.perf_counter() - t0
    return out


def build_all() -> dict[str, Path]:
    """Compile every source that has no current library, in parallel."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        paths = list(pool.map(_compile, SOURCES))
    return dict(zip(SOURCES, paths))


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(_compile(source)))
            _LIBS[source] = lib
        return lib
