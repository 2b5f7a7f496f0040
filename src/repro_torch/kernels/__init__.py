"""Hand-written Hopper kernels and their plain PyTorch versions.

The reference's kernel triple carries over: the kernel (CUDA C++ under
``csrc/`` with its ctypes wrapper), ``ops.py`` (dispatch plus launch
counters) and ``ref.py`` (the plain f32 version). Nothing here builds or
imports a compiler at import time: ``_build.py`` runs ``nvcc`` on first use.
"""
