"""repro_torch — the PyTorch/CUDA port of the WASI reproduction.

Mirrors ``src/repro`` (the JAX/Pallas reference) module for module. It
imports ``torch``, ``numpy`` and the standard library only; the reference
is touched by the tests alone, which hold each ported module against its
JAX counterpart. Entry points run on a CUDA device unless the caller asks
for the CPU, and every factored linear on a CUDA tensor goes through the
hand-written Hopper kernel in ``kernels/csrc``.
"""

__version__ = "0.1.0"
