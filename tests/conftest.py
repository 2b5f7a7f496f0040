# NOTE: do NOT set --xla_force_host_platform_device_count here — smoke
# tests and benches must see 1 device; only launch/dryrun.py forces 512.
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# When `hypothesis` isn't installed, register the stub under its name so a
# plain `from hypothesis import given, ...` works in every test file and
# property tests skip instead of killing collection (the seed-state failure
# mode). New property-test files need no boilerplate.
try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    sys.path.insert(0, os.path.dirname(__file__))
    import _hypothesis_stub

    sys.modules["hypothesis"] = _hypothesis_stub


# Every compiled XLA executable pins several memory maps (LLVM JIT code
# pages), and a process is capped at vm.max_map_count (~65k) of them. The
# full suite compiles enough executables that the count brushes the cap,
# at which point a failed mmap inside LLVM surfaces as a SEGFAULT in
# backend_compile — in whatever unlucky test compiles next. Dropping dead
# executables at module boundaries keeps the count flat; modules compile
# their own executables anyway, so cross-module recompiles are noise
# against the suite's wall clock.
import gc

import pytest


@pytest.fixture(autouse=True, scope="module")
def _reclaim_jit_memory_maps():
    yield
    import jax

    jax.clear_caches()
    gc.collect()


# -- simulated multi-device tests -------------------------------------------
# `@pytest.mark.multidevice` tests need the forced host-device env (set
# BEFORE jax initializes, so it cannot come from this conftest):
#   XLA_FLAGS=--xla_force_host_platform_device_count=8 pytest tests/test_mesh_parity.py
# Tier-1 runs without the flag and skips them; the CI multidevice job sets
# it and runs only this subset (.github/workflows/ci.yml).

def _multidevice_env() -> bool:
    return ("xla_force_host_platform_device_count"
            in os.environ.get("XLA_FLAGS", ""))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "multidevice: needs XLA_FLAGS=--xla_force_host_platform_device_count"
        "=N set before jax init; skipped when absent")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the port's CUDA kernels); the test's "
        "fixture skips it when torch finds no CUDA device")


def pytest_collection_modifyitems(config, items):
    if _multidevice_env():
        return
    skip = pytest.mark.skip(
        reason="multidevice: set XLA_FLAGS="
               "--xla_force_host_platform_device_count=8")
    for item in items:
        if "multidevice" in item.keywords:
            item.add_marker(skip)
