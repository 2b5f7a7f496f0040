"""Architecture config registry. ``get(name)`` resolves ``--arch <id>``.

Only the architectures the port can run are listed; the others of the JAX
package (``repro.configs.ARCHS``) arrive with their model families, in the
order ROADMAP.md gives."""
from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig

ARCHS = (
    "qwen2-0.5b",
    # the paper's own model
    "vit-base",
    # hybrid: Mamba-2 blocks with a shared attention block
    "zamba2-7b",
)


def _module(name: str):
    if name not in ARCHS:
        raise KeyError(f"arch {name!r} is not ported yet (ported: {ARCHS}); "
                       "ROADMAP.md queue 1 lists when it comes")
    return importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))


def get(name: str) -> ModelConfig:
    """Full (assigned) config."""
    return _module(name).config()


def get_smoke(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return _module(name).smoke_config()


def list_archs() -> tuple[str, ...]:
    return ARCHS
