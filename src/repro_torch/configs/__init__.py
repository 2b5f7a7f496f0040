"""Architecture config registry. ``get(name)`` resolves ``--arch <id>``.

Every architecture of the JAX package, in its order
(``repro.configs.ARCHS``)."""
from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig

ARCHS = (
    "zamba2-7b",
    "whisper-tiny",
    "gemma3-4b",
    "qwen2-0.5b",
    "granite-3-8b",
    "stablelm-3b",
    "internvl2-26b",
    "falcon-mamba-7b",
    "deepseek-moe-16b",
    "mixtral-8x7b",
    # the paper's own models
    "tinyllama-1.1b",
    "vit-base",
)


def _module(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
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
