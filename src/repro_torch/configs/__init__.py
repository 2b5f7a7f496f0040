"""Architecture config registry. ``get(name)`` resolves ``--arch <id>``.

Only the architectures the port can run are listed, in the JAX package's
order (``repro.configs.ARCHS``); the one other, whisper-tiny, arrives with
the encoder-decoder family (ROADMAP.md queue 1)."""
from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig

ARCHS = (
    "zamba2-7b",
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
