"""Per-kind transformer block init/apply. Port of ``repro.models.blocks``
for the ``dense`` kind (attention + MLP, pre-norm residuals); the other
kinds arrive with their model families and raise until then.

    init_block(kind, cfg, ...)              -> params (nn.ModuleDict)
    init_block_state(kind, cfg, B, S, ...)  -> ASI warm-start states
    init_block_cache(kind, cfg, B, S, ...)  -> decode cache
    apply_block(kind, params, x, cfg, ...)  -> (x, cache, states, aux)
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.nn.attention import (
    apply_attention,
    init_attention,
    init_attention_state,
    init_cache,
)
from repro_torch.nn.mlp import apply_mlp, init_mlp, init_mlp_state
from repro_torch.nn.norms import apply_norm, init_norm

PORTED_KINDS = ("dense",)


def _check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ported: "
            f"{PORTED_KINDS}; ROADMAP.md queue 1)")


def block_window(kind: str, cfg: ModelConfig) -> int:
    return cfg.window if kind in ("local", "moe_swa") else 0


def init_block(kind: str, cfg: ModelConfig, *, generator: torch.Generator,
               lead: tuple[int, ...] = (), dtype=torch.float32,
               device=None) -> nn.ModuleDict:
    _check_kind(kind)
    d = cfg.d_model
    kw = dict(lead=lead, dtype=dtype, device=device)
    return nn.ModuleDict({
        "ln1": init_norm(cfg.norm, d, **kw),
        "attn": init_attention(cfg, generator=generator, **kw),
        "ln2": init_norm(cfg.norm, d, **kw),
        "mlp": init_mlp(cfg, generator=generator, **kw),
    })


def init_block_state(kind: str, cfg: ModelConfig, batch: int, seq: int, *,
                     generator: torch.Generator, dtype=torch.float32,
                     device=None) -> dict:
    """ASI warm-start states of one layer: {"attn": ..., "mlp": ...}."""
    _check_kind(kind)
    kw = dict(generator=generator, dtype=dtype, device=device)
    return {"attn": init_attention_state(cfg, batch, seq, **kw),
            "mlp": init_mlp_state(cfg, batch, seq, **kw)}


def init_block_cache(kind: str, cfg: ModelConfig, batch: int, seq: int, *,
                     lead: tuple[int, ...] = (), dtype=torch.bfloat16,
                     device=None) -> dict:
    _check_kind(kind)
    return {"kv": init_cache(cfg, batch, seq, window=block_window(kind, cfg),
                             lead=lead, dtype=dtype, device=device)}


def apply_block(kind: str, p, x: torch.Tensor, cfg: ModelConfig, *,
                cache: dict | None = None, pos=None, states=None,
                valid_len=None):
    """Returns (x, new_cache, new_states, aux_loss). With a cache and S > 1
    this is a token-parallel PREFILL step; ``valid_len`` (B,) masks
    right-padded rows out of the cache writes."""
    _check_kind(kind)
    st = states or {}
    h = apply_norm(cfg.norm, p["ln1"], x)
    a, new_kv, s_attn = apply_attention(
        p["attn"], h, cfg, causal=True, window=block_window(kind, cfg),
        cache=None if cache is None else cache["kv"], pos=pos,
        states=st.get("attn"), valid_len=valid_len)
    x = x + a
    h = apply_norm(cfg.norm, p["ln2"], x)
    f, s_mlp = apply_mlp(p["mlp"], h, cfg, st.get("mlp"))
    x = x + f
    new_cache = None if cache is None else {"kv": new_kv}
    return x, new_cache, {"attn": s_attn, "mlp": s_mlp}, 0.0
