"""Per-kind transformer block init/apply. Port of ``repro.models.blocks``
for the ``dense`` kind (attention + MLP, pre-norm residuals), ``local``
(the same block with sliding-window attention over ``cfg.window`` keys and
a rolling KV cache of ``cfg.window`` slots; gemma3's local layers) and the
Mamba kinds: ``mamba1`` (pre-norm Mamba-1 mixer; falcon-mamba),
``mamba2`` (pre-norm Mamba-2 mixer) and zamba2's ``mamba2_attn`` (the
mixer, then the SHARED attention + MLP block, whose weights are passed in
as ``shared``: one copy for the whole net, while each occurrence keeps
its own KV cache). The other kinds arrive with their
model families and raise until then.

    init_block(kind, cfg, ...)              -> params (nn.ModuleDict)
    init_block_state(kind, cfg, B, S, ...)  -> ASI warm-start states
    init_block_cache(kind, cfg, B, S, ...)  -> decode cache (a paged
                                               pool for ``dense``)
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
    init_paged_cache,
)
from repro_torch.nn.mamba import (
    apply_mamba1,
    apply_mamba2,
    init_mamba1,
    init_mamba1_cache,
    init_mamba1_state,
    init_mamba2,
    init_mamba2_cache,
    init_mamba2_state,
)
from repro_torch.nn.mlp import apply_mlp, init_mlp, init_mlp_state
from repro_torch.nn.norms import apply_norm, init_norm

PORTED_KINDS = ("dense", "local", "mamba1", "mamba2", "mamba2_attn")
MAMBA_KINDS = ("mamba1", "mamba2", "mamba2_attn")


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
    if kind in MAMBA_KINDS:
        init = init_mamba1 if kind == "mamba1" else init_mamba2
        return nn.ModuleDict({
            "ln": init_norm(cfg.norm, d, **kw),
            "mixer": init(cfg, generator=generator, **kw)})
    return nn.ModuleDict({
        "ln1": init_norm(cfg.norm, d, **kw),
        "attn": init_attention(cfg, generator=generator, **kw),
        "ln2": init_norm(cfg.norm, d, **kw),
        "mlp": init_mlp(cfg, generator=generator, **kw),
    })


def init_block_state(kind: str, cfg: ModelConfig, batch: int, seq: int, *,
                     generator: torch.Generator, dtype=torch.float32,
                     device=None) -> dict:
    """ASI warm-start states of one layer: {"attn": ..., "mlp": ...}, or
    {"mixer": ...} for a Mamba layer; the shared attention of
    ``mamba2_attn`` runs without ASI (its weights are shared across
    layers), so its entry is {}."""
    _check_kind(kind)
    kw = dict(generator=generator, dtype=dtype, device=device)
    if kind == "mamba1":
        return {"mixer": init_mamba1_state(cfg, batch, seq, **kw)}
    if kind == "mamba2":
        return {"mixer": init_mamba2_state(cfg, batch, seq, **kw)}
    if kind == "mamba2_attn":
        return {"mixer": init_mamba2_state(cfg, batch, seq, **kw),
                "shared_attn": {}}
    return {"attn": init_attention_state(cfg, batch, seq, **kw),
            "mlp": init_mlp_state(cfg, batch, seq, **kw)}


def init_block_cache(kind: str, cfg: ModelConfig, batch: int, seq: int, *,
                     lead: tuple[int, ...] = (), dtype=torch.bfloat16,
                     device=None, pages: int | None = None,
                     page_size: int | None = None) -> dict:
    """{"kv": KVCache} of an attention layer, {"ssm": MambaState} of a
    Mamba layer, both for ``mamba2_attn`` (its shared attention sees the
    full sequence). With ``pages`` and ``page_size`` an attention layer's
    cache is a paged pool, {"kv": PagedKVCache}: only the ``dense`` kind
    (causal full attention) can hold one, every other kind raises."""
    _check_kind(kind)
    kw = dict(lead=lead, dtype=dtype, device=device)
    if pages is not None:
        if kind != "dense":
            raise ValueError(f"block kind {kind!r} cannot use a paged KV "
                             "cache (causal full attention only)")
        return {"kv": init_paged_cache(cfg, pages, page_size, **kw)}
    if kind == "mamba1":
        return {"ssm": init_mamba1_cache(cfg, batch, **kw)}
    if kind in MAMBA_KINDS:
        out = {"ssm": init_mamba2_cache(cfg, batch, **kw)}
        if kind == "mamba2_attn":
            out["kv"] = init_cache(cfg, batch, seq, window=0, **kw)
        return out
    return {"kv": init_cache(cfg, batch, seq, window=block_window(kind, cfg),
                             **kw)}


def apply_block(kind: str, p, x: torch.Tensor, cfg: ModelConfig, *,
                shared=None, cache: dict | None = None, pos=None,
                states=None, valid_len=None, page_table=None):
    """Returns (x, new_cache, new_states, aux_loss). With a cache and S > 1
    this is a token-parallel PREFILL step; ``valid_len`` (B,) masks
    right-padded rows out of the cache writes and freezes recurrent
    states past each row's length. KV caches are written in place; a
    Mamba layer returns its new state in ``new_cache["ssm"]``.
    ``page_table`` (B, pages_per_slot) rides along when the cache is a
    paged pool: one table serves every layer, since page allocation is
    layer-independent."""
    _check_kind(kind)
    st = states or {}
    if kind in MAMBA_KINDS:
        h = apply_norm(cfg.norm, p["ln"], x)
        fn = apply_mamba1 if kind == "mamba1" else apply_mamba2
        m, new_ssm, s_m = fn(
            p["mixer"], h, cfg, state=None if cache is None else cache["ssm"],
            states=st.get("mixer"), valid_len=valid_len)
        new_st = {"mixer": s_m}
        x = x + m
        new_cache = None if cache is None else {"ssm": new_ssm}
        if kind == "mamba2_attn":
            h = apply_norm(cfg.norm, shared["ln"], x)
            a, new_kv, s_sh = apply_attention(
                shared["attn"], h, cfg, causal=True, window=0,
                cache=None if cache is None else cache["kv"], pos=pos,
                states=st.get("shared_attn"), valid_len=valid_len)
            new_st["shared_attn"] = s_sh
            x = x + a
            h = apply_norm(cfg.norm, shared["ln2"], x)
            f, _ = apply_mlp(shared["mlp"], h, cfg, None)
            x = x + f
            if new_cache is not None:
                new_cache["kv"] = new_kv
        return x, new_cache, new_st, 0.0
    h = apply_norm(cfg.norm, p["ln1"], x)
    a, new_kv, s_attn = apply_attention(
        p["attn"], h, cfg, causal=True, window=block_window(kind, cfg),
        cache=None if cache is None else cache["kv"], pos=pos,
        states=st.get("attn"), valid_len=valid_len, page_table=page_table)
    x = x + a
    h = apply_norm(cfg.norm, p["ln2"], x)
    f, s_mlp = apply_mlp(p["mlp"], h, cfg, st.get("mlp"))
    x = x + f
    new_cache = None if cache is None else {"kv": new_kv}
    return x, new_cache, {"attn": s_attn, "mlp": s_mlp}, 0.0
