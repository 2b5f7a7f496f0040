"""Shared config-building helpers."""
from __future__ import annotations

from repro_torch.config import AsiConfig, LayerGroup, WasiConfig

# Default WASI setting for the scale configs: the paper's method as the
# framework's first-class feature. rank_frac 0.25 corresponds to eps≈0.8 on
# trained transformer linears (calibrated by benchmarks/fig3_wsi_vs_svd.py).
SCALE_WASI = WasiConfig(
    method="wasi", scope="all", epsilon=0.8, rank_frac=0.25, rank_align=128,
    update_mode="factored", refresh_every=64,
    # modest per-mode fractions: Tucker factor state scales with D_m * r_m
    # per linear per layer — 1/16 keeps it ZeRO-shardable (DESIGN.md §4)
    asi=AsiConfig(token_frac=0.0625, feature_frac=0.0625, skip_batch=True))

# Reduced-rank settings for smoke configs (no 128-alignment: tiny dims)
SMOKE_WASI = WasiConfig(
    method="wasi", scope="all", epsilon=0.8, rank_frac=0.5, rank_align=1,
    min_rank=4, update_mode="factored",
    asi=AsiConfig(token_frac=0.5, feature_frac=0.5, align=1, skip_batch=True))


def uniform_groups(kind: str, n: int) -> tuple[LayerGroup, ...]:
    return (LayerGroup(pattern=(kind,), repeat=n),)


def patterned_groups(pattern: tuple[str, ...], repeat: int,
                     tail: tuple[str, ...] = ()) -> tuple[LayerGroup, ...]:
    groups = [LayerGroup(pattern=pattern, repeat=repeat)]
    if tail:
        groups.append(LayerGroup(pattern=tail, repeat=1))
    return tuple(groups)
