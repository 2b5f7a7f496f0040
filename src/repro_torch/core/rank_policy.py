"""Rank selection policies (paper §3.3), the static part the serving
slice needs: ``static_rank`` (rank fraction × min(O, I), aligned) and
``asi_mode_ranks`` (per-mode Tucker ranks of an activation).

Copied from ``repro.core.rank_policy``; the data-dependent policies
(``epsilon_ranks``, ``perplexity_dp``) wait for the training slice.
"""
from __future__ import annotations

from typing import Sequence


def align_up(k: int, align: int) -> int:
    return max(align, -(-k // align) * align)


def static_rank(in_dim: int, out_dim: int, rank_frac: float, *,
                align: int = 128, min_rank: int = 8) -> int:
    """Deterministic rank for the scale branch."""
    full = min(in_dim, out_dim)
    k = max(min_rank, int(round(rank_frac * full)))
    if align > 1:
        k = align_up(k, align)
    return min(k, full)


def asi_mode_ranks(shape: Sequence[int], frac: Sequence[float], *,
                   skip_batch: bool = False, align: int = 8,
                   min_rank: int = 1) -> tuple[int, ...]:
    """Per-mode Tucker ranks for an activation of ``shape``.

    ``skip_batch=True`` keeps mode 0 at full rank so the compression never
    couples samples. Ranks are capped at min(D_m, prod_{j!=m} D_j), the
    rank of the mode-m unfolding (paper Alg. 2 line 1).
    """
    total = 1
    for d in shape:
        total *= d
    ranks = []
    for m, (d, f) in enumerate(zip(shape, frac)):
        cap = min(d, total // d)
        if m == 0 and skip_batch:
            ranks.append(cap)
            continue
        r = max(min(min_rank, cap), int(round(f * d)))
        if align > 1 and r < d:
            r = align_up(r, align)
        ranks.append(min(r, cap))
    return tuple(ranks)
