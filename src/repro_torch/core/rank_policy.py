"""Rank selection policies (paper §3.3 + App. A.2). Port of
``repro.core.rank_policy``.

1. ``epsilon_ranks``  — per-layer weight rank K_i from the explained
                        variance threshold eps (paper Eq. 5-7); used at
                        calibration time (``api.resolve(calibration=...)``)
                        and by project mode's ``use_epsilon_ranks``.
2. ``perplexity_dp``  — App. A.2: one threshold index per layer minimizing
                        the total perplexity under a memory budget, a
                        dynamic programme over a discretized budget, linear
                        in the layers (numpy, as in the reference).
3. ``static_rank``    — the scale branch: rank fraction × min(O, I),
                        rounded up to an aligned multiple.

``asi_mode_ranks`` gives the per-mode Tucker ranks of an activation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.svd import pick_rank


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


def epsilon_ranks(weights: Sequence[torch.Tensor], eps: float,
                  align: int = 1) -> list[int]:
    """Paper-faithful per-layer ranks under explained-variance eps: one
    ``pick_rank`` per (O, I) weight, on the weight's own device."""
    return [pick_rank(w, eps, align=align) for w in weights]


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


# ---------------------------------------------------------------------------
# App. A.2 — perplexity-constrained rank selection by dynamic programming
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DPResult:
    choice: tuple[int, ...]      # threshold index j chosen per layer
    total_perplexity: float
    total_memory: float


def perplexity_dp(perplexity: np.ndarray, memory: np.ndarray,
                  budget: float, bins: int = 512) -> DPResult:
    """One threshold index per layer minimizing the sum of perplexities
    subject to the sum of memories <= budget (paper Eq. 29-32).

    perplexity, memory: (num_layers, num_thresholds) arrays. The budget is
    discretized into ``bins`` levels (memories rounded up), a knapsack DP
    linear in the layers. Raises ``ValueError`` on a non-positive or
    infeasible budget."""
    P = np.asarray(perplexity, np.float64)
    M = np.asarray(memory, np.float64)
    n, e = P.shape
    if budget <= 0:
        raise ValueError("budget must be positive")
    scale = bins / budget
    mq = np.minimum(np.ceil(M * scale).astype(np.int64), bins + 1)

    # best[b]: least perplexity of layers 0..i at quantized memory b
    best = np.full(bins + 1, np.inf)
    parent = np.full((n, bins + 1), -1, np.int64)
    for j in range(e):
        b = mq[0, j]
        if b <= bins and P[0, j] < best[b]:
            best[b] = P[0, j]
            parent[0, b] = j
    for i in range(1, n):
        nxt = np.full(bins + 1, np.inf)
        for j in range(e):
            c = mq[i, j]
            if c > bins:
                continue
            shifted = np.full(bins + 1, np.inf)
            shifted[c:] = best[: bins + 1 - c] + P[i, j]
            better = shifted < nxt
            nxt = np.where(better, shifted, nxt)
            parent[i, better] = j
        best = nxt
    if not np.isfinite(best).any():
        raise ValueError("no feasible selection under the given budget")
    b = int(np.argmin(best))
    total_p = float(best[b])
    choice = []
    for i in range(n - 1, -1, -1):
        j = int(parent[i, b])
        choice.append(j)
        b -= int(mq[i, j])
    choice.reverse()
    total_m = float(sum(M[i, j] for i, j in enumerate(choice)))
    return DPResult(choice=tuple(choice), total_perplexity=total_p,
                    total_memory=total_m)


def gradient_perplexity(exact_grad, approx_grad) -> float:
    """Paper Eq. 28: the Frobenius norm of the gradient approximation
    error, in f32."""
    d = (torch.as_tensor(exact_grad).float()
         - torch.as_tensor(approx_grad).float())
    return float(torch.linalg.vector_norm(d))
