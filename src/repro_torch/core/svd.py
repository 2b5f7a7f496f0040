"""Truncated SVD and explained-variance rank selection (paper §3.3, Eq.
5-7). Port of ``repro.core.svd``.

The paper picks, per layer, the smallest rank K such that the cumulative
explained variance of the leading singular values reaches a threshold
eps:

    sigma_j^2 = s_j^2 / sum_k s_k^2,   K = min{K : sum_{j<=K} sigma_j^2 >= eps}

``torch.linalg.svd`` takes the place of ``jnp.linalg.svd``: a library
factorisation outside any kernel, as in the reference. Singular vectors
are defined up to sign, and two LAPACK builds may pick other signs, so
factors are compared through L R and the singular values.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SVDFactors(NamedTuple):
    """W ~= L @ R with L (O, K), R (K, I)."""

    L: torch.Tensor
    R: torch.Tensor


def explained_variance(s: torch.Tensor) -> torch.Tensor:
    """Per-singular-value explained variance sigma_j^2 (paper §3.3)."""
    e = s.float() ** 2
    return e / torch.clamp(e.sum(), min=1e-30)


def rank_for_threshold(s: torch.Tensor, eps: float) -> torch.Tensor:
    """Smallest K with cumulative explained variance >= eps, a 0-d int32
    tensor in [1, len(s)] (eps is clipped so that eps = 1 keeps full
    rank)."""
    cum = torch.cumsum(explained_variance(s), dim=0)
    hit = cum >= torch.clamp(cum[-1] - 1e-7, max=eps)
    k = torch.argmax(hit.to(torch.int32))
    return torch.clamp(k + 1, min=1).to(torch.int32)


def pick_rank(w, eps: float, align: int = 1,
              max_rank: int | None = None) -> int:
    """Python-int rank for the weight matrix ``w`` under threshold
    ``eps``. ``align`` rounds the rank UP to a multiple, never lowering
    the information kept; the result is capped at min(O, I) and
    ``max_rank``."""
    w = torch.as_tensor(w)
    s = torch.linalg.svdvals(w.float())
    k = int(rank_for_threshold(s, eps))
    if align > 1:
        k = -(-k // align) * align
    full = min(w.shape[-2], w.shape[-1])
    k = min(k, full if max_rank is None else min(full, max_rank))
    return max(k, 1)


def truncated_svd(w: torch.Tensor, k: int) -> SVDFactors:
    """Rank-k factorisation W ~= L R (paper Eq. 5-7): L = U_k S_k (O, K),
    R = V_k^T (K, I), in w's dtype; R has orthonormal rows and L carries
    the singular values. Batched over leading dims."""
    u, s, vt = torch.linalg.svd(w.float(), full_matrices=False)
    L = (u[..., :, :k] * s[..., None, :k]).to(w.dtype)
    R = vt[..., :k, :].to(w.dtype)
    return SVDFactors(L=L, R=R)


def svd_approx(w: torch.Tensor, k: int) -> torch.Tensor:
    """Best rank-k approximation of w (oracle for tests)."""
    f = truncated_svd(w, k)
    return (f.L @ f.R).to(w.dtype)


def reconstruction_rel_error(w: torch.Tensor,
                             f: SVDFactors) -> torch.Tensor:
    """||W - L R||_F / ||W||_F."""
    diff = w.float() - f.L.float() @ f.R.float()
    return torch.linalg.norm(diff) / torch.clamp(
        torch.linalg.norm(w.float()), min=1e-30)
