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

The rank reads only the squared singular values, so on a CUDA tensor
``pick_rank`` takes them as the eigenvalues of the float64 Gram
(``gram_singular_values``). On an H100, cuSOLVER's f32 ``svdvals``
read tinyllama-1.1b's (5,632, 2,048) weights' singular values 2.6-2.9e-4
of the largest off the CPU's f32 LAPACK, while the cumulative explained
variance there passes eps 0.8 within about 1e-4; the f64 Gram's read them
within 8e-6 (the CPU f32 SVD's own error), in 27 ms a weight
(``chip_smoke.py`` phase 21 prints both against the CPU).
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


def gram_singular_values(w: torch.Tensor) -> torch.Tensor:
    """Singular values of ``w`` (..., O, I), descending, as the square
    roots of the eigenvalues of its float64 Gram over the shorter side,
    returned in f32 on ``w``'s device. Every squared singular value comes
    out within ~1e-16 of the largest one's, so explained variances are
    exact to f32 rounding."""
    m = w.double()
    g = m.mT @ m if m.shape[-2] >= m.shape[-1] else m @ m.mT
    lam = torch.linalg.eigvalsh(g).flip(-1)
    return torch.clamp(lam, min=0).sqrt().float()


def singular_values(w: torch.Tensor) -> torch.Tensor:
    """f32 singular values of ``w`` on the CPU, computed on ``w``'s own
    device: LAPACK's ``svdvals`` on the CPU (the reference's f32 SVD), the
    f64 Gram's eigenvalues on a CUDA device (``gram_singular_values``)."""
    if w.is_cuda:
        return gram_singular_values(w).cpu()
    return torch.linalg.svdvals(w.float())


def pick_rank(w, eps: float, align: int = 1,
              max_rank: int | None = None) -> int:
    """Python-int rank for the weight matrix ``w`` under threshold
    ``eps``. ``align`` rounds the rank UP to a multiple, never lowering
    the information kept; the result is capped at min(O, I) and
    ``max_rank``.

    The singular values come from ``w``'s own device
    (``singular_values``); the cumulative sum and the threshold then run
    on the CPU in f32 for every device alike, so a card's rank differs
    from the CPU's only where the cumulative explained variance passes
    ``eps`` within the CPU SVD's own error (~1e-5)."""
    s = singular_values(torch.as_tensor(w))
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
