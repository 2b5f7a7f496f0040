"""Orthogonalization for subspace iteration. Port of
``repro.core.orthogonal``.

Paper Alg. 1 uses classical Gram-Schmidt; the reference adapts it to
CholeskyQR, which spans the same subspace:

    G = Y^T Y        (tall-skinny Gram)
    G = C C^T        (K x K Cholesky, tiny)
    Q = Y C^{-T}     (K x K triangular solve)

The Gram-Schmidt oracle and the two-pass CholeskyQR2 come along. Every
function is batched over leading dims and computes in f32.
"""
from __future__ import annotations

import torch


def gram_schmidt(y: torch.Tensor) -> torch.Tensor:
    """Classical Gram-Schmidt (paper-faithful oracle). y: (M, K) -> Q."""
    y = y.float()
    q = torch.zeros_like(y)
    for i in range(y.shape[1]):
        v = y[:, i]
        coeff = q[:, :i].T @ v
        v = v - q[:, :i] @ coeff
        q[:, i] = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-12)
    return q


def _shifted_cholesky(g: torch.Tensor, shift: float) -> torch.Tensor:
    """Lower Cholesky of g + shift*scale*I with the reference's fallback
    ladder (:func:`shifted_cholesky_ladder`)."""
    return shifted_cholesky_ladder(g, shift)[0]


def shifted_cholesky_ladder(g: torch.Tensor, shift: float):
    """(C, retried): the lower Cholesky of g + shift*scale*I, scale =
    max(tr(g)/K, 1e-30), and where that factorization fails, of
    g + 1e4*shift*scale*I instead; ``retried`` (...,) bool says where.
    JAX signals the failure with NaNs; torch's ``cholesky_ex`` reports it
    in ``info``, and both are checked. Nothing waits on the device, so it
    runs inside a CUDA graph."""
    k = g.shape[-1]
    scale = torch.clamp(torch.diagonal(g, dim1=-2, dim2=-1).sum(-1) / k,
                        min=1e-30)
    eye = torch.eye(k, dtype=g.dtype, device=g.device)
    c1, info1 = torch.linalg.cholesky_ex(
        g + (shift * scale)[..., None, None] * eye)
    c2, _ = torch.linalg.cholesky_ex(
        g + (1e4 * shift * scale)[..., None, None] * eye)
    bad = (info1 != 0) | ~torch.isfinite(c1).all(dim=-1).all(dim=-1)
    return torch.where(bad[..., None, None], c2, c1), bad


def _gram(yf: torch.Tensor) -> torch.Tensor:
    return yf.mT @ yf


def cholesky_qr(y: torch.Tensor, shift: float = 1e-6) -> torch.Tensor:
    """Shifted CholeskyQR. y: (..., M, K) -> Q with orthonormal columns,
    in y's dtype."""
    yf = y.float()
    c = _shifted_cholesky(_gram(yf), shift)
    qt = torch.linalg.solve_triangular(c, yf.mT, upper=False)
    return qt.mT.to(y.dtype)


def cholesky_qr_mix_ref(y: torch.Tensor, shift: float = 1e-6, *,
                        with_retry: bool = False):
    """(Q, M = Q^T Y) with the mix from the Gram factor,
    Q^T Y = C^{-1} (Y^T Y): a K x K triangular solve instead of a second
    sweep over Y. The plain version behind ``kernels.ops.cholesky_qr_mix``
    on the CPU, and of the CholeskyQR kernel. Batched over leading dims; Q
    in y's dtype, mix f32; ``with_retry`` adds the ladder's (...,) flags."""
    yf = y.float()
    g = _gram(yf)
    c, retried = shifted_cholesky_ladder(g, shift)
    qt = torch.linalg.solve_triangular(c, yf.mT, upper=False)
    mix = torch.linalg.solve_triangular(c, g, upper=False)
    if with_retry:
        return qt.mT.to(y.dtype), mix, retried
    return qt.mT.to(y.dtype), mix


def cholesky_qr2(y: torch.Tensor) -> torch.Tensor:
    """Two-pass CholeskyQR: orthogonality to ~machine eps even when Y is
    ill-conditioned."""
    return cholesky_qr(cholesky_qr(y))


def orthonormality_error(q: torch.Tensor) -> torch.Tensor:
    """||Q^T Q - I||_F, batched."""
    qf = q.float()
    g = _gram(qf)
    eye = torch.eye(g.shape[-1], dtype=g.dtype, device=g.device)
    return torch.linalg.matrix_norm(g - eye)
