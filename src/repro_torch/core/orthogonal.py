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
    ladder: where the first factorization fails, a 1e4-times larger shift
    is taken instead. JAX signals the failure with NaNs; torch's
    ``cholesky_ex`` reports it in ``info``, and both are checked."""
    k = g.shape[-1]
    scale = torch.clamp(torch.diagonal(g, dim1=-2, dim2=-1).sum(-1) / k,
                        min=1e-30)
    eye = torch.eye(k, dtype=g.dtype, device=g.device)
    c1, info1 = torch.linalg.cholesky_ex(
        g + (shift * scale)[..., None, None] * eye)
    c2, _ = torch.linalg.cholesky_ex(
        g + (1e4 * shift * scale)[..., None, None] * eye)
    bad = (info1 != 0)[..., None, None] | \
        ~torch.isfinite(c1).all(dim=-1, keepdim=True).all(dim=-2,
                                                           keepdim=True)
    return torch.where(bad, c2, c1)


def _gram(yf: torch.Tensor) -> torch.Tensor:
    return yf.mT @ yf


def cholesky_qr(y: torch.Tensor, shift: float = 1e-6) -> torch.Tensor:
    """Shifted CholeskyQR. y: (..., M, K) -> Q with orthonormal columns,
    in y's dtype."""
    yf = y.float()
    c = _shifted_cholesky(_gram(yf), shift)
    qt = torch.linalg.solve_triangular(c, yf.mT, upper=False)
    return qt.mT.to(y.dtype)


def cholesky_qr_mix_ref(y: torch.Tensor, shift: float = 1e-6):
    """(Q, M = Q^T Y) with the mix from the Gram factor,
    Q^T Y = C^{-1} (Y^T Y): a K x K triangular solve instead of a second
    sweep over Y. The plain version behind ``kernels.ops.cholesky_qr_mix``
    on the CPU. Batched over leading dims; Q in y's dtype, mix f32."""
    yf = y.float()
    g = _gram(yf)
    c = _shifted_cholesky(g, shift)
    qt = torch.linalg.solve_triangular(c, yf.mT, upper=False)
    mix = torch.linalg.solve_triangular(c, g, upper=False)
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
