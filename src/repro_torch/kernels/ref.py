"""Plain PyTorch versions of the kernels: what each kernel computes, in
f32. ``ops`` routes CPU tensors here, the tests hold the JAX package's
oracles (``repro.kernels.ref``) against them, and ``chip_smoke.py`` holds
each kernel against them on the card."""
from __future__ import annotations

import torch


def lowrank_matmul_ref(x: torch.Tensor, r_factor: torch.Tensor,
                       l_factor: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """y = (x @ R^T) @ L^T; x (..., I), R (K, I), L (O, K) -> (..., O).
    Both products in f32 (the rank-K ``h`` stays f32), then a cast to
    ``out_dtype`` (default x's dtype)."""
    h = torch.matmul(x.float(), r_factor.float().T)
    y = torch.matmul(h, l_factor.float().T)
    return y.to(out_dtype or x.dtype)


def lowrank_sketch_ref(x: torch.Tensor, r_factor: torch.Tensor,
                       l_factor: torch.Tensor, out_dtype=None):
    """The sketch-saving forward: (y, h) with h = x R^T (..., K) in f32 and
    y = h L^T cast to ``out_dtype`` (default x's dtype)."""
    h = torch.matmul(x.float(), r_factor.float().T)
    y = torch.matmul(h, l_factor.float().T)
    return y.to(out_dtype or x.dtype), h


def lowrank_bwd_ref(dy: torch.Tensor, x: torch.Tensor, h: torch.Tensor,
                    l_factor: torch.Tensor, r_factor: torch.Tensor):
    """(dx, dL, dR) of the fused backward. dy (M, O), x (M, I), h (M, K) =
    x R^T, L (O, K), R (K, I). dx in x's dtype, dL and dR in f32."""
    dyf = dy.float()
    dh = dyf @ l_factor.float()                             # (M, K)
    dx = (dh @ r_factor.float()).to(x.dtype)
    dl = dyf.T @ h.float()                                  # (O, K)
    dr = dh.T @ x.float()                                   # (K, I)
    return dx, dl, dr


def gram_ref(y: torch.Tensor) -> torch.Tensor:
    """G = Y^T Y in f32; y (..., M, K) -> (..., K, K)."""
    yf = y.float()
    return yf.mT @ yf


def choleskyqr_ref(y: torch.Tensor, shift: float = 1e-6):
    """(Q, mix) of the fused CholeskyQR, batched over leading dims:
    Q = Y C^-T with C C^T = Y^T Y + shift * max(tr/K, 1e-30) I, and
    mix = C^-1 Y^T Y. Q in y's dtype, mix f32. ``cholesky_ex`` does not
    wait on the device to check the factorization, so this runs inside a
    CUDA graph; on an indefinite Gram its result is not a factor (the
    reference's jnp version gives NaNs there)."""
    yf = y.float()
    g = yf.mT @ yf
    k = g.shape[-1]
    scale = torch.clamp(torch.diagonal(g, dim1=-2, dim2=-1).sum(-1) / k,
                        min=1e-30)
    eye = torch.eye(k, dtype=g.dtype, device=g.device)
    c, _ = torch.linalg.cholesky_ex(g + (shift * scale)[..., None, None]
                                    * eye)
    qt = torch.linalg.solve_triangular(c, yf.mT, upper=False)
    mix = torch.linalg.solve_triangular(c, g, upper=False)
    return qt.mT.to(y.dtype), mix
