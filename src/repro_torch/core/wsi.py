"""Weight Subspace Iteration (paper Alg. 1). Port of ``repro.core.wsi``.

State per layer: factors (L, R) with W ~= L @ R, L (O, K), R (K, I).

  t = 0 : L, R <- truncated SVD of W (``wsi_init``)
  t > 0 : R^T  <- W^T L_{t-1};  L <- orth(W R^T)  (``wsi_step``, CholeskyQR)

* ``project`` update mode (paper Eq. 9-11): the full W is the parameter;
  the gradient updates W, then one ``wsi_step`` re-extracts the (L, R)
  the next forward uses (``core/project.py``).
* ``factored`` update mode: L and R are the trainable parameters, and
  every ``refresh_every`` steps ``wsi_refresh_factored`` re-balances the
  pair through one CholeskyQR with its mixing matrix.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.orthogonal import cholesky_qr
from repro_torch.core.svd import truncated_svd


class WSIState(NamedTuple):
    L: torch.Tensor  # (..., O, K)
    R: torch.Tensor  # (..., K, I)


def wsi_init(w: torch.Tensor, k: int) -> WSIState:
    """t = 0: the rank-k truncated SVD of W (paper Alg. 1 lines 3-4);
    batched over leading dims, one k for the whole stack."""
    f = truncated_svd(w, k)
    return WSIState(L=f.L, R=f.R)


def wsi_step(w: torch.Tensor, prev: WSIState) -> WSIState:
    """One warm-started subspace iteration against W (paper Alg. 1 lines
    6-7, CholeskyQR orthogonalization). Batched: w (..., O, I), prev.L
    (..., O, K)."""
    wf = w.float()
    lnorm = cholesky_qr(prev.L).float()
    v = cholesky_qr(torch.einsum("...oi,...ok->...ik", wf, lnorm))
    L = cholesky_qr(torch.einsum("...oi,...ik->...ok", wf, v))
    R = torch.einsum("...ok,...oi->...ki", L, wf)
    return WSIState(L=L.to(w.dtype), R=R.to(w.dtype))


def wsi_refresh_factored(state: WSIState) -> WSIState:
    """Re-balance a directly trained (L, R) pair without a full W: one WSI
    step on the implicit W = L R reduces to orthogonalizing L and folding
    the mixing matrix M = Q^T L into R. Q and M come from one CholeskyQR
    (``kernels.ops.cholesky_qr_mix``: the kernel on the card, over every
    stacked layer at once); ``M @ R`` is a plain matmul, as the reference
    leaves its einsum to XLA."""
    from repro_torch.kernels.ops import cholesky_qr_mix

    q, m = cholesky_qr_mix(state.L)                       # (..,O,K), (..,K,K)
    r = torch.matmul(m, state.R.float())
    return WSIState(L=q.to(state.L.dtype), R=r.to(state.R.dtype))


def wsi_apply(state: WSIState) -> torch.Tensor:
    """Materialize W~ = L R (small scale / tests only)."""
    return state.L @ state.R


def wsi_flops(o: int, i: int, k: int) -> int:
    """Per-step WSI overhead FLOPs (paper Eq. 36): 4*I*O*K + 2*O*K^2."""
    return 4 * i * o * k + 2 * o * k * k
