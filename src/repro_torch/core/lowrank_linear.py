"""WASI linear layers: factored weights + compressed saved activations.
Port of ``repro.core.lowrank_linear``.

Four custom-gradient matmuls cover the paper's experiment matrix:

  wasi_matmul    factored W = L R  AND  ASI-compressed residuals (WASI)
  asi_matmul     dense W, ASI-compressed residuals               (ASI)
  wasi_matmul_project  forward through (L, R), gradient delivered to the
                 FULL W via f_LR (paper Eq. 9-11, "project" update mode)
  wsi_matmul_project_exact  the same without compression: dW = dy^T x

Math (3D activations; 4D analogous, paper App. A.1):
  forward   y = (x R^T) L^T                       (Eq. 8)
  dx        = (dy L) R                            (Eq. 10)
  dL[o,k]   = sum_bn dy[b,n,o] h~[b,n,k],  h~ = x~ R^T
  dR[k,i]   = sum_bn dh[b,n,k] x~[b,n,i],  dh = dy L
  dW[o,i]   = sum_bn dy[b,n,o] x~[b,n,i]          (project mode, Eqs. 15-18)

where x~ is the Tucker form of x; the contractions consume the factors
directly (``core.asi.flr_weight_grad_*``), the dense activation is never
rebuilt. h~ is itself a Tucker tensor whose last factor is R @ U_last.

What is saved for backward is exactly what the reference's fwd rules
return, and never ``x``: for ``wasi_matmul`` the Tucker factors of x~, the
(K, r_last) last factor of h~ (built at forward time) and L, R; for
``asi_matmul`` the Tucker factors of x~ and W; for
``wasi_matmul_project`` the Tucker factors, L and R (never W), for
``wsi_matmul_project_exact`` x, L and R. ``utils.memprof`` measures
it. The forward's products run in x's dtype (h rounded to it, as the
reference's einsum pair does), not through the fused kernel.

The ASI state is threaded functionally: the caller compresses
``x.detach()`` under ``torch.no_grad()`` outside the Function (the
reference's ``stop_gradient``), and the factors ride in as inputs that get
no gradient. In project mode L and R come from the WSI states
(``core/project.py``), detached: their gradients are zeros, as the
reference's VJPs return them, and the train step never asks for them (the
reference strips them with ``_strip_lr``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.asi import (
    ASIState,
    TuckerFactors,
    asi_step,
    flr_weight_grad_3d,
    flr_weight_grad_4d,
)


def _flr(xt: TuckerFactors, dy: torch.Tensor) -> torch.Tensor:
    """Dispatch f_LR on the activation's order (3D/4D)."""
    if dy.dim() == 3:
        return flr_weight_grad_3d(xt, dy)
    if dy.dim() == 4:
        return flr_weight_grad_4d(xt, dy)
    raise ValueError(f"f_LR supports 3D/4D activations, got ndim={dy.dim()}")


def _project_last_mode(xt: TuckerFactors, r: torch.Tensor) -> TuckerFactors:
    """Tucker form of x~ contracted with R^T on the feature mode: the last
    factor U_I (I, r_m) becomes R @ U_I (K, r_m); an identity feature mode
    takes R itself (K, I)."""
    last = xt.us[-1]
    new_last = r if last is None else r.to(last.dtype) @ last
    return TuckerFactors(core=xt.core, us=xt.us[:-1] + (new_last,))


def _pack(ctx, xt: TuckerFactors, *tail: torch.Tensor) -> None:
    """Save the core, the non-identity factors and ``tail``; remember
    where the identity modes were."""
    ctx.identity = tuple(u is None for u in xt.us)
    ctx.save_for_backward(xt.core, *(u for u in xt.us if u is not None),
                          *tail)


def _unpack(ctx, n_tail: int):
    saved = list(ctx.saved_tensors)
    core, rest = saved[0], saved[1:len(saved) - n_tail]
    it = iter(rest)
    us = tuple(None if ident else next(it) for ident in ctx.identity)
    return TuckerFactors(core=core, us=us), saved[len(saved) - n_tail:]


class _WasiMatmul(torch.autograd.Function):
    """y = (x R^T) L^T with Tucker residuals (the reference's
    ``wasi_matmul`` custom VJP)."""

    @staticmethod
    def forward(ctx, x, l_factor, r_factor, core, *us):
        y = (x @ r_factor.T) @ l_factor.T
        xt = TuckerFactors(core=core, us=tuple(us))
        # the sketch, not the activation: h~'s (K, r_last) last factor
        ht_last = _project_last_mode(xt, r_factor).us[-1]
        _pack(ctx, xt, ht_last, l_factor, r_factor)
        return y

    @staticmethod
    def backward(ctx, dy):
        xt, (ht_last, l_factor, r_factor) = _unpack(ctx, 3)
        ht = TuckerFactors(core=xt.core, us=xt.us[:-1] + (ht_last,))
        dh = dy @ l_factor                                  # (..., K)
        dx = dh @ r_factor                                  # Eq. 10
        dl = _flr(ht, dy)                                   # (O, K)
        dr = _flr(xt, dh)                                   # (K, I)
        return (dx, dl.to(l_factor.dtype), dr.to(r_factor.dtype), None,
                *(None for _ in xt.us))


class _AsiMatmul(torch.autograd.Function):
    """y = x W^T with Tucker residuals (the reference's ``asi_matmul``)."""

    @staticmethod
    def forward(ctx, x, w, core, *us):
        _pack(ctx, TuckerFactors(core=core, us=tuple(us)), w)
        return x @ w.T

    @staticmethod
    def backward(ctx, dy):
        xt, (w,) = _unpack(ctx, 1)
        dx = dy @ w
        dw = _flr(xt, dy)
        return (dx, dw.to(w.dtype), None, *(None for _ in xt.us))


def _zeros_if_needed(ctx, i: int, t: torch.Tensor):
    return torch.zeros_like(t) if ctx.needs_input_grad[i] else None


class _WasiMatmulProject(torch.autograd.Function):
    """Forward through the factors, gradient on the full W (the
    reference's ``wasi_matmul_project``): saves the Tucker factors of x~,
    L and R."""

    @staticmethod
    def forward(ctx, x, w, l_factor, r_factor, core, *us):
        ctx.w_dtype = w.dtype
        _pack(ctx, TuckerFactors(core=core, us=tuple(us)), l_factor,
              r_factor)
        return (x @ r_factor.T) @ l_factor.T

    @staticmethod
    def backward(ctx, dy):
        xt, (l_factor, r_factor) = _unpack(ctx, 2)
        dx = (dy @ l_factor) @ r_factor                     # Eq. 10
        dw = _flr(xt, dy)                                   # Eqs. 15-18
        return (dx, dw.to(ctx.w_dtype), _zeros_if_needed(ctx, 2, l_factor),
                _zeros_if_needed(ctx, 3, r_factor), None,
                *(None for _ in xt.us))


class _WsiMatmulProjectExact(torch.autograd.Function):
    """Project mode without activation compression (the reference's
    ``wsi_matmul_project_exact``): factored forward, exact dense gradient
    dW = dy^T x; saves x, L and R. A bank of experts, w (E, O, I), L
    (E, O, K), R (E, K, I) and x (E, C, I), is the reference's ``vmap``
    of it over E: one product per expert, dW (E, O, I)."""

    @staticmethod
    def forward(ctx, x, w, l_factor, r_factor):
        ctx.save_for_backward(x, l_factor, r_factor)
        ctx.bank = w.dim() == 3
        return (x @ r_factor.mT) @ l_factor.mT

    @staticmethod
    def backward(ctx, dy):
        x, l_factor, r_factor = ctx.saved_tensors
        dx = (dy @ l_factor) @ r_factor
        if ctx.bank:
            dw = dy.mT @ x
        else:
            dw = dy.reshape(-1, dy.shape[-1]).T @ x.reshape(-1, x.shape[-1])
        return (dx, dw, _zeros_if_needed(ctx, 2, l_factor),
                _zeros_if_needed(ctx, 3, r_factor))


def wasi_matmul(x: torch.Tensor, l_factor: torch.Tensor,
                r_factor: torch.Tensor, xt: TuckerFactors) -> torch.Tensor:
    """y = (x @ R^T) @ L^T with Tucker residuals. x (..., I), L (O, K),
    R (K, I) -> (..., O)."""
    return _WasiMatmul.apply(x, l_factor, r_factor, xt.core, *xt.us)


def asi_matmul(x: torch.Tensor, w: torch.Tensor,
               xt: TuckerFactors) -> torch.Tensor:
    """y = x @ W^T with Tucker residuals. w (O, I)."""
    return _AsiMatmul.apply(x, w, xt.core, *xt.us)


def wasi_matmul_project(x: torch.Tensor, w: torch.Tensor,
                        l_factor: torch.Tensor, r_factor: torch.Tensor,
                        xt: TuckerFactors) -> torch.Tensor:
    """y = (x @ R^T) @ L^T; the gradient lands on w (O, I) as f_LR(x~,
    dy), x's as (dy L) R. L and R are derived from w by WSI outside the
    step."""
    return _WasiMatmulProject.apply(x, w, l_factor, r_factor, xt.core,
                                    *xt.us)


def wsi_matmul_project_exact(x: torch.Tensor, w: torch.Tensor,
                             l_factor: torch.Tensor,
                             r_factor: torch.Tensor) -> torch.Tensor:
    """y = (x @ R^T) @ L^T with the exact dense gradient dW = dy^T x; a
    bank (w 3-D) takes one product per expert."""
    return _WsiMatmulProjectExact.apply(x, w, l_factor, r_factor)


# ---------------------------------------------------------------------------
# Module-level convenience: compress-then-matmul with threaded ASI state
# ---------------------------------------------------------------------------

class WasiLinearParams(NamedTuple):
    L: torch.Tensor              # (O, K)
    R: torch.Tensor              # (K, I)
    bias: torch.Tensor | None = None


def init_wasi_linear(generator: torch.Generator, in_dim: int, out_dim: int,
                     rank: int, *, bias: bool = False, dtype=torch.float32,
                     scale: float | None = None,
                     device=None) -> WasiLinearParams:
    """Factored linear init: both factors normal with std
    (std_W / sqrt(K)) ** 0.5, std_W = ``scale`` or in_dim ** -0.5, so L R
    matches a LeCun-normal dense init in expectation."""
    std_w = scale if scale is not None else in_dim ** -0.5
    split = (std_w / rank ** 0.5) ** 0.5

    def normal(shape):
        t = torch.randn(*shape, generator=generator, device=generator.device,
                        dtype=torch.float32) * split
        return t.to(device=device, dtype=dtype)

    l_factor = normal((out_dim, rank))
    r_factor = normal((rank, in_dim))
    b = (torch.zeros(out_dim, dtype=dtype, device=device) if bias
         else None)
    return WasiLinearParams(L=l_factor, R=r_factor, bias=b)


def wasi_linear_apply(params: WasiLinearParams, x: torch.Tensor,
                      asi_state: ASIState | None):
    """Apply a WASI linear. Returns (y, new_asi_state). Without a state
    the layer runs uncompressed through ``kernels.ops.lowrank_matmul`` (the
    fused kernel on the card), with its sketch-saving gradient."""
    if asi_state is None:
        from repro_torch.kernels.ops import lowrank_matmul

        y, new_state = lowrank_matmul(x, params.R, params.L), None
    else:
        with torch.no_grad():
            xt, new_state = asi_step(x.detach(), asi_state)
        y = wasi_matmul(x, params.L, params.R, xt)
    if params.bias is not None:
        y = y + params.bias
    return y, new_state
