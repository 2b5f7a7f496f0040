"""Activation Subspace Iteration (paper §3.2, Alg. 2, App. A.1). Port of
``repro.core.asi``.

Compresses a saved-for-backward activation A (3D: B×N×I, or 4D:
B×H×W×I) into a Tucker form

    A ~= S ×_1 U1 ×_2 U2 ... ×_m Um

with fixed per-mode ranks, kept across training steps by ONE warm-started
power iteration per mode:

    t = 0 : V ~ N(0,1);                 U_m = orth(A_(m) V)
    t > 0 : V = A_(m)^T U_m^{(t-1)};    U_m = orth(A_(m) V)

Storage drops from prod(D) to prod(r) + sum(D_m * r_m) (paper Eq. 31/44).
A mode kept at full rank has the factor ``None`` (identity), never an eye
matrix: the flatten order of checkpoints and of ``api.bridge`` depends on
it. Unfoldings are mode products and tensor contractions over the original
dims, as in the reference; orthogonalization is shifted CholeskyQR
(``core.orthogonal``), its failed first factorization retried with a
1e4-times larger shift (``cholesky_ex``'s ``info`` stands in for JAX's
NaNs). Each function takes one site's activation; the per-layer states
of a layer group are stacked on its ``repeat`` dim (``models/lm.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch.core.orthogonal import cholesky_qr, shifted_cholesky_ladder


class TuckerFactors(NamedTuple):
    """Tucker core + per-mode factors. ``core`` (r1, ..., rm); ``us`` a
    tuple of (D_m, r_m) matrices with orthonormal columns, or None for a
    mode kept at full rank."""

    core: torch.Tensor
    us: tuple


class ASIState(NamedTuple):
    """Warm-start state carried across training steps: per-mode factors."""

    us: tuple  # tuple of (D_m, r_m) or None


def _mode_product(t: torch.Tensor, m: torch.Tensor, mode: int) -> torch.Tensor:
    """t ×_mode m with m (Q, D_mode): contracts D_mode (paper Eq. 27)."""
    out = torch.movedim(t, mode, -1) @ m.T
    return torch.movedim(out, -1, mode)


def asi_init(generator: torch.Generator, shape: Sequence[int],
             ranks: Sequence[int], dtype=torch.float32,
             device=None) -> ASIState:
    """t = 0 warm start: random orthonormal factors (Alg. 2 line 7), drawn
    on the generator's device and moved to ``device``; rank >= dim gives
    an identity mode (None, never iterated)."""
    us = []
    for d, r in zip(shape, ranks):
        if r >= d:
            us.append(None)
            continue
        v = torch.randn(d, r, generator=generator, device=generator.device,
                        dtype=torch.float32)
        us.append(cholesky_qr(v).to(device=device, dtype=dtype))
    return ASIState(us=tuple(us))


def _gram_last(v: torch.Tensor) -> torch.Tensor:
    """(r, r) Gram over ALL leading dims of v (..., r)."""
    axes = list(range(v.dim() - 1))
    return torch.tensordot(v, v, dims=(axes, axes))


def _orth_last(v: torch.Tensor, shift: float = 1e-6) -> torch.Tensor:
    """Orthonormalize the last axis of v against all leading dims by
    shifted Cholesky, with the ladder of ``core.orthogonal.cholesky_qr``.
    Returns f32."""
    vf = v.float()
    c, _ = shifted_cholesky_ladder(_gram_last(vf), shift)
    eye = torch.eye(c.shape[-1], dtype=c.dtype, device=c.device)
    inv = torch.linalg.solve_triangular(c, eye, upper=False)   # C^{-1}
    return vf @ inv.T


def asi_project(a: torch.Tensor, state: ASIState) -> TuckerFactors:
    """Project ``a`` onto the EXISTING factors (no power iteration)."""
    core = a
    for mode, u in enumerate(state.us):
        if u is None:
            continue
        core = _mode_product(core, u.T.to(a.dtype), mode)
    return TuckerFactors(core=core, us=state.us)


def asi_step(a: torch.Tensor, state: ASIState
             ) -> tuple[TuckerFactors, ASIState]:
    """One warm-started subspace-iteration Tucker compression (Alg. 2):
    the factors approximating ``a`` and the refreshed warm-start state.
    The iteration runs in f32; each new factor and the core come out in
    ``a``'s dtype, as in the reference."""
    new_us = []
    core = a
    for mode, u_prev in enumerate(state.us):
        if u_prev is None:
            new_us.append(None)
            continue
        af = a.float()
        rest = [i for i in range(a.dim()) if i != mode]
        # v = A^T U without unfolding: contract D_m, keep the rest dims + r
        v = _mode_product(af, u_prev.float().T, mode)
        v = torch.movedim(v, mode, -1)
        # stage-wise orthogonalization (cond^2 per stage)
        v = _orth_last(v)
        v = torch.movedim(v, -1, mode)
        # u = orth(A V): contract every rest dim of a with v's
        u = torch.tensordot(af, v, dims=(rest, rest))       # (D_m, r)
        u = cholesky_qr(u).to(a.dtype)
        new_us.append(u)
        core = _mode_product(core, u.T.to(a.dtype), mode)
    us = tuple(new_us)
    return TuckerFactors(core=core, us=us), ASIState(us=us)


def tucker_reconstruct(f: TuckerFactors) -> torch.Tensor:
    """A~ = S ×_1 U1 ... ×_m Um (oracle and tests; the backward never
    rebuilds it)."""
    out = f.core
    for mode, u in enumerate(f.us):
        if u is None:
            continue
        out = _mode_product(out, u, mode)
    return out


def tucker_storage(shape: Sequence[int], ranks: Sequence[int]) -> int:
    """Element count of the compressed form (paper Eq. 31/44)."""
    prod_r = 1
    for r in ranks:
        prod_r *= r
    return prod_r + sum(d * r for d, r in zip(shape, ranks))


def compression_ratio(shape: Sequence[int], ranks: Sequence[int]) -> float:
    dense = 1
    for d in shape:
        dense *= d
    return dense / tucker_storage(shape, ranks)


def tucker_rel_error(a: torch.Tensor, f: TuckerFactors) -> torch.Tensor:
    """||A - A~||_F / ||A||_F."""
    diff = a.float() - tucker_reconstruct(f).float()
    return torch.linalg.vector_norm(diff) / torch.clamp(
        torch.linalg.vector_norm(a.float()), min=1e-30)


# ---------------------------------------------------------------------------
# f_LR: weight gradient straight from Tucker factors (paper App. A.1)
# ---------------------------------------------------------------------------

def _flr_general(f: TuckerFactors, dy: torch.Tensor) -> torch.Tensor:
    """dW for any None pattern: expand every mode but the feature mode, so
    the largest intermediate is dy-sized, contract with dy over every
    position dim, then expand the feature factor."""
    t = f.core
    for mode, u in enumerate(f.us[:-1]):
        if u is not None:
            t = _mode_product(t, u, mode)
    lead = list(range(dy.dim() - 1))
    g = torch.tensordot(dy, t, dims=(lead, lead))   # (O, r_last or I)
    u_last = f.us[-1]
    return g if u_last is None else torch.einsum("ot,it->oi", g, u_last)


def flr_weight_grad_3d(f: TuckerFactors, dy: torch.Tensor) -> torch.Tensor:
    """dW (O, I) from Tucker-compressed A (B, N, I) and dy (B, N, O),
    without rebuilding A: Eqs. 15-18 for a full Tucker form; with an
    identity batch mode the small ranks are contracted first."""
    s, (u1, u2, u3) = f.core, f.us
    if u1 is None:
        t = dy if u2 is None else torch.einsum("bno,nq->bqo", dy, u2)
        if u3 is None:
            return torch.einsum("bqi,bqo->oi", s, t)
        g = torch.einsum("bqt,bqo->to", s, t)
        return torch.einsum("to,it->oi", g, u3)
    if u2 is None or u3 is None:
        return _flr_general(f, dy)
    z1 = torch.einsum("bno,br->nor", dy, u1)           # Eq. 15
    z2 = torch.einsum("rqt,nq->rtn", s, u2)            # Eq. 16
    z3 = torch.einsum("rtn,it->rin", z2, u3)           # Eq. 17
    return torch.einsum("nor,rin->oi", z1, z3)         # Eq. 18


def flr_weight_grad_4d(f: TuckerFactors, dy: torch.Tensor) -> torch.Tensor:
    """dW (O, I) from Tucker-compressed A (B, H, W, I) and dy
    (B, H, W, O) (Eqs. 22-26)."""
    s, (u1, u2, u3, u4) = f.core, f.us
    if u1 is None:
        t = dy
        if u2 is not None:
            t = torch.einsum("bhwo,hq->bqwo", t, u2)
        if u3 is not None:
            t = torch.einsum("bqwo,wt->bqto", t, u3)
        if u4 is None:
            return torch.einsum("bqti,bqto->oi", s, t)
        g = torch.einsum("bqtf,bqto->fo", s, t)
        return torch.einsum("fo,if->oi", g, u4)
    if u2 is None or u3 is None or u4 is None:
        return _flr_general(f, dy)
    z1 = torch.einsum("bhwo,br->rhwo", dy, u1)         # Eq. 22
    z2 = torch.einsum("rqtf,hq->rhtf", s, u2)          # Eq. 23
    z3 = torch.einsum("rhwo,wt->rhto", z1, u3)         # Eq. 24
    z4 = torch.einsum("rhtf,if->rhit", z2, u4)         # Eq. 25
    return torch.einsum("rhto,rhit->oi", z3, z4)       # Eq. 26
