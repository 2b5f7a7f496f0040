"""Plain PyTorch versions of the kernels: what each kernel computes, in
f32. ``ops`` routes CPU tensors here, the tests hold the JAX package's
oracles (``repro.kernels.ref``) against them, and ``chip_smoke.py`` holds
each kernel against them on the card."""
from __future__ import annotations

import torch

from repro_torch.core.orthogonal import cholesky_qr_mix_ref


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype=None) -> torch.Tensor:
    """C = A B in f32, cast to ``out_dtype`` (default A's dtype)."""
    return torch.matmul(a.float(), b.float()).to(out_dtype or a.dtype)


def lowrank_matmul_ref(x: torch.Tensor, r_factor: torch.Tensor,
                       l_factor: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """y = (x @ R^T) @ L^T; x (..., I), R (K, I), L (O, K) -> (..., O).
    Both products in f32 (the rank-K ``h`` stays f32), then a cast to
    ``out_dtype`` (default x's dtype)."""
    h = torch.matmul(x.float(), r_factor.float().T)
    y = torch.matmul(h, l_factor.float().T)
    return y.to(out_dtype or x.dtype)


def lowrank_q8_ref(x: torch.Tensor, r_q: torch.Tensor, r_s: torch.Tensor,
                   l_q: torch.Tensor, l_s: torch.Tensor) -> torch.Tensor:
    """The int8 factored linear: y = ((x Rq^T) * sR) Lq^T * sL; x (..., I),
    Rq int8 (K, I), sR f32 (K,), Lq int8 (O, K), sL f32 (O,) -> (..., O) in
    x's dtype. The factors are converted to f32, never x quantized; both
    products in f32 (the reference's scale-folded einsum pair)."""
    h = torch.matmul(x.float(), r_q.float().T) * r_s
    y = torch.matmul(h, l_q.float().T) * l_s
    return y.to(x.dtype)


def dense_q8_ref(x: torch.Tensor, w_q: torch.Tensor,
                 w_s: torch.Tensor) -> torch.Tensor:
    """The int8 dense linear: y = (x Wq^T) * sW in f32, cast to x's dtype."""
    y = torch.matmul(x.float(), w_q.float().T) * w_s
    return y.to(x.dtype)


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


def split_pieces(v: torch.Tensor, n: int) -> torch.Tensor:
    """The first n bf16 pieces of v, stacked (n, ...): piece q = bf16(v -
    pieces 0..q-1) with round-to-nearest-even, every remainder exact in
    f32. Three pieces sum to an f32 v exactly, two within 2^-17 |v|. The
    plain version of the split that the bf16 kernels of #2 and #3 make of
    h and dh (csrc/gemm_bf16.cuh, ``split_bf16``)."""
    rest = v.float()
    pieces = []
    for _ in range(n):
        pieces.append(rest.to(torch.bfloat16))
        rest = rest - pieces[-1].float()
    return torch.stack(pieces)


def gram_ref(y: torch.Tensor) -> torch.Tensor:
    """G = Y^T Y in f32; y (..., M, K) -> (..., K, K)."""
    yf = y.float()
    return yf.mT @ yf


def choleskyqr_ref(y: torch.Tensor, shift: float = 1e-6, *,
                   with_retry: bool = False):
    """(Q, mix) of the fused CholeskyQR, batched over leading dims:
    Q = Y C^-T with C C^T = Y^T Y + shift * max(tr/K, 1e-30) I, and
    mix = C^-1 Y^T Y; where that factorization fails, the shift is 1e4
    times larger (the reference's ladder; ``with_retry`` adds the (...,)
    flags of where). Q in y's dtype, mix f32. Nothing waits on the device,
    so this runs inside a CUDA graph."""
    return cholesky_qr_mix_ref(y, shift, with_retry=with_retry)


def flash_attention_probs(q: torch.Tensor, k: torch.Tensor, *,
                          causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """The f32 softmax of the flash attention kernel's function: q (B, Sq,
    H, dh), k (B, Sk, KVH, dh), query head h reading KV head h // (H //
    KVH); scores q k^T dh^-0.5, key kpos visible to query qpos (from 0)
    where, with ``causal``, kpos <= qpos and, with ``window`` > 0, kpos >
    qpos - window. Returns p (B, KVH, G, Sq, Sk), G = H // KVH."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, sq, kvh, h // kvh, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * dh ** -0.5
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    return torch.softmax(torch.where(ok, s, -1e30), dim=-1)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """The flash attention kernel's function in f32: softmax
    (``flash_attention_probs``) times v (B, Sk, KVH, dh). Returns o (B,
    Sq, H, dh) in q's dtype."""
    p = flash_attention_probs(q, k, causal=causal, window=window)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(q.shape).to(q.dtype)


def ssd_chunk_ref(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, state: torch.Tensor):
    """One chunk of ``ssd_scan_ref``, f32 throughout: u (Bz, Q, H, dh), dt
    (Bz, Q, H), A (H,), B and C (Bz, Q, N), the (Bz, H, dh, N) state
    entering the chunk -> (y (Bz, Q, H, dh), the state leaving it).
    Differentiable by autograd; ``ops._SSDScan`` takes its gradient one
    chunk at a time."""
    q = u.shape[1]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=u.device))
    da = dt * A[None, None, :]                                  # (B,Q,H)
    cum = torch.cumsum(da, dim=1)
    li = cum[:, :, None, :] - cum[:, None, :, :]                # (B,Q,Q,H)
    # masked BEFORE the exp: above the diagonal li is a positive decay sum
    # that passes f32's exp range (88.7) within a long chunk, and the
    # reference's where(tri, exp(li), 0) then has a NaN gradient (0 * inf);
    # the values are the same
    L = torch.exp(li.masked_fill(~tri[None, :, :, None], float("-inf")))
    cbm = torch.einsum("bqn,bkn->bqk", C, B)                    # (B,Q,Q)
    du = dt[..., None] * u                                      # (B,Q,H,dh)
    y_intra = torch.einsum("bqkh,bkhd->bqhd", cbm[..., None] * L, du)
    decay_in = torch.exp(cum)                                   # (B,Q,H)
    y_inter = torch.einsum("bqn,bhdn,bqh->bqhd", C, state, decay_in)
    decay_out = torch.exp(cum[:, -1:, :] - cum)                 # (B,Q,H)
    s_c = torch.einsum("bqh,bqhd,bqn->bhdn", decay_out, du, B)
    chunk_decay = torch.exp(torch.sum(da, dim=1))               # (B,H)
    return y_intra + y_inter, chunk_decay[..., None, None] * state + s_c


def ssd_pad(chunk: int, u, dt, B, C):
    """u, dt, B and C zero-padded along S to a multiple of ``chunk``: with
    dt = 0 the padded steps are identity steps (decay 1, no input)."""
    pad = -u.shape[1] % chunk
    if not pad:
        return u, dt, B, C
    f = torch.nn.functional.pad
    return (f(u, (0, 0, 0, 0, 0, pad)), f(dt, (0, 0, 0, pad)),
            f(B, (0, 0, 0, pad)), f(C, (0, 0, 0, pad)))


def ssd_scan_ref(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, chunk: int):
    """The SSD (Mamba-2) chunked scan in f32, without the D.u skip term:
    u (Bz, S, H, dh), dt (Bz, S, H) > 0, A (H,) < 0, B and C (Bz, S, N).
    Per chunk of ``chunk`` steps, with cum = cumsum(dt A) inside it and
    L[i, j] = exp(cum_i - cum_j) for j <= i (0 above the diagonal):

        y = ((C B^T) * L)(dt u) + exp(cum) * (C S^T)
        S <- exp(cum_Q) S + (dt u exp(cum_Q - cum))^T B

    from S = 0 (``ssd_chunk_ref``). A ragged S is zero-padded to a chunk
    multiple with dt = 0 (identity steps) and the padding sliced off.
    Returns (y (Bz, S, H, dh), final S (Bz, H, dh, N)). A copy of the
    reference's ``repro.nn.mamba._ssd_chunked`` (a Python loop in place of
    its ``lax.scan``); differentiable by autograd."""
    u, dt, A, B, C = (t.float() for t in (u, dt, A, B, C))
    b, s, h, dh = u.shape
    u, dt, B, C = ssd_pad(chunk, u, dt, B, C)
    state = torch.zeros((b, h, dh, B.shape[-1]), dtype=torch.float32,
                        device=u.device)
    ys = []
    for c0 in range(0, u.shape[1], chunk):
        c1 = c0 + chunk
        y, state = ssd_chunk_ref(u[:, c0:c1], dt[:, c0:c1], A, B[:, c0:c1],
                                 C[:, c0:c1], state)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :s], state
