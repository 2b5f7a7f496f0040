"""Dispatch between the kernels and their plain versions, the custom
gradient of the factored linear, and the launch counters.

A CPU tensor takes the plain PyTorch version (``ref.py``); a CUDA tensor
launches the kernel or raises. There is no fallback from one to the other:
the device of the input decides, and nothing else.

Counters: ``LAUNCHES`` holds the forwards (``lowrank_fwd``, ``lowrank_q8``
of an int8 deployment, ``matmul_tiled`` of the two-launch baseline,
``flash_attention`` and ``ssd_scan``),
``TRAIN_LAUNCHES`` the kernels training reaches (``lowrank_fwd_sketch``,
``lowrank_bwd``, ``gram``, ``choleskyqr``); ``launch_counts`` reads both.
``copy_counts`` reads the copies of an L view (a rank draft's leading
columns) that a route other than the decode routes had to make.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.gram import gram as _gram_kernel
from repro_torch.kernels.lowrank import (
    COPIES,
    LAUNCHES,
    TRAIN_LAUNCHES,
    lowrank_bwd,
    lowrank_fused,
    row_view,
)
from repro_torch.kernels.matmul_tiled import matmul_tiled
from repro_torch.kernels.qr import choleskyqr
from repro_torch.kernels.quant import lowrank_q8
from repro_torch.kernels.ssd_scan import ssd_scan_cuda

__all__ = ["LAUNCHES", "TRAIN_LAUNCHES", "cholesky_qr_mix", "choleskyqr_fused",
           "copy_counts", "dense_matmul_q8", "flash_attention", "gram",
           "launch_counts", "lowrank_bwd_fused", "lowrank_matmul", "lowrank_matmul_q8",
           "lowrank_matmul_q8_fused", "lowrank_matmul_unfused", "matmul",
           "reset_launches", "ssd_scan"]


def reset_launches() -> None:
    """Zero every launch count and the factor copies (``copy_counts``)."""
    for counts in (LAUNCHES, TRAIN_LAUNCHES, COPIES):
        for name in counts:
            counts[name] = 0


def launch_counts() -> dict[str, int]:
    """Every kernel's launches: {name: count}."""
    return {**LAUNCHES, **TRAIN_LAUNCHES}


def copy_counts() -> dict[str, int]:
    """Contiguous copies of an L view made because the route taking the
    call could not read it in place: {wrapper: count}
    (``lowrank.COPIES``)."""
    return dict(COPIES)


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


class _LowrankFused(torch.autograd.Function):
    """The fused factored linear with its sketch-saving gradient (the
    reference's ``_lowrank_fused`` and its custom VJP). Forward: the sketch
    kernel writes y and h = x R^T (f32); (x, h, R, L) are saved and nothing
    is recomputed. Backward: one call of the backward kernel; dx comes back
    in x's dtype, dR and dL in the factors' dtypes. On CPU tensors both
    halves run their plain versions through the same wiring."""

    @staticmethod
    def forward(ctx, x2, r_factor, l_factor):
        if _on_cpu(x2):
            y, h = ref.lowrank_sketch_ref(x2, r_factor, l_factor)
        else:
            x2, r_factor, l_factor = (t.contiguous() for t in
                                      (x2, r_factor, l_factor))
            y, h = lowrank_fused(x2, r_factor, l_factor, save_sketch=True)
        ctx.save_for_backward(x2, h, r_factor, l_factor)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, h, r_factor, l_factor = ctx.saved_tensors
        dx, dl, dr = lowrank_bwd_fused(dy.contiguous(), x2, h, l_factor,
                                       r_factor)
        return dx, dr.to(r_factor.dtype), dl.to(l_factor.dtype)


def lowrank_matmul(x: torch.Tensor, r_factor: torch.Tensor,
                   l_factor: torch.Tensor) -> torch.Tensor:
    """WASI factored linear (Eq. 8): y = (x @ R^T) @ L^T, the entry every
    factored linear routes through. x (..., I), R (K, I), L (O, K) ->
    (..., O), leading dims flattened as the reference's fused wrapper
    does. With grad enabled and any input requiring grad it goes through
    ``_LowrankFused`` (sketch forward, fused backward); otherwise, as in
    serving, CUDA launches the fused forward (``kernels/lowrank.py``) and
    the CPU takes the plain f32 version (``ref.lowrank_matmul_ref``)."""
    lead = x.shape[:-1]
    if torch.is_grad_enabled() and (x.requires_grad or r_factor.requires_grad
                                    or l_factor.requires_grad):
        y = _LowrankFused.apply(x.reshape(-1, x.shape[-1]), r_factor,
                                l_factor)
        return y.reshape(*lead, l_factor.shape[0])
    if _on_cpu(x):
        return ref.lowrank_matmul_ref(x, r_factor, l_factor)
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    y = lowrank_fused(x2, r_factor.contiguous(), _factor(l_factor))
    return y.reshape(*lead, l_factor.shape[0])


def _factor(l_factor: torch.Tensor) -> torch.Tensor:
    """L as the kernel wrappers take it: a ``row_view`` (a rank draft's
    leading columns, rows the full rank apart) as it lies, which the
    decode routes read in place and any other route copies and counts
    (``lowrank.counted_copy``); another layout contiguous."""
    return l_factor if row_view(l_factor) else l_factor.contiguous()


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A B with f32 sums, in A's dtype. a (M, K), b (K, N), 2-D.
    CUDA: one launch of the tiled kernel (``kernels/matmul_tiled.py``; an A
    without unit stride along K is made contiguous first, B is read
    through its strides); CPU: the plain version (``ref.matmul_ref``). No
    gradient, as the reference's Pallas call has none."""
    if _on_cpu(a):
        return ref.matmul_ref(a, b)
    if a.stride(-1) != 1:
        a = a.contiguous()
    return matmul_tiled(a, b)


def lowrank_matmul_unfused(x: torch.Tensor, r_factor: torch.Tensor,
                           l_factor: torch.Tensor) -> torch.Tensor:
    """The two-launch factored linear (the reference's pre-fusion path,
    kept for the Table 2 comparison with the fused kernel): h = x R^T, then
    y = h L^T, each through ``matmul``. h is written to device memory in
    x's dtype between the launches (bf16 at full width, where the fused
    kernel keeps h in f32 on chip). x (..., I), R (K, I), L (O, K) ->
    (..., O); R^T and L^T are strided views, read in place."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    h = matmul(x2, r_factor.T)
    y = matmul(h, l_factor.T)
    return y.reshape(*lead, l_factor.shape[0])


def lowrank_matmul_q8(x: torch.Tensor, r_q: torch.Tensor,
                      r_s: torch.Tensor, l_q: torch.Tensor,
                      l_s: torch.Tensor) -> torch.Tensor:
    """Quantized factored linear, y = ((x Rq^T) * sR) Lq^T * sL, the entry
    every int8-deployed factored site routes through (``api.bind``). x
    (..., I); Rq int8 (K, I) + sR f32 (K,); Lq int8 (O, K) + sL f32 (O,)
    -> (..., O) in x's dtype, leading dims flattened. CUDA: kernel #6 by
    ``quant.q8_route``'s route, one counted launch (``kernels/quant.py``);
    CPU: the plain version
    (``ref.lowrank_q8_ref``). Serve-only: no gradient."""
    if _on_cpu(x):
        return ref.lowrank_q8_ref(x, r_q, r_s, l_q, l_s)
    lead = x.shape[:-1]
    y = lowrank_q8(x.reshape(-1, x.shape[-1]).contiguous(), r_q.contiguous(),
                   r_s.contiguous(), _factor(l_q), l_s.contiguous())
    return y.reshape(*lead, l_q.shape[0])


#: the reference's name for its kernel entry; the port dispatches both the
#: same way (the device of x decides)
lowrank_matmul_q8_fused = lowrank_matmul_q8


def dense_matmul_q8(x: torch.Tensor, w_q: torch.Tensor,
                    w_s: torch.Tensor) -> torch.Tensor:
    """Quantized dense linear, y = (x Wq^T) * sW, plain torch on every
    device, as the reference computes it outside any kernel."""
    return ref.dense_q8_ref(x, w_q, w_s)


def lowrank_bwd_fused(dy: torch.Tensor, x: torch.Tensor, h: torch.Tensor,
                      l_factor: torch.Tensor, r_factor: torch.Tensor):
    """The fused backward, unconditionally: dy (M, O), x (M, I), h (M, K)
    = x @ R^T -> (dx in x's dtype, dL f32, dR f32)."""
    if _on_cpu(x):
        return ref.lowrank_bwd_ref(dy, x, h, l_factor, r_factor)
    return lowrank_bwd(dy, x, h, l_factor, r_factor)


def gram(y: torch.Tensor) -> torch.Tensor:
    """G = Y^T Y (f32), the CholeskyQR reduction. y (..., M, K)."""
    if _on_cpu(y):
        return ref.gram_ref(y)
    return _gram_kernel(y.contiguous())


def choleskyqr_fused(y: torch.Tensor):
    """The fused CholeskyQR, unconditionally: y (..., M, K) ->
    (Q (..., M, K), mix (..., K, K) f32 = Q^T Y)."""
    if _on_cpu(y):
        return ref.choleskyqr_ref(y)
    return choleskyqr(y.contiguous())


def cholesky_qr_mix(y: torch.Tensor):
    """(Q, mix = Q^T Y) for the WSI factored refresh, the entry
    ``core/wsi.py`` routes through. CUDA: the CholeskyQR kernel (Gram,
    factor, apply) over every stacked index at once; the reference sends a
    stacked operand to its jnp version instead, and the kernel computes the
    same function, shift ladder included. A stack with several leading
    dims (an MoE layer group's (repeat, E, O, K) expert banks) goes in
    flattened to one stack axis, and both outputs come back in its shape.
    CPU: ``core.orthogonal.cholesky_qr_mix_ref``, batched."""
    if _on_cpu(y):
        from repro_torch.core.orthogonal import cholesky_qr_mix_ref
        return cholesky_qr_mix_ref(y)
    lead, (m, k) = y.shape[:-2], y.shape[-2:]
    q, mix = choleskyqr(y.reshape(-1, m, k).contiguous())
    return q.reshape(*lead, m, k), mix.reshape(*lead, k, k)


#: above this many query or key tokens the attention backward is tiled
#: (the reference's ``chunked_threshold``, where it switches from
#: ``dense_attention`` to the checkpointed ``chunked_attention``)
DENSE_BWD_MAX = 2048
#: query-block and KV-chunk length of the tiled backward (the reference's
#: ``chunked_attention`` defaults)
BWD_TILE = 1024


class _FlashAttention(torch.autograd.Function):
    """Attention with the flash kernel's forward (the reference has no
    backward kernel for it). Forward: the kernel on a CUDA tensor, the
    plain ``ref.flash_attention_ref`` on a CPU tensor; only q, k and v are
    saved, never the (B, H, Sq, Sk) probabilities. Backward: plain
    PyTorch, the f32 softmax recomputed, dq, dk and dv in the inputs'
    dtypes, dk and dv summed over each KV head's group of query heads; the
    counterpart of the reference's autodiff through ``dense_attention`` up
    to ``DENSE_BWD_MAX`` tokens (``_attention_bwd_dense``, the whole
    softmax at once) and through ``chunked_attention`` above
    (``_attention_bwd_tiled``, one tile of scores at a time)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.causal, ctx.window = causal, window
        ctx.save_for_backward(q, k, v)
        return _flash_forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        if max(q.shape[1], k.shape[1]) <= DENSE_BWD_MAX:
            grads = _attention_bwd_dense(q, k, v, do, ctx.causal, ctx.window)
        else:
            grads = _attention_bwd_tiled(q, k, v, do, ctx.causal, ctx.window,
                                         BWD_TILE, BWD_TILE)
        return (*grads, None, None)


def _attention_bwd_dense(q, k, v, do, causal, window):
    """(dq, dk, dv) from the whole (B, KVH, G, Sq, Sk) f32 softmax."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    p = ref.flash_attention_probs(q, k, causal=causal, window=window)
    dog = do.float().reshape(b, sq, kvh, h // kvh, dh)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * dh ** -0.5
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float())
    qg = q.float().reshape(b, sq, kvh, h // kvh, dh)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    return (dq.reshape(b, sq, h, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _attention_bwd_tiled(q, k, v, do, causal, window, q_tile, kv_tile):
    """(dq, dk, dv) of the same function, recomputed tile by tile: per
    query block of ``q_tile`` rows, a first pass over the KV chunks of
    ``kv_tile`` keys recomputes the row max m, the normaliser l and the
    output o (online softmax, f32), and D = rowsum(do * o); a second pass
    recomputes each chunk's p = exp(s - m) / l and gives dv += p^T do,
    ds = p (do v^T - D) dh^-0.5, dq += ds k and dk += ds^T q. A chunk that
    lies wholly outside the causal or window range of the block is
    skipped. At most one (B, KVH, G, q_tile, kv_tile) tile of scores
    lives at a time (p, and dp turned into ds in place)."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = dh ** -0.5
    qg = q.float().reshape(b, sq, kvh, g, dh)
    dog = do.float().reshape(b, sq, kvh, g, dh)
    kf, vf = k.float(), v.float()
    dq = torch.zeros_like(qg)
    dk = torch.zeros((b, sk, kvh, dh), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)

    def chunks(q0, q1):
        for c0 in range(0, sk, kv_tile):
            c1 = min(c0 + kv_tile, sk)
            if causal and c0 > q1 - 1:
                break
            if window > 0 and c1 - 1 <= q0 - window:
                continue
            yield c0, c1

    def scores(qb, q0, q1, c0, c1):
        s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kf[:, c0:c1]) * scale
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        kpos = torch.arange(c0, c1, device=q.device)[None, :]
        ok = torch.ones((q1 - q0, c1 - c0), dtype=torch.bool,
                        device=q.device)
        if causal:
            ok &= kpos <= qpos
        if window > 0:
            ok &= kpos > qpos - window
        return s.masked_fill_(~ok, -1e30)

    for q0 in range(0, sq, q_tile):
        q1 = min(q0 + q_tile, sq)
        qb, dob = qg[:, q0:q1], dog[:, q0:q1]
        m = torch.full((b, kvh, g, q1 - q0, 1), -1e30, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        o = torch.zeros((b, kvh, g, q1 - q0, dh), dtype=torch.float32,
                        device=q.device)
        for c0, c1 in chunks(q0, q1):
            s = scores(qb, q0, q1, c0, c1)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp(m - m_new)
            p = s.sub_(m_new).exp_()
            l = l * corr + p.sum(-1, keepdim=True)
            o = o * corr + torch.einsum("bhgqk,bkhd->bhgqd", p,
                                        vf[:, c0:c1])
            m = m_new
            del s, p
        dsum = (dob * (o / l).permute(0, 3, 1, 2, 4)).sum(-1)   # (b,q,h,g)
        dsum = dsum.permute(0, 2, 3, 1)[..., None]
        del o
        for c0, c1 in chunks(q0, q1):
            p = scores(qb, q0, q1, c0, c1).sub_(m).exp_().div_(l)
            dv[:, c0:c1] += torch.einsum("bhgqk,bqhgd->bkhd", p, dob)
            ds = torch.einsum("bqhgd,bkhd->bhgqk", dob, vf[:, c0:c1])
            ds.sub_(dsum).mul_(p).mul_(scale)
            del p
            dq[:, q0:q1] += torch.einsum("bhgqk,bkhd->bqhgd", ds,
                                         kf[:, c0:c1])
            dk[:, c0:c1] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qb)
            del ds
    return (dq.reshape(b, sq, h, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _flash_forward(q, k, v, causal, window):
    if _on_cpu(q):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return flash_attention_cuda(q, k, v, causal=causal, window=window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """GQA attention over a full sequence from position 0: q (B, Sq, H,
    dh), k and v (B, Sk, KVH, dh) -> (B, Sq, H, dh) in q's dtype, f32
    scores and softmax, mask causal and/or sliding-window (``window`` > 0)
    or none. CUDA: one launch of the flash kernel
    (``kernels/flash_attention.py``), reading the heads through their
    strides; CPU: the plain version (``ref.flash_attention_ref``). With grad
    enabled and any input requiring grad it goes through
    ``_FlashAttention``, whose backward is plain PyTorch."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window)
    return _flash_forward(q, k, v, causal, window)


def _ssd_forward(u, dt, A, B, C, chunk):
    if _on_cpu(u):
        return ref.ssd_scan_ref(u, dt, A, B, C, chunk)
    return ssd_scan_cuda(u, dt, A, B, C, chunk)


class _SSDScan(torch.autograd.Function):
    """The SSD scan without D.u, with kernel #8's forward (the reference
    has no backward kernel for it: it differentiates the plain
    ``_ssd_chunked``). Differentiated: u, dt, A, B and C as f32 (the
    casts ``ssd_scan`` makes); the scan reads ``stored``, the same u, B
    and C as stored (a bf16 model's, for the card's tensor-core route).
    Forward: the kernel on a CUDA tensor (one ``ssd_scan`` launch),
    ``ref.ssd_scan_ref`` on a CPU tensor; returns (y, final state); only
    the stored u, B, C and dt, A are saved. Backward: plain PyTorch, one
    chunk at a time (``_ssd_scan_bwd``), the final state's gradient, where
    it has one, carried in."""

    @staticmethod
    def forward(ctx, u, dt, A, B, C, chunk, stored):
        ctx.chunk = chunk
        ctx.dtypes = [t.dtype for t in (u, dt, A, B, C)]
        ctx.set_materialize_grads(False)
        su, sb, sc = stored
        ctx.save_for_backward(su, dt, A, sb, sc)
        return _ssd_forward(su, dt, A, sb, sc, chunk)

    @staticmethod
    def backward(ctx, dy, d_final):
        grads = _ssd_scan_bwd(*ctx.saved_tensors, dy, d_final, ctx.chunk)
        return (*(g.to(dt) for g, dt in zip(grads, ctx.dtypes)), None, None)


def _ssd_scan_bwd(u, dt, A, B, C, dy, d_final, chunk):
    """(du, ddt, dA, dB, dC), f32, of ``ref.ssd_scan_ref``'s (y, final
    state) against (``dy``, ``d_final``; either may be None). One pass
    without grad gives the state entering each chunk; then, from the last
    chunk back, ``torch.autograd.grad`` through that chunk's
    ``ref.ssd_chunk_ref`` gives its gradients and the entering state's,
    which the chunk before takes as its leaving state's. At most one
    chunk's (Bz, Q, Q, H) decay block and its autograd graph live at once.
    A ragged S is padded as the forward pads it."""
    s = u.shape[1]
    uf, dtf, Bf, Cf = ref.ssd_pad(chunk, *(t.detach().float()
                                           for t in (u, dt, B, C)))
    Af = A.detach().float()
    pad = (0, 0, 0, 0, 0, uf.shape[1] - s)
    dyf = (torch.zeros_like(uf) if dy is None
           else torch.nn.functional.pad(dy.float(), pad))
    starts = range(0, uf.shape[1], chunk)
    state = torch.zeros((uf.shape[0], uf.shape[2], uf.shape[3],
                         Bf.shape[-1]), dtype=torch.float32,
                        device=uf.device)
    entering = []
    with torch.no_grad():
        for c0 in starts:
            entering.append(state)
            sl = slice(c0, c0 + chunk)
            state = ref.ssd_chunk_ref(uf[:, sl], dtf[:, sl], Af, Bf[:, sl],
                                      Cf[:, sl], state)[1]
    seq = [torch.empty_like(t) for t in (uf, dtf, Bf, Cf)]
    dA = torch.zeros_like(Af)
    d_state = None if d_final is None else d_final.float()
    for c0, s_in in zip(reversed(starts), reversed(entering)):
        sl = slice(c0, c0 + chunk)
        with torch.enable_grad():
            ins = [t[:, sl].detach().requires_grad_()
                   for t in (uf, dtf, Bf, Cf)]
            a, st = Af.detach().requires_grad_(), s_in.requires_grad_()
            y, s_out = ref.ssd_chunk_ref(ins[0], ins[1], a, ins[2], ins[3],
                                         st)
            outs, douts = [y], [dyf[:, sl]]
            if d_state is not None:
                outs.append(s_out)
                douts.append(d_state)
            *g, ga, d_state = torch.autograd.grad(outs, [*ins, a, st], douts)
        for dst, gi in zip(seq, g):
            dst[:, sl] = gi
        dA += ga
    du, ddt, dB, dC = (t[:, :s] for t in seq)
    return du, ddt, dA, dB, dC


def ssd_scan(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, chunk: int,
             *, return_final: bool = False):
    """The Mamba-2 SSD chunked scan with the skip term: u (Bz, S, H, dh),
    dt (Bz, S, H) > 0, A (H,) < 0, B and C (Bz, S, N), D (H,) -> y
    (Bz, S, H, dh) f32 = scan + D.u, and with ``return_final`` also the
    (Bz, H, dh, N) f32 state after the last step; a ragged S behaves as
    zero-padded steps with dt = 0 (``ref.ssd_scan_ref``). The counterpart
    of the reference's ``repro.nn.mamba._ssd_chunked``. u, B and C may be
    bf16 (B and C row views). CUDA: one call of the scan's wrapper
    (``kernels/ssd_scan.py``: the route ``ssd_route`` picks, counted as
    one launch), which masks the ragged chunk itself, so no padding needs
    slicing off. CPU: the plain version. With grad enabled and any of u,
    dt, A, B, C requiring grad the scan goes through ``_SSDScan`` (the
    same forward on u, B and C as stored, a plain chunked backward), which
    differentiates their f32 casts, so u's gradient from the scan and from
    D.u (outside it) is summed in f32 and rounded to u's dtype once."""
    uf = u.float()   # one cast, shared by the scan's gradient and D.u
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (u, dt, A, B, C)):
        y, final = _SSDScan.apply(uf, dt, A, B.float(), C.float(), chunk,
                                  (u, B, C))
    else:
        y, final = _ssd_forward(u, dt, A, B, C, chunk)
    y = y + D.float()[None, None, :, None] * uf
    return (y, final) if return_final else y
