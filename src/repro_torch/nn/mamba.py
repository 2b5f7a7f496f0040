"""Mamba-1 (selective scan) and Mamba-2 (SSD) blocks. Port of
``repro.nn.mamba``.

Modes, as the reference's: train (no state), token-parallel prefill
(state given, S > 1: the full-sequence scan also emits the final
recurrent state and the conv buffers, so decode continues exactly where a
scanned prefill would) and decode (state given, S == 1: the one-token
recurrence, plain PyTorch).

Mamba-1 (``falcon-mamba-7b``): the selective scan of train and prefill is
plain PyTorch, as the reference's is (it has no Pallas kernel for it):
``_selective_scan`` carries the (B, d_inner, N) f32 state over chunks of
128 steps and scans inside a chunk in log depth, each chunk's body
checkpointed so the backward recomputes it. Mamba-2 (zamba2): the chunked
scan goes through ``kernels.ops.ssd_scan``: kernel #8 on the card
(``kernels/ssd_scan.py``; a bf16 model's u, B and C go in as stored, to
the tensor-core route; with grad, ``ops._SSDScan``'s plain chunked
backward), its plain version on the CPU. The reference's block runs the
plain ``_ssd_chunked`` there; the kernel computes the same function.

Decode keeps O(1) recurrent state per layer: Mamba-1 a (B, d_inner, N)
f32 state and one (B, d_conv - 1, d_inner) conv buffer; Mamba-2 a (B, H,
dh, N) f32 state and two rolling conv buffers, (B, d_conv - 1, d_inner)
for u and (B, d_conv - 1, 2 N) for B and C.

Projections (Mamba-1: ``in_proj``, ``x_proj``, ``dt_proj`` with its bias,
``out_proj``; Mamba-2: ``in_proj``, ``bcdt_proj``, ``out_proj``) bind
through the SubspacePlan, so WASI factoring applies. Parameters are the
reference's dict, with the layer group's stack dims in front (``lead``):
an ``nn.ParameterDict`` holding the linear dicts as submodules beside the
conv, decay, skip and norm leaves, which keep their own dtypes (``A_log``
and ``D``, and Mamba-2's ``dt_bias``, are f32 at every model dtype).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.api import bind, plan_of, role_treated
from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.nn.attention import is_vector_pos


class MambaState(NamedTuple):
    ssm: torch.Tensor  # Mamba-1 (B, d_inner, N), Mamba-2 (B, H, dh, N); f32
    conv: object       # rolling conv input buffer(s) (B, d_conv - 1, ch):
    #                    Mamba-1 one tensor, Mamba-2 a (u, bc) pair


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d. x (B, S, C), w (K, C) -> (B, S, C)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
              for i in range(k))
    return out + b[None, None, :]


def _conv_step(state_buf: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor):
    """One decode step of the causal conv. state_buf (B, K-1, C), x_t
    (B, C) -> (new buffer, y (B, C))."""
    window = torch.cat([state_buf, x_t[:, None, :]], dim=1)   # (B, K, C)
    y = torch.einsum("bkc,kc->bc", window, w) + b[None, :]
    return window[:, 1:, :], y


def _prefill_conv_buf(prev_buf: torch.Tensor, raw_seq: torch.Tensor,
                      count) -> torch.Tensor:
    """Rolling conv buffer after consuming ``count`` tokens of ``raw_seq``
    (pre-conv inputs): what a scan of ``_conv_step`` from position 0 would
    leave behind. ``count`` is an int or a (B,) per-row valid length, so
    right-padded prefill rows pick up their own last K-1 real inputs.
    ``prev_buf`` gives only the buffer's shape, never its contents (a
    recycled serve slot hands in a stale one)."""
    b, km1 = prev_buf.shape[0], prev_buf.shape[1]
    hist = torch.cat([torch.zeros_like(prev_buf), raw_seq.to(prev_buf.dtype)],
                     dim=1)
    if is_vector_pos(count):
        cnt = count.to(hist.device).long()
    else:
        cnt = torch.full((b,), int(count), device=hist.device)
    idx = cnt[:, None] + torch.arange(km1, device=hist.device)[None, :]
    return torch.gather(hist, 1, idx[..., None].expand(-1, -1,
                                                       hist.shape[-1]))


def _leaf(t: torch.Tensor, dtype, device) -> nn.Parameter:
    return nn.Parameter(t.to(device=device, dtype=dtype), requires_grad=False)


def _conv_w(ssm, ch: int, lead, generator, dtype, device) -> nn.Parameter:
    return _leaf(torch.randn(*lead, ssm.d_conv, ch, generator=generator,
                             device=generator.device) * ssm.d_conv ** -0.5,
                 dtype, device)


def _full(lead, size, value, dtype, device) -> nn.Parameter:
    return _leaf(torch.full((*lead, size), value, dtype=torch.float32),
                 dtype, device)


# ---------------------------------------------------------------------------
# Mamba-1
# ---------------------------------------------------------------------------

def _dt_rank(cfg: ModelConfig) -> int:
    return cfg.ssm.dt_rank or max(cfg.d_model // 16, 1)


def init_mamba1(cfg: ModelConfig, *, generator: torch.Generator,
                lead: tuple[int, ...] = (), dtype=torch.float32,
                device=None) -> nn.ParameterDict:
    d = cfg.d_model
    ssm = cfg.ssm
    di = ssm.expand * d
    n = ssm.d_state
    dtr = _dt_rank(cfg)
    plan = plan_of(cfg)
    kw = dict(generator=generator, lead=lead, dtype=dtype, device=device)
    p = nn.ParameterDict()
    p["in_proj"] = bind.init_params(plan.linear("ssm/in_proj", d, 2 * di),
                                    **kw)
    p["x_proj"] = bind.init_params(
        plan.linear("ssm/x_proj", di, dtr + 2 * n), **kw)
    p["dt_proj"] = bind.init_params(plan.linear("ssm/dt_proj", dtr, di),
                                    bias=True, **kw)
    p["out_proj"] = bind.init_params(plan.linear("ssm/out_proj", di, d),
                                     scale=di ** -0.5, **kw)
    p["conv_w"] = _conv_w(ssm, di, lead, generator, dtype, device)
    p["conv_b"] = _full(lead, di, 0.0, dtype, device)
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32))
    p["A_log"] = _leaf(a_log.expand(*lead, di, n).contiguous(),
                       torch.float32, device)
    p["D"] = _full(lead, di, 1.0, torch.float32, device)
    return p


def init_mamba1_state(cfg: ModelConfig, batch: int, seq: int, *,
                      generator: torch.Generator, dtype=torch.float32,
                      device=None) -> dict:
    """ASI warm-start states of ``in_proj``, ``x_proj`` and ``out_proj``
    (``dt_proj`` runs without one, as in the reference); {} when the plan
    leaves the SSM's activations dense."""
    w = cfg.wasi
    if not (w.compress_acts and role_treated(w, "ssm")):
        return {}
    d = cfg.d_model
    di = cfg.ssm.expand * d
    kw = dict(dtype=dtype, device=device)
    return {
        "in_proj": bind.asi_state(generator, (batch, seq, d), w, **kw),
        "x_proj": bind.asi_state(generator, (batch, seq, di), w, **kw),
        "out_proj": bind.asi_state(generator, (batch, seq, di), w, **kw),
    }


def _scan_chunk(h0, u, dt, A, B, C):
    """One chunk of the selective scan, f32: (state after the chunk, y
    without D.u). The pairs (a_t, b_t) = (exp(dt_t A), dt_t u_t B_t) are
    scanned over the chunk's steps in log depth (Hillis-Steele doubling)
    with the reference's ``compose``: at offset k, step t takes (a_t
    a_{t-k}, a_t b_{t-k} + b_t). Each doubling builds new tensors, so at
    most four (B, Q, d_inner, N) tensors live at once besides ``h``."""
    a = torch.exp(dt[..., None] * A[None, None])               # (B,Q,di,N)
    b = (dt * u)[..., None] * B[:, :, None, :]
    q, k = a.shape[1], 1
    while k < q:
        a_k = a[:, k:]
        b = torch.cat([b[:, :k], torch.addcmul(b[:, k:], a_k, b[:, :-k])], 1)
        a = torch.cat([a[:, :k], a_k * a[:, :-k]], 1)
        del a_k
        k *= 2
    h = torch.addcmul(b, a, h0[:, None])                        # carry in
    del a, b
    return h[:, -1], torch.einsum("bsdn,bsn->bsd", h, C)


def _selective_scan(u, dt, A, B, C, D, chunk: int = 128, *,
                    return_final: bool = False):
    """u (B, S, di), dt (B, S, di), A (di, N), B and C (B, S, N) -> y
    (B, S, di), f32:

        h_t = exp(dt_t A) h_{t-1} + dt_t B_t u_t ;  y_t = C_t . h_t + D u_t

    A loop over chunks of ``chunk`` steps carries the (B, di, N) state; a
    sequence that is not a multiple of ``chunk`` is one chunk, as in the
    reference. With grad enabled each chunk's body runs under a
    non-reentrant checkpoint (the reference's ``jax.checkpoint``), so the
    backward recomputes it instead of keeping its (B, Q, di, N) tensors.
    ``return_final=True`` also returns h_S (B, di, N), the decode state a
    scan of single-token steps would leave (token-parallel prefill)."""
    bsz, s, di = u.shape
    if s % chunk != 0:
        chunk = s
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (u, dt, A, B, C))
    h = torch.zeros((bsz, di, B.shape[-1]), dtype=u.dtype, device=u.device)
    ys = []
    for c0 in range(0, s, chunk):
        xs = (u[:, c0:c0 + chunk], dt[:, c0:c0 + chunk], A,
              B[:, c0:c0 + chunk], C[:, c0:c0 + chunk])
        if remat:
            h, y = checkpoint(_scan_chunk, h, *xs, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            h, y = _scan_chunk(h, *xs)
        ys.append(y)
    y = torch.cat(ys, 1) + D[None, None] * u
    return (y, h) if return_final else y


def apply_mamba1(p, x: torch.Tensor, cfg: ModelConfig, *,
                 state: MambaState | None = None, states=None,
                 valid_len=None):
    """Returns (y, new_state, new_asi_states). ``valid_len`` (B,) freezes
    the recurrence (dt = 0) past each row's true prompt length for
    right-padded prefill."""
    ssm = cfg.ssm
    di = ssm.expand * cfg.d_model
    n = ssm.d_state
    dtr = _dt_rank(cfg)
    st = states or {}
    new_st = dict(st)
    prefill = state is not None and x.shape[1] > 1
    lin = _linear(p, cfg, st, new_st)

    u, z = torch.split(lin("in_proj", x), di, dim=-1)       # (B, S, di) x2
    A = -torch.exp(p["A_log"])

    if state is None or prefill:  # train, or the cache-building prefill
        s = u.shape[1]
        u_raw = u
        u = _causal_conv(u, p["conv_w"], p["conv_b"])
        u = F.silu(u.float()).to(x.dtype)
        dt_r, B, C = torch.split(lin("x_proj", u), [dtr, n, n], dim=-1)
        dt = F.softplus(lin("dt_proj", dt_r).float())
        if valid_len is not None:
            # dt = 0 past the true length: exp(0 A) = 1 and dt B u = 0, so
            # the state rides through the padding untouched
            live = (torch.arange(s, device=x.device)[None, :]
                    < valid_len.to(x.device)[:, None])
            dt = torch.where(live[..., None], dt, 0.0)
        scanned = _selective_scan(u.float(), dt, A, B.float(), C.float(),
                                  p["D"], return_final=prefill)
        if prefill:
            y, h_final = scanned
            cnt = s if valid_len is None else valid_len
            new_state = MambaState(
                ssm=h_final,
                conv=_prefill_conv_buf(state.conv, u_raw, cnt))
        else:
            y = scanned
            new_state = None
    else:  # decode one token: x (B, 1, d)
        conv_buf, u1 = _conv_step(state.conv, u[:, 0], p["conv_w"],
                                  p["conv_b"])
        u1 = F.silu(u1.float()).to(x.dtype)
        dbc = lin("x_proj", u1[:, None, :])[:, 0]
        dt_r, B, C = torch.split(dbc, [dtr, n, n], dim=-1)
        dt = F.softplus(lin("dt_proj", dt_r[:, None, :])[:, 0].float())
        a = torch.exp(dt[..., None] * A[None])                 # (B, di, N)
        h = a * state.ssm + ((dt * u1.float())[..., None]
                             * B[:, None, :].float())
        y = (torch.einsum("bdn,bn->bd", h, C.float())
             + p["D"][None] * u1.float())[:, None, :]
        new_state = MambaState(ssm=h, conv=conv_buf)

    y = y.to(x.dtype) * F.silu(z.float()).to(x.dtype)
    return lin("out_proj", y), new_state, new_st


def init_mamba1_cache(cfg: ModelConfig, batch: int, *,
                      lead: tuple[int, ...] = (), dtype=torch.float32,
                      device=None) -> MambaState:
    di = cfg.ssm.expand * cfg.d_model
    return MambaState(
        ssm=torch.zeros((*lead, batch, di, cfg.ssm.d_state),
                        dtype=torch.float32, device=device),
        conv=torch.zeros((*lead, batch, cfg.ssm.d_conv - 1, di), dtype=dtype,
                         device=device))


def _linear(p, cfg: ModelConfig, st: dict, new_st: dict):
    """``lin(name, x)``: the mixer's site ``ssm/<name>`` applied through
    the plan, its refreshed ASI state written to ``new_st``."""
    plan = plan_of(cfg)

    def lin(name, inp):
        spec = plan.linear(f"ssm/{name}", inp.shape[-1],
                           bind.linear_out_dim(p[name]))
        y, ns = bind.apply(spec, p[name], inp, cfg.wasi, st.get(name))
        if ns is not None:
            new_st[name] = ns
        return y

    return lin


# ---------------------------------------------------------------------------
# Mamba-2 (SSD, chunked)
# ---------------------------------------------------------------------------

def init_mamba2(cfg: ModelConfig, *, generator: torch.Generator,
                lead: tuple[int, ...] = (), dtype=torch.float32,
                device=None) -> nn.ParameterDict:
    d = cfg.d_model
    ssm = cfg.ssm
    di = ssm.expand * d
    n = ssm.d_state
    nh = di // ssm.head_dim
    plan = plan_of(cfg)
    kw = dict(generator=generator, lead=lead, dtype=dtype, device=device)
    p = nn.ParameterDict()
    p["in_proj"] = bind.init_params(plan.linear("ssm/in_proj", d, 2 * di),
                                    **kw)
    p["bcdt_proj"] = bind.init_params(
        plan.linear("ssm/bcdt_proj", d, 2 * n + nh), **kw)
    p["out_proj"] = bind.init_params(plan.linear("ssm/out_proj", di, d),
                                     scale=di ** -0.5, **kw)
    p["conv_w"] = _conv_w(ssm, di, lead, generator, dtype, device)
    p["conv_b"] = _full(lead, di, 0.0, dtype, device)
    p["conv_w_bc"] = _conv_w(ssm, 2 * n, lead, generator, dtype, device)
    p["conv_b_bc"] = _full(lead, 2 * n, 0.0, dtype, device)
    p["A_log"] = _full(lead, nh, 0.0, torch.float32, device)
    p["dt_bias"] = _full(lead, nh, 0.0, torch.float32, device)
    p["D"] = _full(lead, nh, 1.0, torch.float32, device)
    p["norm_scale"] = _full(lead, di, 1.0, dtype, device)
    return p


def init_mamba2_state(cfg: ModelConfig, batch: int, seq: int, *,
                      generator: torch.Generator, dtype=torch.float32,
                      device=None) -> dict:
    """ASI warm-start states of the three projections (train path); {}
    when the plan leaves the SSM's activations dense."""
    w = cfg.wasi
    if not (w.compress_acts and role_treated(w, "ssm")):
        return {}
    d = cfg.d_model
    di = cfg.ssm.expand * d
    kw = dict(dtype=dtype, device=device)
    return {
        "in_proj": bind.asi_state(generator, (batch, seq, d), w, **kw),
        "bcdt_proj": bind.asi_state(generator, (batch, seq, d), w, **kw),
        "out_proj": bind.asi_state(generator, (batch, seq, di), w, **kw),
    }


def apply_mamba2(p, x: torch.Tensor, cfg: ModelConfig, *,
                 state: MambaState | None = None, states=None,
                 valid_len=None):
    """Returns (y, new_state, new_asi_states). ``valid_len`` (B,) freezes
    the recurrence (dt = 0) past each row's true prompt length for
    right-padded prefill."""
    ssm = cfg.ssm
    di = ssm.expand * cfg.d_model
    n = ssm.d_state
    nh = di // ssm.head_dim
    dh = ssm.head_dim
    st = states or {}
    new_st = dict(st)
    prefill = state is not None and x.shape[1] > 1
    lin = _linear(p, cfg, st, new_st)

    proj = lin("in_proj", x)                                # (B, S, 2 di)
    u, z = torch.split(proj, di, dim=-1)
    bcdt = lin("bcdt_proj", x)                              # (B, S, 2n+nh)
    Bv, Cv, dt_raw = torch.split(bcdt, [n, n, nh], dim=-1)
    A = -torch.exp(p["A_log"])

    if state is None or prefill:
        u_raw, bc_raw = u, torch.cat([Bv, Cv], dim=-1)
        u = _causal_conv(u, p["conv_w"], p["conv_b"])
        u = F.silu(u.float()).to(x.dtype)
        bc = _causal_conv(bc_raw, p["conv_w_bc"], p["conv_b_bc"])
        bc = F.silu(bc.float()).to(x.dtype)
        Bv, Cv = torch.split(bc, n, dim=-1)
        dt = F.softplus(dt_raw.float() + p["dt_bias"][None, None])
        bsz, s, _ = u.shape
        if valid_len is not None:
            live = (torch.arange(s, device=x.device)[None, :]
                    < valid_len.to(x.device)[:, None])
            dt = torch.where(live[..., None], dt, 0.0)      # identity steps
        # u, B and C in the model's dtype: the card's bf16 route reads them
        # as stored (B and C as views of bc), the CPU's plain version casts
        scanned = ops.ssd_scan(u.reshape(bsz, s, nh, dh), dt, A, Bv, Cv,
                               p["D"], min(ssm.chunk, s),
                               return_final=prefill)
        if prefill:
            y, s_final = scanned
            cnt = s if valid_len is None else valid_len
            conv_u_prev, conv_bc_prev = state.conv
            new_state = MambaState(
                ssm=s_final,
                conv=(_prefill_conv_buf(conv_u_prev, u_raw, cnt),
                      _prefill_conv_buf(conv_bc_prev, bc_raw, cnt)))
        else:
            y = scanned
            new_state = None
        y = y.reshape(bsz, s, di)
    else:  # decode one token
        conv_u, conv_bc = state.conv
        conv_u, u1 = _conv_step(conv_u, u[:, 0], p["conv_w"], p["conv_b"])
        u1 = F.silu(u1.float())
        bc1 = torch.cat([Bv[:, 0], Cv[:, 0]], dim=-1)
        conv_bc, bc1 = _conv_step(conv_bc, bc1, p["conv_w_bc"],
                                  p["conv_b_bc"])
        bc1 = F.silu(bc1.float())
        B1, C1 = torch.split(bc1, n, dim=-1)
        dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"][None])
        uh = u1.reshape(-1, nh, dh)
        a = torch.exp(dt * A[None])                         # (B, H)
        h_new = (a[..., None, None] * state.ssm
                 + (dt[..., None] * uh)[..., None] * B1[:, None, None, :])
        y = (torch.einsum("bhdn,bn->bhd", h_new, C1)
             + p["D"][None, :, None] * uh)
        y = y.reshape(-1, 1, di)
        new_state = MambaState(ssm=h_new, conv=(conv_u, conv_bc))

    # gated RMSNorm (the Mamba-2 norm before out_proj)
    yz = y.float() * F.silu(z.float())
    var = torch.mean(yz * yz, dim=-1, keepdim=True)
    yz = yz * torch.rsqrt(var + 1e-6) * p["norm_scale"].float()
    out = lin("out_proj", yz.to(x.dtype))
    return out, new_state, new_st


def init_mamba2_cache(cfg: ModelConfig, batch: int, *,
                      lead: tuple[int, ...] = (), dtype=torch.float32,
                      device=None) -> MambaState:
    ssm = cfg.ssm
    di = ssm.expand * cfg.d_model
    nh = di // ssm.head_dim
    return MambaState(
        ssm=torch.zeros((*lead, batch, nh, ssm.head_dim, ssm.d_state),
                        dtype=torch.float32, device=device),
        conv=(torch.zeros((*lead, batch, ssm.d_conv - 1, di), dtype=dtype,
                          device=device),
              torch.zeros((*lead, batch, ssm.d_conv - 1, 2 * ssm.d_state),
                          dtype=dtype, device=device)))
