"""MLP blocks: SwiGLU (LLaMA-style) and GELU. Port of ``repro.nn.mlp``.

Every projection ("mlp/gate", "mlp/up", "mlp/down") binds through the
SubspacePlan, so a factored site runs ``y = (x R^T) L^T`` through the fused
kernel on the card. Parameters are the reference's dict layout, with the
layer group's stack dims in front (``lead``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.api import bind, plan_of, role_treated
from repro_torch.config import ModelConfig


def init_mlp(cfg: ModelConfig, *, generator: torch.Generator,
             lead: tuple[int, ...] = (), d_in: int | None = None,
             d_ff: int | None = None, dtype=torch.float32,
             device=None) -> nn.ModuleDict:
    d = d_in or cfg.d_model
    f = d_ff or cfg.d_ff
    plan = plan_of(cfg)
    kw = dict(generator=generator, lead=lead, dtype=dtype, device=device)
    out = nn.ModuleDict()
    if cfg.mlp_act == "swiglu":
        out["gate"] = bind.init_params(plan.linear("mlp/gate", d, f), **kw)
    out["up"] = bind.init_params(plan.linear("mlp/up", d, f), **kw)
    out["down"] = bind.init_params(plan.linear("mlp/down", f, d),
                                   scale=f ** -0.5, **kw)
    return out


def init_mlp_state(cfg: ModelConfig, batch: int, seq: int, *,
                   generator: torch.Generator, d_in: int | None = None,
                   d_ff: int | None = None, dtype=torch.float32,
                   device=None) -> dict:
    """ASI warm-start states of the MLP's projections (the train path of
    the ``wasi``/``asi`` methods); {} when the plan leaves the MLP's
    activations dense."""
    w = cfg.wasi
    if not (w.compress_acts and role_treated(w, "mlp")):
        return {}
    d = d_in or cfg.d_model
    f = d_ff or cfg.d_ff
    kw = dict(dtype=dtype, device=device)
    st = {"up": bind.asi_state(generator, (batch, seq, d), w, **kw),
          "down": bind.asi_state(generator, (batch, seq, f), w, **kw)}
    if cfg.mlp_act == "swiglu":
        st["gate"] = bind.asi_state(generator, (batch, seq, d), w, **kw)
    return st


def apply_mlp(p, x: torch.Tensor, cfg: ModelConfig, states=None):
    """Returns (y, new_states): ``states`` with each site's refreshed ASI
    state, {} without states."""
    st = states or {}
    new_st = dict(st)
    plan = plan_of(cfg)

    def lin(name, inp):
        spec = plan.linear(f"mlp/{name}", inp.shape[-1],
                           bind.linear_out_dim(p[name]))
        y, ns = bind.apply(spec, p[name], inp, cfg.wasi, st.get(name))
        if ns is not None:
            new_st[name] = ns
        return y

    if "gate" in p:
        g = lin("gate", x)
        u = lin("up", x)
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        h = F.gelu(lin("up", x).float(), approximate="tanh").to(x.dtype)
    return lin("down", h), new_st
