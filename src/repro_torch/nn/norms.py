"""RMSNorm / LayerNorm (fp32 statistics, cast back to activation dtype).
Port of ``repro.nn.norms``."""
from __future__ import annotations

import torch
from torch import nn


def init_rmsnorm(dim: int, *, lead: tuple[int, ...] = (), dtype=torch.float32,
                 device=None) -> nn.ParameterDict:
    return nn.ParameterDict({"scale": nn.Parameter(
        torch.ones(*lead, dim, dtype=dtype, device=device),
        requires_grad=False)})


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def init_layernorm(dim: int, *, lead: tuple[int, ...] = (),
                   dtype=torch.float32, device=None) -> nn.ParameterDict:
    return nn.ParameterDict({
        "scale": nn.Parameter(torch.ones(*lead, dim, dtype=dtype,
                                         device=device), requires_grad=False),
        "bias": nn.Parameter(torch.zeros(*lead, dim, dtype=dtype,
                                         device=device), requires_grad=False)})


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def init_norm(kind: str, dim: int, **kw) -> nn.ParameterDict:
    return init_rmsnorm(dim, **kw) if kind == "rmsnorm" \
        else init_layernorm(dim, **kw)


def apply_norm(kind: str, p, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(p, x) if kind == "rmsnorm" else layernorm(p, x)
