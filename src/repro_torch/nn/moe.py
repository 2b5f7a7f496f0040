"""Mixture-of-Experts FFN: GShard-style capacity dispatch, top-k routing,
DeepSeek-style shared experts. Port of ``repro.nn.moe``.

Dispatch per token group (each batch row is one group of S tokens):
  router logits (S, E) in f32 -> softmax -> top-k (renormalised) ->
  capacity positions by a cumsum over the (S*k) choices, token-major ->
  kept tokens scattered into (E, C, d) -> each expert's FFN on its C
  slots of every group at once, (E, B*C, d) -> outputs gathered back,
  weighted by the gates.

A choice whose position reaches the capacity ``moe_capacity(S)`` is
DROPPED (standard GShard). The reference scatters a dropped choice's
zero to the slot (e, C - 1), which may belong to a kept token, and sums
into it; here the scatter is an accumulating ``index_put`` as well, so the
kept token's value survives (x + 0 = x). The gather masks the same rows.

Top-k ties: ``jax.lax.top_k`` takes the lower expert index first; a
stable descending sort gives the same order (``_top_k``), and with it the
same capacity positions.

Expert banks are per-expert stacks of one plan site each (``moe/w_gate``,
``moe/w_up``, ``moe/w_down``): factored {L (E, O, K), R (E, K, I)} or
dense {w (E, O, I)}, int8-packed {L, sL, R, sR} / {w, sW} with per-expert
per-channel scales, and project mode's {w, L, R}. Their products are
``torch.bmm`` pairs, as the reference leaves its einsums to XLA: no
kernel of the reference runs inside an expert. Factor banks keep exact
autodiff gradients (no ASI state: ``models.blocks.init_block_state``
gives an MoE layer its attention's states only). The router stays f32 in
a bf16 model.

Profiler ranges: ``moe_dispatch`` (router, top-k, positions, scatter),
``moe_experts`` (the routed and the shared experts' FFNs) and
``moe_combine`` (the gather and the gate-weighted sum).

The reference's sharding arguments (``policy``, ``shard(...)``) are not
ported: a non-None ``policy`` raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from repro_torch.api import bind, plan_of
from repro_torch.api.plan import LinearSpec
from repro_torch.config import ModelConfig


def _init_bank(spec: LinearSpec, n: int, *, generator: torch.Generator,
               lead: tuple[int, ...] = (), dtype=torch.float32, device=None,
               scale: float | None = None) -> nn.ParameterDict:
    """``n`` experts' weights at one site, stacked after ``lead``: the
    layout and distributions of ``bind.init_params`` (the reference's
    ``_init_bank``)."""
    return bind.init_params(spec, generator=generator, lead=(*lead, n),
                            dtype=dtype, device=device, scale=scale,
                            bias=False)


def _bank_matmul(spec: LinearSpec, p, x: torch.Tensor) -> torch.Tensor:
    """x (E, C, I) through per-expert weights -> (E, C, O), by the site's
    planned mode and the layout of ``p``."""
    if bind.is_quantized(p):
        # int8 deployment banks (convert.quantize): per-expert per-channel
        # scales fold into f32 products, as the reference's einsums do
        xf = x.float()
        if "L" in p:
            h = torch.bmm(xf, p["R"].float().mT) * p["sR"][:, None, :]
            y = torch.bmm(h, p["L"].float().mT) * p["sL"][:, None, :]
        else:
            y = torch.bmm(xf, p["w"].float().mT) * p["sW"][:, None, :]
        return y.to(x.dtype)
    if spec.mode == "factored":
        return torch.bmm(torch.bmm(x, p["R"].mT), p["L"].mT)
    if spec.mode == "project" and bind.linear_layout(p) == "project":
        from repro_torch.core.lowrank_linear import wsi_matmul_project_exact
        return wsi_matmul_project_exact(x, p["w"], p["L"], p["R"])
    return torch.bmm(x, p["w"].mT)


def _bank_specs(cfg: ModelConfig) -> dict[str, LinearSpec]:
    plan = plan_of(cfg)
    d = cfg.d_model
    f = cfg.moe.expert_d_ff or cfg.d_ff
    return {"w_gate": plan.linear("moe/w_gate", d, f),
            "w_up": plan.linear("moe/w_up", d, f),
            "w_down": plan.linear("moe/w_down", f, d)}


def init_moe(cfg: ModelConfig, *, generator: torch.Generator,
             lead: tuple[int, ...] = (), dtype=torch.float32,
             device=None) -> nn.ModuleDict:
    """{"router": {"w" f32 (E, d)}, "experts": {w_gate, w_up, w_down}
    [, "shared": the same at ``n_shared``]}, every leaf stacked after
    ``lead``. The router is f32 whatever ``dtype`` is."""
    m = cfg.moe
    d = cfg.d_model
    f = m.expert_d_ff or cfg.d_ff
    specs = _bank_specs(cfg)
    w = torch.randn(*lead, m.n_experts, d, generator=generator,
                    device=generator.device, dtype=torch.float32) * d ** -0.5
    out = nn.ModuleDict({"router": nn.ParameterDict({"w": nn.Parameter(
        w.to(device), requires_grad=False)})})
    kw = dict(generator=generator, lead=lead, dtype=dtype, device=device)
    banks = [("experts", m.n_experts)]
    if m.n_shared > 0:
        banks.append(("shared", m.n_shared))
    for name, n in banks:
        out[name] = nn.ModuleDict({
            "w_gate": _init_bank(specs["w_gate"], n, **kw),
            "w_up": _init_bank(specs["w_up"], n, **kw),
            "w_down": _init_bank(specs["w_down"], n, scale=f ** -0.5, **kw)})
    return out


def _expert_ffn(specs: dict, bank, x: torch.Tensor) -> torch.Tensor:
    g = _bank_matmul(specs["w_gate"], bank["w_gate"], x)
    u = _bank_matmul(specs["w_up"], bank["w_up"], x)
    h = F.silu(g.float()).to(x.dtype) * u
    return _bank_matmul(specs["w_down"], bank["w_down"], h)


def moe_capacity(group_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert and group: ``capacity_factor * S * k / E``
    truncated, rounded up to a multiple of 8, at least 8 (the reference's
    Python float arithmetic)."""
    m = cfg.moe
    c = int(m.capacity_factor * group_tokens * m.top_k / m.n_experts)
    return max(8, -(-c // 8) * 8)


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, largest
    first, ties to the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity_positions(top_e: torch.Tensor, cfg: ModelConfig):
    """(pos, fits) of top-k choices (B, S, k): each choice's position in
    its expert's slots, counted over the group's (S*k) choices
    token-major, and whether it is below ``moe_capacity(S)``."""
    m = cfg.moe
    b, s, k = top_e.shape
    flat = F.one_hot(top_e, m.n_experts).reshape(b, s * k, m.n_experts)
    pos = torch.cumsum(flat, dim=1) - flat
    pos = (pos * flat).sum(-1).reshape(b, s, k)
    return pos, pos < moe_capacity(s, cfg)


def route(p, x: torch.Tensor, cfg: ModelConfig):
    """The router's part of ``apply_moe``: (logits f32 (B, S, E), probs,
    top_p renormalised (B, S, k), top_e (B, S, k), pos (B, S, k) each
    choice's capacity position in its group, fits (B, S, k))."""
    logits = torch.matmul(x.float(), p["router"]["w"].float().mT)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, cfg.moe.top_k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return (logits, probs, top_p, top_e) + capacity_positions(top_e, cfg)


def apply_moe(p, x: torch.Tensor, cfg: ModelConfig, policy=None):
    """x (B, S, d) -> (y (B, S, d), aux f32 scalar). Routing in f32; each
    batch row is one capacity group."""
    if policy is not None:
        raise NotImplementedError("sharding policies arrive with the "
                                  "distributed slice (ROADMAP.md queue 1)")
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.n_experts, m.top_k
    cap = moe_capacity(s, cfg)
    specs = _bank_specs(cfg)
    with record_function("moe_dispatch"):
        _, probs, top_p, top_e, pos, fits = route(p, x, cfg)
        gate = top_p * fits
        e_idx = top_e.reshape(b, s * k)
        keep = fits.reshape(b, s * k)
        safe_c = torch.where(keep, pos.reshape(b, s * k), cap - 1)
        b_idx = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
        tok = torch.arange(s, device=x.device).repeat_interleave(k)
        vals = torch.where(keep[..., None], x[:, tok], 0).to(x.dtype)
        # expert-major (E, B, C, d): the experts' (E, B*C, d) without a
        # transpose; accumulate, so a dropped choice's zero adds nothing
        # to the kept token that owns slot C - 1
        disp = torch.zeros((e, b, cap, d), dtype=x.dtype,
                           device=x.device).index_put(
            (e_idx, b_idx, safe_c), vals, accumulate=True)
    with record_function("moe_experts"):
        out = _expert_ffn(specs, p["experts"], disp.reshape(e, b * cap, d))
    with record_function("moe_combine"):
        gathered = out.reshape(e, b, cap, d)[e_idx, b_idx, safe_c]
        gathered = torch.where(keep[..., None], gathered, 0)
        y = (gathered.reshape(b, s, k, d)
             * gate[..., None].to(out.dtype)).sum(dim=2)
    if m.n_shared > 0:
        with record_function("moe_experts"):
            xs = x.reshape(1, b * s, d).expand(m.n_shared, b * s, d)
            y = y + _expert_ffn(specs, p["shared"], xs).sum(0).reshape(
                b, s, d)
    # load-balancing aux loss (Switch-style, on the top-1 choice)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(top_e[..., 0], e).float().mean(dim=(0, 1))
    aux = e * torch.sum(me * ce)
    return y.to(x.dtype), aux
