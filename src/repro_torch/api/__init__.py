"""Declarative SubspacePlan API (port of ``repro.api``): one plan ->
init / apply, shared by every linear site.

    from repro_torch import api

    plan = api.install(api.resolve(cfg))   # decide subspaces ONCE
    model = init_lm(cfg, device="cuda")    # plan-driven layouts
    plan = api.resolve(cfg, calibration=dense_model)   # epsilon ranks

``api.bridge`` carries parameter trees across from the JAX package, and
``api.convert`` factorizes, densifies and quantizes them and restores
plan-bearing checkpoints.
"""
from repro_torch.api import bind, convert, plan
from repro_torch.api.plan import (
    LinearSpec,
    SubspacePlan,
    collect_linear_weights,
    install,
    installed,
    plan_of,
    resolve,
    resolve_linear_spec,
    role_treated,
    uninstall,
)

__all__ = [
    "LinearSpec",
    "SubspacePlan",
    "bind",
    "collect_linear_weights",
    "convert",
    "install",
    "installed",
    "plan",
    "plan_of",
    "resolve",
    "resolve_linear_spec",
    "role_treated",
    "uninstall",
]
