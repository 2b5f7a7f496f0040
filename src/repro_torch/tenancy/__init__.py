"""Multi-tenant subspace adapters. Port of ``repro.tenancy``.

One resident base, many per-user rank-K_a deltas: train them against the
frozen base (:mod:`repro_torch.tenancy.finetune`), register them
content-addressed on disk (:mod:`repro_torch.tenancy.store`, the
reference's format), and hot-swap them through a device-resident LRU bank
(:mod:`repro_torch.tenancy.resident`) whose rows the serve engine gathers
per slot and per site. Tree plumbing is :mod:`repro_torch.tenancy.adapter`.

``resident`` is imported lazily, as in the reference: the serve engine
imports :mod:`repro_torch.tenancy.adapter`, and an eager import here would
close the cycle.
"""
from __future__ import annotations

from repro_torch.tenancy import adapter, finetune, store
from repro_torch.tenancy.adapter import (adapter_site_ranks, gather_rows,
                                         init_adapters, merge_adapters,
                                         stack_adapters, zero_adapters)
from repro_torch.tenancy.finetune import (adapter_loss_fn, eval_ce,
                                          finetune_adapters)
from repro_torch.tenancy.store import AdapterStore, plan_sha

__all__ = [
    "AdapterStore", "ResidentAdapters", "adapter", "adapter_loss_fn",
    "adapter_site_ranks", "eval_ce", "finetune", "finetune_adapters",
    "gather_rows", "init_adapters", "merge_adapters", "plan_sha",
    "resident", "stack_adapters", "store", "zero_adapters",
]


def __getattr__(name):
    if name in ("resident", "ResidentAdapters"):
        import importlib
        resident = importlib.import_module("repro_torch.tenancy.resident")
        return resident if name == "resident" else resident.ResidentAdapters
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
