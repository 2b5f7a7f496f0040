"""Per-tenant adapter trees: init, merge, stack, gather. Port of
``repro.tenancy.adapter``.

An *adapter tree* mirrors a model's param tree but carries only the
additive delta pairs of the plan's adapter-stamped sites
(``SubspacePlan.with_adapter``): each stamped linear dict maps to
``{"La": (*stack, O, K_a), "Ra": (*stack, K_a, I)}`` with the base
leaves' leading stack dims (a layer group's ``repeat``). Everything else
is a structural placeholder (``{}``, or a list of the same length), so
the tree has the reference's structure exactly, its on-disk spec
(``tenancy.store``) included, and a merge is a lockstep walk.

* TRAIN: ``init_adapters`` (La zeros, so the first forward is the base's
  exactly; Ra small normal draws from a ``torch.Generator``),
  ``merge_adapters`` inside the loss, only the adapter tree trains
  (``tenancy.finetune``).
* SERVE: ``make_banks`` / ``stack_adapters`` pile tenants' trees into
  banks whose tenant axis sits at ``ndim - 3`` (after the stack dims,
  before (O, K_a)); row 0 is the all-zeros identity of adapter-less slots.
  ``gather_rows`` selects one row per slot, eagerly, as the reference's
  jitted step does. The serve engine instead serves a ``SlotAdapters``
  view: each stamped site of each layer holds ``BankRows``, which
  ``bind.adapter_delta`` gathers when the site runs, so no more than one
  site's rows exist at a time (a whole qwen2-0.5b tree is 455 MB a
  tenant in f32).

The delta itself is ``api.bind.adapter_delta``; this module only builds
and walks the trees, keyed by the ``LEAF_TO_SPEC`` that ``api.convert``
walks with. Adapters are f32; a model of another dtype is refused
(``merge_adapters``), as the reference cannot run one (ROADMAP.md queue
3).
"""
from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from repro_torch.api.bind import is_linear_params, linear_dims
from repro_torch.api.plan import LEAF_TO_SPEC, SubspacePlan

_DICTS = (Mapping, nn.ModuleDict, nn.ParameterDict)
_LISTS = (list, nn.ModuleList)


def _walk_sites(tree, plan: SubspacePlan, fn):
    """A tree PARALLEL to ``tree``: ``fn(spec, linear_dict)`` at every
    adapter-stamped site, placeholders ({} or same-length lists)
    everywhere else, as the reference builds it."""
    def walk(node):
        if isinstance(node, _DICTS):
            out = {}
            for key, v in node.items():
                if key in LEAF_TO_SPEC and is_linear_params(v):
                    name, role = LEAF_TO_SPEC[key]
                    o, i = linear_dims(v)
                    spec = plan.linear(name, i, o, role=role)
                    if spec.adapter:
                        out[key] = fn(spec, v)
                else:
                    out[key] = walk(v)
            return out
        if isinstance(node, _LISTS):
            return [walk(v) for v in node]
        if isinstance(node, tuple):
            return tuple(walk(v) for v in node)
        return {}

    return walk(tree.tree() if hasattr(tree, "tree") else tree)


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of nested dicts/lists/tuples (nn
    containers read as dicts and lists), placeholders kept; ``rest``
    trees of the same structure give ``fn`` their leaves too."""
    if isinstance(tree, _DICTS):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, _LISTS):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v, *(r[i] for r in rest))
                     for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensor leaves of a tree, in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def _base_leaf(p) -> torch.Tensor:
    """A linear dict's base weight leaf: its stack dims, device, dtype."""
    return p["L"] if "L" in p else p["w"]


def init_adapters(params, plan: SubspacePlan, *, generator: torch.Generator,
                  dtype=torch.float32, ra_scale: float = 0.02):
    """A fresh adapter tree for ``params`` (a model or its tree) under an
    adapter-stamped plan: La ZEROS, so the first forward is exactly the
    base's, and Ra ~ N(0, ra_scale^2), so the first gradient reaches La.
    Draws in site order on the generator's device, then moves each site's
    pair to its base leaves' device."""
    if not plan.has_adapters:
        raise ValueError("plan carries no adapter stamps; call "
                         "plan.with_adapter(rank_frac) first")

    def one(spec, p):
        leaf, ka = _base_leaf(p), spec.adapter
        stack, dev = leaf.shape[:-2], leaf.device
        ra = torch.randn(*stack, ka, spec.in_dim, generator=generator,
                         device=generator.device) * ra_scale
        return {"La": torch.zeros(*stack, spec.out_dim, ka, dtype=dtype,
                                  device=dev),
                "Ra": ra.to(device=dev, dtype=dtype)}

    return _walk_sites(params, plan, one)


def zero_adapters(params, plan: SubspacePlan, *, dtype=torch.float32):
    """The all-zeros adapter tree (the identity delta), on the base
    leaves' devices."""
    def one(spec, p):
        leaf = _base_leaf(p)
        stack, dev = leaf.shape[:-2], leaf.device
        return {"La": torch.zeros(*stack, spec.out_dim, spec.adapter,
                                  dtype=dtype, device=dev),
                "Ra": torch.zeros(*stack, spec.adapter, spec.in_dim,
                                  dtype=dtype, device=dev)}

    return _walk_sites(params, plan, one)


def check_dtype(base: torch.dtype, adapter: torch.dtype) -> None:
    """Raise ``ValueError`` where a model of dtype ``base`` would run
    adapters of dtype ``adapter``: the reference cannot (its layer scan
    refuses the f32 carry the delta makes of a bf16 stream), so the port
    refuses it too."""
    if base != adapter:
        raise ValueError(
            f"adapter dtype {adapter} clashes with the model's {base}: the "
            "reference cannot run f32 adapters on a model of another dtype "
            "(its layer scan refuses the f32 carry), so neither does the "
            "port; serve and train adapters on an f32 model (ROADMAP.md "
            "queue 3)")


def _check_site(p, a) -> None:
    base = _base_leaf(p).dtype
    la = a["La"].bank if isinstance(a["La"], BankRows) else a["La"]
    if base != torch.int8:          # an int8 site's model dtype is its x's
        check_dtype(base, la.dtype)


def _frozen_param(t) -> nn.Parameter:
    return t if isinstance(t, nn.Parameter) else nn.Parameter(
        t, requires_grad=False)


def _merge_plain(p, a):
    """The reference's lockstep walk over a plain tree (nn containers
    read as dicts and lists): nested dicts/lists holding the base leaves,
    each stamped linear dict with the adapter pair beside them."""
    if not isinstance(a, (dict, list, tuple)) or not a:
        return p
    if isinstance(p, _DICTS):
        if is_linear_params(p) and isinstance(a, dict) and "La" in a:
            _check_site(p, a)
            out = dict(p.items())
            out.update(a)
            return out
        return {k: _merge_plain(v, a.get(k) if isinstance(a, dict) else None)
                for k, v in p.items()}
    if isinstance(p, (_LISTS, tuple)):
        t = [_merge_plain(v, a[i] if i < len(a) else None)
             for i, v in enumerate(p)]
        return tuple(t) if isinstance(p, tuple) else t
    return p


def _merge_modules(node, a):
    """The lockstep walk over nn containers: new containers sharing every
    base module and leaf, each stamped linear ``ParameterDict`` rebuilt
    with the adapter pair beside its base leaves."""
    if not isinstance(a, (dict, list)) or not a:
        return node
    if isinstance(node, nn.ModuleList):
        return nn.ModuleList(_merge_modules(v, a[i] if i < len(a) else None)
                             for i, v in enumerate(node))
    if isinstance(node, nn.ParameterDict) and is_linear_params(node) \
            and "La" in a:
        out = nn.ParameterDict(dict(node.items()))
        for k, v in a.items():
            out[k] = _frozen_param(v)
        return out
    if isinstance(node, nn.ModuleDict):
        return nn.ModuleDict({k: _merge_modules(v, a.get(k))
                              for k, v in node.items()})
    return node


def merge_adapters(params, adapters):
    """``params`` with each stamped site's adapter pair beside its base
    leaves, so ``bind.apply`` adds the delta. ``adapters``: an adapter tree
    (single-tenant leaves (*stack, O, K_a), or gathered per-slot rows
    (*stack, B, O, K_a)), or a module holding one (``.tree()``).

    A ``LanguageModel`` gives a ``LanguageModel`` that shares every base
    module and leaf, as ``convert.draft_view`` does; the adapter leaves
    join as ``nn.Parameter``s (the trainable ones as they are, tensors as
    frozen ones over their storage). A plain tree gives nested dicts and
    lists. A base of another dtype than the adapters raises
    ``ValueError``."""
    from repro_torch.models.lm import LanguageModel, _dtype

    if hasattr(adapters, "tree"):
        adapters = adapters.tree()
    adapters = tree_map(lambda t: t, adapters)     # nn containers -> plain
    if not isinstance(params, LanguageModel):
        tree = params.tree() if hasattr(params, "tree") else params
        return _merge_plain(tree, adapters)
    leaves = tree_leaves(adapters)
    if leaves:
        check_dtype(_dtype(params.cfg.dtype), leaves[0].dtype)
    shared = getattr(params, "shared_attn", None)
    if shared is not None:
        shared = _merge_modules(shared, adapters.get("shared_attn"))
    return LanguageModel(params.cfg, params.embed, params.final_norm,
                         _merge_modules(params.groups, adapters["groups"]),
                         getattr(params, "lm_head", None), shared)


def stack_adapters(trees):
    """Pile tenants' adapter trees (one structure) into banks: every leaf
    gains a tenant axis at ``ndim - 2`` of the input leaf, after the stack
    dims and before (O, K_a) / (K_a, I), so ``gather_rows`` always finds it
    at ``ndim - 3``."""
    if not trees:
        raise ValueError("stack_adapters needs at least one tree")
    return tree_map(lambda *ls: torch.stack(ls, dim=ls[0].ndim - 2), *trees)


def gather_rows(banks, ix: torch.Tensor):
    """Per-slot bank rows: ``ix`` (B,) row indices -> a tree of
    (*stack, B, O, K_a) leaves, one tenant's factors per batch row (the
    reference's eager gather; the engine gathers per site through
    ``SlotAdapters``)."""
    return tree_map(lambda b: b.index_select(b.ndim - 3, ix.to(b.device)),
                    banks)


def set_bank_row(banks, row: int, tree):
    """Write one tenant's adapter tree into bank row ``row`` IN PLACE,
    without grad: the banks keep their storage, so every view of them
    (``SlotAdapters``) stays valid. Returns ``banks``."""
    def put(b, h):
        b[..., row, :, :].copy_(h)

    with torch.no_grad():
        tree_map(put, banks, tree)
    return banks


def make_banks(template, capacity: int, *, device=None):
    """Zero f32 banks of ``capacity`` tenants PLUS the identity row 0,
    shaped from a single-tenant ``template``, on ``device`` (default the
    template's)."""
    def one(h):
        return torch.zeros(*h.shape[:-2], capacity + 1, *h.shape[-2:],
                           dtype=torch.float32,
                           device=h.device if device is None else device)

    return tree_map(one, template)


def adapter_site_ranks(plan: SubspacePlan) -> dict[str, int]:
    """{site name: K_a} for every adapter-stamped site of the plan."""
    return {s.name: s.adapter for s in plan.specs if s.adapter}


class BankRows:
    """One bank leaf (*stack, T, O, K_a) and the holder of the engine's
    per-slot rows (``slots.ix``, (B,)): indexing slices the stack (a
    layer), ``rows()`` gathers (B, O, K_a) for the current rows.
    ``bind.adapter_delta`` calls ``rows()`` when the site runs."""

    __slots__ = ("bank", "slots")

    def __init__(self, bank: torch.Tensor, slots):
        self.bank, self.slots = bank, slots

    def __getitem__(self, j) -> "BankRows":
        return BankRows(self.bank[j], self.slots)

    def rows(self) -> torch.Tensor:
        return self.bank.index_select(self.bank.ndim - 3, self.slots.ix)


class SlotAdapters:
    """A ``LanguageModel`` served with per-slot tenant rows: ``lm_*`` take
    it as they take the model. Its layer views are the model's with
    ``BankRows`` beside each stamped site's base leaves, built once (the
    banks are written in place, never replaced); ``ix`` (B,) picks each
    batch row's bank row before a call (0 = no tenant)."""

    def __init__(self, model, banks):
        self.cfg = model.cfg
        self.embed, self.final_norm = model.embed, model.final_norm
        self.lm_head = getattr(model, "lm_head", None)
        self.ix: torch.Tensor | None = None
        rows = tree_map(lambda b: BankRows(b, self), banks)
        shared = getattr(model, "shared_attn", None)
        self.shared_attn = (None if shared is None else
                            _merge_plain(shared, rows.get("shared_attn")))
        with torch.no_grad():
            base = model.layer_views()
        self._views = [
            [[_merge_plain(base[gi][pi][j], _index(rows["groups"][gi][pi], j))
              for j in range(len(base[gi][pi]))]
             for pi in range(len(base[gi]))]
            for gi in range(len(base))]

    def layer_views(self) -> list:
        return self._views


def _index(node, j: int):
    """Layer ``j`` of an adapter tree whose leaves are ``BankRows``."""
    if isinstance(node, dict):
        return {k: _index(v, j) for k, v in node.items()}
    if isinstance(node, list):
        return [_index(v, j) for v in node]
    return node[j]
