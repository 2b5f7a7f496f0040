"""Weights carried across between the JAX package and the port.

``from_reference(tree, cfg, device)`` takes the reference's parameter
pytree as ``init_lm``, ``init_vit`` or ``init_encdec`` returns it (nested
dicts/lists; leaves numpy arrays, or anything ``numpy.asarray`` accepts)
and gives the port's :class:`~repro_torch.models.lm.LanguageModel`,
:class:`~repro_torch.models.vit.VisionTransformer` or
:class:`~repro_torch.models.encdec.EncoderDecoder` (by ``cfg.family``)
holding the same values. ``to_reference(model)`` gives the nested
dict/list of numpy arrays back.

``from_reference(..., trainable=True)`` gives leaves that require grad.
``state_from_reference`` / ``state_to_reference`` carry a reference
``TrainState`` across (params, the optimizer's moments and step, and the
ASI warm-start states of the ``wasi``/``asi`` methods), the weight carry
of the training parity tests. ``states_from_reference`` /
``states_to_reference`` carry ASI states alone: the reference's
``init_lm_states`` tree (groups, pattern positions, block dicts,
``ASIState(us=...)`` with a leading ``repeat`` dim), ``init_vit_states``
or ``init_encdec_states`` tree (``cross_attn`` an empty dict), identity
modes None on both sides, so the leaves keep JAX's flatten
order. ``wsi_from_reference`` carries project mode's ``{path:
WSIState(L, R)}`` dict in, whose paths the two packages spell alike;
``states_to_reference`` takes it out as it takes any state tree.

Every leaf is copied, torch tensors on the same device too, so the model
shares no storage with the tree it was built from. Leaves keep their
dtype (a Mamba-2 mixer's f32 ``A_log``, ``dt_bias`` and ``D`` beside bf16
weights included), int8 weights and their f32 scales (an int8
deployment tree, ``api.convert.quantize``) included; leaves may also be
torch tensors (``api.convert.load_checkpoint`` gives those). bfloat16 is
carried bit for bit through an int16 view, since numpy has no bfloat16 of
its own: ``from_reference`` reads a 2-byte array whose dtype is named
``bfloat16`` (the one JAX hands out) that way, and ``to_reference``
returns bfloat16 leaves as float32 arrays holding the same values
(bf16 -> f32 is exact). For float32 and int8 trees the round trip is
exact, dtype included.

The tree's layout is checked against the installed plan (``plan_of``):
factored sites carry L and R, and a site is int8-packed exactly where the
plan stamps ``quant``. An int8 tree cannot train: ``trainable=True``
raises.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.api import bind, plan_of
from repro_torch.config import ModelConfig
from repro_torch.models.lm import LanguageModel, needs_shared
from repro_torch.utils.device import resolve_device

_TOP = {"lm": ("embed", "final_norm", "groups"),
        "vit": ("patch", "cls", "pos", "blocks", "final_norm", "head"),
        "encdec": ("embed", "enc", "enc_norm", "dec", "final_norm")}


def _tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        # a copy, as numpy's is: training the model must not write into
        # the tree it came from (a dense model ``api.convert`` factorized)
        return a.detach().to(device, copy=True).contiguous()
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _module(node, device, trainable: bool = False):
    if not isinstance(node, (Mapping, list, tuple)):
        return nn.Parameter(_tensor(node, device), requires_grad=trainable)
    if isinstance(node, Mapping):
        if all(isinstance(v, (Mapping, list, tuple))
               for v in node.values()):
            return nn.ModuleDict({k: _module(v, device, trainable)
                                  for k, v in node.items()})
        # leaves, or leaves beside subtrees (a Mamba-2 mixer): a
        # ParameterDict holds both, the subtrees as submodules
        return nn.ParameterDict({k: _module(v, device, trainable)
                                 for k, v in node.items()})
    if isinstance(node, (list, tuple)):
        return nn.ModuleList(_module(v, device, trainable) for v in node)
    raise TypeError(f"unexpected node {type(node).__name__} in param tree")


def from_reference(tree: Mapping, cfg: ModelConfig, device=None, *,
                   trainable: bool = False):
    """The port's model holding the reference tree's values on ``device``
    (default CUDA; raises if absent); frozen leaves unless ``trainable``.
    A ``LanguageModel``, a ``VisionTransformer`` for the ``vit`` family,
    or an ``EncoderDecoder`` for ``encdec`` (stacks ``enc`` and ``dec``
    on their leading layer dims)."""
    dev = resolve_device(device)
    top = _TOP[cfg.family]
    if cfg.family == "lm" and needs_shared(cfg):
        top += ("shared_attn",)       # zamba2's shared attention block
    missing = [k for k in top if k not in tree]
    if missing:
        raise ValueError(f"not a {cfg.family} param tree: missing "
                         f"{missing}")
    extra = set(tree) - set(top) - ({"lm_head"} if cfg.family == "lm"
                                     else set())
    if extra:
        raise NotImplementedError(
            f"param tree keys {sorted(extra)} belong to model parts that "
            "are not ported yet")
    layers = {"vit": ("blocks",), "encdec": ("enc", "dec")}.get(
        cfg.family, ("groups",))
    if trainable and any(bind.is_quantized(p) for k in layers
                         for _, p in bind.iter_linear_dicts(tree[k])):
        raise ValueError("an int8-packed param tree is serve-only: int8 "
                         "leaves cannot require grad; dequantize it "
                         "(api.convert.dequantize) to train")
    if cfg.family in ("vit", "encdec"):
        from repro_torch.models.encdec import EncoderDecoder
        from repro_torch.models.vit import VisionTransformer

        mods = {k: _module(tree[k], dev, trainable) for k in top}
        for k in layers:
            bind.check_layout(mods[k], plan_of(cfg))
        cls = VisionTransformer if cfg.family == "vit" else EncoderDecoder
        return cls(cfg, **mods)
    groups = _module(tree["groups"], dev, trainable)
    if len(groups) != len(cfg.groups):
        raise ValueError(f"tree has {len(groups)} layer groups, config "
                         f"{cfg.name!r} has {len(cfg.groups)}")
    shared = (_module(tree["shared_attn"], dev, trainable)
              if "shared_attn" in tree else None)
    bind.check_layout(groups, plan_of(cfg))
    if shared is not None:
        bind.check_layout(shared, plan_of(cfg))
    return LanguageModel(
        cfg, _module(tree["embed"], dev, trainable),
        _module(tree["final_norm"], dev, trainable), groups,
        _module(tree["lm_head"], dev, trainable) if "lm_head" in tree
        else None, shared)


def _numpy(node):
    if isinstance(node, (Mapping, nn.ModuleDict, nn.ParameterDict)):
        return {k: _numpy(v) for k, v in node.items()}
    if isinstance(node, nn.ModuleList):
        return [_numpy(v) for v in node]
    t = node.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def to_reference(model) -> dict:
    """The reference's nested dict/list of numpy arrays."""
    return {k: _numpy(v) for k, v in model.tree().items()}


def _flat(node, prefix: str = "") -> dict:
    """{dotted name: leaf} of a nested dict/list, in the names
    ``named_parameters`` gives the same tree."""
    if isinstance(node, Mapping):
        items = node.items()
    elif isinstance(node, (list, tuple)):
        items = enumerate(node)
    else:
        return {prefix: node}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _nest(template, named: dict, prefix: str = ""):
    """The nested dict/list of ``template`` with the leaves of ``named``."""
    if isinstance(template, Mapping):
        return {k: _nest(v, named, f"{prefix}.{k}" if prefix else k)
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [_nest(v, named, f"{prefix}.{i}" if prefix else str(i))
                for i, v in enumerate(template)]
    return named[prefix]


def _moments(tree, model, device) -> dict | None:
    if tree is None:
        return None
    flat = _flat(tree)
    names = [n for n, _ in model.named_parameters()]
    if sorted(flat) != sorted(names):
        raise ValueError("optimizer moments do not match the param tree")
    return {n: _tensor(flat[n], device).float() for n in names}


def states_from_reference(tree, device=None):
    """ASI states of the reference (any NamedTuple with a ``us`` field is
    an ``ASIState``; leaves numpy or anything ``numpy.asarray`` takes) ->
    the port's, tensors on ``device`` (default CUDA; raises if absent)."""
    from repro_torch.core.asi import ASIState

    dev = resolve_device(device)

    def walk(node):
        if node is None:
            return None
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            if node._fields != ("us",):
                raise TypeError(f"unexpected {type(node).__name__} in ASI "
                                "states")
            return ASIState(us=tuple(walk(u) for u in node.us))
        if isinstance(node, tuple):
            return tuple(walk(v) for v in node)
        return _tensor(node, dev)

    return walk(tree)


def states_to_reference(states):
    """The port's ASI states with numpy leaves (bf16 as f32 holding the
    same values), structure and ``ASIState`` kept."""
    from repro_torch.models.lm import map_states

    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()

    return map_states(leaf, states)


def wsi_from_reference(wsi, device=None):
    """Project mode's ``{path: WSIState(L, R)}`` of the reference (leaves
    numpy or anything ``numpy.asarray`` takes) -> the port's, tensors on
    ``device`` (default CUDA; raises if absent); None stays None."""
    from repro_torch.core.wsi import WSIState

    if wsi is None:
        return None
    dev = resolve_device(device)
    return {path: WSIState(L=_tensor(st.L, dev), R=_tensor(st.R, dev))
            for path, st in wsi.items()}


def state_from_reference(rstate, cfg: ModelConfig, device=None):
    """A reference ``TrainState`` (arrays as numpy or anything
    ``numpy.asarray`` takes) -> the port's ``TrainState``: trainable params,
    the optimizer's moments, both step counts, the ASI states and project
    mode's WSI states. PowerSGD is not ported and must be None."""
    from repro_torch.optim import OptState
    from repro_torch.train.step import TrainState

    if rstate.psgd is not None:
        raise NotImplementedError("PowerSGD states are not ported yet "
                                  "(ROADMAP.md queue 1)")
    dev = resolve_device(device)
    model = from_reference(rstate.params, cfg, dev, trainable=True)
    ropt = rstate.opt
    opt = OptState(step=int(np.asarray(ropt.step)),
                   mu=_moments(ropt.mu, model, dev),
                   nu=_moments(ropt.nu, model, dev))
    return TrainState(params=model, opt=opt, step=int(np.asarray(rstate.step)),
                      asi=states_from_reference(rstate.asi, dev),
                      wsi=wsi_from_reference(rstate.wsi, dev))


def state_to_reference(state) -> dict:
    """{"params", "mu", "nu" (nested dict/list of numpy, or None), "asi"
    and "wsi" (``states_to_reference``, or None), "opt_step", "step"} of
    the port's ``TrainState``, in the reference's tree."""
    tree = to_reference(state.params)

    def moments(d):
        if d is None:
            return None
        return _nest(tree, {k: v.detach().cpu().numpy().copy()
                            for k, v in d.items()})

    return {"params": tree, "mu": moments(state.opt.mu),
            "nu": moments(state.opt.nu), "asi": states_to_reference(state.asi),
            "wsi": states_to_reference(state.wsi),
            "opt_step": state.opt.step, "step": state.step}
