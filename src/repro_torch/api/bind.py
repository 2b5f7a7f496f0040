"""Plan-driven linear init/apply, and the ONLY place allowed to look at raw
param-dict keys. The port of ``repro.api.bind``.

Param layouts are the reference's, one leaf per key:

    dense:    {"w": (O, I) [, "b"]}
    factored: {"L": (O, K), "R": (K, I) [, "b"]}
    project:  {"w": (O, I) [, "L", "R"] [, "b"]}  (factors injected per
              step by core/project.py, or carried by a converted
              checkpoint)

``init_params`` returns them as an ``nn.ParameterDict`` (optionally with
leading stack dims, the layer group's ``repeat``); ``apply`` takes any
mapping of tensors with those keys, a per-layer slice of the stack.

Ported: the dense, factored and project layouts with or without an ASI
state (``init_state``/``asi_state``: the ``wasi`` and ``asi`` methods
compress a site's input into Tucker factors and train through
``core.lowrank_linear``), their int8-packed deployment layouts
(quant/quantize.py), ``map_factored`` for the factored-mode refresh and
``inject_factors``/``extract_project_factors`` for project mode:

    factored int8: {"L": int8 (O, K), "sL": f32 (O,),
                    "R": int8 (K, I), "sR": f32 (K,) [, "b"]}
    dense int8:    {"w": int8 (O, I), "sW": f32 (O,) [, "b"]}

What each path saves for backward is the reference's: Tucker x~ plus the
sketch's last factor under ``wasi``, Tucker x~ under ``asi``, Tucker x~
plus L and R in project mode (x, L and R without a state), x plus the
dense sketch through the fused kernel for factored sites without a state,
dense x for vanilla. ``apply`` raises on tenant adapter pairs; those
arrive with a later slice (ROADMAP.md).

Parameters are built frozen (``requires_grad=False``): serving never
needs their gradients. Training turns them trainable in one place,
``train.step.make_train_state``.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import torch
from torch import nn

from repro_torch.api.plan import (
    LEAF_TO_SPEC,
    LinearSpec,
    _act_mode_ranks,
    role_treated,
)
from repro_torch.config import WasiConfig
from repro_torch.core.asi import ASIState, asi_init, asi_project, asi_step
from repro_torch.core.lowrank_linear import (
    asi_matmul,
    wasi_matmul,
    wasi_matmul_project,
    wsi_matmul_project_exact,
)


def init_params(spec: LinearSpec, *, generator: torch.Generator,
                lead: tuple[int, ...] = (), dtype=torch.float32,
                device=None, scale: float | None = None,
                bias: bool | None = None) -> nn.ParameterDict:
    """Random init for one linear site, in the layout its spec dictates.
    Same distributions as the reference (normal, std ``in_dim ** -0.5``
    split evenly over the two factors; zero bias); the numbers differ,
    since torch and JAX draw different streams. Draws on the generator's
    device (the CPU for a default generator), then moves to ``device``, so
    one seed gives the same weights on every device."""
    std = scale if scale is not None else spec.in_dim ** -0.5
    with_bias = spec.bias if bias is None else bias
    gen_dev = generator.device

    def normal(shape, s):
        t = torch.randn(*lead, *shape, generator=generator, device=gen_dev,
                        dtype=torch.float32) * s
        return nn.Parameter(t.to(device=device, dtype=dtype),
                            requires_grad=False)

    p = nn.ParameterDict()
    if spec.mode == "factored":
        k = spec.rank
        split = (std / k ** 0.5) ** 0.5
        p["L"] = normal((spec.out_dim, k), split)
        p["R"] = normal((k, spec.in_dim), split)
    else:
        p["w"] = normal((spec.out_dim, spec.in_dim), std)
    if with_bias:
        p["b"] = nn.Parameter(torch.zeros(*lead, spec.out_dim, dtype=dtype,
                                          device=device), requires_grad=False)
    return p


def asi_state(generator: torch.Generator, act_shape: Sequence[int],
              wasi: WasiConfig, dtype=torch.float32,
              device=None) -> ASIState | None:
    """Warm-start ASI state for a linear whose input activation has
    ``act_shape`` (B, N, I) or (B, H, W, I); None if compression is off."""
    if not wasi.compress_acts:
        return None
    ranks = _act_mode_ranks(tuple(act_shape), wasi)
    return asi_init(generator, act_shape, ranks, dtype, device)


def init_state(generator: torch.Generator, spec: LinearSpec,
               act_shape: Sequence[int], wasi: WasiConfig,
               dtype=torch.float32, device=None) -> ASIState | None:
    """Per-spec ASI warm-start state; None when this site's activations
    stay dense under the plan."""
    if not (wasi.compress_acts and role_treated(wasi, spec.role)):
        return None
    return asi_state(generator, act_shape, wasi, dtype, device)


def apply(spec: LinearSpec, p: Mapping[str, torch.Tensor], x: torch.Tensor,
          wasi: WasiConfig, state: ASIState | None = None):
    """Apply one linear site per its spec. Returns (y, new_state);
    new_state is None when no ASI state is involved. With a state, x is
    compressed (``asi_step``, or ``asi_project`` under
    ``wasi.asi.frozen``) on a detached copy without grad, and the site
    trains through ``wasi_matmul`` (factored) or ``asi_matmul`` (dense)."""
    new_state = None

    def compress(x_):
        with torch.no_grad():
            if wasi.asi.frozen:
                return asi_project(x_.detach(), state), state
            return asi_step(x_.detach(), state)

    if state is not None and is_quantized(p):
        raise ValueError(
            f"site {spec.name}: quantized params are serve-only; ASI "
            "states cannot thread through an int8 site")
    if "La" in p:
        raise NotImplementedError(
            f"site {spec.name}: tenant adapters are not ported yet")
    if is_quantized(p):
        # int8 deployment (plan.quantized + convert.quantize): the scales
        # fold into the products, no dequantized weight is ever formed
        if spec.quant is None:
            raise ValueError(
                f"site {spec.name}: params are quantized but the spec is "
                "not; serve under plan.quantized(...)")
        from repro_torch.kernels.ops import dense_matmul_q8, lowrank_matmul_q8
        if "L" in p:
            y = lowrank_matmul_q8(x, p["R"], p["sR"], p["L"], p["sL"])
        else:
            y = dense_matmul_q8(x, p["w"], p["sW"])
    elif spec.quant is not None:
        raise ValueError(
            f"site {spec.name}: plan stamps quant={spec.quant!r} but the "
            "params are not packed; run convert.quantize(params, plan)")
    elif spec.mode == "project" and "L" in p:
        # factored forward, dense-W gradient (paper Eq. 9-11); the factors
        # come from the per-step WSI injection or a converted checkpoint
        if state is not None:
            xt, new_state = compress(x)
            y = wasi_matmul_project(x, p["w"], p["L"], p["R"], xt)
        else:
            y = wsi_matmul_project_exact(x, p["w"], p["L"], p["R"])
    elif spec.mode == "factored":
        if state is not None:
            xt, new_state = compress(x)
            y = wasi_matmul(x, p["L"], p["R"], xt)
        else:
            # every factored site without a state resolves to the fused
            # route: the CUDA kernel on the card, its plain f32 version on
            # the CPU
            from repro_torch.kernels.ops import lowrank_matmul
            y = lowrank_matmul(x, p["R"], p["L"])
    elif state is not None:
        # dense weights (ASI baseline, or an un-injected project site)
        xt, new_state = compress(x)
        y = asi_matmul(x, p["w"], xt)
    else:
        y = torch.matmul(x, p["w"].T)
    if "b" in p:
        y = y + p["b"]
    return y, new_state


def linear_out_dim(p: Mapping[str, torch.Tensor]) -> int:
    return p["L"].shape[-2] if "L" in p else p["w"].shape[-2]


def is_linear_params(v) -> bool:
    """Does ``v`` look like one linear's param dict (any layout)?"""
    return isinstance(v, (Mapping, nn.ParameterDict)) and ("w" in v
                                                          or "L" in v)


def is_quantized(p) -> bool:
    """Is this linear dict in an int8-packed layout?"""
    return "sL" in p or "sW" in p


def linear_layout(p) -> str:
    """The subspace layout a param dict is in: "dense" | "factored" |
    "project"."""
    if "L" in p and "w" in p:
        return "project"
    if "L" in p:
        return "factored"
    return "dense"


def dense_weight(v):
    """The dense (..., O, I) weight of a dense-layout linear dict, else
    None (plan calibration reads dense trees only)."""
    if isinstance(v, (Mapping, nn.ParameterDict)) and "w" in v \
            and getattr(v["w"], "ndim", 0) >= 2:
        return v["w"]
    return None


def linear_dims(p) -> tuple[int, int]:
    """(out_dim, in_dim) of a linear param dict in any layout."""
    if linear_layout(p) == "factored":
        return int(p["L"].shape[-2]), int(p["R"].shape[-1])
    return int(p["w"].shape[-2]), int(p["w"].shape[-1])


def _children(tree):
    if isinstance(tree, (Mapping, nn.ModuleDict, nn.ParameterDict)):
        return list(tree.items())
    if isinstance(tree, (list, tuple, nn.ModuleList)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return []


def iter_linear_dicts(tree, prefix: str = ""):
    """Yield (path, linear_dict) for every linear param dict in a tree of
    dicts/lists or of ``ModuleDict``/``ModuleList``/``ParameterDict``."""
    if is_linear_params(tree):
        yield prefix, tree
        return
    for k, v in _children(tree):
        yield from iter_linear_dicts(v, f"{prefix}/{k}" if prefix else k)


def _layout_fits(p, mode: str) -> bool:
    """Does a linear dict's layout fit a site of ``mode``? Factored sites
    carry L and R and no w; dense sites w alone; project sites w, with or
    without the (L, R) a converted checkpoint carries."""
    layout = linear_layout(p)
    if mode == "project":
        return layout in ("project", "dense")
    return layout == ("factored" if mode == "factored" else "dense")


def check_layout(groups, plan) -> None:
    """Raise ``ValueError`` where a linear dict of the layer blocks does
    not have its plan site's layout (``_layout_fits``), or is int8-packed
    where the plan stamps no ``quant`` (or the other way round)."""
    for path, p in iter_linear_dicts(groups):
        spec = plan.spec(LEAF_TO_SPEC[path.split("/")[-1]][0])
        if not _layout_fits(p, spec.mode):
            raise ValueError(f"{path}: layout does not match the plan's "
                             f"{spec.mode} site {spec.name}")
        if is_quantized(p) != (spec.quant is not None):
            raise ValueError(
                f"{path}: params are {'' if is_quantized(p) else 'not '}"
                f"int8-packed but the plan's site {spec.name} has "
                f"quant={spec.quant!r}; serve int8 params under "
                "plan.quantized(...), packed by convert.quantize(params, "
                "plan)")


def linear_param_bytes(p) -> dict:
    """Storage of one linear dict: {"weights", "scales", "bias"} bytes."""
    out = {"weights": 0, "scales": 0, "bias": 0}
    for k, v in p.items():
        n = v.numel() * v.element_size()
        if k in ("w", "L", "R"):
            out["weights"] += n
        elif k in ("sW", "sL", "sR"):
            out["scales"] += n
        elif k == "b":
            out["bias"] += n
    return out


def map_factored(params, fn):
    """Apply ``fn(WSIState) -> WSIState`` to every {L, R} factor pair of a
    param tree (the factored-mode WSI refresh). Unlike the reference, which
    returns a new tree, the result is copied IN PLACE into the stacked
    leaves under ``torch.no_grad``: their storage, and with it every
    per-layer view and optimizer reference to them, stays the same. ``fn``
    sees the whole stack, leaves (repeat, O, K) and (repeat, K, I). int8
    factors (``sL``) are serve-frozen and left alone. Returns ``params``."""
    from repro_torch.core.wsi import WSIState

    with torch.no_grad():
        for _, p in iter_linear_dicts(params):
            if "L" in p and "R" in p and "w" not in p and "sL" not in p:
                st = fn(WSIState(L=p["L"], R=p["R"]))
                p["L"].copy_(st.L)
                p["R"].copy_(st.R)
    return params


def inject_factors(params, states: dict):
    """The param tree with (L, R) from ``states`` (a path-keyed
    ``WSIState`` dict, paths ending "/w") detached beside each dense W, so
    ``apply`` takes the project path. Returns plain nested dicts and lists
    holding the same leaves (W itself, not a copy, so its gradient
    reaches the parameter); the model is not changed."""
    def patch(node, prefix=""):
        if isinstance(node, (Mapping, nn.ModuleDict, nn.ParameterDict)):
            node = dict(node.items())
            st = states.get(prefix + "/w") if "w" in node else None
            if st is not None:
                node["L"] = st.L.detach()
                node["R"] = st.R.detach()
                return node
            return {k: patch(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple, nn.ModuleList)):
            return [patch(v, f"{prefix}/{i}" if prefix else str(i))
                    for i, v in enumerate(node)]
        return node

    return patch(params)


def extract_project_factors(params):
    """Split converted project-mode params {"w", "L", "R"} into a dense
    param tree plus a path-keyed {".../w": WSIState} dict (the keying of
    ``core.project.init_project_states``) for warm-starting the WSI
    states. A tree of nn containers is stripped IN PLACE (its L and R
    entries deleted) and returned; a plain tree is copied. Trees without
    carried factors return (params, {})."""
    from repro_torch.core.wsi import WSIState

    factors: dict = {}

    def strip(node, prefix=""):
        if isinstance(node, (Mapping, nn.ModuleDict, nn.ParameterDict)):
            if "w" in node and "L" in node and "R" in node:
                factors[prefix + "/w"] = WSIState(L=node["L"], R=node["R"])
                if isinstance(node, nn.ParameterDict):
                    del node["L"], node["R"]
                    return node
                return {k: v for k, v in node.items() if k not in ("L", "R")}
            kids = {k: strip(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in node.items()}
            return node if isinstance(node, nn.Module) else kids
        if isinstance(node, nn.ModuleList):
            for i, v in enumerate(node):
                strip(v, f"{prefix}/{i}" if prefix else str(i))
            return node
        if isinstance(node, (list, tuple)):
            t = [strip(v, f"{prefix}/{i}" if prefix else str(i))
                 for i, v in enumerate(node)]
            return t if isinstance(node, list) else tuple(t)
        return node

    tree = params.tree() if hasattr(params, "tree") else params
    stripped = strip(tree)
    if not factors:
        return params, {}
    return (params if hasattr(params, "tree") else stripped), factors
