"""Model-level dense <-> factored <-> int8 conversion and plan-bearing
checkpoints. Port of ``repro.api.convert``.

``factorize(dense_params, plan)`` rewrites every plan-covered linear into
its planned layout (truncated SVD per spec), ``densify`` is the inverse,
and ``quantize(params, plan)`` packs the quant-stamped sites of a
deployment plan (``plan.quantized("int8")``) to int8 with per-channel f32
scales, the last conversion before serving.

Param trees here are the reference's nested dicts and lists, with tensors
for leaves; a ``LanguageModel`` is taken as its tree (``model.tree()``).
Every function returns a new nested dict/list; ``api.bridge
.from_reference`` turns one back into a model.

The plan rides in the checkpoint's manifest, so ``load_checkpoint(dir)``
rebuilds (params, plan) with no config in hand.

``draft_view`` (speculative decoding) is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.api.bind import (
    is_linear_params,
    is_quantized,
    linear_dims,
    linear_layout,
)
from repro_torch.api.plan import LEAF_TO_SPEC, LinearSpec, SubspacePlan
from repro_torch.checkpoint.ckpt import (
    as_tree,
    latest_step,
    load_manifest,
    restore_untyped,
)


def _svd_factors(w: torch.Tensor, k: int):
    """W (..., O, I) -> (L (..., O, K), R (..., K, I)) by truncated SVD in
    f32, batched over leading stack dims; no autograd history (a trained
    model's W may require grad)."""
    u, s, vt = torch.linalg.svd(w.detach().float(), full_matrices=False)
    L = u[..., :, :k] * s[..., None, :k]
    R = vt[..., :k, :]
    return L.to(w.dtype), R.to(w.dtype)


def factorize_linear(w: torch.Tensor, spec: LinearSpec, bias=None) -> dict:
    """One dense weight -> the param layout its spec dictates."""
    p: dict = {}
    if spec.mode == "factored":
        p["L"], p["R"] = _svd_factors(w, spec.rank)
    elif spec.mode == "project":
        p["w"] = w
        p["L"], p["R"] = _svd_factors(w, spec.rank)
    else:
        p["w"] = w
    if bias is not None:
        p["b"] = bias
    return p


def densify_linear(p, spec: LinearSpec) -> dict:
    """Inverse of :func:`factorize_linear` (lossy by the rank truncation
    for factored sites, exact for project and dense; int8 sites dequantize
    first)."""
    if is_quantized(p):
        from repro_torch.quant.quantize import dequantize_linear
        p = dequantize_linear(p, spec)
    out: dict = {}
    if linear_layout(p) == "factored":
        out["w"] = torch.matmul(p["L"], p["R"]).to(p["L"].dtype)
    else:
        out["w"] = p["w"]
    if p.get("b") is not None:
        out["b"] = p["b"]
    return out


def _walk_linears(tree, plan: SubspacePlan, fn):
    """Apply fn(spec, linear_dict) to every plan-covered linear dict of a
    param tree; everything else (norms, embeddings) passes through."""
    def walk(node):
        if isinstance(node, dict):
            out = {}
            for key, v in node.items():
                if key in LEAF_TO_SPEC and is_linear_params(v):
                    name, role = LEAF_TO_SPEC[key]
                    o, i = linear_dims(v)
                    out[key] = fn(plan.linear(name, i, o, role=role), v)
                else:
                    out[key] = walk(v)
            return out
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, tuple):
            return tuple(walk(v) for v in node)
        return node

    return walk(as_tree(tree))


def factorize(dense_params, plan: SubspacePlan):
    """Dense param tree -> the plan's layouts (factored {L, R}, project
    {w, L, R}, dense passthrough)."""
    def one(spec, p):
        if linear_layout(p) != "dense" or is_quantized(p):
            raise ValueError(f"site {spec.name} already factored or "
                             "quantized; factorize expects a dense f32 tree")
        return factorize_linear(p["w"], spec, bias=p.get("b"))

    return _walk_linears(dense_params, plan, one)


def densify(params, plan: SubspacePlan):
    """Any plan-layout param tree -> fully dense ({"w"} everywhere)."""
    return _walk_linears(params, plan, lambda spec, p: densify_linear(p, spec))


def quantize(params, plan: SubspacePlan):
    """Pack every quant-stamped site of the deployment plan
    (``plan.quantized("int8")``) to int8 + per-channel f32 scales; sites
    whose spec carries no ``quant`` pass through. Save the result with
    ``plan=plan`` and the checkpoint serves through
    ``ServeEngine.from_checkpoint`` with nothing else in hand."""
    from repro_torch.quant.quantize import quantize_linear

    return _walk_linears(params, plan,
                         lambda spec, p: quantize_linear(p, spec))


def dequantize(params, plan: SubspacePlan):
    """Inverse of :func:`quantize` (lossy by the quantization error)."""
    from repro_torch.quant.quantize import dequantize_linear

    return _walk_linears(params, plan,
                         lambda spec, p: dequantize_linear(p, spec))


def load_plan(ckpt_dir: str, step: int | None = None) -> SubspacePlan | None:
    """The plan stored in a checkpoint's manifest, or None."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        return None
    m = load_manifest(ckpt_dir, step)
    return SubspacePlan.from_json(m["plan"]) if m.get("plan") else None


def load_checkpoint(ckpt_dir: str, step: int | None = None):
    """Template-free restore of a plan-bearing checkpoint: (params, plan,
    step), params a nested dict/list of CPU tensors. A ``"train_state"``
    checkpoint gives its first field, the params."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    m = load_manifest(ckpt_dir, step)
    tree = restore_untyped(ckpt_dir, step)
    if m.get("label") == "train_state":
        tree = tree[0]          # TrainState.params
    plan = SubspacePlan.from_json(m["plan"]) if m.get("plan") else None
    return tree, plan, step


def export_dense(ckpt_dir: str, step: int | None = None):
    """(dense_params, plan, step) from a plan-bearing checkpoint."""
    params, plan, step = load_checkpoint(ckpt_dir, step)
    if plan is None:
        raise ValueError(f"checkpoint at {ckpt_dir} carries no plan; "
                         "cannot infer factored sites")
    return densify(params, plan), plan, step
