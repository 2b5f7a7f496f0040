"""Symmetric per-channel absmax int8 quantization of linear-site weights.
Port of ``repro.quant.quantize``; the packs are identical to the
reference's, bit for bit.

For a weight whose LAST axis is the contraction axis (L (..., O, K),
R (..., K, I), dense w (..., O, I)) each row gets one f32 scale
``s = absmax / 127`` and packs to ``q = clip(round(w / s), -127, 127)``
int8, computed in f32 with round half to even; an all-zero row gets
scale 1. Leading stack dims quantize independently.

Quantized layouts (the scales ride next to the int8 payload):

    factored: {"L": int8 (..., O, K), "sL": f32 (..., O),
               "R": int8 (..., K, I), "sR": f32 (..., K) [, "b"]}
    dense:    {"w": int8 (..., O, I), "sW": f32 (..., O) [, "b"]}

Biases stay as they are. Project-mode sites keep their training layout.
Which sites pack is the plan's decision (``SubspacePlan.quantized``), the
tree walk is ``api.convert.quantize``, and dispatch stays ``api.bind``'s.
"""
from __future__ import annotations

import numpy as np
import torch

QMAX = 127.0

#: weight leaf key -> its scale key
SCALE_KEY = {"L": "sL", "R": "sR", "w": "sW"}


def quantize_tensor(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """w (..., C, D) -> (q int8 (..., C, D), scale f32 (..., C)):
    symmetric per-channel absmax over the last axis, on w's device."""
    wf = w.detach().float()
    absmax = wf.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / QMAX, torch.ones_like(absmax))
    q = torch.clamp(torch.round(wf / scale[..., None]), -QMAX, QMAX)
    return q.to(torch.int8), scale


def dequantize_tensor(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """f32 (..., C, D) = q * scale[..., None]. The serve path never does
    this to a whole weight: the kernels fold the scales into the sums."""
    return q.float() * scale[..., None]


def quantize_linear(p, spec) -> dict:
    """One linear param dict -> its quantized layout per ``spec.quant``.
    Passthrough when the spec carries no quant format or the layout cannot
    pack (project mode); raises on an already-quantized dict."""
    from repro_torch.api.bind import is_quantized, linear_layout

    if is_quantized(p):
        raise ValueError(f"site {spec.name} is already quantized")
    if spec.quant is None or linear_layout(p) == "project":
        return p
    if spec.quant != "int8":
        raise ValueError(f"unknown quant format {spec.quant!r}")
    out: dict = {}
    for key, v in p.items():
        if key in SCALE_KEY:
            out[key], out[SCALE_KEY[key]] = quantize_tensor(v)
        else:
            out[key] = v
    return out


def dequantize_linear(p, spec=None) -> dict:
    """Inverse of :func:`quantize_linear`: back to the f32 layout (lossy by
    the quantization error, which :func:`error_report` measures)."""
    from repro_torch.api.bind import is_quantized

    if not is_quantized(p):
        return p
    out = {}
    for key, v in p.items():
        if key in SCALE_KEY and SCALE_KEY[key] in p:
            out[key] = dequantize_tensor(v, p[SCALE_KEY[key]])
        elif key not in SCALE_KEY.values():
            out[key] = v
    return out


def _tensor_report(name: str, tensor_key: str, w) -> dict:
    q, s = quantize_tensor(w)
    back = dequantize_tensor(q, s).numpy()
    w = w.detach().float().numpy()
    denom = float(np.linalg.norm(w))
    rel = float(np.linalg.norm(w - back)) / max(denom, 1e-30)
    return {"site": name, "tensor": tensor_key,
            "rel_err": rel,
            "max_abs_err": float(np.max(np.abs(w - back))),
            "f32_bytes": int(w.size) * 4,
            "q8_bytes": int(w.size) + int(s.numel()) * 4}


def error_report(params, plan) -> list[dict]:
    """Per-site, per-tensor quantization error of ``params`` under the
    quant-stamped ``plan``: one record per weight leaf that would pack,
    {site, tensor, rel_err (Frobenius), max_abs_err, f32_bytes, q8_bytes}.
    ``params`` stay untouched. CPU tensors."""
    from repro_torch.api.bind import is_quantized, linear_layout
    from repro_torch.api.convert import _walk_linears

    records: list[dict] = []

    def one(spec, p):
        if spec.quant is not None and not is_quantized(p) \
                and linear_layout(p) != "project":
            for key in SCALE_KEY:
                if key in p:
                    records.append(_tensor_report(spec.name, key,
                                                  p[key].cpu()))
        return p

    _walk_linears(params, plan, one)
    return records


def format_error_report(records: list[dict]) -> str:
    """Markdown table over :func:`error_report` records plus a totals row."""
    lines = ["| site | tensor | rel err | max abs err | f32 bytes | q8 bytes |",
             "|---|---|---|---|---|---|"]
    for r in records:
        lines.append(f"| {r['site']} | {r['tensor']} | {r['rel_err']:.2e} "
                     f"| {r['max_abs_err']:.2e} | {r['f32_bytes']} "
                     f"| {r['q8_bytes']} |")
    f32 = sum(r["f32_bytes"] for r in records)
    q8 = sum(r["q8_bytes"] for r in records)
    if records:
        worst = max(r["rel_err"] for r in records)
        lines.append(f"| **total** | | worst {worst:.2e} | "
                     f"| {f32} | {q8} ({f32 / max(q8, 1):.2f}x smaller) |")
    return "\n".join(lines)
