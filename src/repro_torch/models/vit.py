"""Vision Transformer, the paper's primary experimental model. Port of
``repro.models.vit``.

Patch extraction is a host-side reshape (16 x 16 x 3 -> a 768 vector);
the model starts at the linear patch embedding, the layer granularity the
paper instruments. Bidirectional attention (``causal=False``) through the
flash kernel, pre-norm LayerNorm blocks with a GELU MLP, the class token's
final state through a linear head.

The parameter tree is the reference's, as modules: ``patch`` and ``head``
are ``ParameterDict``s, ``cls`` (1, 1, d) and ``pos`` (1, N + 1, d) plain
parameters, ``blocks`` one ``ModuleDict`` whose leaves carry the stacked
leading ``n_layers`` dim, ``final_norm`` a ``ParameterDict``. The
reference's ``lax.scan`` over the blocks is a Python loop over that dim.

``vit_forward``/``vit_loss`` take the model or a plain tree of the same
structure: ``core.project.project_forward_params`` hands them the tree
with each project site's (L, R) beside its W. ASI states mirror the
blocks, stacked on the same dim (``init_vit_states``).
"""
from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models.lm import _dtype, _layer_states, _stack_states
from repro_torch.nn.attention import (
    apply_attention,
    init_attention,
    init_attention_state,
)
from repro_torch.nn.mlp import apply_mlp, init_mlp, init_mlp_state
from repro_torch.nn.norms import apply_norm, init_norm
from repro_torch.utils.device import resolve_device


class VisionTransformer(nn.Module):
    """Parameter container with the reference's tree; the math lives in
    the module-level functions, as in the reference."""

    def __init__(self, cfg: ModelConfig, patch: nn.ParameterDict,
                 cls: nn.Parameter, pos: nn.Parameter, blocks: nn.ModuleDict,
                 final_norm: nn.ParameterDict, head: nn.ParameterDict):
        super().__init__()
        self.cfg = cfg
        self.patch = patch
        self.cls = cls
        self.pos = pos
        self.blocks = blocks
        self.final_norm = final_norm
        self.head = head

    def tree(self) -> dict:
        """The params as the reference's nested dict (of modules)."""
        return {"patch": self.patch, "cls": self.cls, "pos": self.pos,
                "blocks": self.blocks, "final_norm": self.final_norm,
                "head": self.head}


def init_vit(cfg: ModelConfig, n_classes: int, patch_dim: int = 768,
             n_patches: int = 196, *, dtype=None, device=None,
             generator: torch.Generator | None = None, seed: int = 0,
             plan=None) -> VisionTransformer:
    """Init params in the layouts the config's SubspacePlan dictates, drawn
    from ``generator`` (default: a CPU generator seeded with ``seed``) and
    moved to ``device`` (default CUDA; raises if absent). ``plan``: an
    explicitly resolved SubspacePlan, installed first so every linear init
    reads it. Same distributions as the reference; other numbers, since
    torch and JAX draw different streams."""
    if plan is not None:
        from repro_torch.api import install
        install(plan)
    dev = resolve_device(device)
    dtype = dtype or _dtype(cfg.dtype)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    d, n = cfg.d_model, cfg.n_layers
    kw = dict(lead=(n,), dtype=dtype, device=dev)

    def param(shape, std):
        t = torch.randn(*shape, generator=generator,
                        device=generator.device) * std
        return nn.Parameter(t.to(device=dev, dtype=dtype),
                            requires_grad=False)

    patch = nn.ParameterDict({"w": param((d, patch_dim), patch_dim ** -0.5)})
    pos = param((1, n_patches + 1, d), 0.02)
    blocks = nn.ModuleDict({
        "ln1": init_norm("layernorm", d, **kw),
        "attn": init_attention(cfg, generator=generator, **kw),
        "ln2": init_norm("layernorm", d, **kw),
        "mlp": init_mlp(cfg, generator=generator, **kw)})
    head = nn.ParameterDict({
        "w": param((n_classes, d), d ** -0.5),
        "b": nn.Parameter(torch.zeros(n_classes, dtype=dtype, device=dev),
                          requires_grad=False)})
    cls = nn.Parameter(torch.zeros(1, 1, d, dtype=dtype, device=dev),
                       requires_grad=False)
    return VisionTransformer(cfg, patch, cls, pos, blocks,
                             init_norm("layernorm", d, dtype=dtype,
                                       device=dev), head)


def init_vit_states(cfg: ModelConfig, batch: int, n_patches: int = 196, *,
                    dtype=torch.float32, device=None,
                    generator: torch.Generator | None = None,
                    seed: int = 0) -> dict:
    """ASI warm-start states of the blocks, {"attn": ..., "mlp": ...}
    with every factor stacked on a leading ``n_layers`` dim (the
    reference's vmapped ``block_state``); {} where the plan leaves a
    sublayer's activations dense."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    seq = n_patches + 1
    kw = dict(generator=generator, dtype=dtype, device=dev)
    return _stack_states([
        {"attn": init_attention_state(cfg, batch, seq, **kw),
         "mlp": init_mlp_state(cfg, batch, seq, **kw)}
        for _ in range(cfg.n_layers)])


def _tree(params):
    return params.tree() if isinstance(params, VisionTransformer) else params


def _layer(node, j: int):
    """Layer ``j`` of a stacked block tree: views of every leaf."""
    if isinstance(node, (Mapping, nn.ModuleDict, nn.ParameterDict)):
        return {k: _layer(v, j) for k, v in node.items()}
    return node[j]


def vit_forward(params, patches: torch.Tensor, cfg: ModelConfig, *,
                states=None, policy=None):
    """patches (B, N, patch_dim) -> (logits (B, n_classes) f32, new
    states or None). ``params``: the model or its tree."""
    if policy is not None:
        raise NotImplementedError("sharding policies arrive with the "
                                  "distributed slice (ROADMAP.md queue 1)")
    p = _tree(params)
    b = patches.shape[0]
    x = torch.matmul(patches.to(_dtype(cfg.dtype)), p["patch"]["w"].T)
    cls = p["cls"].expand(b, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + p["pos"]
    new_states = []
    for j in range(cfg.n_layers):
        lp = _layer(p["blocks"], j)
        st = None if states is None else _layer_states(states, j)
        a, _, ns_a = apply_attention(
            lp["attn"], apply_norm("layernorm", lp["ln1"], x), cfg,
            causal=False, states=None if st is None else st["attn"])
        x = x + a
        f, ns_m = apply_mlp(lp["mlp"], apply_norm("layernorm", lp["ln2"], x),
                            cfg, None if st is None else st["mlp"])
        x = x + f
        new_states.append({"attn": ns_a, "mlp": ns_m})
    x = apply_norm("layernorm", p["final_norm"], x)
    logits = torch.matmul(x[:, 0], p["head"]["w"].T) + p["head"]["b"]
    return logits.float(), (None if states is None
                            else _stack_states(new_states))


def vit_loss(params, batch: dict, cfg: ModelConfig, *, states=None,
             policy=None):
    """Cross-entropy of the class logits. batch: {patches (B, N, P),
    labels (B,)}. Returns (loss, (new_states, {"ce", "acc"}))."""
    logits, ns = vit_forward(params, batch["patches"], cfg, states=states,
                             policy=policy)
    labels = batch["labels"].long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    loss = (lse - gold).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, (ns, {"ce": loss, "acc": acc})
