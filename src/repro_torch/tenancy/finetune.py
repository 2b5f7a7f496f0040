"""Freeze-base adapter fine-tuning: train ONLY the per-site delta factors.
Port of ``repro.tenancy.finetune``.

A fine-tune is a rank-K_a pair per site, not a model copy. The trained
state is the adapter tree alone (``AdapterModule``, whose leaves require
grad); the base stays frozen as it was built (a base with trainable
leaves is read through frozen aliases of their storage, the reference's
``stop_gradient``), so the gradients, the optimizer state and the clip
all see adapter leaves only. It runs through the port's unmodified
``train.step.make_train_step``: its factored refresh walks the adapter
tree, which holds no (L, R) pair, and so does nothing, as in the
reference; it never reaches the merged model's base factors.

``finetune_adapters(base, plan, data, ...)`` is the library entry;
``launch/finetune_user.py`` the CLI from a checkpointed base into an
``AdapterStore``.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.config import TrainConfig
from repro_torch.models.lm import LanguageModel, lm_loss
from repro_torch.optim import init_optimizer
from repro_torch.tenancy.adapter import init_adapters, merge_adapters
from repro_torch.train.step import TrainState, make_train_step

#: the small-model SGD recipe that moves a rank-K adapter in tens of steps
DEFAULT_TCFG = TrainConfig(optimizer="sgd", lr=0.3, momentum=0.9,
                           weight_decay=0.0, schedule="constant",
                           warmup=0, clip_norm=2.0)


def _module(node):
    if isinstance(node, dict):
        if node and not any(isinstance(v, (dict, list)) for v in
                            node.values()):
            return nn.ParameterDict({
                k: nn.Parameter(v.detach().clone(), requires_grad=True)
                for k, v in node.items()})
        return nn.ModuleDict({k: _module(v) for k, v in node.items()})
    if isinstance(node, (list, tuple)):
        return nn.ModuleList(_module(v) for v in node)
    raise TypeError(f"unexpected node {type(node).__name__} in an adapter "
                    "tree")


class AdapterModule(nn.Module):
    """An adapter tree as the trainable state of ``make_train_step``: its
    leaves (copies of the tree's) require grad; ``tree()`` gives the
    nested containers, ``adapters()`` the plain tree of detached
    tensors."""

    def __init__(self, tree):
        super().__init__()
        self.root = _module(tree)

    def tree(self):
        return self.root

    def adapters(self):
        def plain(node):
            if isinstance(node, (nn.ModuleDict, nn.ParameterDict)):
                return {k: plain(v) for k, v in node.items()}
            if isinstance(node, nn.ModuleList):
                return [plain(v) for v in node]
            return node.detach()

        return plain(self.root)


def _frozen(model: LanguageModel) -> LanguageModel:
    """``model`` itself when no leaf requires grad, else a
    ``LanguageModel`` of frozen aliases of its leaves (same storage)."""
    if not any(p.requires_grad for p in model.parameters()):
        return model

    def walk(node):
        if isinstance(node, nn.ModuleList):
            return nn.ModuleList(walk(v) for v in node)
        if isinstance(node, nn.ModuleDict):
            return nn.ModuleDict({k: walk(v) for k, v in node.items()})
        if isinstance(node, nn.ParameterDict):
            return nn.ParameterDict({k: walk(v) for k, v in node.items()})
        return nn.Parameter(node.detach(), requires_grad=False)

    parts = {k: walk(v) for k, v in model.tree().items()}
    return LanguageModel(model.cfg, parts["embed"], parts["final_norm"],
                         parts["groups"], parts.get("lm_head"),
                         parts.get("shared_attn"))


def adapter_loss_fn(base_params, loss_fn=lm_loss):
    """A ``train.step``-shaped loss over the ADAPTER tree only: the frozen
    base is merged in before the forward, so differentiating it reaches
    the La/Ra leaves and nothing of the base."""
    frozen = _frozen(base_params)

    def fn(adapters, batch, cfg, *, states=None, policy=None):
        return loss_fn(merge_adapters(frozen, adapters), batch, cfg,
                       states=states, policy=policy)

    return fn


def _device(params) -> torch.device:
    return next(iter(params.parameters())).device


def _as_model(base, plan, device) -> LanguageModel:
    """A frozen ``LanguageModel`` of ``base``: the model itself, or a
    plain tree (numpy or tensors, a checkpoint's) carried in on
    ``device`` (default CUDA)."""
    if isinstance(base, LanguageModel):
        return base
    from repro_torch.api.bridge import from_reference
    return from_reference(base, plan.model, device)


def _on(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def finetune_adapters(base_params, plan, data, *, steps: int = 40,
                      tcfg: TrainConfig | None = None, seed: int = 0,
                      batch_size: int | None = None, adapters=None,
                      log_every: int = 0, device=None):
    """Train a fresh (or resumed) adapter tree against a frozen base.

    ``plan`` is adapter-stamped (``plan.with_adapter``) and NOT quantized:
    deltas train in f32 against the f32 master; store the adapter int8
    instead. ``data.batch(i, batch_size)`` gives step i's {tokens,
    labels}, moved to the base's device. Fresh adapters draw Ra from a
    ``torch.Generator`` on the base's device seeded with ``seed``.
    Returns (adapter tree, the last step's metrics as floats)."""
    if plan.is_quantized:
        raise ValueError("fine-tune against the f32 master, not an int8 "
                         "deployment view (store the adapter int8 instead)")
    base = _as_model(base_params, plan, device)
    dev = _device(base)
    cfg = plan.model
    tcfg = tcfg or dataclasses.replace(DEFAULT_TCFG, steps=steps)
    if adapters is None:
        adapters = init_adapters(
            base, plan, generator=torch.Generator(dev).manual_seed(seed))
    module = AdapterModule(adapters).to(dev)
    # no ASI, WSI or PowerSGD state belongs to a delta
    state = TrainState(params=module, opt=init_optimizer(
        dict(module.named_parameters()), tcfg))
    step = make_train_step(adapter_loss_fn(base), cfg, tcfg)
    metrics = {}
    for i in range(steps):
        state, metrics = step(state, _on(data.batch(i, batch_size), dev))
        if log_every and (i + 1) % log_every == 0:
            print(f"[finetune] step {i + 1}/{steps} "
                  f"ce={float(metrics['ce']):.4f}")
    return module.adapters(), {k: float(v) for k, v in metrics.items()}


def eval_ce(params, cfg, data, *, steps: int = 4,
            batch_size: int | None = None, start_step: int = 10_000) -> float:
    """Mean CE of ``params`` (a base or merged model) on held-out batches
    of ``data``, held out by step offset, since batches are a pure
    function of (seed, step)."""
    dev = _device(params)
    vals = []
    with torch.inference_mode():
        for i in range(steps):
            batch = _on(data.batch(start_step + i, batch_size), dev)
            vals.append(float(lm_loss(params, batch, cfg)[1][1]["ce"]))
    return sum(vals) / len(vals)
