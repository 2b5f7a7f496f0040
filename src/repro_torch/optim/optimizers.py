"""Optimizers written out from scratch, as in ``repro.optim.optimizers``:
SGD (+momentum), the paper's recipe, and AdamW (b1 0.9, b2 0.95, eps 1e-8)
for the scale configs, both with decoupled weight decay. f32 statistics
over params of any dtype.

Params, grads and moments are {name: tensor} dicts (the names of
``model.named_parameters()``). Unlike the reference, which returns new
trees, ``optimizer_update`` updates the params and the moments IN PLACE
under ``torch.no_grad`` (the new values are computed in f32 exactly as the
reference computes them, then copied in): the model's storage, and every
view of it, stays the same.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.config import TrainConfig


@dataclass
class OptState:
    step: int
    mu: dict | None     # first moment / momentum ({name: f32 tensor})
    nu: dict | None     # second moment (adamw only)


def init_optimizer(params: dict, cfg: TrainConfig) -> OptState:
    def zeros():
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}

    if cfg.optimizer == "sgd":
        return OptState(step=0, mu=zeros() if cfg.momentum > 0 else None,
                        nu=None)
    if cfg.optimizer == "adamw":
        return OptState(step=0, mu=zeros(), nu=zeros())
    raise ValueError(cfg.optimizer)


@torch.no_grad()
def optimizer_update(params: dict, grads: dict, state: OptState,
                     cfg: TrainConfig, lr) -> OptState:
    """One update of every param in ``params`` by its grad; returns the new
    state (whose moment dicts hold the same, updated tensors)."""
    step = state.step + 1
    wd = cfg.weight_decay
    dev = next(iter(params.values())).device if params else None
    lr = torch.as_tensor(lr, dtype=torch.float32).to(dev)

    if cfg.optimizer == "sgd":
        for k, p in params.items():
            g = grads[k].float()
            if cfg.momentum > 0:
                m = state.mu[k]
                m.copy_(cfg.momentum * m + g)
                u = m
            else:
                u = g
            pf = p.float()
            p.copy_((pf - lr * (u + wd * pf)).to(p.dtype))
        return OptState(step=step, mu=state.mu, nu=None)

    b1, b2, eps = 0.9, 0.95, 1e-8
    c1 = (1 - torch.tensor(b1, dtype=torch.float32) ** float(step)).to(dev)
    c2 = (1 - torch.tensor(b2, dtype=torch.float32) ** float(step)).to(dev)
    for k, p in params.items():
        g = grads[k].float()
        m, v = state.mu[k], state.nu[k]
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        mhat = m / c1
        vhat = v / c2
        pf = p.float()
        p.copy_((pf - lr * (mhat / (torch.sqrt(vhat) + eps)
                            + wd * pf)).to(p.dtype))
    return OptState(step=step, mu=state.mu, nu=state.nu)
