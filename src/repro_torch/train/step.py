"""Train-step assembly: model loss -> grads -> clip -> optimizer -> WSI
subspace maintenance. Port of ``repro.train.step`` on one device.

``make_train_step(loss_fn, cfg, tcfg)`` returns ``step(state, batch) ->
(state, metrics)``. The reference's step is a pure function of a state
pytree; here the state holds the model itself, whose leaves the optimizer
and the refresh update IN PLACE (``optimizer_update``,
``api.bind.map_factored``), and the returned state is the same model with
the new optimizer state and step count.

ASI states (the ``wasi``/``asi`` methods, ``make_train_state(asi_states=
...)``) ride in ``TrainState.asi``: the loss returns the refreshed states,
and under ``tcfg.microbatch > 1`` they carry from one microbatch to the
next, as the reference's scan carry does. They are new tensors each step,
not updated in place.

Factored WASI maintenance: after the update of step ``s``, when
``(s + 1) % refresh_every == 0``, every (L, R) pair is re-orthogonalized
(``core.wsi.wsi_refresh_factored``: one CholeskyQR per stacked site).

Not ported yet, and refused with ``NotImplementedError``: PowerSGD
(``tcfg.powersgd_rank``), the data-parallel step (``mesh=``,
``mean_fn=``) and project mode. See ROADMAP.md queue 1.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.api.bind import map_factored
from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.core.wsi import wsi_refresh_factored
from repro_torch.optim import (
    OptState,
    clip_by_global_norm,
    init_optimizer,
    make_schedule,
    optimizer_update,
)


class TrainState(NamedTuple):
    """The reference's ``TrainState`` without the project-mode and
    PowerSGD states, which are not ported."""
    params: Any         # the model (LanguageModel); leaves updated in place
    opt: OptState
    step: int = 0
    asi: Any = None     # ASI warm-start states (models.lm.init_lm_states)


def _refuse(what: str) -> None:
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md "
                              "queue 1)")


def make_train_state(model, cfg: ModelConfig, tcfg: TrainConfig, *,
                     asi_states=None, use_epsilon_ranks: bool = False,
                     dp_degree: int = 0) -> TrainState:
    """The state training starts from. Makes every leaf of ``model``
    trainable (``requires_grad_``): the serving entry points build them
    frozen, and this is where training turns them on."""
    if cfg.wasi.project:
        _refuse("project update mode")
    if tcfg.powersgd_rank > 0:
        _refuse("PowerSGD gradient compression")
    if dp_degree:
        _refuse("the data-parallel train state")
    if use_epsilon_ranks:
        _refuse("epsilon-calibrated ranks")
    from repro_torch.api.bind import is_quantized, iter_linear_dicts
    packed = [path for path, p in iter_linear_dicts(model.tree())
              if is_quantized(p)]
    if packed:
        raise ValueError(
            f"cannot train an int8-packed model ({len(packed)} packed "
            f"sites, first {packed[0]}): int8 deployment is serve-only; "
            "train the f32/bf16 params and quantize after "
            "(api.convert.quantize)")
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    return TrainState(params=model, opt=init_optimizer(params, tcfg),
                      asi=asi_states)


def value_and_grad(loss_fn, model, batch, cfg: ModelConfig, states=None):
    """(loss, metrics, grads, new_states) of one batch; ``states`` (ASI
    warm starts, or None) go into the loss and its refreshed states come
    out; grads a {name: tensor} dict in the params' dtypes (zeros for a
    leaf the loss does not reach, as ``jax.grad`` gives)."""
    params = dict(model.named_parameters())
    with torch.enable_grad():
        loss, (new_states, metrics) = loss_fn(model, batch, cfg,
                                              states=states)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), grads)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads, new_states)


def _microbatches(batch: dict, nm: int) -> list[dict]:
    return [{k: v.reshape(nm, v.shape[0] // nm, *v.shape[1:])[i]
             for k, v in batch.items()} for i in range(nm)]


def make_train_step(loss_fn, cfg: ModelConfig, tcfg: TrainConfig, *,
                    policy=None, mean_fn=None, mesh=None):
    """loss_fn(model, batch, cfg, states=...) -> (loss, (states, metrics)).

    Returns step(state, batch) -> (state, metrics). ``tcfg.microbatch > 1``
    accumulates f32 gradients over that many slices of the batch's leading
    dim and averages them, the ASI states carried from slice to slice, as
    the reference's scan does."""
    if mesh is not None or mean_fn is not None or policy is not None:
        _refuse("the data-parallel (mesh) train step")
    schedule = make_schedule(tcfg)

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        model = state.params
        new_asi = state.asi
        if tcfg.microbatch > 1:
            nm = tcfg.microbatch
            grads, losses, metset = None, [], []
            for mb in _microbatches(batch, nm):
                loss, mets, g, new_asi = value_and_grad(
                    loss_fn, model, mb, cfg, new_asi)
                if grads is None:
                    grads = {k: torch.zeros(v.shape, dtype=torch.float32,
                                            device=v.device)
                             for k, v in g.items()}
                grads = {k: grads[k] + (g[k] / nm).float() for k in grads}
                losses.append(loss)
                metset.append(mets)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in metset]).mean()
                       for k in metset[0]}
        else:
            loss, metrics, grads, new_asi = value_and_grad(
                loss_fn, model, batch, cfg, state.asi)

        grads, gnorm = clip_by_global_norm(grads, tcfg.clip_norm)
        lr = schedule(state.step)
        params = dict(model.named_parameters())
        new_opt = optimizer_update(params, grads, state.opt, tcfg, lr)

        if cfg.wasi.factored and cfg.wasi.refresh_every > 0 and \
                (state.step + 1) % cfg.wasi.refresh_every == 0:
            map_factored(model.tree(), wsi_refresh_factored)

        metrics = dict(metrics)
        metrics.update({"loss": loss, "grad_norm": gnorm, "lr": lr})
        return state._replace(opt=new_opt, step=state.step + 1,
                              asi=new_asi), metrics

    return step
