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

WASI maintenance per update mode:

* factored: after the update of step ``s``, when ``(s + 1) %
  refresh_every == 0``, every (L, R) pair is re-orthogonalized
  (``core.wsi.wsi_refresh_factored``: one CholeskyQR per stacked site).
* project (paper Eq. 9-11; ViTs and decoder LMs): ``TrainState.wsi``
  holds a path-keyed ``WSIState`` per wasi-scoped dense W (stacked on a
  layer group's ``repeat`` dim for an LM). Each step the loss runs
  on the param tree with each (L, R) beside its W
  (``core.project.project_forward_params``; the factors detached, so
  autograd never asks for their gradients, which the reference computes
  as zeros and strips); the gradient lands on W; after the optimizer, one
  WSI step against the new W gives the next step's factors
  (``update_project_states``, paper Alg. 1).

Not ported yet, and refused with ``NotImplementedError``: PowerSGD
(``tcfg.powersgd_rank``) and the data-parallel step (``mesh=``,
``mean_fn=``). See ROADMAP.md queue 1.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.api.bind import map_factored
from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.core.project import (
    init_project_states,
    project_forward_params,
    update_project_states,
)
from repro_torch.core.wsi import wsi_refresh_factored
from repro_torch.optim import (
    OptState,
    clip_by_global_norm,
    init_optimizer,
    make_schedule,
    optimizer_update,
)


class TrainState(NamedTuple):
    """The reference's ``TrainState`` without the PowerSGD states, which
    are not ported."""
    params: Any         # the model (LanguageModel, VisionTransformer);
                        # leaves updated in place
    opt: OptState
    step: int = 0
    asi: Any = None     # ASI warm-start states (init_lm_states, ...)
    wsi: Any = None     # project mode: {path: WSIState}, else None


def _refuse(what: str) -> None:
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md "
                              "queue 1)")


def make_train_state(model, cfg: ModelConfig, tcfg: TrainConfig, *,
                     asi_states=None, use_epsilon_ranks: bool = False,
                     dp_degree: int = 0) -> TrainState:
    """The state training starts from. Makes every leaf of ``model``
    trainable (``requires_grad_``): the serving entry points build them
    frozen, and this is where training turns them on.

    Project mode: factors a converted checkpoint carries ({"w", "L", "R"})
    are stripped from the model in place and warm-start their sites; every
    other wasi-scoped W gets a truncated SVD at the static rank, or with
    ``use_epsilon_ranks`` at the smallest rank whose explained variance
    reaches ``cfg.wasi.epsilon`` (the max over stacked layers). Outside
    project mode ``use_epsilon_ranks`` has nothing to pick and is ignored,
    as in the reference."""
    if tcfg.powersgd_rank > 0:
        _refuse("PowerSGD gradient compression")
    if dp_degree:
        _refuse("the data-parallel train state")
    from repro_torch.api.bind import is_quantized, iter_linear_dicts
    packed = [path for path, p in iter_linear_dicts(model.tree())
              if is_quantized(p)]
    if packed:
        raise ValueError(
            f"cannot train an int8-packed model ({len(packed)} packed "
            f"sites, first {packed[0]}): int8 deployment is serve-only; "
            "train the f32/bf16 params and quantize after "
            "(api.convert.quantize)")
    wsi = None
    if cfg.wasi.project:
        from repro_torch.api.bind import extract_project_factors
        model, warm = extract_project_factors(model)
        wsi = init_project_states(model, cfg, use_epsilon=use_epsilon_ranks,
                                  warm=warm)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    return TrainState(params=model, opt=init_optimizer(params, tcfg),
                      asi=asi_states, wsi=wsi)


def value_and_grad(loss_fn, model, batch, cfg: ModelConfig, states=None,
                   fwd=None):
    """(loss, metrics, grads, new_states) of one batch; ``states`` (ASI
    warm starts, or None) go into the loss and its refreshed states come
    out; grads a {name: tensor} dict in the params' dtypes (zeros for a
    leaf the loss does not reach, as ``jax.grad`` gives). ``fwd``: what the
    loss runs on instead of ``model`` (project mode's tree with the
    factors injected, sharing the model's leaves); the gradients are the
    model's parameters' all the same."""
    params = dict(model.named_parameters())
    with torch.enable_grad():
        loss, (new_states, metrics) = loss_fn(
            model if fwd is None else fwd, batch, cfg, states=states)
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
        fwd = None
        if state.wsi is not None:
            fwd = project_forward_params(model, state.wsi)
        if tcfg.microbatch > 1:
            nm = tcfg.microbatch
            grads, losses, metset = None, [], []
            for mb in _microbatches(batch, nm):
                loss, mets, g, new_asi = value_and_grad(
                    loss_fn, model, mb, cfg, new_asi, fwd)
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
                loss_fn, model, batch, cfg, state.asi, fwd)

        grads, gnorm = clip_by_global_norm(grads, tcfg.clip_norm)
        lr = schedule(state.step)
        params = dict(model.named_parameters())
        new_opt = optimizer_update(params, grads, state.opt, tcfg, lr)

        new_wsi = state.wsi
        if state.wsi is not None:
            # paper Alg. 1: one subspace iteration against the updated W
            new_wsi = update_project_states(model, state.wsi)
        elif cfg.wasi.factored and cfg.wasi.refresh_every > 0 and \
                (state.step + 1) % cfg.wasi.refresh_every == 0:
            map_factored(model.tree(), wsi_refresh_factored)

        metrics = dict(metrics)
        metrics.update({"loss": loss, "grad_norm": gnorm, "lr": lr})
        return state._replace(opt=new_opt, step=state.step + 1,
                              asi=new_asi, wsi=new_wsi), metrics

    return step
