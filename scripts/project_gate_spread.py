"""The reference's own spread on the project-mode training gate's inputs,
beside the port's gap.

    PYTHONPATH=src python scripts/project_gate_spread.py [--draws 6]

``tests/test_torch_lm_project.py``'s gate trains tinyllama smoke in
project mode (batch 4, 16 tokens) for 4 steps from the reference's dense
draws, converted under a calibrated plan (``api.convert.factorize``):
``wasi`` and ``wsi``, AdamW (lr 1e-2, weight decay 1e-4) and SGD+momentum
(lr 0.3, 0.9), clip 2.0, the reference's ``SyntheticLM`` batches. Per
(method, optimizer) this runs the jitted reference (the baseline), the
reference run eagerly, ``--draws`` jitted reference runs whose starting
dense W has every element moved by at most one ulp (up, down or not, at
random), and the port, each from the same converted state (the port's
``make_train_state`` on the reference's converted tree), and prints
against the baseline:

* the largest relative gap over the 4 steps of the loss, ``ppl_proxy``
  and grad_norm;
* after the 4 steps: the largest param difference in units of lr, the
  moments' largest difference over their scale (AdamW: both moments),
  the WSI states' L R over its scale, the ASI factors' over their scale.

The eager and one-ulp runs compute the same function as the baseline and
differ from it by rounding alone, so their largest readings are the
spread rounding gives on these inputs; the gate's tolerances are set
from them. A last column gives the port started from its own conversion
(its own ``api.convert.factorize`` of the dense draws): two LAPACK builds'
f32 truncated SVDs differ by ~1e-5 of L R, a larger start gap than one
ulp, which AdamW's updates of near-zero gradient entries then grow. CPU
only, about 3 minutes.
"""
from __future__ import annotations

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as rconfigs
import repro.models.lm as rlm
import repro_torch.configs as tconfigs
import repro_torch.models.lm as tlm
from repro import api as rapi
from repro.api import convert as rconvert
from repro.config import TrainConfig as RTrainConfig
from repro.data.synthetic import SyntheticLM as RSyntheticLM
from repro.train.step import make_train_state as rmake_state
from repro.train.step import make_train_step as rmake_step
from repro_torch import api as tapi
from repro_torch.api import convert as tconvert
from repro_torch.api.bridge import (
    from_reference,
    state_to_reference,
    states_from_reference,
)
from repro_torch.config import TrainConfig
from repro_torch.train.step import make_train_state, make_train_step

ARCH, B, S, STEPS = "tinyllama-1.1b", 4, 16, 4
KEY = jax.random.PRNGKey(0)
GATES = {"adamw": dict(optimizer="adamw", lr=1e-2, weight_decay=1e-4),
         "sgd_momentum": dict(optimizer="sgd", lr=0.3, momentum=0.9)}


def _cfg(pkg, method, update="project"):
    c = pkg.get_smoke(ARCH)
    return c.replace(wasi=dataclasses.replace(c.wasi, method=method,
                                              update_mode=update))


def _one_ulp(a, rng):
    a = np.asarray(a, np.float32)
    d = rng.integers(-1, 2, a.shape)
    up = np.nextafter(a, np.float32(np.inf))
    down = np.nextafter(a, np.float32(-np.inf))
    return np.where(d > 0, up, np.where(d < 0, down, a))


def _perturb_w(tree, seed: int):
    """Every dense W of the layer groups (the params project mode trains
    beside its factors) moved by at most one ulp."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: (jnp.asarray(_one_ulp(v, rng))
                        if k == "w" and "L" in node else walk(v))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node
    return walk(tree)


def _readings(run, base, lr):
    """(metric gaps over the steps, final-state gaps) of ``run`` against
    ``base``; each a (metrics per step, state dict) pair."""
    (ms, st), (mb, sb) = run, base
    out = {}
    for k in ("loss", "ppl_proxy", "grad_norm"):
        out[k] = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(ms, mb))

    def rel(a, b):
        return max(float(np.abs(np.asarray(x, np.float32)
                                - np.asarray(y, np.float32)).max()
                         / max(np.abs(np.asarray(y)).max(), 1e-30))
                   for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))

    out["params/lr"] = max(
        float(np.abs(np.asarray(x) - np.asarray(y)).max())
        for x, y in zip(jax.tree.leaves(st["params"]),
                        jax.tree.leaves(sb["params"]))) / lr
    out["moments"] = max(rel(st[k], sb[k]) for k in ("mu", "nu")
                         if sb[k] is not None)
    out["wsi_LR"] = max(rel(np.asarray(st["wsi"][p][0])
                            @ np.asarray(st["wsi"][p][1]),
                            np.asarray(sb["wsi"][p][0])
                            @ np.asarray(sb["wsi"][p][1]))
                        for p in sb["wsi"])
    out["asi"] = rel(st["asi"], sb["asi"]) if sb["asi"] is not None else 0.0
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--draws", type=int, default=6)
    args = ap.parse_args()
    torch.set_num_threads(1)
    dcfg = _cfg(rconfigs, "none")
    rapi.install(rapi.resolve(dcfg))
    dense = jax.tree.map(np.asarray, rlm.init_lm(KEY, dcfg))
    data = RSyntheticLM(vocab_size=dcfg.vocab_size, seq_len=S,
                        global_batch=B, seed=1)
    draw = jax.jit(data.batch)
    batches = [jax.tree.map(np.asarray, draw(i)) for i in range(STEPS)]
    for method in ("wasi", "wsi"):
        rcfg, tcfg = _cfg(rconfigs, method), _cfg(tconfigs, method)
        rplan = rapi.install(rapi.resolve(
            rcfg, batch=B, seq=S,
            calibration=jax.tree.map(jnp.asarray, dense)))
        tplan = tapi.install(tapi.resolve(tcfg, batch=B, seq=S,
                                          calibration=dense))
        converted = rconvert.factorize(jax.tree.map(jnp.asarray, dense),
                                       rplan)
        asi = (rlm.init_lm_states(KEY, rcfg, B, S)
               if rcfg.wasi.compress_acts else None)
        for gate, kw in sorted(GATES.items()):
            kw = dict(kw, steps=STEPS, clip_norm=2.0, checkpoint_every=0)
            rtc = RTrainConfig(**kw)
            jstep = jax.jit(rmake_step(rlm.lm_loss, rcfg, rtc))

            def reference(params, step):
                state = rmake_state(KEY, params, rcfg, rtc, asi_states=asi)
                ms = []
                for b in batches:
                    state, m = step(state, jax.tree.map(jnp.asarray, b))
                    ms.append({k: float(v) for k, v in m.items()})
                np_ = jax.tree.map(np.asarray, state)
                return ms, {"params": np_.params, "mu": np_.opt.mu,
                            "nu": np_.opt.nu, "asi": np_.asi,
                            "wsi": {k: tuple(v) for k, v in
                                    np_.wsi.items()}}

            def port(own: bool):
                if own:
                    tree = tconvert.factorize(from_reference(
                        dense, _cfg(tconfigs, "none"), "cpu"), tplan)
                else:
                    tree = jax.tree.map(np.asarray, converted)
                model = from_reference(tree, tcfg, "cpu")
                state = make_train_state(
                    model, tcfg, TrainConfig(**kw),
                    asi_states=None if asi is None else states_from_reference(
                        jax.tree.map(np.asarray, asi), "cpu"))
                step = make_train_step(tlm.lm_loss, tcfg, TrainConfig(**kw))
                ms = []
                for b in batches:
                    state, m = step(state, {k: torch.tensor(v).long()
                                            for k, v in b.items()})
                    ms.append({k: float(v) for k, v in m.items()})
                out = state_to_reference(state)
                out["wsi"] = {k: tuple(v) for k, v in out["wsi"].items()}
                return ms, out

            base = reference(converted, jstep)
            own = [_readings(reference(converted,
                                       rmake_step(rlm.lm_loss, rcfg, rtc)),
                             base, kw["lr"])]
            own += [_readings(reference(_perturb_w(converted, d), jstep),
                              base, kw["lr"]) for d in range(args.draws)]
            got = _readings(port(False), base, kw["lr"])
            own_conv = _readings(port(True), base, kw["lr"])
            print(f"{method} {gate}: reading  port  reference's largest "
                  f"(eager, {args.draws} one-ulp draws)  port from its own "
                  f"conversion")
            for k in got:
                print(f"   {k:10s} {got[k]:.3e}  {max(o[k] for o in own):.3e}"
                      f"  ({own[0][k]:.3e}, "
                      + ", ".join(f"{o[k]:.1e}" for o in own[1:])
                      + f")  {own_conv[k]:.3e}", flush=True)


if __name__ == "__main__":
    main()
