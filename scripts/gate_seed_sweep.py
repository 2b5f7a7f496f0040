"""Seed sweep of the training gate's loss gap on weights the port draws.

    PYTHONPATH=src python scripts/gate_seed_sweep.py [--seeds 8] [--steps 4]

``tests/test_torch_remat.py``'s gate trains tinyllama smoke (batch 4, 16
tokens, ``remat="block"``, refresh every 2) from the reference's own
``init_lm`` draws. Here each seed's weights come from the port's
``init_lm(seed=s)`` instead and are handed to the reference with
``api.bridge.to_reference``; both packages then take the reference's
``SyntheticLM`` batches (seed 1) under ``wsi`` and AdamW (lr 1e-2, weight
decay 1e-4, clip 2.0), the gate's settings.

Per seed it prints the step-``steps`` loss of the port, of the reference
under ``jax.jit`` and of the reference run eagerly (op by op), and the
relative gaps against the jitted reference: the port's, the eager run's,
and the largest of ``--draws`` jitted runs from the same weights with
every element moved by at most one ulp (up, down or not, drawn at
random). The eager and one-ulp runs compute the same function as the
jitted one and differ from it by rounding alone: the eager run by XLA's
fusion and order, the one-ulp runs by an input perturbation at the size
of one rounding. Together with the jitted run they are the reference's
rounding cloud on that seed; the last columns give the port's distance
to the nearest member and the cloud's width (its largest gap). A port
loss inside the cloud, nearer to a member than the cloud is wide, is
rounding too.

Where AdamW meets a gradient entry near zero, its first update
g / (|g| + 1e-8) turns that entry's rounding into a change of up to ~lr
in its param, which the next steps' losses carry. The last columns give
the largest gap over the first ``steps`` losses.

CPU only (JAX and the port's plain versions); about 1-2 minutes a seed.
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
from repro.config import TrainConfig as RTrainConfig
from repro.data.synthetic import SyntheticLM as RSyntheticLM
from repro.train.step import make_train_state as rmake_state
from repro.train.step import make_train_step as rmake_step
from repro_torch import api as tapi
from repro_torch.api.bridge import state_from_reference, to_reference
from repro_torch.config import TrainConfig
from repro_torch.train.step import make_train_step

ARCH, B, S = "tinyllama-1.1b", 4, 16
KW = dict(optimizer="adamw", lr=1e-2, weight_decay=1e-4, clip_norm=2.0,
          checkpoint_every=0)


def _cfg(pkg):
    c = pkg.get_smoke(ARCH)
    return c.replace(remat="block", wasi=dataclasses.replace(
        c.wasi, method="wsi", refresh_every=2))


def _one_ulp(tree, seed: int):
    """Every float32 element moved to its next float32 up or down, or
    left, at random (``seed``)."""
    rng = np.random.default_rng(seed)

    def leaf(a):
        a = np.asarray(a, np.float32)
        d = rng.integers(-1, 2, a.shape)
        up = np.nextafter(a, np.float32(np.inf))
        down = np.nextafter(a, np.float32(-np.inf))
        return jnp.asarray(np.where(d > 0, up, np.where(d < 0, down, a)))
    return jax.tree.map(leaf, tree)


def _reference_losses(params, rcfg, batches, steps, jit: bool) -> list:
    rtc = RTrainConfig(steps=steps, **KW)
    state = rmake_state(jax.random.PRNGKey(0), params, rcfg, rtc)
    step = rmake_step(rlm.lm_loss, rcfg, rtc)
    if jit:
        step = jax.jit(step)
    out = []
    for b in batches:
        state, m = step(state, jax.tree.map(jnp.asarray, b))
        out.append(float(m["loss"]))
    return out


def _port_losses(tree, tcfg, batches, steps) -> list:
    rtc = RTrainConfig(steps=steps, **KW)
    rcfg = _cfg(rconfigs)
    rstate = rmake_state(jax.random.PRNGKey(0),
                         jax.tree.map(jnp.asarray, tree), rcfg, rtc)
    state = state_from_reference(jax.tree.map(np.asarray, rstate), tcfg,
                                 "cpu")
    step = make_train_step(tlm.lm_loss, tcfg, TrainConfig(steps=steps, **KW))
    out = []
    for b in batches:
        state, m = step(state, {k: torch.tensor(v).long()
                                for k, v in b.items()})
        out.append(float(m["loss"]))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--draws", type=int, default=6)
    args = ap.parse_args()
    torch.set_num_threads(1)
    rcfg, tcfg = _cfg(rconfigs), _cfg(tconfigs)
    for api_, cfg in ((rapi, rcfg), (tapi, tcfg)):
        api_.uninstall(cfg)
        api_.install(api_.resolve(cfg, batch=B, seq=S))
    data = RSyntheticLM(vocab_size=rcfg.vocab_size, seq_len=S,
                        global_batch=B, seed=1)
    draw = jax.jit(data.batch)
    batches = [jax.tree.map(np.asarray, draw(i)) for i in range(args.steps)]
    print(f"seed  loss_port  loss_ref_jit  loss_ref_eager  "
          f"gap_port  gap_eager  gap_ulp  (relative to the jitted reference "
          f"at step {args.steps}; then the largest over steps 1-"
          f"{args.steps})")
    rows = []
    for seed in range(args.seeds):
        tree = to_reference(tlm.init_lm(tcfg, device="cpu", seed=seed))
        params = jax.tree.map(jnp.asarray, tree)
        jit = _reference_losses(params, rcfg, batches, args.steps, True)
        eager = _reference_losses(params, rcfg, batches, args.steps, False)
        ulps = [_reference_losses(_one_ulp(params, d), rcfg, batches,
                                  args.steps, True)
                for d in range(args.draws)]
        port = _port_losses(tree, tcfg, batches, args.steps)

        def gap(run):
            return [abs(x - j) / abs(j) for x, j in zip(run, jit)]
        g_ulp = max((gap(u) for u in ulps), key=lambda g: g[-1])
        gaps = [gap(port), gap(eager), g_ulp]
        cloud = [jit[-1], eager[-1]] + [u[-1] for u in ulps]
        near = min(abs(port[-1] - c) for c in cloud) / abs(jit[-1])
        width = max(gaps[1][-1], gaps[2][-1])
        rows.append([g[-1] for g in gaps] + [near, width])
        print(f"{seed:4d}  {port[-1]:.7f}  {jit[-1]:.7f}  {eager[-1]:.7f}  "
              + "  ".join(f"{g[-1]:.3e}" for g in gaps)
              + "  (max " + ", ".join(f"{max(g):.3e}" for g in gaps) + ")"
              + f"  nearest {near:.3e} width {width:.3e}", flush=True)
    outside = [i for i, r in enumerate(rows) if r[3] > r[4]]
    print(f"step-{args.steps} gaps over {len(rows)} seeds: port "
          f"{min(r[0] for r in rows):.3e}-{max(r[0] for r in rows):.3e}; "
          f"the reference against itself: eager "
          f"{min(r[1] for r in rows):.3e}-{max(r[1] for r in rows):.3e}, "
          f"one ulp {min(r[2] for r in rows):.3e}-"
          f"{max(r[2] for r in rows):.3e}; seeds where the port's loss is "
          f"farther from its seed's reference cloud than the cloud is wide: "
          f"{outside}")


if __name__ == "__main__":
    main()
