"""The reference's own spread on the encoder-decoder training gate's
inputs, beside the port's gap.

    PYTHONPATH=src python scripts/encdec_gate_spread.py

``tests/test_torch_encdec.py``'s gate trains whisper smoke (2 + 2 layers,
d 32, 16 frames, f32) for 4 steps of batch 4 x 16 decoder tokens from the
port's ``init_encdec`` (and ``init_encdec_states`` under ``wasi``) at seed
0, carried to the reference as numpy, on the reference's
``SyntheticAudio`` batches: ``wsi`` and ``wasi``, SGD+momentum
(lr 0.05, 0.9) and AdamW (lr 1e-2, weight decay 1e-4), clip 2.0, the WSI
refresh every 2 steps. Per (method, optimizer) this runs the jitted
reference (the baseline), the same steps with ``jax.disable_jit`` (the
reference eager), ``DRAWS`` jitted runs whose starting params have
every element moved by at most one ulp (up, down or not, at random) and
the port, from the same state, and prints against the baseline:

* the largest relative gap over the 4 steps of the loss and grad_norm;
* after the 4 steps: the largest param difference over its leaf's scale
  (and, under AdamW, in units of lr), the moments' over their scale, the
  ASI factors' over their scale.

A first line gives the same readings for the ASI factors one ``wasi``
``encdec_loss`` on batch 0 returns (the forward test's).

The eager and one-ulp runs compute the same function as the baseline and
differ from it by rounding alone: their largest readings are the spread
rounding gives on these inputs, and the gate's tolerances are set at
about 4x them. CPU only, about two minutes.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as rconfigs
import repro.models.encdec as red
import repro_torch.configs as tconfigs
import repro_torch.models.encdec as ted
from repro import api as rapi
from repro.config import TrainConfig as RTrainConfig
from repro.core.asi import ASIState as RASIState
from repro.data.synthetic import SyntheticAudio as RSyntheticAudio
from repro.train.step import make_train_state as rmake_state
from repro.train.step import make_train_step as rmake_step
from repro_torch import api as tapi
from repro_torch.api.bridge import (
    from_reference,
    state_from_reference,
    state_to_reference,
    states_from_reference,
    states_to_reference,
    to_reference,
)
from repro_torch.config import TrainConfig
from repro_torch.train.step import make_train_step

B, S, STEPS, REFRESH = 4, 16, 4, 2
DRAWS = 4
GATES = {"sgd_momentum": dict(optimizer="sgd", lr=0.05, momentum=0.9),
         "adamw": dict(optimizer="adamw", lr=1e-2, weight_decay=1e-4)}


def cfgs(method: str):
    def m(c):
        return c.replace(wasi=dataclasses.replace(
            c.wasi, method=method, refresh_every=REFRESH))
    return (m(rconfigs.get_smoke("whisper-tiny")),
            m(tconfigs.get_smoke("whisper-tiny")))


def batches(rcfg, n: int) -> list:
    data = RSyntheticAudio(vocab_size=rcfg.vocab_size, enc_seq=rcfg.enc_seq,
                           d_model=rcfg.d_model, seq_len=S, global_batch=B,
                           seed=0)
    return [jax.tree.map(np.asarray, data.batch(i)) for i in range(n)]


def torch_batch(b: dict) -> dict:
    return {"frames": torch.tensor(b["frames"]),
            "tokens": torch.tensor(b["tokens"]).long(),
            "labels": torch.tensor(b["labels"]).long()}


def rel(a, w) -> float:
    fa = jax.tree.leaves(a)
    fw = jax.tree.leaves(w)
    return max(float(np.abs(np.asarray(x, np.float32) - np.asarray(y)).max()
                     / max(np.abs(np.asarray(y)).max(), 1e-30))
               for x, y in zip(fa, fw))


def absdiff(a, w) -> float:
    return max(float(np.abs(np.asarray(x, np.float32) - np.asarray(y)).max())
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(w)))


def install(method: str):
    rcfg, tcfg = cfgs(method)
    rapi.uninstall(rcfg)
    tapi.uninstall(tcfg)
    rapi.install(rapi.resolve(rcfg, batch=B, seq=S))
    tapi.install(tapi.resolve(tcfg, batch=B, seq=S))
    return rcfg, tcfg


def draws(tcfg):
    """The test's params and ASI states (the port's seed-0 draws) as the
    reference's numpy tree and ``ASIState``s."""
    params = to_reference(ted.init_encdec(tcfg, device="cpu", seed=0))
    st = states_to_reference(ted.init_encdec_states(tcfg, B, S,
                                                    device="cpu"))
    return params, jax.tree.map(lambda a: RASIState(us=tuple(a.us)), st,
                                is_leaf=lambda n: hasattr(n, "us"))


def forward_states() -> None:
    rcfg, tcfg = install("wasi")
    params, st = draws(tcfg)
    b = jax.tree.map(jnp.asarray, batches(rcfg, 1)[0])

    def f(p, s):
        return red.encdec_loss(p, b, rcfg, states=s)[1][0]

    base = jax.jit(f)(params, st)
    with jax.disable_jit():
        eager = f(params, st)
    _, (ns, _) = ted.encdec_loss(
        from_reference(params, tcfg, "cpu"), torch_batch(batches(rcfg, 1)[0]),
        tcfg, states=states_from_reference(st, "cpu"))
    print(f"wasi  forward      eager asi {rel(eager, base):.2e}\n"
          f"wasi  forward      port  asi "
          f"{rel(states_to_reference(ns), base):.2e}", flush=True)


def run(method: str, gate: str) -> None:
    rcfg, tcfg = install(method)
    kw = dict(GATES[gate], steps=STEPS, clip_norm=2.0, checkpoint_every=0)
    rtc, ttc = RTrainConfig(**kw), TrainConfig(**kw)
    key = jax.random.PRNGKey(0)
    params, st = draws(tcfg)
    start = rmake_state(key, jax.tree.map(jnp.asarray, params), rcfg, rtc,
                        asi_states=(jax.tree.map(jnp.asarray, st)
                                    if rcfg.wasi.compress_acts else None))
    step = rmake_step(red.encdec_loss, rcfg, rtc)
    data = batches(rcfg, STEPS)

    def ulp(seed: int):
        """``start`` with every param moved by at most one ulp."""
        rng = np.random.default_rng(seed)

        def move(a):
            a = np.asarray(a)
            to = np.where(rng.random(a.shape) < 0.5, np.inf, -np.inf)
            moved = np.nextafter(a, to.astype(a.dtype))
            return jnp.asarray(np.where(rng.random(a.shape) < 2 / 3, moved,
                                        a))
        return start._replace(params=jax.tree.map(move, start.params))

    def ref(jit: bool, s0=None):
        s, ms = start if s0 is None else s0, []
        fn = jitted if jit else step
        for b in data:
            if jit:
                s, m = fn(s, jax.tree.map(jnp.asarray, b))
            else:
                with jax.disable_jit():
                    s, m = fn(s, jax.tree.map(jnp.asarray, b))
            ms.append({k: float(v) for k, v in m.items()})
        return s, ms

    jitted = jax.jit(step)
    base, bm = ref(True)
    eager, em = ref(False)
    ulps = [ref(True, ulp(i)) for i in range(DRAWS)]
    state = state_from_reference(jax.tree.map(np.asarray, start), tcfg,
                                 "cpu")
    tstep = make_train_step(ted.encdec_loss, tcfg, ttc)
    pm = []
    for b in data:
        state, m = tstep(state, torch_batch(b))
        pm.append({k: float(v) for k, v in m.items()})
    port = state_to_reference(state)
    lr = GATES[gate]["lr"]
    for name, s, ms in (("eager", eager, em),
                        *((f"ulp{i}", u, um) for i, (u, um) in
                          enumerate(ulps)),
                        ("port", None, pm)):
        gaps = {k: max(abs(m[k] - w[k]) / abs(w[k])
                       for m, w in zip(ms, bm)) for k in ("loss",
                                                          "grad_norm")}
        if s is None:
            p, mu, asi = port["params"], port["mu"], port["asi"]
        else:
            p, mu, asi = s.params, s.opt.mu, s.asi
        line = (f"{method:5s} {gate:12s} {name:5s} loss {gaps['loss']:.2e} "
                f"grad_norm {gaps['grad_norm']:.2e} params/scale "
                f"{rel(p, base.params):.2e} params/lr "
                f"{absdiff(p, base.params) / lr:.2e} mu {rel(mu, base.opt.mu):.2e}")
        if asi is not None and base.asi is not None:
            line += f" asi {rel(asi, base.asi):.2e}"
        print(line, flush=True)


def main() -> None:
    torch.set_num_threads(1)
    forward_states()
    for method in ("wsi", "wasi"):
        for gate in GATES:
            run(method, gate)


if __name__ == "__main__":
    main()
