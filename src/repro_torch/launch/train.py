"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.
Port of ``repro.launch.train`` (single device, synthetic data,
checkpoints, measured memory; the text-data and mesh flags arrive with
those features).

``--ckpt-dir DIR`` saves a plan-bearing ``"train_state"`` checkpoint every
``--ckpt-every`` steps and at the end, and resumes from the latest one on
start; ``api.convert.load_checkpoint(DIR)`` gives its params and plan
back, for serving (``launch.serve --ckpt DIR``) or int8 deployment.

``python -m repro_torch.launch.train --arch qwen2-0.5b --full`` trains the
full config on the CUDA device under its own method, ``wasi``;
``--device cpu`` asks for the CPU, and without ``--full`` the smoke config
is used. ``--wasi`` picks another method:

* ``wasi`` (the config default): factored weights, every linear input
  compressed to Tucker factors by one ASI step (``core/asi.py``) and the
  backward from the factors (``core/lowrank_linear.py``); the ASI states
  come from ``init_lm_states`` and ride in ``TrainState.asi``;
* ``asi``: dense weights, compressed inputs;
* ``wsi``: factored weights through the sketch-saving forward and the
  fused backward (kernels/csrc/lowrank_fwd.cu, lowrank_bwd.cu);
* ``none``: dense weights, plain autograd.

Under ``wasi`` and ``wsi`` the WSI refresh runs the CholeskyQR kernels
(gram.cu, choleskyqr.cu) every ``refresh_every`` steps. ``--memprof`` logs
the measured memory columns (``train/loop.py``). Weights are random,
drawn from ``TrainConfig.seed``, and the batches come from ``SyntheticLM``
with the same seed.
"""
from __future__ import annotations

import argparse
import dataclasses

import repro_torch.configs as configs
from repro_torch import api
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import TrainConfig
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models.lm import _dtype, init_lm, init_lm_states, lm_loss
from repro_torch.train.loop import train_loop
from repro_torch.train.step import make_train_state, make_train_step
from repro_torch.utils.device import resolve_device


def build(arch: str, *, smoke: bool, batch: int, seq: int, wasi: str | None,
          tcfg: TrainConfig, device=None, refresh_every: int | None = None):
    """(cfg, plan, state, step, dataset) for one training run: the plan
    resolved once with the activation-shape hint and installed, the model
    and, under ``wasi``/``asi``, the ASI states (``batch`` x ``seq``
    activations, the config's dtype) initialised from ``tcfg.seed`` on
    ``device`` (default CUDA; raises if absent), the model made trainable,
    the single-device step. ``refresh_every`` overrides the config's WSI
    refresh period (scripts only; no flag)."""
    dev = resolve_device(device)
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    if wasi is not None:
        cfg = cfg.replace(wasi=dataclasses.replace(cfg.wasi, method=wasi))
    if refresh_every is not None:
        cfg = cfg.replace(wasi=dataclasses.replace(
            cfg.wasi, refresh_every=refresh_every))
    if cfg.family != "lm":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    dataset = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                          global_batch=batch, seed=tcfg.seed)
    plan = api.install(api.resolve(cfg, batch=batch, seq=seq))
    model = init_lm(cfg, device=dev, seed=tcfg.seed)
    asi = (init_lm_states(cfg, batch, seq, dtype=_dtype(cfg.dtype),
                          device=dev, seed=tcfg.seed)
           if cfg.wasi.compress_acts else None)
    state = make_train_state(model, cfg, tcfg, asi_states=asi)
    step = make_train_step(lm_loss, cfg, tcfg)
    return cfg, plan, state, step, dataset


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--optimizer", default="sgd")
    ap.add_argument("--wasi", default=None, help="none|wasi|asi|wsi")
    ap.add_argument("--full", action="store_true",
                    help="full (assigned) config instead of smoke")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ckpt-dir", default="",
                    help="save (and resume from) checkpoints here")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--memprof", action="store_true",
                    help="log measured memory columns (utils/memprof.py)")
    return ap


def main(argv=None) -> list[dict]:
    args = build_parser().parse_args(argv)
    tcfg = TrainConfig(optimizer=args.optimizer, lr=args.lr,
                       steps=args.steps, checkpoint_every=args.ckpt_every,
                       checkpoint_dir=args.ckpt_dir)
    cfg, plan, state, step, data = build(
        args.arch, smoke=not args.full, batch=args.batch, seq=args.seq,
        wasi=args.wasi, tcfg=tcfg, device=args.device)
    dev = resolve_device(args.device)
    n = sum(p.numel() for p in state.params.parameters())
    print(f"[train] arch={cfg.name} wasi={cfg.wasi.method} data=synthetic "
          f"device={dev} params={n:,}")

    def feed(s):
        return {k: v.to(dev) for k, v in data.batch(s).items()}

    # plan-bearing checkpoints: the manifest carries the resolved plan, so
    # the checkpoint restores for serving with no config in hand
    ckpt = (CheckpointManager(args.ckpt_dir, keep=tcfg.keep_checkpoints,
                              plan=plan, label="train_state")
            if args.ckpt_dir else None)
    state, hist = train_loop(state, step, feed, tcfg, ckpt=ckpt,
                             memprof=args.memprof)
    if hist:
        print(f"[train] done: loss {hist[0]['loss']:.4f} -> "
              f"{hist[-1]['loss']:.4f}")
    else:
        print(f"[train] already trained to step {state.step}")
    return hist


if __name__ == "__main__":
    main()
