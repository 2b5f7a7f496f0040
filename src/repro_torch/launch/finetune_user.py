"""Per-user adapter fine-tuning CLI: checkpointed base -> AdapterStore.
Port of ``repro.launch.finetune_user``.

``python -m repro_torch.launch.finetune_user --ckpt DIR --tenant alice
--store ADAPTERS --steps 40`` runs on the CUDA device; ``--device cpu``
asks for the CPU.

Loads a plan-bearing checkpoint, freezes it, trains only the per-site
rank-K_a delta pair on the tenant's stream (``SyntheticLM(...).for_tenant``
skews its topic mixture: a real shift to learn) and registers the result
in the content-addressed store that ``launch/serve --adapters`` hot-swaps
from. ``--data`` takes ``synthetic`` only: the text pipeline of the
reference's data registry is not ported (ROADMAP.md queue 1, item 3).

``--check`` makes the run an acceptance test: exit non-zero unless the
adapter's CE on the tenant's held-out stream beats the frozen base's.
"""
from __future__ import annotations

import argparse

from repro_torch import api
from repro_torch.api.bridge import from_reference
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.tenancy import (AdapterStore, eval_ce, finetune_adapters,
                                 merge_adapters)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "repro_torch.launch.finetune_user")
    ap.add_argument("--ckpt", required=True,
                    help="plan-bearing base checkpoint directory")
    ap.add_argument("--tenant", required=True,
                    help="tenant id ([A-Za-z0-9._-]); also picks the "
                         "tenant's synthetic topic")
    ap.add_argument("--store", required=True,
                    help="AdapterStore root to register the adapter in")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--rank-frac", type=float, default=0.25,
                    help="adapter rank fraction per site "
                         "(SubspacePlan.with_adapter)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data", default="synthetic",
                    help="the tenant's stream: 'synthetic' (topic-skewed "
                         "SyntheticLM)")
    ap.add_argument("--quant", default="", choices=["", "int8"],
                    help="pack the STORED adapter int8 (training stays "
                         "f32; serving loads it dequantized)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless adapter CE < frozen-base CE on the "
                         "tenant's held-out stream")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.data != "synthetic":
        raise SystemExit(
            f"--data {args.data!r}: only 'synthetic' is ported; the text "
            "pipeline of the data registry is ROADMAP.md queue 1, item 3")
    tree, plan, step = api.convert.load_checkpoint(args.ckpt)
    if plan is None:
        raise SystemExit(f"checkpoint at {args.ckpt} carries no plan")
    cfg = plan.model
    api.uninstall(cfg)
    api.install(plan)
    base = from_reference(tree, cfg, args.device)
    aplan = plan.with_adapter(args.rank_frac)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                       global_batch=args.batch,
                       seed=args.seed).for_tenant(args.tenant)
    adapters, _ = finetune_adapters(
        base, aplan, data, steps=args.steps, seed=args.seed,
        log_every=max(args.steps // 4, 1))
    base_ce = eval_ce(base, cfg, data)
    adapter_ce = eval_ce(merge_adapters(base, adapters), cfg, data)

    store = AdapterStore(args.store)
    meta = store.save(args.tenant, adapters, aplan,
                      fmt=args.quant or "f32",
                      extra={"base_step": step, "steps": args.steps,
                             "base_ce": base_ce, "adapter_ce": adapter_ce})
    print(f"[finetune_user] tenant={args.tenant} base_step={step} "
          f"steps={args.steps} rank_frac={args.rank_frac} "
          f"device={args.device}")
    print(f"[finetune_user] base_ce={base_ce:.4f} "
          f"adapter_ce={adapter_ce:.4f} "
          f"delta={base_ce - adapter_ce:+.4f}")
    print(f"[finetune_user] stored format={meta['format']} "
          f"bytes={meta['bytes']} ({meta['bytes'] / 2**20:.4f} MiB) "
          f"object={meta['object'][:12]} store={args.store}")
    if args.check and not adapter_ce < base_ce:
        raise SystemExit(
            f"--check failed: adapter CE {adapter_ce:.4f} does not beat "
            f"frozen base CE {base_ce:.4f} on tenant {args.tenant!r}")
    return {"base_ce": base_ce, "adapter_ce": adapter_ce, "meta": meta}


if __name__ == "__main__":
    main()
