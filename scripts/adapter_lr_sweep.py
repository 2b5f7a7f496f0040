"""Fine-tune one qwen2-0.5b tenant adapter at several SGD settings on the
card: the per-step training CE and the held-out CE against the frozen
base's, for each of phase 27's three tenant streams.

    python3 scripts/adapter_lr_sweep.py

Runs on one CUDA device from the root of a checkout (it builds the
kernels). qwen2-0.5b at full width and depth in f32, ``rank_frac`` 0.25,
batch 4 x 128, each tenant's stream ``chip_smoke.TenantStream``; the
settings are ``DEFAULT_TCFG`` with lr 0.3, 0.1, 0.03 and 1.0 (momentum
0.9), lr 0.3 without momentum, 8 steps each, and lr 0.3 for 24 steps on
the first tenant. Where phase 27's lr comes from.
"""
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from repro_torch.tenancy.finetune import DEFAULT_TCFG  # noqa: E402

SETTINGS = ((0.3, 0.9, 8), (0.1, 0.9, 8), (0.03, 0.9, 8), (0.3, 0.0, 8),
            (1.0, 0.9, 8), (0.3, 0.9, 24))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("adapter_lr_sweep.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    c._build.build_all()
    print(c.card_line(), flush=True)
    cfg = c.configs.get("qwen2-0.5b").replace(dtype="float32")
    plan = c.api.install(c.api.resolve(cfg))
    aplan = plan.with_adapter(c.ADAPTER_FRAC)
    model = c.init_lm(cfg, device="cuda", seed=0)
    for n in range(3):
        lo = c.ADAPTER_WINDOW + c.ADAPTER_WINDOW_GAP * n
        stream = c.TenantStream(lo, 2700 + n)
        base = c.eval_ce(model, cfg, stream, steps=4, batch_size=4)
        print(f"tenant {n} base held-out CE {base:.5f}", flush=True)
        for lr, mom, steps in SETTINGS:
            if n and steps == 24:
                continue
            tc = dataclasses.replace(DEFAULT_TCFG, lr=lr, momentum=mom,
                                     steps=steps)
            t0 = time.perf_counter()
            tree, met = c.finetune_adapters(model, aplan, stream,
                                            steps=steps, seed=n,
                                            batch_size=4, tcfg=tc,
                                            log_every=1 if n == 0 else 0)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / steps
            ad = [c.eval_ce(c.merge_adapters(model, tree), cfg, stream,
                            steps=k, batch_size=4) for k in (2, 4)]
            print(f"tenant {n} lr {lr} mom {mom} steps {steps}: {dt:.3f} "
                  f"s/step last-step ce {met['ce']:.5f} gnorm "
                  f"{met['grad_norm']:.4f}; held-out CE (2, 4 batches) "
                  f"{ad[0]:.5f} {ad[1]:.5f} vs base {base:.5f}: delta "
                  f"{base - ad[1]:+.5f}", flush=True)
            del tree


if __name__ == "__main__":
    main()
