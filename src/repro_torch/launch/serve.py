"""Serving launcher: thin CLI over the continuous-batching engine. Port of
``repro.launch.serve`` (dense slots, the paged KV pool with its prefix
cache and chunked prefill, self-speculative decoding, tenant adapters,
int8 deployment and plan-bearing checkpoints; the mesh flag arrives with
mesh serving).

``python -m repro_torch.launch.serve --arch qwen2-0.5b --full --tokens 32``
runs on the CUDA device; ``--device cpu`` asks for the CPU.

Every factored linear runs in its rank-K subspace, ``y = (x R^T) L^T``,
through the fused CUDA kernel (kernels/csrc/lowrank_fwd.cu) on the card;
with ``--quant int8`` the factors are packed to int8 with per-channel
scales and run through the int8 kernel (kernels/csrc/lowrank_q8.cu).
``--paged`` serves from a paged KV pool (``--page-size``,
``--total-pages``, ``--prefill-chunk``, ``--prefill-every``,
``--no-prefix-cache``; configs with sliding-window or Mamba layers
cannot be paged and raise).
``--spec-k K`` drafts K tokens a tick through a cheap view of the same
weights (``--draft int8`` or ``rank:<frac>``) and verifies them in one
forward; the summary then prints a ``[serve] spec ...`` line.
``--adapters DIR`` serves tenant adapters hot-swapped from an
``AdapterStore`` (``launch/finetune_user.py`` writes one) through
``--adapter-slots`` device-resident bank rows; ``--tenants a,b,`` cycles
tenant ids over the requests (an empty entry is the bare base) and the
summary prints a ``[serve] tenancy ...`` line.
``--ckpt DIR`` serves the latest step of a plan-bearing checkpoint (its
plan carries the config; ``--quant`` packs it first unless it is packed
already). Without ``--ckpt`` the weights are random, drawn from seed 0;
the prompts are always.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch import api
from repro_torch.api.bridge import from_reference
from repro_torch.models.lm import (
    _dtype,
    init_lm,
    init_lm_cache,
    lm_decode_step,
    lm_prefill,
)
from repro_torch.serve import SCHEDULERS, EventKind, SamplingParams, ServeEngine


def generate(model, cfg, prompt: torch.Tensor, max_cache: int,
             n_new: int) -> torch.Tensor:
    """prompt (B, P) -> (B, P + n_new), greedy, lockstep batch: one
    token-parallel prefill, then one decode step per token with argmax on
    the returned logits. The oracle the engine's greedy rows are held to."""
    b, p = prompt.shape
    dev = prompt.device
    with torch.inference_mode():
        caches = init_lm_cache(cfg, b, max_cache, dtype=_dtype(cfg.dtype),
                               device=dev)
        logits, caches = lm_prefill(model, prompt, cfg, caches=caches,
                                    last_only=True)
        logits = logits[:, 0]
        out = [prompt]
        for j in range(n_new):
            nxt = torch.argmax(logits, dim=-1)[:, None]
            out.append(nxt)
            if j < n_new - 1:  # the last token needs no further forward
                logits, caches = lm_decode_step(model, nxt, caches, p + j,
                                                cfg)
        return torch.cat(out, dim=1)


def _stream(engine, handles) -> None:
    """Drive the engine to completion, printing tokens as they arrive and
    a TTFT/TPOT line per request."""
    cursors = [0] * len(handles)
    while engine.busy:
        engine.step()
        for i, h in enumerate(handles):
            events = h.events
            for ev in events[cursors[i]:]:
                if ev.kind is EventKind.TOKEN:
                    print(f"[stream] rid={ev.rid} token={ev.token}",
                          flush=True)
                else:
                    print(f"[stream] rid={ev.rid} {ev.kind.value}"
                          + (f" ({ev.reason})" if ev.reason else ""))
            cursors[i] = len(events)
    for h in handles:
        ttft, tpot = h.ttft_s, h.tpot_s
        print(f"[stream] rid={h.rid} status={h.status.value} "
              f"new={len(h.generated)} "
              f"ttft_ms={ttft * 1e3 if ttft else float('nan'):.2f} "
              f"tpot_ms={tpot * 1e3 if tpot else float('nan'):.3f}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen2-0.5b",
                    choices=configs.list_archs())
    ap.add_argument("--full", action="store_true",
                    help="the assigned config (default: its smoke config)")
    ap.add_argument("--batch", type=int, default=4,
                    help="number of requests to submit")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--max-slots", type=int, default=0,
                    help="serve slots (0 => min(batch, 4))")
    ap.add_argument("--wasi", default=None,
                    help="override the config's WASI method (none = dense)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples on the device")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=None,
                    help="sampling seed (default: stable per-request rid)")
    ap.add_argument("--sched", default="fcfs", choices=sorted(SCHEDULERS))
    ap.add_argument("--paged", action="store_true",
                    help="paged KV pool with prefix sharing + chunked "
                         "prefill (serve/kvpool.py); needs full causal "
                         "attention in every layer")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV positions per page (paged mode)")
    ap.add_argument("--total-pages", type=int, default=0,
                    help="pool size (0 => dense-equivalent capacity)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="tokens per chunked-prefill tick (0 => largest "
                         "bucket)")
    ap.add_argument("--prefill-every", type=int, default=1,
                    help="run chunked prefill every Nth tick while decodes "
                         "are active (higher => lower decode TPOT tax, "
                         "slower long-prompt TTFT)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable cross-request radix prefix reuse")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="self-speculative decoding: draft this many "
                         "tokens a tick through a cheap subspace view of "
                         "the SAME weights, verify them in one forward "
                         "(0 = off)")
    ap.add_argument("--draft", default="int8",
                    help="draft source for --spec-k: 'int8' (packed "
                         "factors) or 'rank:<frac>' (leading slice of each "
                         "site's L/R, e.g. rank:0.5)")
    ap.add_argument("--adapters", default="",
                    help="AdapterStore directory (launch/finetune_user.py "
                         "writes it): requests carry per-tenant deltas "
                         "hot-swapped from this store")
    ap.add_argument("--tenants", default="",
                    help="comma-separated tenant ids cycled across the "
                         "submitted requests ('' entries = bare base); "
                         "requires --adapters")
    ap.add_argument("--adapter-slots", type=int, default=4,
                    help="device-resident adapter LRU capacity (tenant "
                         "churn past it rewrites bank rows in place)")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they are generated")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--quant", default=None, choices=["int8"],
                    help="int8 deployment: pack every factored and dense "
                         "site to int8 + per-channel scales")
    ap.add_argument("--ckpt", default="",
                    help="serve a plan-bearing checkpoint directory")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    slots = args.max_slots or min(args.batch, 4)
    max_cache = args.prompt_len + args.tokens + 1
    if args.tenants and not args.adapters:
        raise SystemExit("--tenants needs --adapters DIR")
    tenants = ([t or None for t in args.tenants.split(",")]
               if args.tenants else [None])
    if args.ckpt:
        tree, plan, _ = api.convert.load_checkpoint(args.ckpt)
        if plan is None:
            raise SystemExit(f"checkpoint at {args.ckpt} carries no plan")
        if args.quant and not plan.is_quantized:
            plan = plan.quantized(args.quant)
            tree = api.convert.quantize(tree, plan)
        cfg = plan.model
    else:
        cfg = configs.get(args.arch) if args.full \
            else configs.get_smoke(args.arch)
        if args.wasi is not None:
            cfg = cfg.replace(wasi=dataclasses.replace(cfg.wasi,
                                                       method=args.wasi))
        plan = api.install(api.resolve(cfg))
        tree = init_lm(cfg, device=args.device, seed=0)
        if args.quant:
            api.uninstall(cfg)          # the engine installs the quant view
            plan = plan.quantized(args.quant)
            tree = api.convert.quantize(tree, plan)
    if not isinstance(tree, torch.nn.Module):
        api.uninstall(cfg)
        api.install(plan)
        tree = from_reference(tree, cfg, args.device)
    paged_kw = {}
    if args.adapters:
        paged_kw.update(adapters=args.adapters,
                        adapter_slots=args.adapter_slots)
    if args.spec_k:
        paged_kw.update(spec_k=args.spec_k, draft=args.draft)
    if args.paged:
        paged_kw.update(paged=True, page_size=args.page_size,
                        total_pages=args.total_pages or None,
                        prefill_chunk=args.prefill_chunk or None,
                        prefill_every=args.prefill_every,
                        prefix_cache=not args.no_prefix_cache)
    engine = ServeEngine(tree, plan=plan, max_slots=slots,
                         max_cache=max_cache, scheduler=args.sched,
                         device=args.device, **paged_kw)
    sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p, seed=args.seed)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))
    t0 = time.time()
    handles = [engine.submit(list(prompts[i]), max_new=args.tokens,
                             sampling=sp, tenant=tenants[i % len(tenants)])
               for i in range(args.batch)]
    if args.adapters:
        for i, h in enumerate(handles):
            print(f"[serve] rid={h.rid} tenant={tenants[i % len(tenants)]}")
    if args.stream:
        _stream(engine, handles)
    else:
        engine.run()
    dt = time.time() - t0
    s = engine.summary()
    stag = "" if sp.is_greedy else (f" T={sp.temperature}"
                                    f" top_k={sp.top_k} top_p={sp.top_p}")
    qtag = " quant=int8" if s["quantized"] else ""
    ptag = ""
    if s["paged"]:
        ptag = (f" paged pg={s['page_size']} pages={s['total_pages']} "
                f"chunks={s['prefill_chunks']} "
                f"prefix_hits={s['prefix_hit_tokens']}")
    print(f"[serve] arch={cfg.name} wasi={cfg.wasi.method}{qtag}{stag} "
          f"device={s['device']} sched={s['scheduler']} slots={slots} "
          f"requests={args.batch} wall={dt:.2f}s "
          f"weights={s['weight_mib']:.2f}MiB "
          f"kv={s['cache_bytes'] / 2**20:.2f}MiB{ptag}")
    print(f"[serve] prefill {s['prefill_tokens']} tok "
          f"({s['prefill_tok_s']:.1f} tok/s) | decode {s['decode_tokens']} "
          f"tok ({s['decode_tok_s']:.1f} tok/s) | "
          f"{s['requests_s']:.2f} req/s")
    if args.adapters:
        t = s["tenancy"]
        print(f"[serve] tenancy resident={','.join(t['resident']) or '-'} "
              f"capacity={t['capacity']} swaps={t['swaps']} "
              f"evictions={t['evictions']} hits={t['hits']} "
              f"bank={t['bank_bytes'] / 2**20:.2f}MiB "
              f"store_tenants={t['store_tenants']} "
              f"deferred={s['deferred']}")
    if args.spec_k:
        print(f"[serve] spec k={s['spec_k']} draft={s['draft_source']} "
              f"acceptance_rate={s['acceptance_rate']:.3f} "
              f"tokens_per_verify={s['tokens_per_verify']:.2f} "
              f"verify_steps={s['spec_steps']} "
              f"drafted={s['spec_draft_tokens']} "
              f"accepted={s['spec_accepted_tokens']}")
    print("[serve] sample:", handles[0].tokens)
    return s


if __name__ == "__main__":
    main()
