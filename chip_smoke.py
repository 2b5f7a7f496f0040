"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: require CUDA, print the card's name and power limit, turn TF32
   off for f32 matmuls and convolutions;
2. build: compile every CUDA kernel of the port from the sources in this
   checkout (one nvcc per source, all started together);
3. kernels: hold each kernel against its plain PyTorch version at the
   serving shapes of qwen2-0.5b, and time kernel, plain version, one
   library call computing the same function, and the card's bound;
4. smoke parity: qwen2 smoke in f32, the same seeded weights on the card
   and on the CPU, prefill then teacher-forced decode, logits compared at
   every step; the card's engine against its own lockstep generate;
5. full width: qwen2-0.5b (24 layers, d_model 896, bf16, random weights
   from a seed) serves 8 requests through 4 slots; the kernel launch count
   shows every factored linear went through the kernel; one prompt's
   logits are held against the same weights in f32 on the CPU.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. ``--json PATH`` also writes
every measurement (per-shape kernel rows, serving figures) to PATH.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import api, configs  # noqa: E402
from repro_torch.api.bridge import from_reference, to_reference  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models.lm import (  # noqa: E402
    init_lm,
    init_lm_cache,
    lm_decode_step,
    lm_prefill,
)
from repro_torch.serve import SamplingParams, ServeEngine  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 rate, bf16 tensor-core
# rate, f32 rate outside the tensor cores
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
EPS32 = float(np.finfo(np.float32).eps)

# the seven factored sites of qwen2-0.5b's plan, (I, K, O) each
SITES = {"attn/wq": (896, 256, 896), "attn/wk": (896, 128, 128),
         "attn/wv": (896, 128, 128), "attn/wo": (896, 256, 896),
         "mlp/gate": (896, 256, 4864), "mlp/up": (896, 256, 4864),
         "mlp/down": (4864, 256, 896)}
SHAPES = {"attn/wq|wo": (896, 256, 896), "attn/wk|wv": (896, 128, 128),
          "mlp/gate|up": (896, 256, 4864), "mlp/down": (4864, 256, 896)}
MS = (4, 37, 256, 1024)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, sets, reps: int = 5) -> float:
    """Device time of one call: ``fn`` over ``sets`` of inputs (cycled so
    the working set exceeds the 50 MB L2, as the serving loop finds the
    weights) captured in a CUDA graph, replayed ``reps`` times between
    CUDA events; the median over the replays, per call. The graph takes
    the host's launch cost out, so this is the kernel's own time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for s in sets[:3]:
            fn(*s)
    torch.cuda.current_stream().wait_stream(side)
    n = max(len(sets), 20)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for j in range(n):
            fn(*sets[j % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return statistics.median(times)


def call_ms(fn, sets, reps: int = 5) -> float:
    """Time of one eager call, host launch cost included (what the eager
    serving loop pays): CUDA events around a loop of calls."""
    for s in sets[:3]:
        fn(*s)
    torch.cuda.synchronize()
    n = max(len(sets), 20)
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for j in range(n):
            fn(*sets[j % len(sets)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def work(m, i, k, o, dtype):
    """(bytes, flops) the function needs: each input read once, the output
    written once; 2 flops per multiply-add of both products."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (m * i + k * i + o * k + m * o) * item
    flops = 2 * m * k * (i + o)
    return nbytes, flops


def bound(m, i, k, o, dtype):
    nbytes, flops = work(m, i, k, o, dtype)
    tb, tf = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype]
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def inputs(m, i, k, o, dtype, gen, n_sets=1):
    sets = []
    for _ in range(n_sets):
        x = torch.randn(m, i, device="cuda", generator=gen).to(dtype)
        r = (torch.randn(k, i, device="cuda", generator=gen)
             * i ** -0.5).to(dtype)
        l_ = (torch.randn(o, k, device="cuda", generator=gen)
              * k ** -0.5).to(dtype)
        sets.append((x, r, l_))
    return sets


def library_lowrank(x, r, l_):
    # yardstick only, timed here and used nowhere in the port
    return torch.matmul(torch.matmul(x, r.T), l_.T)


def phase_kernels(card: str) -> dict:
    print("== phase 3: lowrank_fwd against its plain version", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    rows = []
    for name, (i, k, o) in SHAPES.items():
        for m in MS:
            for dtype in (torch.bfloat16, torch.float32):
                (x, r, l_), = inputs(m, i, k, o, dtype, gen)
                got = ops.lowrank_matmul(x, r, l_)
                torch.cuda.synchronize()
                want = ref.lowrank_matmul_ref(x, r, l_)
                err = (got.float() - want.float()).abs().max().item()
                scale = want.float().abs().max().item()
                # f32: sums of I then K terms in another order, bounded by
                # 2 (I + K) eps |y|; bf16 adds one rounding of the output
                tol = 2 * (i + k) * EPS32 * max(scale, 1.0)
                if dtype == torch.bfloat16:
                    tol += 2.0 ** -7 * scale
                if not err <= tol:
                    raise AssertionError(
                        f"lowrank_fwd {name} M={m} {dtype}: max abs err "
                        f"{err:.3e} > tol {tol:.3e}")
                worst = max(worst, err)
                nbytes, _ = work(m, i, k, o, dtype)
                n_sets = max(1, min(48, int(120e6 // nbytes) + 1))
                sets = inputs(m, i, k, o, dtype, gen, n_sets)
                k_ms = time_ms(ops.lowrank_matmul, sets)
                p_ms = time_ms(ref.lowrank_matmul_ref, sets)
                l_ms = time_ms(library_lowrank, sets)
                kc_ms = call_ms(ops.lowrank_matmul, sets)
                b_ms, b_by = bound(m, i, k, o, dtype)
                rows.append(dict(site=name, M=m, dtype=str(dtype)[6:],
                                 kernel_ms=k_ms, plain_ms=p_ms,
                                 library_ms=l_ms, bound_ms=b_ms,
                                 bound_by=b_by, kernel_call_ms=kc_ms,
                                 max_abs_err=err, tol=tol))
                print(f"[kernel] lowrank_fwd {name:11s} I={i} K={k} O={o} "
                      f"M={m:4d} {str(dtype)[6:]:8s} err={err:.2e} "
                      f"(tol {tol:.2e}) kernel_ms={k_ms:.4f} "
                      f"plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
                      f"bound_ms={b_ms:.5f} ({b_by}) "
                      f"eager_call_ms={kc_ms:.4f} | {card}", flush=True)
                del sets
    # headline: one decode step's seven site launches of one layer (M = 4
    # serve slots, bf16), each at its own shape
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "eager_call_ms": 0.0}
    nbytes = flops = 0
    for name, (i, k, o) in SITES.items():
        sets = inputs(4, i, k, o, torch.bfloat16, gen,
                      max(1, int(120e6 // work(4, i, k, o,
                                               torch.bfloat16)[0]) + 1))
        tot["ms"] += time_ms(ops.lowrank_matmul, sets)
        tot["plain_ms"] += time_ms(ref.lowrank_matmul_ref, sets)
        tot["library_ms"] += time_ms(library_lowrank, sets)
        tot["eager_call_ms"] += call_ms(ops.lowrank_matmul, sets)
        b, f = work(4, i, k, o, torch.bfloat16)
        nbytes, flops = nbytes + b, flops + f
        del sets
    tb, tf = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[torch.bfloat16]
    print(f"[kernel] lowrank_fwd one layer's 7 sites at decode (M=4, bf16): "
          f"kernel_ms={tot['ms']:.4f} plain_ms={tot['plain_ms']:.4f} "
          f"library_ms={tot['library_ms']:.4f} "
          f"bound_ms={max(tb, tf) * 1e3:.5f} "
          f"eager_call_ms={tot['eager_call_ms']:.4f} | {card}", flush=True)
    return dict(rows=rows, worst=worst, headline=dict(
        tot, bound_ms=max(tb, tf) * 1e3,
        bound_by="bytes" if tb >= tf else "operations"))


def phase_smoke_parity(card: str) -> None:
    print("== phase 4: qwen2 smoke, card against CPU (f32)", flush=True)
    cfg = configs.get_smoke("qwen2-0.5b")
    api.install(api.resolve(cfg))
    gpu = init_lm(cfg, device="cuda", seed=11)
    cpu = init_lm(cfg, device="cpu", seed=11)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 9)))
    vl = torch.tensor([9, 4, 6])
    # f32 on both sides; the card's sums run in other orders (the kernel's
    # reduction split over warps and tensor cores off, cuBLAS elsewhere):
    # a few ulps per op through 2 layers, 1e-4 on logits of magnitude ~1
    tol = 1e-4
    worst = 0.0
    with torch.inference_mode():
        caches = {d: init_lm_cache(cfg, 3, 32, dtype=torch.float32, device=d)
                  for d in ("cuda", "cpu")}
        out = {}
        for d, model in (("cuda", gpu), ("cpu", cpu)):
            lg, caches[d] = lm_prefill(model, toks.to(d), cfg,
                                       caches=caches[d],
                                       valid_len=vl.to(d), last_only=True)
            out[d] = lg[:, 0].cpu()
        worst = max(worst, (out["cuda"] - out["cpu"]).abs().max().item())
        pos = vl.clone()
        for _ in range(6):
            nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 1)))
            for d, model in (("cuda", gpu), ("cpu", cpu)):
                lg, caches[d] = lm_decode_step(model, nxt.to(d), caches[d],
                                               pos.to(d), cfg)
                out[d] = lg.cpu()
            worst = max(worst, (out["cuda"] - out["cpu"]).abs().max().item())
            pos += 1
    if not worst <= tol:
        raise AssertionError(f"smoke card vs CPU logits differ by {worst:.3e}"
                             f" > {tol:.1e}")
    print(f"[parity] smoke prefill + 6 teacher-forced decode steps: max |card"
          f" - cpu| logits = {worst:.3e} (tol {tol:.1e}) | {card}")
    eng = ServeEngine(gpu, cfg, max_slots=2, max_cache=64,
                      buckets=(4, 8, 16), device="cuda")
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n)))
               for n in (3, 7, 5, 11, 20)]
    hs = [eng.submit(p, max_new=6) for p in prompts]
    eng.run()
    for p, h in zip(prompts, hs):
        want = generate(gpu, cfg, torch.tensor([p], device="cuda"),
                        max_cache=64, n_new=6)[0].tolist()
        if h.tokens != want:
            raise AssertionError(f"card engine {h.tokens} != lockstep "
                                 f"generate {want}")
    print(f"[parity] smoke engine (2 slots, 5 prompts) == lockstep generate "
          f"on the card | {card}", flush=True)


def phase_full_width(card: str) -> dict:
    print("== phase 5: qwen2-0.5b full width, bf16, 8 requests, 4 slots",
          flush=True)
    cfg = configs.get("qwen2-0.5b")
    plan = api.install(api.resolve(cfg))
    assert {s.name for s in plan.specs} == set(SITES)
    assert all(s.mode == "factored" for s in plan.specs)
    t0 = time.perf_counter()
    model = init_lm(cfg, device="cuda", seed=0)
    print(f"[full] init {time.perf_counter() - t0:.1f}s", flush=True)
    eng = ServeEngine(model, plan=plan, max_slots=4, max_cache=512,
                      device="cuda")
    rng = np.random.default_rng(1)
    # warm-up (CUDA context, cuBLAS handles, allocator), then measure
    eng.submit(list(map(int, rng.integers(0, cfg.vocab_size, 9))), max_new=4)
    eng.run()
    eng.reset_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    lengths = (5, 17, 33, 64, 9, 120, 48, 200)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n)))
               for n in lengths]
    sampled = SamplingParams(temperature=0.8, top_k=50, seed=99)
    ops.reset_launches()
    hs = [eng.submit(p, max_new=16,
                     sampling=sampled if i in (2, 5) else None)
          for i, p in enumerate(prompts)]
    eng.run()
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["lowrank_fwd"]
    s = eng.summary()
    per_forward = len(SITES) * cfg.n_layers
    for h in hs:
        if not (h.finished and len(h.generated) == 16):
            raise AssertionError(f"request {h.rid} ended {h.status} with "
                                 f"{len(h.generated)} tokens")
        if not all(0 <= t < cfg.padded_vocab for t in h.generated):
            raise AssertionError(f"request {h.rid}: token out of range")
    if launches % per_forward or launches < per_forward * s["decode_steps"]:
        raise AssertionError(f"lowrank_fwd launches {launches} is not a "
                             f"multiple of {per_forward} covering "
                             f"{s['decode_steps']} decode steps")
    forwards = launches // per_forward
    print(f"[full] lowrank_fwd launches={launches} = {forwards} forwards x "
          f"{per_forward} ({s['decode_steps']} decode steps + "
          f"{forwards - s['decode_steps']} prefill groups)")
    # no NaN logits: one more prefill over every prompt's first 5 tokens
    with torch.inference_mode():
        c = init_lm_cache(cfg, 8, 16, device="cuda")
        lg, _ = lm_prefill(model, torch.tensor([p[:5] for p in prompts],
                                               device="cuda"), cfg, caches=c)
        if torch.isnan(lg).any():
            raise AssertionError("NaN logits at full width")
    ttft = [h.ttft_s for h in hs]
    tpot = [h.tpot_s for h in hs]
    peak = torch.cuda.max_memory_allocated()
    res = dict(prefill_tok_s=s["prefill_tok_s"], decode_tok_s=s["decode_tok_s"],
               ttft_ms_median=statistics.median(ttft) * 1e3,
               ttft_ms_max=max(ttft) * 1e3,
               tpot_ms_median=statistics.median(tpot) * 1e3,
               weight_mib=s["weight_mib"], kv_mib=s["cache_bytes"] / 2**20,
               max_memory_allocated_mib=peak / 2**20,
               decode_steps=s["decode_steps"], launches=launches,
               prefill_tokens=s["prefill_tokens"],
               decode_tokens=s["decode_tokens"], wall_s=s["wall_s"])
    for key in ("prefill_tok_s", "decode_tok_s", "ttft_ms_median",
                "ttft_ms_max", "tpot_ms_median", "weight_mib", "kv_mib",
                "max_memory_allocated_mib"):
        print(f"[full] {key}={res[key]:.3f} | {card}")
    print(f"[full] greedy sample rid=0: {hs[0].generated}")

    res.update(profile_decode(eng, cfg, rng, card))

    # one 16-token prompt: bf16 on the card against the same weights in f32
    # on the CPU. bf16 rounds every activation to 8 significant bits, 24
    # layers deep; 5% of the logits' scale bounds what that can add up to
    # on this random init, and a wrong kernel or layout misses it by far.
    prompt = torch.tensor([prompts[3][:16]])
    tree = to_reference(model)
    del eng
    cpu = from_reference(tree, cfg, "cpu")
    del tree
    cpu32 = cpu.float()
    cfg32 = cfg.replace(dtype="float32")
    api.install(api.resolve(cfg32))
    with torch.inference_mode():
        lg_gpu, _ = lm_prefill(model, prompt.cuda(), cfg,
                               caches=init_lm_cache(cfg, 1, 16,
                                                    device="cuda"),
                               last_only=True)
        lg_cpu, _ = lm_prefill(cpu32, prompt, cfg32,
                               caches=init_lm_cache(cfg32, 1, 16,
                                                    dtype=torch.float32,
                                                    device="cpu"),
                               last_only=True)
    a, b = lg_gpu.float().cpu()[0, 0], lg_cpu[0, 0]
    err = (a - b).abs().max().item()
    scale = b.abs().max().item()
    if not err <= 0.05 * scale:
        raise AssertionError(f"full-width bf16 card vs f32 CPU logits differ "
                             f"by {err:.3e} > 0.05 x {scale:.3e}")
    print(f"[full] 16-token prompt, bf16 card vs f32 CPU last logits: max "
          f"abs err {err:.3e}, scale {scale:.3e}, argmax card "
          f"{int(a.argmax())} cpu {int(b.argmax())} | {card}", flush=True)
    res["cpu_logit_err"] = err
    return res


def profile_decode(eng, cfg, rng, card: str) -> dict:
    """Device busy share of steady decode: 4 requests decoding, 5 engine
    ticks under torch.profiler; device time summed over CUDA kernels
    against the host wall clock of the ticks (the profiler's own host
    cost included, so the share is a lower bound)."""
    for n in (16, 16, 16, 16):
        eng.submit(list(map(int, rng.integers(0, cfg.vocab_size, n))),
                   max_new=12)
    eng.step()                       # admit + prefill + first decode
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    eng.run()
    # device-side kernel rows only: an aten op's row repeats the device
    # time of the kernels it launched
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and getattr(e, "self_device_time_total", 0) > 0]
    dev_us = sum(e.self_device_time_total for e in events)
    if dev_us <= 0:
        print(f"[profile] no device time in the trace: busy share not "
              f"measured | {card}")
        return {"decode_busy_share": None}
    print(f"[profile] 5 decode ticks (4 slots): wall {wall_us / 5e3:.3f} ms "
          f"per tick, device busy {dev_us / 5e3:.3f} ms per tick, busy "
          f"share {dev_us / wall_us:.3f} | {card}")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        print(f"[profile]   {e.self_device_time_total / 5e3:8.3f} ms/tick "
              f"{e.count // 5:5d} calls/tick  {e.key[:70]}")
    return {"decode_busy_share": dev_us / wall_us,
            "decode_tick_wall_ms": wall_us / 5e3,
            "decode_tick_device_ms": dev_us / 5e3,
            "decode_top": [(e.key[:70], e.self_device_time_total / 5e3,
                            e.count // 5) for e in top]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default="",
                    help="also write every measurement to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none found")
    t_start = time.perf_counter()
    print("== phase 1: device", flush=True)
    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    print("== phase 2: build", flush=True)
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"[build] {', '.join(built)} in {time.perf_counter() - t0:.1f}s "
          f"(nvcc per source: {_build.BUILD_SECONDS})", flush=True)

    k = phase_kernels(card)
    phase_smoke_parity(card)
    full = phase_full_width(card)

    head = k["headline"]
    line = {"kernels": [{
        "name": "lowrank_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lowrank_fwd.cu",
        "replaces": "src/repro/kernels/lowrank.py:58",
        "launches": full["launches"], "max_abs_err": k["worst"],
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"]}]}
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": card, "kernel_rows": k["rows"], "full": full,
                       "kernels": line["kernels"],
                       "seconds": time.perf_counter() - t_start}, f,
                      indent=1)
    print(f"[done] {time.perf_counter() - t_start:.1f}s | {card}")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
