"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: require CUDA, print the card's name and power limit, turn TF32
   off for f32 matmuls and convolutions;
2. build: compile every CUDA kernel of the port from the sources in this
   checkout (one nvcc per source, all started together);
3. kernel #1: hold each route of ``lowrank_fused`` (decode,
   tensor-core, fused; ``lowrank.forward_route``) against its plain
   PyTorch version at the serving shapes of qwen2-0.5b (M from 4 to
   1,024, both sides of the decode threshold, bf16 and f32, and a ragged
   shape the tensor cores refuse) and of zamba2-7b (M = 4 and 1,024),
   two calls on the same inputs bit-equal; time kernel, plain version,
   one library call computing the same function, and the card's bound;
   headlines for a qwen2 decode layer and a zamba2 prefill layer; rows at
   tinyllama-1.1b's and internvl2-26b's site shapes (M = 4 on the decode
   route, and 1,024) and a tinyllama decode layer's headline; a sweep
   of the decode and tensor-core routes over M = 1-32 (where the decode
   threshold comes from);
4. smoke parity: qwen2 smoke in f32, the same seeded weights on the card
   and on the CPU, prefill then teacher-forced decode, logits compared at
   every step; the card's engine against its own lockstep generate;
5. full width: qwen2-0.5b (24 layers, d_model 896, bf16, random weights
   from a seed) serves 8 requests through 4 slots (``serve_dense``, which
   phases 19 and 20 share); the exact launch counts show every factored
   linear went through the kernel; the device time ``device_events`` sums
   from the profiler's raw events is printed beside ``key_averages``'
   for one decode trace; one prompt's logits, prefill and 3 teacher-forced
   decode steps, are held against the same weights in f32 on the CPU
   (``logits_vs_cpu``, the one logits check of phases 5, 18, 19 and 20:
   RMS error within 0.015 sqrt(L) and largest error within 0.07 sqrt(L)
   of the RMS logit, L the depth);
6. training kernels: hold the sketch forward, the backward, the Gram and
   the CholeskyQR kernels against their plain versions at the training
   shapes of qwen2-0.5b (M = 2048 and a ragged 1000 rows; the stacked
   (24, O, K) factors of each site for Gram and CholeskyQR), bf16 and
   f32, and time kernel, plain version, library yardstick and bound;
   bf16 sketch and backward take the tensor-core route (bf16 pieces of
   h and dh), f32 the FMA kernels; each shape prints its route and the
   error margin (tolerance over error); the Gram's route and plan per
   stack (bf16: the upper-triangle tiles on the tensor cores), G exactly
   symmetric and the same bits in two calls; then one tinyllama-1.1b
   refresh in bf16, its stacks (22, 2,048, 512), (22, 256, 128) and (22,
   5,632, 512): K = 512 takes #4's global factor (``choleskyqr.cu``);
7. smoke training parity: qwen2 smoke, ``wsi``, AdamW, refresh every 2,
   4 steps from one seed and one batch stream on the card and on the CPU
   (f32); losses and final factors compared, launch counts exact;
8. full-width training: qwen2-0.5b (24 layers, bf16, ``wsi``, the
   config's ``remat="block"``), AdamW,
   batch 4 x seq 512, refresh every 4, 8 steps through
   ``launch/train.py``'s build and ``train/loop.py``, which saves the
   final state with the port's ``CheckpointManager``; step time,
   tokens/s, peak memory, busy share (the device sums of the step's trace
   also printed beside ``key_averages``'), exact launch counts (the
   recompute's included: ``train_want``), the
   checkpoint read back equal, and one step at batch 1 x seq 32 against
   the same weights in f32 on the CPU;
9. int8 kernel: hold each route of ``lowrank_q8`` (decode, tensor-core,
   fused; ``quant.q8_route``) against its plain version at the seven
   sites' shapes and a ragged one, M from 4 to 1,024 (both sides of the
   decode threshold), bf16 and f32, two calls bit-equal; time kernel,
   plain version, library yardstick and bound; headlines for a decode
   layer (M = 4) and a prefill layer (M = 1,024); a sweep of the decode
   and tensor-core routes over M = 1-32 (where the threshold comes from);
10. int8 deployment at full width: phase 8's checkpoint ->
   ``load_checkpoint`` -> ``plan.quantized("int8")`` -> ``convert.quantize``
   -> ``save_checkpoint`` -> ``ServeEngine.from_checkpoint`` on the card
   serves phase 5's 8 requests through 4 slots; exact launch counts (168
   ``lowrank_q8`` per forward, no ``lowrank_fwd``), packed weight bytes,
   one prefill's logits (card f32 and bf16) against the CPU's f32 run of
   the same int8 tree, decode in turns against the same weights with bf16
   factors, and qwen2 smoke int8 served on the card and the CPU with
   equal greedy tokens;
11. tiled matmul: hold ``matmul_tiled`` (``ops.matmul``) against its plain
   version at ragged shapes and at decode rows, B row-major and a
   transposed view, bf16 and f32 (each row prints its route,
   ``matmul_tiled.matmul_route``; two calls bit-equal), and the two-launch ``ops.lowrank_matmul_unfused`` at the seven
   sites' shapes, M in (4, 1024, 2048), beside the fused kernel #1 at the
   same shapes; time kernel, plain version, ``torch.matmul`` and bound;
12. the paper's Table 2 at full width: qwen2-0.5b (24 layers, bf16,
   batch 4 x seq 512, AdamW, refresh every 4) trained 5 steps under each
   method, ``none``, ``asi``, ``wsi`` and ``wasi``, through
   ``launch/train.py``'s build and ``train_loop(memprof=True)``: step
   time, tokens/s, the allocator's peak (all under the config's
   ``remat="block"``), the saved-for-backward bytes of one ``lm_loss``
   and the allocator's peak of one forward and backward under ``block``
   and under ``none`` (the paper's memory comparison is the ``none``
   column), and the time of one ``lm_forward`` without states; exact
   launch counts, the recompute's included (``wasi``: #7 and, at the
   refresh, Gram and CholeskyQR; 168 ``lowrank_fwd`` per inference
   forward); the Table 2 two-launch row (the trained
   factors of layer 0 through ``lowrank_matmul_unfused``: 14
   ``matmul_tiled`` launches) against the fused kernel; one full-width
   ``wasi_matmul`` per site shape saves exactly its Tucker factors, h~'s
   last factor, L and R, and not x; one ``wasi`` and one ``none`` step
   under the profiler (busy share); qwen2 smoke under ``wasi``
   (SGD+momentum) trained on the card and the CPU from the same weights
   and ASI states, compared;
13. flash attention: hold ``flash_attention`` (kernel #7, ``ops``) against
   its plain version on the reference's sweep (ragged 100, GQA, windows,
   dh 16-128, causal and not; f32 and bf16) and the main paths' shapes
   (ViT-B/16 at batch 64, f32, bidirectional; qwen2-0.5b's training rows
   and one prefill bucket, and zamba2-7b's 4 x 256 prefill bucket, bf16,
   causal; the dense configs' shapes: tinyllama-1.1b's training rows and
   prefill bucket, the prefill buckets of stablelm-3b (dh 80),
   granite-3-8b and internvl2-26b (dh 128), gemma3-4b's 1,536 bucket
   under its 1,024-key window at dh 256); each row's route (bf16, or
   f32 in exact bf16 pieces) and plan (``flash_attention.flash_plan``);
   time kernel, plain version, ``scaled_dot_product_attention`` and
   bound, and a headline per path;
   a sweep of every plan at the paths' shapes and at shapes on the other
   side of each of ``flash_plan``'s thresholds (where they come from),
   each plan held on fresh inputs with its output's memory NaN first;
   one backward through
   ``_FlashAttention`` against autograd of the plain version; the tiled
   backward (above 2,048 tokens) at qwen2-0.5b's heads, bf16, causal: at
   4,096 tokens against autograd of the plain version, at 32,768 tokens
   one forward and backward with the allocator's peak;
14. ViT smoke: vit-smoke under project-mode ``wasi``, SGD+momentum, 4
   steps on the card and the CPU from the same params, ASI states and WSI
   states; losses, W, (L, R) and ASI factors compared; exact launches;
15. the paper's Fig. 5 / Tab. 1 at full width: ViT-B/16 (12 layers, d
   768, f32, random init from a seed) on ``SyntheticVision`` (10
   classes, 196 patches of 768, noise 0.5), batch 64, SGD+momentum, 10
   steps per row: ``none``, ``asi`` and project-mode ``wasi`` at epsilon
   0.8 under scope "mlp" (Fig. 5), and ``wasi`` under scope "all" (Tab.
   1); step time, images/s, the allocator's peak, the saved bytes of one
   ``vit_loss``, one ``vit_forward`` without states, the busy share of
   one step, the picked ranks, the loss after step 10, and exact launch
   counts (12 of #7 per forward, none in the backward);
16. SSD scan: hold ``ssd_scan`` (kernel #8) against its plain version,
   y and the final state, on the reference's sweep, ragged S and the
   path's shapes (zamba2-7b's 4 x 256 prefill bucket, the 700-token
   prompt's 768 bucket, one 4,096-token prompt), in f32 and, at the
   path's shapes, with bf16 u, B and C (B and C as row views, as the
   mixer hands them over; the plain version reads the same values in
   f32); each row's route (``ssd_route``), two calls bit-equal; time
   kernel, plain version, the f32 CUDA-core bound and the route's own
   (no library call computes this function); the headline is the bf16
   prefill bucket, what the main path runs;
17. zamba2 smoke, card against CPU (f32): the same seeded weights,
   prefill with ragged ``valid_len`` then teacher-forced decode, logits
   and caches compared at every step, exact launches; the card's engine
   against its own lockstep ``generate``;
18. zamba2-7b at full width (81 Mamba-2 layers, the shared attention
   block after every sixth, bf16, weights drawn on the card from a
   seed) serves phase 5's 8 requests and one of 700 tokens through 4
   slots at ``max_cache`` 1024: decode and prefill tok/s, TTFT, TPOT,
   weight and cache bytes (KV, SSM, conv), the allocator's peak, the
   busy share of a decode tick and of a prefill under the profiler
   (and #8's device ms in that prefill tick),
   exact launches (81 of #8 and 13 of #7 per prefill call, none per
   decode step, 334 of #1 per forward or decode step); one prompt's
   logits at full width and
   reduced depth (5 ``mamba2`` + 1 ``mamba2_attn``), bf16 on the card
   against the same weights in f32 on the CPU (``logits_vs_cpu``);
19. tinyllama-1.1b, the paper's Fig. 7 model, at full width and depth (22
   layers, d 2,048, bf16, random weights from a seed): trained under
   ``wasi``, ``wsi`` and ``none`` through ``launch/train.py``'s build and
   ``train_loop(memprof=True)``, batch 4 x seq 512 of seeded uniform
   tokens, SGD+momentum 0.9 at a constant 0.05, refresh every 8: 8 steps
   under the config's ``remat="block"``, then 4 under ``"none"``, each
   row with step time, tokens/s, the allocator's peak, the busy share of
   one profiled step and exact launch counts (the recompute's included;
   ``train_run``, which phase 12 shares); the saved bytes of one
   ``lm_loss`` and the peak of one forward and backward under each
   setting from one state (``remat_memory``); one step's gradients and
   ASI states under ``block`` against ``none`` from the same state
   (largest difference, bit-equal or not); Fig. 7's analytic weight and
   activation ratios for the last 1 and 2 layers from the full config;
   then phase 5's 8 requests served through 4 slots (154 launches of #1
   per forward, 22 of #7 per prefill call) and one prompt's logits,
   prefill and 3 teacher-forced decode steps, against the same weights in
   f32 on the CPU;
20. the other dense configs at full width, weights drawn on the card:
   gemma3-4b at full depth (34 layers: 5 x (5 ``local`` + 1 ``dense``) +
   4 ``local``, window 1,024, dh 256, tied vocab 262,144, softcap 30)
   serves phase 5's requests and one of 1,500 tokens at ``max_cache``
   2,048 (#7 windowed, the local layers' rolling caches wrap);
   stablelm-3b, granite-3-8b and internvl2-26b, depth cut to 2 layers,
   serve phase 5's requests (internvl2 also a forward of precomputed
   embeddings); exact launches; each config's logits against the f32
   CPU at reduced depth (gemma3: one pattern of 6 layers, a 1,100-token
   prompt, then decode reading wrapped rolling caches);
21. tinyllama-1.1b in the paper's project mode, full width and depth:
   dense weights drawn on the card (method ``none``, a pretrained
   checkpoint's place) -> ``api.resolve(cfg, calibration=dense)``, the
   epsilon-0.8 ranks of every site (the max over its 22-layer stack,
   rank_align 128), timed, with ``mlp/gate``'s unaligned rank at layers 0
   and 21 held to ``pick_rank`` on the CPU -> ``convert.factorize`` to the
   project layout {w, L, R}; kernel #1 held to its plain version at the
   calibrated sites' shapes; per method (``wasi``, ``wsi``): the
   converted factors as warm WSI states (``make_train_state``), the saved
   bytes and peaks of one loss under ``block`` and ``none``, 6 steps under
   ``block`` (phase 19's batch 4 x 512, SGD+momentum 0.9 at 0.05) through
   ``train_loop`` with exact launches (#7 44 a step, nothing else), a
   profiled step (busy share) and a profiled WSI step (its device time
   beside the rest of the step's), and one project step at 2 layers, bf16
   on the card against f32 on the CPU (loss, W gradients, then one
   ``update_project_states``); the trained W -> ``convert.factorize``
   under the calibrated plan in the config's factored mode -> a
   plan-bearing checkpoint -> ``ServeEngine.from_checkpoint`` serves phase
   5's requests (#1's route per site at decode and prefill, 154 launches
   a forward) and one prompt's logits against the f32 CPU;
22. #8's gradient: ``ops.ssd_scan`` with grad (``_SSDScan``: the kernel's
   forward, a plain chunked backward) at zamba2-7b's heads (H 112, dh 64,
   N 64, chunk 256), bf16 and f32, S 256, 512 and a ragged 700, against
   the CPU's plain autograd in f32 (``ssd_grad_tol``: 8 eps sqrt(r) of
   each gradient's scale, r the terms an entry sums, plus one bf16
   rounding), two runs bit-equal, one launch a forward and none a
   backward; the forward's and the backward's device time at one
   zamba2 training layer (4 x 512);
23. zamba2-7b trained at full width and depth (81 layers, bf16, the
   config's ``remat="block"``), batch 4 x 512 of seeded uniform tokens,
   SGD+momentum 0.9 at a constant 0.05, refresh every 8, under ``wasi``
   and ``wsi``: the saved-for-backward bytes and peak of one loss, 8
   steps through ``train_loop`` (exact launches of every kernel:
   ``train_want`` from ``forward_counts``) and a profiled step (busy
   share); per method one step at 9 layers (the pattern once and the
   tail) on the card under ``block`` and ``none`` (the same bits) and in
   f32, against the f32 CPU; then int8 zamba2 at 9 layers through
   ``plan.quantized("int8")`` -> ``convert.quantize`` -> a plan-bearing
   checkpoint -> ``ServeEngine.from_checkpoint``, serving phase 5's
   requests through #6 (exact launches);
24. falcon-mamba-7b (64 Mamba-1 layers, d 4,096, bf16): kernel #1 at its
   four sites' shapes (M = 4 and 1,024); served at full width and depth
   (phase 5's requests and a 700-token prompt, 256 launches of #1 a
   forward, the plain selective scan's device time in a profiled prefill
   tick and alone at the buckets' shapes), then int8 through #6; logits
   against the f32 CPU at 4 layers; one ``wasi`` and one ``wsi`` run of 2
   steps at 4 layers, batch 4 x 512 (exact #2 and #3 launches).

Every full-sequence attention (training, a forward without caches, the
prefill at offset 0) goes through kernel #7, so phases 5, 7, 8, 10, 12,
19, 20 and 21 count its launches too: 24 per qwen2-0.5b forward or prefill
call, none per decode step. Under ``remat="block"`` (every full LM
config) a training step runs each forward kernel twice, the forward and
the backward's recompute, so phases 8, 12 and 19 count #2 and #7 twice a
step and #3 once. Every Mamba-2 scan of a train or prefill pass goes
through kernel #8 (phases 17, 18, 22, 23); Mamba-1's selective scan is
plain PyTorch, as the reference's is (phase 24).

Phase 6 also holds the CholeskyQR kernel's shift ladder against the plain
ladder on a stack with one well-conditioned and one ill-conditioned index.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. ``--json PATH`` also writes
every measurement (per-shape kernel rows, serving and training figures) to
PATH.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from typing import NamedTuple

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import api, configs  # noqa: E402
from repro_torch.api.bridge import from_reference, to_reference  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.api import convert  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointManager,
    load_manifest,
    save_checkpoint,
)
from repro_torch.config import TrainConfig  # noqa: E402
from repro_torch.core.project import (  # noqa: E402
    project_forward_params,
    update_project_states,
)
from repro_torch.core.orthogonal import (  # noqa: E402
    cholesky_qr_mix_ref,
    orthonormality_error,
)
from repro_torch.data.synthetic import SyntheticLM  # noqa: E402
from repro_torch.kernels import flash_attention as kflash  # noqa: E402
from repro_torch.kernels import gram as kgram  # noqa: E402
from repro_torch.kernels import lowrank as klowrank  # noqa: E402
from repro_torch.kernels import matmul_tiled as kmm  # noqa: E402
from repro_torch.kernels import qr as kqr  # noqa: E402
from repro_torch.kernels import quant as kquant  # noqa: E402
from repro_torch.kernels import ssd_scan as kssd  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.optim import global_norm  # noqa: E402
from repro_torch.train.loop import train_loop  # noqa: E402
from repro_torch.train.step import (  # noqa: E402
    make_train_state,
    make_train_step,
    value_and_grad,
)
from repro_torch.models.lm import (  # noqa: E402
    _dtype,
    init_lm,
    init_lm_cache,
    lm_decode_step,
    lm_forward,
    lm_loss,
    lm_prefill,
)
from repro_torch.quant import quantize_tensor  # noqa: E402
from repro_torch.serve import SamplingParams, ServeEngine  # noqa: E402
from repro_torch.serve.engine import _tree_leaves  # noqa: E402

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
# checkpoints of phases 8 and 10, inside the checkout (git-ignored build/)
CKPT_DIR = os.path.join(ROOT, "build", "chip_smoke_ckpt")


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


def bound_of(nbytes, flops, dtype):
    """The least time (ms) the card could take: bytes at the HBM rate
    against flops at the dtype's peak, and which of the two it is."""
    tb, tf = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype]
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def bound(m, i, k, o, dtype):
    return bound_of(*work(m, i, k, o, dtype), dtype)


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


def lowrank_tol(want, i, k, dtype) -> float:
    """f32: sums of I then K terms in another order, bounded by 2 (I + K)
    eps |y|; bf16 adds one rounding of the output. (The tensor-core
    route's two bf16 pieces of h add at most 2^-17 of each term of h L^T,
    0.018-0.081 of the f32 part at qwen2's shapes, tests/test_torch_split.py.)"""
    scale = want.float().abs().max().item()
    tol = 2 * (i + k) * EPS32 * max(scale, 1.0)
    if dtype == torch.bfloat16:
        tol += 2.0 ** -7 * scale
    return tol


def held_twice(label, fn, args, want, tol):
    """``fn(*args)`` twice on the same inputs: the two results bit-equal,
    the first within ``tol`` of ``want``; returns its max abs error."""
    got, again = fn(*args), fn(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two calls on the same inputs differ")
    err = (got.float() - want.float()).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{label}: max abs err {err:.3e} > tol "
                             f"{tol:.3e}")
    return err


def lowrank_row(tag, name, m, i, k, o, dtype, gen, card: str) -> dict:
    """Kernel #1 at one shape: its route (``forward_route``) held to the
    plain version with two bit-equal calls, then timed beside the plain
    version, the library's two matmuls and the bound."""
    (x, r, l_), = inputs(m, i, k, o, dtype, gen)
    route = klowrank.forward_route(m, i, k, o, dtype, (x, r, l_))
    want = ref.lowrank_matmul_ref(x, r, l_)
    tol = lowrank_tol(want, i, k, dtype)
    err = held_twice(f"lowrank_fwd {name} M={m} {dtype} ({route})",
                     ops.lowrank_matmul, (x, r, l_), want, tol)
    del x, r, l_, want
    nbytes, _ = work(m, i, k, o, dtype)
    n_sets = max(1, min(48, int(120e6 // nbytes) + 1))
    sets = inputs(m, i, k, o, dtype, gen, n_sets)
    k_ms = time_ms(ops.lowrank_matmul, sets)
    p_ms = time_ms(ref.lowrank_matmul_ref, sets)
    l_ms = time_ms(library_lowrank, sets)
    kc_ms = call_ms(ops.lowrank_matmul, sets)
    b_ms, b_by = bound(m, i, k, o, dtype)
    how = route
    if route == "fused":
        how += f" ({klowrank.launch_config(m, k, o).bm}-row tiles)"
    print(f"{tag} lowrank_fwd {name:11s} I={i} K={k} O={o} M={m:4d} "
          f"{str(dtype)[6:]:8s} route={how} err={err:.2e} (tol "
          f"{tol:.2e}) kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
          f"library_ms={l_ms:.4f} bound_ms={b_ms:.5f} ({b_by}) "
          f"eager_call_ms={kc_ms:.4f} | {card}", flush=True)
    return dict(site=name, M=m, I=i, K=k, O=o, dtype=str(dtype)[6:],
                route=route, kernel_ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                bound_ms=b_ms, bound_by=b_by, kernel_call_ms=kc_ms,
                max_abs_err=err, tol=tol)


def layer_headline(label, rows, counts, dtype, card: str) -> dict:
    """Sum of ``rows``' times over one layer's sites (``counts``: sites
    per row key), beside the bound of the layer's bytes and flops."""
    tot = dict.fromkeys(("ms", "plain_ms", "library_ms", "eager_call_ms"),
                        0.0)
    nbytes = flops = 0
    for row in rows:
        c = counts[row["site"]]
        for key, src in (("ms", "kernel_ms"), ("plain_ms", "plain_ms"),
                         ("library_ms", "library_ms"),
                         ("eager_call_ms", "kernel_call_ms")):
            tot[key] += c * row[src]
        b, f = work(row["M"], row["I"], row["K"], row["O"], dtype)
        nbytes, flops = nbytes + c * b, flops + c * f
    tot["bound_ms"], tot["bound_by"] = bound_of(nbytes, flops, dtype)
    print(f"[kernel] lowrank_fwd {label}: kernel_ms={tot['ms']:.4f} "
          f"plain_ms={tot['plain_ms']:.4f} library_ms="
          f"{tot['library_ms']:.4f} bound_ms={tot['bound_ms']:.5f} "
          f"({tot['bound_by']}) eager_call_ms={tot['eager_call_ms']:.4f} | "
          f"{card}", flush=True)
    return tot


# M rows of the route sweep: the decode route covers at most 32 (4 n8
# tiles of mma)
SWEEP_MS = (1, 4, 8, 12, 16, 24, 32)


def route_sweep(card: str) -> list:
    """The decode route (``lowrank._decode``) against the tensor-core route
    (``lowrank._sketch_bf16`` without h) at M = 1-32, bf16, at qwen2-0.5b's
    and zamba2-7b's site shapes; each held to the plain version with two
    bit-equal calls, then both timed. ``lowrank.DECODE_MAX_M`` is the
    largest M at which the decode route is the faster at every shape."""
    gen = torch.Generator(device="cuda").manual_seed(33)
    shapes = dict(SHAPES, **{f"z:{n}": ZAMBA_SHAPES[n] for n in (
        "ssm/in_proj", "ssm/bcdt_proj", "ssm/out_proj", "mlp/down")})
    rows = []
    for name, (i, k, o) in shapes.items():
        for m in SWEEP_MS:
            dtype = torch.bfloat16
            (x, r, l_), = inputs(m, i, k, o, dtype, gen)
            want = ref.lowrank_matmul_ref(x, r, l_)
            tol = lowrank_tol(want, i, k, dtype)
            fns = {"decode": lambda x, r, l_: routed(klowrank._decode, x, r,
                                                     l_),
                   "tensor_core": lambda x, r, l_: routed(
                       klowrank._sketch_bf16, x, r, l_, None)}
            errs = {n: held_twice(f"route sweep {name} M={m} {n}", f,
                                  (x, r, l_), want, tol)
                    for n, f in fns.items()}
            del x, r, l_, want
            nbytes, _ = work(m, i, k, o, dtype)
            sets = inputs(m, i, k, o, dtype, gen,
                          max(1, min(48, int(120e6 // nbytes) + 1)))
            ms = {n: time_ms(f, sets) for n, f in fns.items()}
            del sets
            best = min(ms, key=ms.get)
            print(f"[sweep] {name:15s} M={m:3d} decode_ms={ms['decode']:.4f} "
                  f"tensor_core_ms={ms['tensor_core']:.4f} faster={best} "
                  f"errs decode {errs['decode']:.2e} tensor_core "
                  f"{errs['tensor_core']:.2e} (tol {tol:.2e}) | {card}",
                  flush=True)
            rows.append(dict(site=name, M=m, decode_ms=ms["decode"],
                             tensor_core_ms=ms["tensor_core"], faster=best))
    return rows


def routed(launch, x, r, l_, *extra):
    """y of one route's launcher, called directly (no count)."""
    y = torch.empty((x.shape[0], l_.shape[0]), dtype=x.dtype,
                    device=x.device)
    launch(x, r, l_, y, *extra)
    return y


# a bf16 shape whose widths ``tensor_core_route`` refuses (not multiples
# of 8): the fused kernel at every M
RAGGED_SHAPE = {"ragged": (70, 5, 33)}


def plan_shapes(plan) -> dict:
    """{"wq|wo": (I, K, O), ...}: a plan's factored sites grouped by
    shape, in the plan's order."""
    shapes: dict = {}
    for sp in plan.specs:
        shapes.setdefault((sp.in_dim, sp.rank, sp.out_dim), []).append(
            sp.name.split("/")[1])
    return {"|".join(names): sh for sh, names in shapes.items()}


def dense_lowrank_rows(card: str) -> tuple[list, dict]:
    """Kernel #1 at tinyllama-1.1b's and internvl2-26b's site shapes, bf16,
    a decode step's rows (M = 4, the decode route) and a prefill bucket's
    (M = 1,024); the headline of a tinyllama decode layer's 7 sites."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    rows, counts = [], {}
    for arch in ("tinyllama-1.1b", "internvl2-26b"):
        tag = arch.split("-")[0]
        for name, (i, k, o) in plan_shapes(
                api.resolve(configs.get(arch))).items():
            counts[f"{tag}:{name}"] = name.count("|") + 1
            for m in (4, 1024):
                row = lowrank_row(f"[{tag}]", f"{tag}:{name}", m, i, k, o,
                                  torch.bfloat16, gen, card)
                if m == 4 and row["route"] != "decode":
                    raise AssertionError(f"{arch} {name} M=4 took "
                                         f"{row['route']}")
                rows.append(row)
    head = layer_headline(
        "one tinyllama-1.1b layer's 7 sites at decode (M=4, bf16)",
        [r for r in rows if r["site"].startswith("tinyllama")
         and r["M"] == 4], counts, torch.bfloat16, card)
    return rows, head


def phase_kernels(card: str) -> dict:
    print("== phase 3: lowrank_fwd (each route) against its plain version",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    d = klowrank.DECODE_MAX_M
    ms = sorted(set(MS) | {d, d + 1})
    rows = []
    for name, (i, k, o) in dict(SHAPES, **RAGGED_SHAPE).items():
        for m in ms:
            for dtype in (torch.bfloat16, torch.float32):
                rows.append(lowrank_row("[kernel]", name, m, i, k, o, dtype,
                                        gen, card))
    routes = {(r["route"], r["M"] <= d) for r in rows}
    if not {("decode", True), ("tensor_core", False), ("fused", False),
            ("fused", True)} <= routes:
        raise AssertionError(f"phase 3 missed a route: {sorted(routes)}")
    zrows = zamba2_lowrank_rows(card)
    drows, dense_head = dense_lowrank_rows(card)
    worst = max(r["max_abs_err"] for r in rows + zrows + drows)
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
    # zamba2-7b: a mamba2_attn layer's 10 sites (the mixer's 3, the shared
    # block's 7) at a prefill bucket's 1,024 rows
    zamba = layer_headline(
        "one zamba2 mamba2_attn layer's 10 sites at prefill (M=1024, bf16)",
        [r for r in zrows if r["M"] == 1024], ZAMBA_LAYER_SITES,
        torch.bfloat16, card)
    sweep = route_sweep(card)
    return dict(rows=rows, zamba2_rows=zrows, worst=worst, sweep=sweep,
                zamba2_headline=zamba, dense_rows=drows,
                tinyllama_decode_headline=dense_head, headline=dict(
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


SERVE_LENGTHS = (5, 17, 33, 64, 9, 120, 48, 200)   # phase 5's requests
# logits_vs_cpu's limits, per square root of the depth, against the RMS
# logit: the RMS error and the largest error
LOGIT_RMS_TOL, LOGIT_MAX_TOL = 0.015, 0.07


def serve_dense(tag: str, cfg, model, plan, card: str, *, extra=(),
                max_cache: int = 512, check_sums: bool = False,
                engine=None, kernel: str = "lowrank_fwd",
                prefill_profile: bool = False) -> dict:
    """Phase 5's 8 requests (2 sampled) and prompts of ``extra`` lengths
    through 4 slots, 16 new tokens each: decode and prefill tok/s, TTFT,
    TPOT, weight and cache MiB, the allocator's peak, exact launches (the
    factored linears' ``kernel``, #1 or #6 of an int8 deployment, per
    forward or decode step; #7 and #8 per attention and Mamba-2 layer of
    a prefill call, none per decode step; ``forward_counts``) and the busy
    share of a decode tick (``profile_decode``, which ``check_sums`` is
    handed to) and, with ``prefill_profile``, of a prefill tick
    (``profile_prefill``). ``engine``: an engine built elsewhere
    (``ServeEngine.from_checkpoint``, 4 slots) instead of one over
    ``model``."""
    eng = engine or ServeEngine(model, plan=plan, max_slots=4,
                                max_cache=max_cache, device="cuda")
    rng = np.random.default_rng(1)
    eng.submit(list(map(int, rng.integers(0, cfg.vocab_size, 9))), max_new=4)
    eng.run()
    eng.reset_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lengths = SERVE_LENGTHS + tuple(extra)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n)))
               for n in lengths]
    sampled = SamplingParams(temperature=0.8, top_k=50, seed=99)
    ops.reset_launches()
    hs = [eng.submit(p, max_new=16,
                     sampling=sampled if i in (2, 5) else None)
          for i, p in enumerate(prompts)]
    eng.run()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    s = eng.summary()
    for h in hs:
        if not (h.finished and len(h.generated) == 16):
            raise AssertionError(f"{tag} request {h.rid} ended {h.status} "
                                 f"with {len(h.generated)} tokens")
        if not all(0 <= t < cfg.padded_vocab for t in h.generated):
            raise AssertionError(f"{tag} request {h.rid}: token out of "
                                 "range")
    fc = forward_counts(cfg)
    per_fwd = fc["sites"]
    lr = counts[kernel]
    if lr % per_fwd or lr < per_fwd * s["decode_steps"]:
        raise AssertionError(f"{tag} {kernel} launches {lr} is not a "
                             f"multiple of {per_fwd} covering "
                             f"{s['decode_steps']} decode steps")
    prefills = lr // per_fwd - s["decode_steps"]
    want = dict.fromkeys(counts, 0)
    want.update({kernel: lr, "flash_attention": fc["flash"] * prefills,
                 "ssd_scan": fc["ssd"] * prefills})
    if counts != want:
        raise AssertionError(f"{tag} serving launches {counts} != {want}")
    print(f"[{tag}] launches: {kernel} {lr} = {lr // per_fwd} forwards x"
          f" {per_fwd} factored linears ({cfg.n_layers} layers; "
          f"{s['decode_steps']} decode steps + {prefills} prefill calls); "
          f"flash_attention {counts['flash_attention']} = {prefills} prefill"
          f" calls x {fc['flash']}, ssd_scan {counts['ssd_scan']} = "
          f"{prefills} x {fc['ssd']}, 0 of either per decode step",
          flush=True)
    ttft = [h.ttft_s for h in hs]
    tpot = [h.tpot_s for h in hs]
    res = dict(prefill_tok_s=s["prefill_tok_s"],
               decode_tok_s=s["decode_tok_s"],
               ttft_ms_median=statistics.median(ttft) * 1e3,
               ttft_ms_max=max(ttft) * 1e3,
               tpot_ms_median=statistics.median(tpot) * 1e3,
               weight_mib=s["weight_mib"], kv_mib=s["cache_bytes"] / 2**20,
               max_memory_allocated_mib=torch.cuda.max_memory_allocated()
               / 2**20, decode_steps=s["decode_steps"],
               prefill_calls=prefills, launches=counts,
               launches_per_forward=per_fwd, prefill_tokens=s[
                   "prefill_tokens"], decode_tokens=s["decode_tokens"],
               wall_s=s["wall_s"])
    if extra:
        res["ttft_ms_extra"] = [t * 1e3 for t in ttft[len(SERVE_LENGTHS):]]
    for key in ("prefill_tok_s", "decode_tok_s", "ttft_ms_median",
                "ttft_ms_max", "tpot_ms_median", "weight_mib", "kv_mib",
                "max_memory_allocated_mib"):
        print(f"[{tag}] {key}={res[key]:.3f} | {card}")
    if extra:
        print(f"[{tag}] TTFT of the {list(extra)}-token prompt(s): "
              f"{[round(t, 1) for t in res['ttft_ms_extra']]} ms | {card}")
    print(f"[{tag}] greedy sample rid=0: {hs[0].generated}")
    res.update(profile_decode(eng, cfg, rng, card, check_sums))
    if prefill_profile:
        res.update(profile_prefill(eng, cfg, rng, card))
    del eng
    return res


def logits_vs_cpu(tag: str, cfg, model, card: str, *, prompt_len: int = 16,
                  decode: int = 4,
                  limits: tuple = (LOGIT_RMS_TOL, LOGIT_MAX_TOL)) -> dict:
    """One prompt prefilled, then ``decode`` - 1 teacher-forced decode
    steps, bf16 on the card against the same weights in f32 on the CPU:
    the one logits check of phases 5, 18, 19 and 20. bf16 rounds every
    activation to 8 significant bits, and the logits' error grows about
    as the square root of the depth L: on an H100 the attention models
    read RMS errors of 0.0083-0.0102 sqrt(L) and largest errors of
    0.038-0.047 sqrt(L) of the RMS logit at L = 2 (stablelm, granite,
    internvl2), 6 (gemma3), 22 (tinyllama) and 24 (qwen2), zamba2's 6
    Mamba-2 layers 0.0130 and 0.055 sqrt(L). Each step's RMS error is
    held within ``LOGIT_RMS_TOL`` sqrt(L) of the RMS of the CPU's logits
    (a typical logit) and its largest error within ``LOGIT_MAX_TOL``
    sqrt(L): 1.5x the attention models' largest readings, 1.15x and 1.27x
    zamba2's (the readings repeat to the digit from call to call). A
    wrong kernel, layout or cache gives an RMS error near the logits'
    own. ``limits``: another (RMS, largest) pair per sqrt(L), where a
    family's bf16 error differs for a stated reason (Mamba-1's, phase
    24) or the model runs in f32."""
    rng = np.random.default_rng(20)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (1, prompt_len + decode)))
    cache_len = prompt_len + decode
    cfg32 = cfg.replace(dtype="float32")
    plan = api.plan_of(cfg)
    api.install(dataclasses.replace(plan, model=cfg32))

    def run(m, c, dev, dtype):
        caches = init_lm_cache(c, 1, cache_len, dtype=dtype, device=dev)
        t = toks.to(dev)
        out = []
        with torch.inference_mode():
            lg, caches = lm_prefill(m, t[:, :prompt_len], c, caches=caches,
                                    last_only=True)
            out.append(lg[0, 0].float().cpu())
            for i in range(prompt_len, prompt_len + decode - 1):
                lg, caches = lm_decode_step(m, t[:, i:i + 1], caches, i, c)
                out.append(lg[0].float().cpu())
        return out

    gpu = run(model, cfg, "cuda", _dtype(cfg.dtype))
    tree = to_reference(model)
    cpu32 = from_reference(tree, cfg32, "cpu").float()
    del tree
    cpu = run(cpu32, cfg32, "cpu", torch.float32)
    del cpu32
    gc.collect()
    errs = []
    rms_tol = limits[0] * math.sqrt(cfg.n_layers)
    max_tol = limits[1] * math.sqrt(cfg.n_layers)
    for i, (a, b) in enumerate(zip(gpu, cpu)):
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        rms = b.square().mean().sqrt().item()
        rms_err = (a - b).square().mean().sqrt().item()
        errs.append(dict(max_abs_err=err, scale=scale, rms=rms,
                         rms_err=rms_err, argmax_card=int(a.argmax()),
                         argmax_cpu=int(b.argmax())))
        if not (rms_err <= rms_tol * rms and err <= max_tol * rms):
            raise AssertionError(f"{tag} step {i}: bf16 card vs f32 CPU "
                                 f"logits: RMS err {rms_err:.3e} (limit "
                                 f"{rms_tol:.4f} x {rms:.3e}), max abs err "
                                 f"{err:.3e} (limit {max_tol:.4f} x "
                                 f"{rms:.3e})")
    worst = max(e["rms_err"] / e["rms"] for e in errs)
    worst_max = max(e["max_abs_err"] / e["rms"] for e in errs)
    print(f"[{tag}] {cfg.n_layers} layers, a {prompt_len}-token prompt and "
          f"{decode - 1} decode steps, {cfg.dtype} card vs f32 CPU logits: "
          f"largest "
          f"RMS error {worst:.3e} of the RMS logit (limit {rms_tol:.4f}), "
          f"largest error {worst_max:.3e} of it (limit {max_tol:.4f}); per "
          f"step max"
          f" abs err {[round(e['max_abs_err'], 4) for e in errs]}, RMS err "
          f"{[round(e['rms_err'], 4) for e in errs]}, RMS logit "
          f"{[round(e['rms'], 4) for e in errs]}, argmax card/cpu "
          f"{[(e['argmax_card'], e['argmax_cpu']) for e in errs]} | {card}",
          flush=True)
    api.install(plan)
    return dict(steps=errs, worst_rel=worst, worst_max_rel=worst_max,
                rms_tol=rms_tol, max_tol=max_tol, prompt_len=prompt_len,
                n_layers=cfg.n_layers)


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
    res = serve_dense("full", cfg, model, plan, card, check_sums=True)
    # no NaN logits: one more prefill over 8 prompts of 5 tokens
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (8, 5))).cuda()
    with torch.inference_mode():
        c = init_lm_cache(cfg, 8, 16, device="cuda")
        lg, _ = lm_prefill(model, toks, cfg, caches=c)
        if torch.isnan(lg).any():
            raise AssertionError("NaN logits at full width")
    del lg, c
    res["cpu_logits"] = logits_vs_cpu("full", cfg, model, card)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return res


#: the profiler range phase 24 wraps each Mamba-1 selective scan in
SCAN_RANGE = "selective_scan"


class DeviceRow(NamedTuple):
    """One kernel (or copy) name's device time in a trace."""
    key: str
    self_device_time_total: float   # µs
    count: int


def device_events(prof, ranges: bool = False) -> list:
    """The profile's device-side rows, summed by name from the profiler's
    raw events: what ``key_averages`` gives for the device's kernels and
    copies (an aten op's row, which repeats the device time of the
    kernels it launched, is left out), without building every host
    event's record first (``key_averages`` took 11-24 s on a trace of
    80,000 launches on an H100; this takes well under one). The device
    span of a ``record_function`` range named ``SCAN_RANGE``, which
    repeats its kernels' time, is left out too; ``ranges`` returns those
    spans alone."""
    us: dict = {}
    count: dict = {}
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CUDA"):
            continue
        name = e.name()
        if (name == SCAN_RANGE) != ranges:
            continue
        us[name] = us.get(name, 0.0) + e.duration_ns() / 1e3
        count[name] = count.get(name, 0) + 1
    return [DeviceRow(k, v, count[k]) for k, v in us.items() if v > 0]


def check_device_sums(prof, events, label: str, card: str) -> dict:
    """``device_events``' sums beside ``key_averages``' device-side rows
    (the rule it replaced) on the same trace: totals, the largest
    per-name difference and the names whose counts differ. Run once on a
    decode trace and once on a training step's."""
    t0 = time.perf_counter()
    old = {e.key: (e.self_device_time_total, e.count)
           for e in prof.key_averages()
           if str(getattr(e, "device_type", "")).endswith("CUDA")
           and getattr(e, "self_device_time_total", 0) > 0}
    took = time.perf_counter() - t0
    new = {e.key: (e.self_device_time_total, e.count) for e in events}
    names = set(old) | set(new)
    tot_old = sum(v[0] for v in old.values())
    tot_new = sum(v[0] for v in new.values())
    worst = max((abs(old.get(n, (0, 0))[0] - new.get(n, (0, 0))[0])
                 for n in names), default=0.0)
    counts_differ = sum(old.get(n, (0, 0))[1] != new.get(n, (0, 0))[1]
                        for n in names)
    print(f"[profile] {label}: device time from the raw events "
          f"{tot_new / 1e3:.4f} ms in {len(new)} names, from key_averages "
          f"{tot_old / 1e3:.4f} ms in {len(old)} names (key_averages took "
          f"{took:.1f} s); largest per-name difference {worst:.3f} us, "
          f"names whose counts differ {counts_differ} | {card}", flush=True)
    return dict(raw_ms=tot_new / 1e3, key_averages_ms=tot_old / 1e3,
                raw_names=len(new), key_averages_names=len(old),
                max_name_diff_us=worst, names_counts_differ=counts_differ,
                key_averages_s=took)


def q8_kernel(key: str) -> bool:
    """Whether a profiled kernel is one of #6's: the fused kernel of
    lowrank_q8.cu, the decode route's products with int8 weights
    (lowrank_decode.cuh's templates on signed char), or a tensor-core
    product with an int8 B (gemm_bf16.cuh, Config<..., true, true, true,
    false>: A_K, B_K, int8 B, no batch)."""
    return ("lowrank_q8" in key or "signed char" in key
            or ("gemm16::" in key and "true, true, true, false>" in key))


def profile_decode(eng, cfg, rng, card: str, check_sums: bool = False
                   ) -> dict:
    """Device busy share of steady decode: 4 requests decoding, 5 engine
    ticks under torch.profiler; device time summed over CUDA kernels
    against the host wall clock of the ticks (the profiler's own host
    cost included, so the share is a lower bound). ``check_sums``: also
    ``check_device_sums`` on the trace."""
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
    events = device_events(prof)
    dev_us = sum(e.self_device_time_total for e in events)
    if dev_us <= 0:
        print(f"[profile] no device time in the trace: busy share not "
              f"measured | {card}")
        return {"decode_busy_share": None}
    sums = (check_device_sums(prof, events, "5 decode ticks", card)
            if check_sums else None)
    print(f"[profile] 5 decode ticks (4 slots): wall {wall_us / 5e3:.3f} ms "
          f"per tick, device busy {dev_us / 5e3:.3f} ms per tick, busy "
          f"share {dev_us / wall_us:.3f} | {card}")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        print(f"[profile]   {e.self_device_time_total / 5e3:8.3f} ms/tick "
              f"{e.count // 5:5d} calls/tick  {e.key[:70]}")
    q8_us = sum(e.self_device_time_total for e in events if q8_kernel(e.key))
    if q8_us:
        print(f"[profile]   #6's kernels: {q8_us / 5e3:.3f} ms/tick | {card}")
    return {"decode_busy_share": dev_us / wall_us, "decode_sums": sums,
            "decode_tick_wall_ms": wall_us / 5e3,
            "decode_tick_device_ms": dev_us / 5e3,
            "decode_q8_ms": q8_us / 5e3,
            "decode_top": [(e.key[:70], e.self_device_time_total / 5e3,
                            e.count // 5) for e in top]}


# ---------------------------------------------------------------------------
# training: kernels #2-#5, smoke parity, full width
# ---------------------------------------------------------------------------

TRAIN_M = (2048, 1000)
# how many of the seven sites share each shape (for one layer's total)
SITE_COUNT = {"attn/wq|wo": 2, "attn/wk|wv": 2, "mlp/gate|up": 2,
              "mlp/down": 1}
# the stacked L (repeat, O, K) of each site, as one WSI refresh sees it
STACKS = {"attn/wq|wo": (24, 896, 256), "attn/wk|wv": (24, 128, 128),
          "mlp/gate|up": (24, 4864, 256), "mlp/down": (24, 896, 256)}
TRAIN_KERNELS = ("lowrank_fwd_sketch", "lowrank_bwd", "gram", "choleskyqr")
# tinyllama-1.1b's refresh (phase 19): the stacked L (22, O, K) of its 7
# sites in 3 shapes, and how many sites share each; K = 512 is above the
# blocked factor's 288, so those stacks take #4's global factor
TINY_STACKS = {"attn/wq|wo|mlp/down": (22, 2048, 512),
               "attn/wk|wv": (22, 256, 128), "mlp/gate|up": (22, 5632, 512)}
TINY_STACK_COUNT = {"attn/wq|wo|mlp/down": 3, "attn/wk|wv": 2,
                    "mlp/gate|up": 2}


def itemsize(dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


def sketch_work(m, i, k, o, dtype):
    """#1's bytes and flops plus the f32 sketch h written once."""
    nbytes, flops = work(m, i, k, o, dtype)
    return nbytes + m * k * 4, flops


def bwd_work(m, i, k, o, dtype):
    """dy, x, h, L, R read once; dx, dL, dR written once; four products."""
    it = itemsize(dtype)
    nbytes = (m * o + m * i + o * k + k * i + m * i) * it \
        + (m * k + o * k + k * i) * 4
    return nbytes, 4 * m * k * (o + i)


def gram_work(b, m, k, dtype):
    return b * m * k * itemsize(dtype) + b * k * k * 4, 2 * b * m * k * k


def choleskyqr_work(b, m, k, dtype):
    """Y read once, Q and mix written once; Gram, apply and mix products,
    plus K^3 / 3 each for the Cholesky and the triangular inverse."""
    nbytes = 2 * b * m * k * itemsize(dtype) + b * k * k * 4
    flops = 4 * b * m * k * k + 2 * b * k ** 3 + 2 * b * k ** 3 // 3
    return nbytes, flops


# yardsticks: timed here, used nowhere in the port
def library_bwd(dy, x, h, l_, r):
    dh = torch.matmul(dy, l_)
    return (torch.matmul(dh, r), torch.matmul(dy.T, h.to(dy.dtype)),
            torch.matmul(dh.T, x))


def library_gram(y):
    yf = y.float()
    return torch.matmul(yf.mT, yf)


def library_choleskyqr(y):
    """Gram, torch.linalg.cholesky_ex (cholesky without its host-side
    check, so it runs in a CUDA graph) and two solve_triangular."""
    yf = y.float()
    g = torch.matmul(yf.mT, yf)
    k = g.shape[-1]
    scale = torch.clamp(torch.diagonal(g, dim1=-2, dim2=-1).sum(-1) / k,
                        min=1e-30)
    eye = torch.eye(k, device=y.device)
    c, _ = torch.linalg.cholesky_ex(g + (1e-6 * scale)[..., None, None]
                                    * eye)
    q = torch.linalg.solve_triangular(c, yf.mT, upper=False).mT
    return q.to(y.dtype), torch.linalg.solve_triangular(c, g, upper=False)


def library_after_gram(y, g):
    """library_choleskyqr from a given Gram: cholesky_ex and two solves."""
    k = g.shape[-1]
    scale = torch.clamp(torch.diagonal(g, dim1=-2, dim2=-1).sum(-1) / k,
                        min=1e-30)
    eye = torch.eye(k, device=y.device)
    c, _ = torch.linalg.cholesky_ex(g + (1e-6 * scale)[..., None, None]
                                    * eye)
    q = torch.linalg.solve_triangular(c, y.float().mT, upper=False).mT
    return q.to(y.dtype), torch.linalg.solve_triangular(c, g, upper=False)


def qr_after_gram(y, g):
    """#4 from a given Gram: its route's factor and apply launches alone
    (``qr._blocked`` or ``qr._global``, what ``qr.choleskyqr`` launches
    after the Gram), no count."""
    lead, (m, k) = y.shape[:-2], y.shape[-2:]
    b = math.prod(lead)
    q = torch.empty_like(y)
    mix = torch.empty((*lead, k, k), dtype=torch.float32, device=y.device)
    retried = torch.empty(lead, dtype=torch.int32, device=y.device)
    factor, apply = kqr.qr_route(k, y.dtype, (y, q))
    code = klowrank.dtype_code("choleskyqr", y)
    err = (kqr._blocked(y, g, q, mix, retried, b, m, k, code, 1e-6,
                        apply == "tensor_core") if factor == "blocked"
           else kqr._global(y, g, q, mix, retried, b, m, k, code, 1e-6))
    if err != 0:
        raise AssertionError(f"choleskyqr after the Gram: CUDA error {err}")
    return q, mix


def profile_choleskyqr(b, o, k, card: str) -> dict:
    """One #4 call (Gram included) on a (b, o, k) bf16 stack under
    torch.profiler: device ms per call by kernel (the factor, the Gram,
    the apply and mix products)."""
    gen = torch.Generator(device="cuda").manual_seed(61)
    y = well_conditioned(b, o, k, torch.bfloat16, gen)
    for _ in range(3):
        kqr.choleskyqr(y)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(5):
            kqr.choleskyqr(y)
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 5e3, e.key[:60])
                   for e in device_events(prof)), reverse=True)
    total = sum(ms for ms, _ in rows)
    print(f"[profile] choleskyqr ({b},{o},{k}) bf16, one call: device "
          f"{total:.4f} ms | {card}")
    for ms, key in rows:
        print(f"[profile]   {ms:.4f} ms  {key}")
    return {"device_ms": total, "kernels": rows}


def held_tol(want, n, out_dtype) -> float:
    """Tolerance against the plain version: f32 sums of n terms in another
    order, 2 n eps |result scale|; a bf16 output adds one rounding (2^-7 of
    the scale)."""
    scale = want.float().abs().max().item()
    tol = 2 * n * EPS32 * max(scale, 1.0)
    if out_dtype == torch.bfloat16:
        tol += 2.0 ** -7 * scale
    return tol


def held_twice_all(label, fn, args):
    """``fn(*args)`` twice: every output of the two calls bit-equal; the
    first call's outputs."""
    got, again = fn(*args), fn(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{label}: two calls on the same inputs differ")
    return got


def held(label, got, want, n, out_dtype) -> float:
    """Max abs error against the plain version, within ``held_tol``."""
    tol = held_tol(want, n, out_dtype)
    err = (got.float() - want.float()).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{label}: max abs err {err:.3e} > tol "
                             f"{tol:.3e}")
    return err


def held_margin(label, checks) -> tuple[float, dict]:
    """``held`` over (name, got, want, n, out_dtype) checks: the largest
    error, and the smallest margin (tolerance over error) per output dtype.
    A bf16 output's margin is bounded by its one rounding (an output that
    rounds the other way is an error of one ulp, up to 2^-7 of the scale,
    against 2^-7 of the scale plus the f32 part), an f32 output's is not."""
    worst, margin = 0.0, {}
    for name, got, want, n, out_dtype in checks:
        err = held(f"{label} {name}", got, want, n, out_dtype)
        worst = max(worst, err)
        key = str(out_dtype)[6:]
        margin[key] = min(margin.get(key, math.inf),
                          held_tol(want, n, out_dtype) / max(err, 1e-30))
    return worst, margin


def margin_text(margin: dict) -> str:
    return ", ".join(f"{k} outputs {v:.1f}x" for k, v in margin.items())


def well_conditioned(b, o, k, dtype, gen):
    """(b, o, k) with orthonormal columns scaled by 0.5-2 (cond <= 4), the
    shape of a site's stacked L; a trained L after a refresh is like it."""
    q, _ = torch.linalg.qr(torch.randn(b, o, k, device="cuda",
                                       generator=gen))
    s = 0.5 + 1.5 * torch.rand(b, 1, k, device="cuda", generator=gen)
    return (q * s).to(dtype).contiguous()


def ladder_case(card: str) -> float:
    """The CholeskyQR kernel's shift ladder on a stack of two (896, 256)
    f32 operands: index 0 well conditioned; index 1 Y = U diag(s) V^T, U
    and V orthonormal (tests/test_orthogonal.py:34's U diag(s), rotated),
    with one singular value 1 and 255 of 1e-5. The Gram's rounding (~eps
    ||G||) then exceeds the first shift (1e-6 tr/K, ~4e-9 ||G||), so the
    first Cholesky fails at index 1 in JAX's and torch's CPU builds for
    every seed tried, and the 1e4-times larger shift is taken. (Unrotated,
    U diag(logspace(0, -6)) is a graded matrix that factors at the first
    shift; rotated, whether it fails depends on each implementation's
    rounding.) The kernel's flags must equal the plain ladder's on the card
    and the CPU's; Q and mix within 1e-3 of their scale, as the
    well-conditioned cases (JAX and torch on the CPU differ by 2e-5 at
    index 1, whose shifted Gram has condition ~2.6e4)."""
    rng = np.random.default_rng(13)
    m, k = 896, 256
    y0 = np.linalg.qr(rng.standard_normal((m, k)))[0] \
        * (0.5 + 1.5 * rng.random(k))
    u = np.linalg.qr(rng.standard_normal((m, k)))[0]
    v = np.linalg.qr(rng.standard_normal((k, k)))[0]
    sv = np.full(k, 1e-5)
    sv[0] = 1.0
    y_cpu = torch.from_numpy(np.stack([y0, (u * sv) @ v.T]).astype(
        np.float32))
    y = y_cpu.cuda()
    q, mix, flags = kqr.choleskyqr(y, with_retry=True)
    torch.cuda.synchronize()
    wq, wmix, wflags = ref.choleskyqr_ref(y, with_retry=True)
    cq, cmix, cflags = cholesky_qr_mix_ref(y_cpu, with_retry=True)
    got = [flags.cpu().tolist(), wflags.cpu().tolist(), cflags.tolist()]
    if got[2] != [False, True] or got[0] != got[2] or got[1] != got[2]:
        raise AssertionError(f"choleskyqr ladder flags: kernel {got[0]}, "
                             f"plain on the card {got[1]}, CPU {got[2]} "
                             "(want [False, True] from all three)")
    worst = 0.0
    for j in range(2):
        for what, a, b in (("Q", q[j], wq[j]), ("mix", mix[j], wmix[j]),
                           ("Q (CPU)", q[j].cpu(), cq[j]),
                           ("mix (CPU)", mix[j].cpu(), cmix[j])):
            scale = b.float().abs().max().item()
            err = (a.float() - b.float()).abs().max().item()
            if not err <= 1e-3 * scale:
                raise AssertionError(f"choleskyqr ladder index {j} {what}: "
                                     f"err {err:.3e} > 1e-3 x {scale:.3e}")
            worst = max(worst, err)
            print(f"[kernel] choleskyqr ladder index {j} {what}: err "
                  f"{err:.2e} (scale {scale:.2e})")
    print(f"[kernel] choleskyqr ladder: flags kernel {got[0]} == plain "
          f"(card) {got[1]} == plain (CPU) {got[2]} | {card}", flush=True)
    return worst


def timed(label, fns, sets, nbytes, flops, dtype, card, extra="",
          eager=False):
    """Kernel, plain and library times (CUDA graphs) and the bound; with
    ``eager`` also one eager call of the kernel's wrapper, host included."""
    k_ms, p_ms, l_ms = (time_ms(f, sets) for f in fns)
    b_ms, b_by = bound_of(nbytes, flops, dtype)
    row = dict(kernel_ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
               bound_ms=b_ms, bound_by=b_by)
    if eager:
        row["eager_call_ms"] = call_ms(fns[0], sets)
        extra += f" eager_call_ms={row['eager_call_ms']:.4f}"
    print(f"[kernel] {label} {str(dtype)[6:]:8s} kernel_ms={k_ms:.4f} "
          f"plain_ms={p_ms:.4f} library_ms={l_ms:.4f} bound_ms={b_ms:.5f} "
          f"({b_by}){extra} | {card}", flush=True)
    return row


def refresh_stack(name, b, o, k, dtype, gen, worst, card: str):
    """One stacked site of a WSI refresh, (b, O, K): the Gram (#5) and
    CholeskyQR (#4) held to their plain versions (two calls bit-equal, G
    exactly symmetric; Q, mix and Q^T Q within the tolerances below), then
    timed beside the plain version, the library and the bound, and #4
    without its Gram. Returns (Gram row, its (bytes, flops), CholeskyQR
    row, its (bytes, flops), #4's times without the Gram); ``worst`` takes
    the largest errors."""
    y = well_conditioned(b, o, k, dtype, gen)
    tag = f"{name} ({b},{o},{k}) {str(dtype)[6:]}"
    g_route = kgram.gram_route(dtype, k, (y,))
    g_plan = (tuple(kgram.gram_plan(b, o, k))
              if g_route == "tensor_core" else None)
    g, = held_twice_all(f"gram {tag}", lambda t: (ops.gram(t),),
                        (y,))
    e = held(f"gram {tag}", g, ref.gram_ref(y), o, torch.float32)
    worst["gram"] = max(worst["gram"], e)
    if not torch.equal(g, g.mT):
        raise AssertionError(f"gram {tag}: G is not symmetric")
    print(f"[kernel] gram {tag} route={g_route} plan (tile, splits)"
          f"={g_plan}: err {e:.2e}, G == G^T exactly, two calls "
          "bit-equal", flush=True)
    route = "/".join(kqr.qr_route(k, dtype, (y, y)))
    q, mix = held_twice_all(f"choleskyqr {tag} ({route})",
                            kqr.choleskyqr, (y,))
    wq, wmix = ref.choleskyqr_ref(y)
    # Q: a Cholesky of a cond <= 16 Gram amplifies the Gram's
    # rounding ~16x: 1e-3 of Q's scale in f32; a bf16 Q adds one
    # rounding (2^-7 of the scale). mix: 1e-3 of its scale.
    # Q^T Q = I: 1e-3 (f32); a bf16 rounding of each entry of Q
    # moves each entry of Q^T Q by <= 2^-8, K of them in a row.
    qs, ms = wq.float().abs().max().item(), wmix.abs().max().item()
    eq = (q.float() - wq.float()).abs().max().item()
    em = (mix - wmix).abs().max().item()
    tol_q = 1e-3 * qs + (2.0 ** -7 * qs if dtype == torch.bfloat16
                         else 0.0)
    ortho = orthonormality_error(q).max().item()
    tol_o = 1e-3 + (k * 2.0 ** -8 if dtype == torch.bfloat16
                    else 0.0)
    lq, lmix = cholesky_qr_mix_ref(y)
    el = (mix - lmix).abs().max().item()
    if not (eq <= tol_q and em <= 1e-3 * ms and ortho <= tol_o
            and el <= 1e-3 * ms):
        raise AssertionError(
            f"choleskyqr {tag}: Q err {eq:.3e} (tol {tol_q:.3e}), "
            f"mix err {em:.3e} / ladder ref {el:.3e} (tol "
            f"{1e-3 * ms:.3e}), |Q^T Q - I| {ortho:.3e} (tol "
            f"{tol_o:.3e})")
    worst["choleskyqr"] = max(worst["choleskyqr"], eq, em)
    print(f"[kernel] choleskyqr {tag} route={route}: Q err "
          f"{eq:.2e} mix err {em:.2e} |Q^T Q - I|_F {ortho:.2e}",
          flush=True)
    del g, q, mix, wq, wmix, lq, lmix

    n_sets = max(1, min(16, int(120e6 // (b * o * k *
                                          itemsize(dtype))) + 1))
    sets = [(well_conditioned(b, o, k, dtype, gen),)
            for _ in range(n_sets)]
    nb, fl = gram_work(b, o, k, dtype)
    row = timed(f"gram       {name:11s} ({b},{o},{k})",
                (ops.gram, ref.gram_ref, library_gram), sets, nb,
                fl, dtype, card, extra=f" route={g_route}")
    g_row = dict(row, kernel="gram", site=name, M=o, dtype=str(dtype)[6:],
                 route=g_route, plan=g_plan)
    g_work = (nb, fl)
    nb, fl = choleskyqr_work(b, o, k, dtype)
    row = timed(f"choleskyqr {name:11s} ({b},{o},{k})",
                (kqr.choleskyqr, ref.choleskyqr_ref,
                 library_choleskyqr), sets, nb, fl, dtype, card)
    gsets = [(ys, ops.gram(ys)) for ys, in sets]
    ag = {"ms": time_ms(qr_after_gram, gsets),
          "library_ms": time_ms(library_after_gram, gsets)}
    print(f"[kernel] choleskyqr {name:11s} ({b},{o},{k}) "
          f"{str(dtype)[6:]:8s} route={route} without the Gram: "
          f"kernel_ms={ag['ms']:.4f} library_ms="
          f"{ag['library_ms']:.4f} | {card}", flush=True)
    c_row = dict(row, kernel="choleskyqr", site=name, M=o,
                 dtype=str(dtype)[6:], route=route,
                 kernel_ms_after_gram=ag["ms"],
                 library_ms_after_gram=ag["library_ms"])
    del sets, gsets
    return g_row, g_work, c_row, (nb, fl), ag


def tinyllama_refresh(gen, worst, card: str) -> dict:
    """One tinyllama-1.1b refresh in bf16, its 7 stacked sites in 3 shapes
    (``refresh_stack`` each): the Gram's and #4's sums over the refresh
    beside the bound, and #4 without its Gram."""
    tot = {n: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, flops=0)
           for n in ("gram", "choleskyqr")}
    after_gram = {"ms": 0.0, "library_ms": 0.0}
    rows = []
    for name, (b, o, k) in TINY_STACKS.items():
        g_row, g_work, c_row, c_work, ag = refresh_stack(
            f"tiny:{name}", b, o, k, torch.bfloat16, gen, worst, card)
        rows += [g_row, c_row]
        mult = TINY_STACK_COUNT[name]
        for n, row, (nb, fl) in (("gram", g_row, g_work),
                                 ("choleskyqr", c_row, c_work)):
            t = tot[n]
            for key, src in (("ms", "kernel_ms"), ("plain_ms", "plain_ms"),
                             ("library_ms", "library_ms")):
                t[key] += mult * row[src]
            t["bytes"] += mult * nb
            t["flops"] += mult * fl
        for key in after_gram:
            after_gram[key] += mult * ag[key]
    for n, t in tot.items():
        t["bound_ms"], t["bound_by"] = bound_of(t.pop("bytes"),
                                                t.pop("flops"),
                                                torch.bfloat16)
        print(f"[kernel] {n} one tinyllama-1.1b refresh, 7 stacked sites (22"
              f" layers), bf16: kernel_ms={t['ms']:.4f} plain_ms="
              f"{t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} "
              f"bound_ms={t['bound_ms']:.5f} ({t['bound_by']}) | {card}",
              flush=True)
    print(f"[kernel] choleskyqr one tinyllama-1.1b refresh without its Gram "
          f"launches, bf16: kernel_ms={after_gram['ms']:.4f} library_ms="
          f"{after_gram['library_ms']:.4f} | {card}", flush=True)
    return dict(rows=rows, headline=tot, after_gram=after_gram)


def phase_train_kernels(card: str) -> dict:
    print("== phase 6: training kernels against their plain versions",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = dict.fromkeys(TRAIN_KERNELS, 0.0)
    rows = []
    head = {n: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                "eager_call_ms": 0.0, "bytes": 0, "flops": 0}
            for n in TRAIN_KERNELS}
    # the refresh's #4 without its Gram launch, and the library's
    after_gram = {"ms": 0.0, "library_ms": 0.0}

    def add(name, mult, row, nbytes, flops):
        h = head[name]
        h["ms"] += mult * row["kernel_ms"]
        h["eager_call_ms"] += mult * row.get("eager_call_ms", 0.0)
        h["plain_ms"] += mult * row["plain_ms"]
        h["library_ms"] += mult * row["library_ms"]
        h["bytes"] += mult * nbytes
        h["flops"] += mult * flops

    for name, (i, k, o) in SHAPES.items():
        for m in TRAIN_M:
            for dtype in (torch.bfloat16, torch.float32):
                (x, r, l_), = inputs(m, i, k, o, dtype, gen)
                dy = torch.randn(m, o, device="cuda", generator=gen).to(dtype)
                tag = f"{name} M={m} {str(dtype)[6:]}"
                # bf16 at these widths: the tensor-core kernels
                # (gemm_bf16.cuh); f32: the f32 FMA kernels
                route = ("tensor cores" if klowrank.tensor_core_route(
                    dtype, (i, k, o), (x, r, l_, dy)) else "f32 FMA")
                y, h = klowrank.lowrank_fused(x, r, l_, save_sketch=True)
                torch.cuda.synchronize()
                wy, wh = ref.lowrank_sketch_ref(x, r, l_)
                e, mg = held_margin(f"sketch {tag}", (
                    ("h", h, wh, i, torch.float32),
                    ("y", y, wy, i + k, dtype)))
                worst["lowrank_fwd_sketch"] = max(
                    worst["lowrank_fwd_sketch"], e)
                got = klowrank.lowrank_bwd(dy, x, wh, l_, r)
                torch.cuda.synchronize()
                want = ref.lowrank_bwd_ref(dy, x, wh, l_, r)
                eb, mb = held_margin(f"bwd {tag}", (
                    ("dx", got[0], want[0], o + k, dtype),
                    ("dL", got[1], want[1], m, torch.float32),
                    ("dR", got[2], want[2], o + m, torch.float32)))
                worst["lowrank_bwd"] = max(worst["lowrank_bwd"], eb)
                print(f"[kernel] {tag} route={route}: sketch err {e:.2e} "
                      f"(margin {margin_text(mg)}) bwd err {eb:.2e} (margin "
                      f"{margin_text(mb)})", flush=True)
                del y, h, got, want, wy

                nb, fl = sketch_work(m, i, k, o, dtype)
                sets = inputs(m, i, k, o, dtype, gen,
                              max(1, min(48, int(120e6 // nb) + 1)))
                row = timed(f"lowrank_fwd_sketch {name:11s} I={i} K={k} "
                            f"O={o} M={m:4d}",
                            (lambda a, b, c: klowrank.lowrank_fused(
                                a, b, c, save_sketch=True),
                             ref.lowrank_sketch_ref, library_lowrank),
                            sets, nb, fl, dtype, card, eager=True)
                rows.append(dict(row, kernel="lowrank_fwd_sketch", site=name,
                                 M=m, dtype=str(dtype)[6:], route=route,
                                 max_abs_err=e, margin=mg))
                if m == 2048 and dtype == torch.bfloat16:
                    add("lowrank_fwd_sketch", SITE_COUNT[name], row, nb, fl)
                del sets

                nb, fl = bwd_work(m, i, k, o, dtype)
                sets = []
                for xs, rs, ls in inputs(m, i, k, o, dtype, gen,
                                         max(1, min(48,
                                                    int(120e6 // nb) + 1))):
                    dys = torch.randn(m, o, device="cuda",
                                      generator=gen).to(dtype)
                    hs = xs.float() @ rs.float().T
                    sets.append((dys, xs, hs, ls, rs))
                row = timed(f"lowrank_bwd        {name:11s} I={i} K={k} "
                            f"O={o} M={m:4d}",
                            (klowrank.lowrank_bwd, ref.lowrank_bwd_ref,
                             library_bwd), sets, nb, fl, dtype, card,
                            eager=True)
                rows.append(dict(row, kernel="lowrank_bwd", site=name, M=m,
                                 dtype=str(dtype)[6:], route=route,
                                 max_abs_err=eb, margin=mb))
                if m == 2048 and dtype == torch.bfloat16:
                    add("lowrank_bwd", SITE_COUNT[name], row, nb, fl)
                del sets

    for name, (b, o, k) in STACKS.items():
        for dtype in (torch.bfloat16, torch.float32):
            g_row, g_work, c_row, c_work, ag = refresh_stack(
                name, b, o, k, dtype, gen, worst, card)
            rows += [g_row, c_row]
            if dtype == torch.bfloat16:
                mult = SITE_COUNT[name]
                add("gram", mult, g_row, *g_work)
                add("choleskyqr", mult, c_row, *c_work)
                for key in after_gram:
                    after_gram[key] += mult * ag[key]
    worst["choleskyqr"] = max(worst["choleskyqr"], ladder_case(card))
    for n, h in head.items():
        h["bound_ms"], h["bound_by"] = bound_of(h.pop("bytes"),
                                                h.pop("flops"),
                                                torch.bfloat16)
        scope = ("one layer's 7 sites at M=2048" if n.startswith("lowrank")
                 else "one refresh, 7 stacked sites (24 layers)")
        eager = (f" eager_call_ms={h['eager_call_ms']:.4f}"
                 if h["eager_call_ms"] else "")
        print(f"[kernel] {n} {scope}, bf16: kernel_ms={h['ms']:.4f} "
              f"plain_ms={h['plain_ms']:.4f} "
              f"library_ms={h['library_ms']:.4f} "
              f"bound_ms={h['bound_ms']:.5f} ({h['bound_by']}){eager} | "
              f"{card}", flush=True)
    print(f"[kernel] choleskyqr one refresh without its Gram launches, "
          f"bf16: kernel_ms={after_gram['ms']:.4f} library_ms="
          f"{after_gram['library_ms']:.4f} | {card}", flush=True)
    head["choleskyqr"]["after_gram"] = after_gram
    head["choleskyqr"]["profile"] = profile_choleskyqr(
        *STACKS["attn/wq|wo"], card)
    tiny = tinyllama_refresh(gen, worst, card)
    return dict(rows=rows, worst=worst, headline=head,
                tinyllama_refresh=tiny)


def smoke_card_vs_cpu(method: str, tcfg: TrainConfig) -> dict:
    """qwen2 smoke under ``method``, refresh every 2, 4 steps from one seed
    (weights, and ASI states where the method compresses activations) and
    one batch stream, on the card and on the CPU (f32). Per device: the
    losses, the final L and R, the ASI state leaves after the first and
    the last step, and the launch counts of the run."""
    from repro_torch.models.lm import init_lm_states, map_states

    cfg = configs.get_smoke("qwen2-0.5b")
    cfg = cfg.replace(wasi=dataclasses.replace(cfg.wasi, method=method,
                                               refresh_every=2))
    api.uninstall(cfg)
    api.install(api.resolve(cfg, batch=4, seq=16))
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4,
                       seed=1)
    batches = [data.batch(i) for i in range(4)]

    def leaves(tree):
        got = []
        map_states(lambda t: got.append(t.detach().cpu().clone()), tree)
        return got

    out = {"n_layers": cfg.n_layers}
    for dev in ("cuda", "cpu"):
        model = init_lm(cfg, device=dev, seed=7)
        asi = init_lm_states(cfg, 4, 16, device=dev, seed=7) \
            if cfg.wasi.compress_acts else None
        state = make_train_state(model, cfg, tcfg, asi_states=asi)
        step = make_train_step(lm_loss, cfg, tcfg)
        ops.reset_launches()
        losses, first = [], None
        for b in batches:
            state, m = step(state, {k: v.to(dev) for k, v in b.items()})
            losses.append(float(m["loss"]))
            if first is None:
                first = leaves(state.asi)
        out[dev] = dict(
            losses=losses, launches=ops.launch_counts(), first=first,
            states=leaves(state.asi),
            factors={n: p.detach().cpu() for n, p in model.named_parameters()
                     if n.endswith((".L", ".R"))})
    api.uninstall(cfg)
    if any(out["cpu"]["launches"].values()):
        raise AssertionError(f"CPU {method} training launched kernels: "
                             f"{out['cpu']['launches']}")
    return out


def phase_smoke_training(card: str) -> dict:
    print("== phase 7: qwen2 smoke training, card against CPU (f32)",
          flush=True)
    lr = 1e-2
    out = smoke_card_vs_cpu("wsi", TrainConfig(optimizer="adamw", lr=lr,
                                               steps=4))
    cuda, cpu = out["cuda"], out["cpu"]
    per_step = 7 * out["n_layers"]
    want = dict.fromkeys(cuda["launches"], 0)
    want.update(lowrank_fwd_sketch=4 * per_step, lowrank_bwd=4 * per_step,
                gram=2 * 7, choleskyqr=2 * 7,
                flash_attention=4 * out["n_layers"])
    if cuda["launches"] != want:
        raise AssertionError(f"smoke training launches {cuda['launches']} "
                             f"!= {want}")
    # f32 on both sides, sums in other orders: losses within 1e-5
    # relative. AdamW divides each gradient entry by its own magnitude plus
    # eps = 1e-8, so an entry whose gradient is near eps, where f32
    # rounding is a large share of it, moves by up to ~lr differently in
    # two runs (seen: an entry with gradient -7e-9 moving 2e-4 apart, port
    # against reference on the CPU). So each final L and R is held within
    # 1e-3 of its norm (Frobenius) and each entry within lr.
    loss_err = max(abs(a / b - 1) for a, b in zip(cuda["losses"],
                                                  cpu["losses"]))
    par_err = max((cuda["factors"][n] - w).abs().max().item()
                  for n, w in cpu["factors"].items())
    fro_err = max((torch.linalg.vector_norm(cuda["factors"][n] - w)
                   / torch.linalg.vector_norm(w)).item()
                  for n, w in cpu["factors"].items())
    if not (loss_err <= 1e-5 and fro_err <= 1e-3 and par_err <= lr):
        raise AssertionError(f"smoke training card vs CPU: loss rel err "
                             f"{loss_err:.3e} (tol 1e-5), L/R rel Frobenius "
                             f"err {fro_err:.3e} (tol 1e-3), max abs err "
                             f"{par_err:.3e} (tol {lr:.1e})")
    print(f"[train-smoke] losses card {cuda['losses']} cpu {cpu['losses']}: "
          f"max rel err {loss_err:.3e} (tol 1e-5); final L/R rel Frobenius "
          f"err {fro_err:.3e} (tol 1e-3), max abs err {par_err:.3e} (tol "
          f"{lr:.1e}); launches {cuda['launches']} | {card}", flush=True)
    return dict(losses_cuda=cuda["losses"], losses_cpu=cpu["losses"],
                loss_rel_err=loss_err, factor_rel_fro_err=fro_err,
                factor_abs_err=par_err, launches=cuda["launches"])


def profiled(fn):
    """``fn()`` under torch.profiler, synchronized: (its result, the host
    wall clock in µs, the profile, its ``device_events``)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return out, wall_us, prof, device_events(prof)


def profile_train_step(state, step, batch, card: str,
                       check_sums: bool = False):
    """Device busy share of one full-width training step (no refresh)
    under torch.profiler: device time summed over CUDA kernels against the
    host wall clock of the step (the profiler's own host cost included, so
    the share is a lower bound), and the top kernels by device time.
    ``check_sums``: also ``check_device_sums`` on the trace."""
    (state, _), wall_us, prof, events = profiled(lambda: step(state, batch))
    dev_us = sum(e.self_device_time_total for e in events)
    if dev_us <= 0:
        print(f"[profile] no device time in the trace: busy share not "
              f"measured | {card}")
        return state, {"train_busy_share": None}
    print(f"[profile] one training step: wall {wall_us / 1e3:.3f} ms, "
          f"device busy {dev_us / 1e3:.3f} ms, busy share "
          f"{dev_us / wall_us:.3f} | {card}")
    sums = (check_device_sums(prof, events, "one training step", card)
            if check_sums else None)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    for e in top:
        print(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms "
              f"{e.count:5d} calls  {e.key[:70]}")
    return state, {"train_busy_share": dev_us / wall_us,
                   "train_step_wall_ms_profiled": wall_us / 1e3,
                   "train_step_device_ms": dev_us / 1e3,
                   "train_sums": sums,
                   "train_top": [(e.key[:70], e.self_device_time_total / 1e3,
                                  e.count) for e in top]}


def _dotted(tree, prefix: str = ""):
    """{dotted name: leaf} of a nested dict/list, the names
    ``named_parameters`` gives the same tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_dotted(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def check_train_checkpoint(state, plan, n_steps: int, save_s: float,
                           card: str) -> dict:
    """Phase 8's checkpoint read back: the published step, label and plan,
    and every parameter, moment and step count equal to the live state,
    bit for bit (bf16 leaves included)."""
    from repro_torch.checkpoint import restore_untyped

    d = os.path.join(CKPT_DIR, "train")
    m = load_manifest(d, n_steps)
    t0 = time.perf_counter()
    tree = restore_untyped(d, n_steps)
    load_s = time.perf_counter() - t0
    params, opt, step = _dotted(tree[0]), tree[1], int(tree[5])
    if m.get("label") != "train_state" or step != n_steps \
            or int(opt[0]) != state.opt.step:
        raise AssertionError(f"checkpoint label {m.get('label')} step "
                             f"{step} opt step {int(opt[0])}")
    if convert.load_plan(d) != plan:
        raise AssertionError("checkpoint plan differs from the run's")
    live = dict(state.params.named_parameters())
    mu, nu = _dotted(opt[1]), _dotted(opt[2])
    if sorted(params) != sorted(live):
        raise AssertionError("checkpoint params do not match the model's")
    nbytes = 0
    for n, p in live.items():
        for got, want in ((params[n], p), (mu[n], state.opt.mu[n]),
                          (nu[n], state.opt.nu[n])):
            if got.dtype != want.dtype or not torch.equal(
                    got, want.detach().cpu()):
                raise AssertionError(f"checkpoint leaf {n} differs")
            nbytes += got.numel() * got.element_size()
    print(f"[train-full] checkpoint step {n_steps}: {m['n_leaves']} leaves, "
          f"{nbytes / 2 ** 20:.1f} MiB, saved in {save_s:.2f}s "
          f"(train_loop's final save), read back in {load_s:.2f}s, every "
          f"param, moment and step equal | {card}", flush=True)
    return {"ckpt_save_s": save_s, "ckpt_load_s": load_s,
            "ckpt_mib": nbytes / 2 ** 20, "ckpt_leaves": m["n_leaves"]}


def phase_full_training(card: str) -> dict:
    print("== phase 8: qwen2-0.5b full-width training, bf16, wsi, AdamW, "
          "batch 4 x seq 512, refresh every 4, 8 steps", flush=True)
    b, s, n_steps = 4, 512, 8
    # no periodic checkpoint: train_loop saves the final state once
    tcfg = TrainConfig(optimizer="adamw", lr=3e-4, steps=n_steps,
                       checkpoint_every=0)
    t0 = time.perf_counter()
    cfg, plan, state, step, _ = launch_train.build(
        "qwen2-0.5b", smoke=False, batch=b, seq=s, wasi="wsi", tcfg=tcfg,
        device="cuda", refresh_every=4)
    print(f"[train-full] build {time.perf_counter() - t0:.1f}s", flush=True)
    assert {sp.name for sp in plan.specs} == set(SITES)
    assert all(sp.mode == "factored" for sp in plan.specs)

    # seeded uniform tokens: SyntheticLM's dense (vocab, vocab) bigram table
    # would be ~92 GB at this vocab (ROADMAP.md queue 3)
    batch_fn = uniform_batches(cfg, b, s, 1000)

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    mgr = CheckpointManager(os.path.join(CKPT_DIR, "train"), keep=1,
                            plan=plan, label="train_state")
    marks = []

    def log(line):
        marks.append(time.perf_counter())
        print(line, flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    state, hist = train_loop(state, step, batch_fn, tcfg, log_every=1,
                             log_fn=log, ckpt=mgr)
    save_s = time.perf_counter() - marks[-1]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if cfg.remat != "block":
        raise AssertionError(f"qwen2-0.5b's config sets remat {cfg.remat}")
    refreshes = refreshes_in(cfg, 0, n_steps)
    want = train_want(cfg, "wsi", n_steps, refreshes)
    if counts != want:
        raise AssertionError(f"full training launches {counts} != {want}")
    losses = [h["loss"] for h in hist]
    if len(hist) != n_steps or not all(np.isfinite(x) for x in losses):
        raise AssertionError(f"full training losses {losses}")
    step_s = statistics.median(h["sec"] for h in hist[1:])
    res = dict(losses=losses, step_ms_median=step_s * 1e3,
               step_ms=[h["sec"] * 1e3 for h in hist],
               tok_s=b * s / step_s, peak_allocated_mib=peak / 2 ** 20,
               launches=counts)
    print(f"[train-full] losses {[round(x, 4) for x in losses]}", flush=True)
    print(f"[train-full] step_ms_median (steps 2-8)={step_s * 1e3:.3f} "
          f"tok_s={b * s / step_s:.1f} peak_allocated_mib="
          f"{peak / 2 ** 20:.1f} | {card}")
    print(f"[train-full] launches {counts} = "
          f"{want_text(cfg, 'wsi', n_steps, refreshes)}; 0 lowrank_fwd",
          flush=True)
    res.update(check_train_checkpoint(state, plan, n_steps, save_s, card))
    state, prof = profile_train_step(state, step, batch_fn(n_steps), card,
                                     check_sums=True)
    res.update(prof)

    # one step at batch 1 x seq 32 from the same weights: card f32 and
    # card bf16 against CPU f32
    tree = to_reference(state.params)
    del state, step
    torch.cuda.empty_cache()
    g = torch.Generator().manual_seed(5)
    t = torch.randint(0, cfg.vocab_size, (1, 33), generator=g)
    small = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    cfg32 = cfg.replace(dtype="float32")
    api.install(api.resolve(cfg32))
    out = {}
    for name, dev, c in (("cpu32", "cpu", cfg32), ("cuda32", "cuda", cfg32),
                         ("cuda16", "cuda", cfg)):
        # to_reference hands bf16 leaves back as f32 holding the same values
        model = from_reference(tree, c, dev, trainable=True).to(
            _dtype(c.dtype))
        loss, _, grads, _ = value_and_grad(
            lm_loss, model, {k: v.to(dev) for k, v in small.items()}, c)
        out[name] = (float(loss), float(global_norm(grads)))
        del model, grads
    l32 = abs(out["cuda32"][0] / out["cpu32"][0] - 1)
    g32 = abs(out["cuda32"][1] / out["cpu32"][1] - 1)
    l16 = abs(out["cuda16"][0] / out["cpu32"][0] - 1)
    # f32 both sides, sums in other orders through 24 layers: loss 1e-4,
    # gradient global norm 1e-3 relative; bf16 rounds every activation to
    # 8 significant bits: loss within 2%
    if not (l32 <= 1e-4 and g32 <= 1e-3 and l16 <= 0.02):
        raise AssertionError(f"full-width step vs CPU f32: {out} (loss rel "
                             f"{l32:.2e}, grad norm rel {g32:.2e}, bf16 loss "
                             f"rel {l16:.2e})")
    print(f"[train-full] batch 1 x seq 32 from the trained weights: loss "
          f"cpu f32 {out['cpu32'][0]:.6f} card f32 {out['cuda32'][0]:.6f} "
          f"(rel {l32:.2e}, tol 1e-4) card bf16 {out['cuda16'][0]:.6f} "
          f"(rel {l16:.2e}, tol 2e-2); grad norm cpu f32 "
          f"{out['cpu32'][1]:.6f} card f32 {out['cuda32'][1]:.6f} (rel "
          f"{g32:.2e}, tol 1e-3) | {card}", flush=True)
    res.update(cpu_check=out, loss_rel_f32=l32, gnorm_rel_f32=g32,
               loss_rel_bf16=l16)
    api.install(api.resolve(cfg))
    return res


# ---------------------------------------------------------------------------
# int8 deployment: kernel #6, the lifecycle at full width, smoke parity
# ---------------------------------------------------------------------------

def q8_work(m, i, k, o, dtype):
    """x read and y written in x's dtype, the int8 factors and their f32
    scales read once; 2 flops per multiply-add of both products."""
    it = itemsize(dtype)
    return (m * i + m * o) * it + k * i + o * k + 4 * (k + o), \
        2 * m * k * (i + o)


def q8_inputs(m, i, k, o, dtype, gen, n_sets=1):
    sets = []
    for _ in range(n_sets):
        x = torch.randn(m, i, device="cuda", generator=gen).to(dtype)
        rq, rs = quantize_tensor(torch.randn(k, i, device="cuda",
                                             generator=gen) * i ** -0.5)
        lq, ls = quantize_tensor(torch.randn(o, k, device="cuda",
                                             generator=gen) * k ** -0.5)
        sets.append((x, rq, rs, lq, ls))
    return sets


def library_q8(x, rf, rs, lf, ls):
    # yardstick only, timed here and used nowhere in the port: #1's two
    # matmuls on factors (and scales) converted to x's dtype once, outside
    # the timed region, plus the two scale multiplies; it reads the factors
    # at twice the int8 kernel's bytes
    return torch.matmul(torch.matmul(x, rf.T) * rs, lf.T) * ls


def _library_sets(sets):
    return [(x, rq.to(x.dtype), rs.to(x.dtype), lq.to(x.dtype),
             ls.to(x.dtype)) for x, rq, rs, lq, ls in sets]


def q8_layer(m, card: str, gen) -> dict:
    """One layer's seven int8 site launches at M rows (bf16), each at its
    own shape: kernel, plain, library and eager times summed, beside the
    bound of the layer's bytes and flops."""
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "eager_call_ms": 0.0}
    nbytes = flops = 0
    for name, (i, k, o) in SITES.items():
        b, f = q8_work(m, i, k, o, torch.bfloat16)
        sets = q8_inputs(m, i, k, o, torch.bfloat16, gen,
                         max(1, min(48, int(120e6 // b) + 1)))
        tot["ms"] += time_ms(ops.lowrank_matmul_q8, sets)
        tot["plain_ms"] += time_ms(ref.lowrank_q8_ref, sets)
        tot["library_ms"] += time_ms(library_q8, _library_sets(sets))
        tot["eager_call_ms"] += call_ms(ops.lowrank_matmul_q8, sets)
        nbytes, flops = nbytes + b, flops + f
        del sets
    b_ms, b_by = bound_of(nbytes, flops, torch.bfloat16)
    route = kquant.q8_route(m, 896, 256, 896, torch.bfloat16, ())
    print(f"[kernel] lowrank_q8 one layer's 7 sites at M={m} (bf16, route "
          f"{route}): kernel_ms={tot['ms']:.4f} plain_ms="
          f"{tot['plain_ms']:.4f} library_ms={tot['library_ms']:.4f} "
          f"bound_ms={b_ms:.5f} ({b_by}) eager_call_ms="
          f"{tot['eager_call_ms']:.4f}, {nbytes} bytes | {card}", flush=True)
    return dict(tot, bound_ms=b_ms, bound_by=b_by, route=route)


def q8_route_sweep(card: str) -> list:
    """#6's decode route against its tensor-core route at M = 1-32, bf16,
    at qwen2-0.5b's four site shapes; each held to the plain version with
    two bit-equal calls, then both timed. ``quant.Q8_DECODE_MAX_M`` is the
    largest M at which the decode route is the faster at every shape."""
    gen = torch.Generator(device="cuda").manual_seed(39)
    fns = {"decode": kquant._decode, "tensor_core": kquant._tensor_core}

    def routed_q8(launch):
        def run(x, rq, rs, lq, ls):
            y = torch.empty((x.shape[0], lq.shape[0]), dtype=x.dtype,
                            device=x.device)
            if launch(x, rq, rs, lq, ls, y) != 0:
                raise AssertionError("q8 route sweep: launch failed")
            return y
        return run

    rows = []
    for name, (i, k, o) in SHAPES.items():
        for m in SWEEP_MS:
            dtype = torch.bfloat16
            args, = q8_inputs(m, i, k, o, dtype, gen)
            want = ref.lowrank_q8_ref(*args)
            tol = lowrank_tol(want, i, k, dtype)
            errs = {n: held_twice(f"q8 route sweep {name} M={m} {n}",
                                  routed_q8(f), args, want, tol)
                    for n, f in fns.items()}
            del args, want
            nbytes, _ = q8_work(m, i, k, o, dtype)
            sets = q8_inputs(m, i, k, o, dtype, gen,
                             max(1, min(48, int(120e6 // nbytes) + 1)))
            ms = {n: time_ms(routed_q8(f), sets) for n, f in fns.items()}
            del sets
            best = min(ms, key=ms.get)
            print(f"[q8-sweep] {name:11s} M={m:3d} decode_ms="
                  f"{ms['decode']:.4f} tensor_core_ms="
                  f"{ms['tensor_core']:.4f} faster={best} errs decode "
                  f"{errs['decode']:.2e} tensor_core "
                  f"{errs['tensor_core']:.2e} (tol {tol:.2e}) | {card}",
                  flush=True)
            rows.append(dict(site=name, M=m, decode_ms=ms["decode"],
                             tensor_core_ms=ms["tensor_core"], faster=best))
    return rows


def phase_q8_kernels(card: str) -> dict:
    print("== phase 9: lowrank_q8 (each route) against its plain version",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(9)
    d = kquant.Q8_DECODE_MAX_M
    worst = 0.0
    rows = []
    for name, (i, k, o) in dict(SHAPES, **RAGGED_SHAPE).items():
        for m in sorted(set(MS) | {d, d + 1}):
            for dtype in (torch.bfloat16, torch.float32):
                args, = q8_inputs(m, i, k, o, dtype, gen)
                route = kquant.q8_route(m, i, k, o, dtype,
                                        (args[0], args[1], args[3]))
                want = ref.lowrank_q8_ref(*args)
                # as kernel #1 (phase 3): the int8 factors convert exactly,
                # and the tensor-core route's two bf16 pieces of h sR add at
                # most 2^-17 of each term of h Lq^T
                tol = lowrank_tol(want, i, k, dtype)
                err = held_twice(f"lowrank_q8 {name} M={m} {dtype} "
                                 f"({route})", ops.lowrank_matmul_q8, args,
                                 want, tol)
                worst = max(worst, err)
                del args, want
                nbytes, flops = q8_work(m, i, k, o, dtype)
                sets = q8_inputs(m, i, k, o, dtype, gen,
                                 max(1, min(48, int(120e6 // nbytes) + 1)))
                k_ms = time_ms(ops.lowrank_matmul_q8, sets)
                p_ms = time_ms(ref.lowrank_q8_ref, sets)
                l_ms = time_ms(library_q8, _library_sets(sets))
                b_ms, b_by = bound_of(nbytes, flops, dtype)
                rows.append(dict(site=name, M=m, dtype=str(dtype)[6:],
                                 route=route, kernel_ms=k_ms, plain_ms=p_ms,
                                 library_ms=l_ms, bound_ms=b_ms,
                                 bound_by=b_by, max_abs_err=err, tol=tol))
                print(f"[kernel] lowrank_q8 {name:11s} I={i} K={k} O={o} "
                      f"M={m:4d} {str(dtype)[6:]:8s} route={route} "
                      f"err={err:.2e} (tol {tol:.2e}) kernel_ms={k_ms:.4f} "
                      f"plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
                      f"bound_ms={b_ms:.5f} ({b_by}) | {card}", flush=True)
                del sets
    routes = {(r["route"], r["M"] <= d) for r in rows}
    if not {("decode", True), ("tensor_core", False), ("fused", False),
            ("fused", True)} <= routes:
        raise AssertionError(f"phase 9 missed a route: {sorted(routes)}")
    # headlines: one decode step's seven site launches of one layer (M = 4
    # serve slots), and one prefill bucket's (M = 1,024), bf16
    head = q8_layer(4, card, gen)
    prefill = q8_layer(1024, card, gen)
    sweep = q8_route_sweep(card)
    return dict(rows=rows, worst=worst, headline=head,
                prefill_headline=prefill, sweep=sweep)


def _count_calls(obj, name: str, counter: dict) -> None:
    """Count calls of ``obj.name`` (an engine's prefill or decode step, one
    model forward each) in ``counter[name]``."""
    fn = getattr(obj, name)

    def counted(*a, **kw):
        counter[name] += 1
        return fn(*a, **kw)

    setattr(obj, name, counted)


def phase_int8_deploy(card: str, full: dict) -> dict:
    print("== phase 10: int8 deployment at full width: phase 8's checkpoint "
          "-> quantize -> from_checkpoint -> serve", flush=True)
    src, dst = (os.path.join(CKPT_DIR, d) for d in ("train", "int8"))
    t0 = time.perf_counter()
    tree, plan, step = convert.load_checkpoint(src)
    t1 = time.perf_counter()
    qplan = plan.quantized("int8")
    qtree = convert.quantize(tree, qplan)
    t2 = time.perf_counter()
    save_checkpoint(dst, step, qtree, plan=qplan, label="params")
    t3 = time.perf_counter()
    cfg = plan.model
    # the saves of phases 8 and 10 (~3 GB) leave dirty pages that the
    # kernel writes back in the background, on the host the decode loop
    # is bound by: flush them before serving is measured
    os.sync()
    t4 = time.perf_counter()
    print(f"[int8] load_checkpoint {t1 - t0:.2f}s, quantize (CPU) "
          f"{t2 - t1:.2f}s, save {t3 - t2:.2f}s (step {step}); os.sync "
          f"{t4 - t3:.2f}s", flush=True)
    api.uninstall(cfg)
    eng = ServeEngine.from_checkpoint(dst, device="cuda", max_slots=4,
                                      max_cache=512)
    if not (eng.quantized and eng.plan == qplan):
        raise AssertionError("from_checkpoint did not serve the int8 plan")
    # the packed bytes the summary must report: the bf16 tied embedding,
    # then per layer each site's int8 R (K, I) and L (O, K), f32 sR (K) and
    # sL (O), and the bf16 bias of the q, k, v projections
    want_bytes = cfg.padded_vocab * cfg.d_model * 2 + cfg.n_layers * sum(
        sp.rank * (sp.in_dim + sp.out_dim) + 4 * (sp.rank + sp.out_dim)
        + (2 * sp.out_dim if sp.bias else 0) for sp in qplan.specs)
    calls = {"_prefill": 0, "_decode_all": 0}
    _count_calls(eng, "_prefill", calls)
    _count_calls(eng, "_decode_all", calls)
    rng = np.random.default_rng(1)
    # phase 5's warm-up and prompts (the same draws), the trained weights
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
    calls.update(_prefill=0, _decode_all=0)
    hs = [eng.submit(p, max_new=16,
                     sampling=sampled if i in (2, 5) else None)
          for i, p in enumerate(prompts)]
    eng.run()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    s = eng.summary()
    per_forward = len(SITES) * cfg.n_layers
    forwards = calls["_prefill"] + calls["_decode_all"]
    want = dict.fromkeys(counts, 0)
    want["lowrank_q8"] = per_forward * forwards
    want["flash_attention"] = cfg.n_layers * calls["_prefill"]
    if counts != want or calls["_decode_all"] != s["decode_steps"]:
        raise AssertionError(f"int8 serving launches {counts} != {want} "
                             f"({calls}, {s['decode_steps']} decode steps)")
    for h in hs:
        if not (h.finished and len(h.generated) == 16):
            raise AssertionError(f"request {h.rid} ended {h.status} with "
                                 f"{len(h.generated)} tokens")
        if not all(0 <= t < cfg.padded_vocab for t in h.generated):
            raise AssertionError(f"request {h.rid}: token out of range")
    if s["weight_bytes"] != want_bytes or not s["quantized"]:
        raise AssertionError(f"weight_bytes {s['weight_bytes']} != "
                             f"{want_bytes} (quantized {s['quantized']})")
    print(f"[int8] lowrank_q8 launches={counts['lowrank_q8']} = {forwards} "
          f"forwards ({calls['_decode_all']} decode steps + "
          f"{calls['_prefill']} prefill groups) x {per_forward}; "
          f"flash_attention={counts['flash_attention']} = "
          f"{calls['_prefill']} prefill calls x {cfg.n_layers}; "
          f"lowrank_fwd={counts['lowrank_fwd']}", flush=True)
    ttft = [h.ttft_s for h in hs]
    tpot = [h.tpot_s for h in hs]
    peak = torch.cuda.max_memory_allocated()
    res = dict(prefill_tok_s=s["prefill_tok_s"],
               decode_tok_s=s["decode_tok_s"],
               ttft_ms_median=statistics.median(ttft) * 1e3,
               ttft_ms_max=max(ttft) * 1e3,
               tpot_ms_median=statistics.median(tpot) * 1e3,
               weight_mib=s["weight_mib"], kv_mib=s["cache_bytes"] / 2**20,
               max_memory_allocated_mib=peak / 2**20,
               decode_steps=s["decode_steps"], prefill_calls=calls["_prefill"],
               launches=counts["lowrank_q8"],
               prefill_tokens=s["prefill_tokens"],
               decode_tokens=s["decode_tokens"], wall_s=s["wall_s"],
               load_s=t1 - t0, quantize_s=t2 - t1, save_s=t3 - t2,
               sync_s=t4 - t3,
               phase5_weight_mib=full["weight_mib"])
    for key in ("prefill_tok_s", "decode_tok_s", "ttft_ms_median",
                "ttft_ms_max", "tpot_ms_median", "weight_mib", "kv_mib",
                "max_memory_allocated_mib"):
        print(f"[int8] {key}={res[key]:.3f} | {card}")
    print(f"[int8] weight_mib {s['weight_mib']:.3f} against phase 5's "
          f"{full['weight_mib']:.3f} (bf16 factors)")
    print(f"[int8] greedy sample rid=0: {hs[0].generated}", flush=True)
    res.update({f"int8_{k}": v for k, v in
                profile_decode(eng, cfg, rng, card).items()})
    res["ab"] = serve_ab(eng, tree, plan, prompts, sampled, card)
    del tree

    # one 16-token prompt through the same int8 tree (same factors and
    # scales; norms and embedding bf16 -> f32 exactly) in f32 on the CPU,
    # against the card in f32 and in bf16 (the served model). f32 on both
    # sides differs by the order of sums only: 1e-3 of the logits' scale.
    # bf16 rounds every activation to 8 significant bits through 24
    # layers: 10% of the scale (measured on an H100: 3.1% on phase 5's
    # random init, 4.9% on these trained weights; PERF.md), which a wrong
    # kernel or layout misses by far.
    prompt = torch.tensor([prompts[3][:16]])
    cfg32 = cfg.replace(dtype="float32")
    api.install(api.resolve(cfg32).quantized("int8"))
    lg = {}
    for name, model, c, dev in (
            ("cpu32", from_reference(qtree, cfg32, "cpu").float(), cfg32,
             "cpu"),
            ("cuda32", from_reference(qtree, cfg32, "cuda").float(), cfg32,
             "cuda"),
            ("cuda16", eng.params, cfg, "cuda")):
        with torch.inference_mode():
            out, _ = lm_prefill(model, prompt.to(dev), c,
                                caches=init_lm_cache(c, 1, 16,
                                                     dtype=_dtype(c.dtype),
                                                     device=dev),
                                last_only=True)
        lg[name] = out.float().cpu()[0, 0]
        del model, out
    del qtree
    b = lg["cpu32"]
    scale = b.abs().max().item()
    err32 = (lg["cuda32"] - b).abs().max().item()
    err16 = (lg["cuda16"] - b).abs().max().item()
    if not (err32 <= 1e-3 * scale and err16 <= 0.1 * scale):
        raise AssertionError(f"int8 full-width card vs f32 CPU logits: f32 "
                             f"{err32:.3e} (tol 1e-3 x {scale:.3e}), bf16 "
                             f"{err16:.3e} (tol 0.1 x {scale:.3e})")
    print(f"[int8] 16-token prompt, card vs f32 CPU (same int8 tree), last "
          f"logits of scale {scale:.3e}: card f32 max abs err {err32:.3e} "
          f"({err32 / scale:.2e} of scale, tol 1e-3), card bf16 {err16:.3e} "
          f"({err16 / scale:.2e}, tol 0.1); argmax cpu {int(b.argmax())} "
          f"card f32 {int(lg['cuda32'].argmax())} bf16 "
          f"{int(lg['cuda16'].argmax())} | {card}", flush=True)
    res.update(cpu_logit_err_f32=err32, cpu_logit_err=err16,
               cpu_logit_scale=scale)
    del eng
    api.uninstall(cfg)
    res.update(int8_smoke(card))
    return res


def serve_ab(eng8, tree, plan, prompts, sampled, card: str) -> list:
    """Decode through the int8 engine against the same trained weights
    with bf16 factors, in turns (bf16, int8, int8, bf16) within this call,
    the way two versions are compared on one card. The bf16 engine's
    config differs from the int8 one's in its name only, so both plans
    stay installed at once."""
    cfg16 = plan.model.replace(name=plan.model.name + "-bf16")
    plan16 = api.install(dataclasses.replace(plan, model=cfg16))
    eng16 = ServeEngine(from_reference(tree, cfg16, "cuda"), plan=plan16,
                        max_slots=4, max_cache=512, device="cuda")
    eng16.submit(prompts[0][:5], max_new=4)       # warm-up
    eng16.run()
    rows = []
    for name, eng in (("bf16", eng16), ("int8", eng8), ("int8", eng8),
                      ("bf16", eng16)):
        eng.reset_stats()
        hs = [eng.submit(p, max_new=16,
                         sampling=sampled if i in (2, 5) else None)
              for i, p in enumerate(prompts)]
        eng.run()
        torch.cuda.synchronize()
        s = eng.summary()
        row = dict(factors=name, decode_tok_s=s["decode_tok_s"],
                   tpot_ms_median=statistics.median(h.tpot_s for h in hs)
                   * 1e3,
                   ttft_ms_median=statistics.median(h.ttft_s for h in hs)
                   * 1e3, prefill_tok_s=s["prefill_tok_s"])
        rows.append(row)
        print(f"[int8-ab] {name:4s} factors: decode {row['decode_tok_s']:.1f}"
              f" tok/s, TPOT median {row['tpot_ms_median']:.2f} ms, TTFT "
              f"median {row['ttft_ms_median']:.1f} ms, prefill "
              f"{row['prefill_tok_s']:.1f} tok/s | {card}", flush=True)
    del eng16
    api.uninstall(cfg16)
    return rows


def int8_smoke(card: str) -> dict:
    """qwen2 smoke, f32, seeded random weights packed to int8, served on
    the card and on the CPU from the same int8 tree: greedy tokens equal
    (f32 on both sides; only the order of sums differs)."""
    cfg = configs.get_smoke("qwen2-0.5b")
    api.uninstall(cfg)
    plan = api.install(api.resolve(cfg))
    model = init_lm(cfg, device="cpu", seed=21)
    qplan = plan.quantized("int8")
    qtree = convert.quantize(model, qplan)
    api.uninstall(cfg)
    api.install(qplan)
    rng = np.random.default_rng(3)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n)))
               for n in (3, 7, 5, 11, 20)]
    toks = {}
    for dev in ("cuda", "cpu"):
        eng = ServeEngine(from_reference(qtree, cfg, dev), plan=qplan,
                          max_slots=2, max_cache=64, buckets=(4, 8, 16),
                          device=dev)
        ops.reset_launches()
        hs = [eng.submit(p, max_new=8) for p in prompts]
        eng.run()
        toks[dev] = [h.tokens for h in hs]
        counts = ops.launch_counts()
        if (dev == "cuda") != (counts["lowrank_q8"] > 0) \
                or counts["lowrank_fwd"]:
            raise AssertionError(f"int8 smoke launches on {dev}: {counts}")
    if toks["cuda"] != toks["cpu"]:
        raise AssertionError(f"int8 smoke greedy tokens differ: card "
                             f"{toks['cuda']} cpu {toks['cpu']}")
    print(f"[int8-smoke] qwen2 smoke int8, 5 prompts x 8 greedy tokens "
          f"through 2 slots: card == CPU | {card}", flush=True)
    api.uninstall(cfg)
    return {"smoke_tokens_equal": True}


# ---------------------------------------------------------------------------
# kernel #9 and the paper's Table 2 comparison
# ---------------------------------------------------------------------------

UNFUSED_M = (4, 1024, 2048)
# (M, K, N) of ops.matmul: ragged on every dim, a ragged M through an
# MLP-wide product, and the products of the two-launch row (M = 2048: a
# d_model and mlp/down's first product, mlp/gate|up's second) and of
# mlp/down's first at decode (M = 4)
MM_RAGGED = ((33, 257, 129), (1000, 896, 4864), (2048, 896, 256),
             (2048, 4864, 256), (2048, 256, 4864), (4, 4864, 256),
             (4, 896, 256), (4, 256, 4864))
METHODS = ("none", "asi", "wsi", "wasi")


def mm_work(m, k, n, dtype, out_dtype=None):
    """A and B read once, C written once; 2 flops per multiply-add."""
    nbytes = (m * k + k * n) * itemsize(dtype) \
        + m * n * itemsize(out_dtype or dtype)
    return nbytes, 2 * m * k * n


def unfused_work(m, i, k, o, dtype):
    """The pair's two products: x and R read, h written in x's dtype; h
    and L read, y written."""
    b1, f1 = mm_work(m, i, k, dtype)
    b2, f2 = mm_work(m, k, o, dtype)
    return b1 + b2, f1 + f2


def plain_unfused(x, r, l_):
    return ref.matmul_ref(ref.matmul_ref(x, r.T), l_.T)


def mm_tol(a, b, out_dtype) -> float:
    """Every product exact in f32, K of them summed in f32 in another
    order (tensor cores included): 2 K eps (|A| |B|).max(). A bf16 output
    is rounded on each side, and two sums that straddle a rounding boundary
    land one bf16 ulp apart: up to 2^-7 of the value (8 significant bits),
    so 2^-7 of the scale."""
    k = a.shape[1]
    tol = 2 * k * EPS32 * max((a.float().abs() @ b.float().abs()).max()
                              .item(), 1.0)
    if out_dtype == torch.bfloat16:
        tol += 2.0 ** -7 * (a.float() @ b.float()).abs().max().item()
    return tol


def held_pair(label, x, r, l_, y) -> dict:
    """The two-launch pair y = (x R^T) L^T, one product at a time. The
    kernel is deterministic, so ``ops.matmul(x, R^T)`` gives the bits of
    the pair's first launch, h, written in x's dtype. h is held against the
    plain product, and y against the plain product of that h and L^T, each
    at ``mm_tol``: both sides round h the same way, so only each product's
    summation order is free."""
    h = ops.matmul(x, r.T)
    h_err = (h.float() - ref.matmul_ref(x, r.T).float()).abs().max().item()
    h_tol = mm_tol(x, r.T, x.dtype)
    err = (y.float() - ref.matmul_ref(h, l_.T).float()).abs().max().item()
    tol = mm_tol(h, l_.T, x.dtype)
    if not (h_err <= h_tol and err <= tol):
        raise AssertionError(f"{label}: h max abs err {h_err:.3e} (tol "
                             f"{h_tol:.3e}), y max abs err {err:.3e} (tol "
                             f"{tol:.3e})")
    return dict(h_err=h_err, h_tol=h_tol, max_abs_err=err, tol=tol)


def phase_matmul_kernels(card: str) -> dict:
    print("== phase 11: matmul_tiled against its plain version", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(11)
    worst = 0.0
    rows = []
    for m, k, n in MM_RAGGED:
        for dtype in (torch.bfloat16, torch.float32):
            for layout in ("n_major", "k_major"):
                def draw():
                    a = torch.randn(m, k, device="cuda", generator=gen)
                    b = (torch.randn(k, n, device="cuda", generator=gen)
                         if layout == "n_major" else
                         torch.randn(n, k, device="cuda", generator=gen).T)
                    return a.to(dtype), b.to(dtype)
                a, b = draw()
                route = kmm.matmul_route(a, b)
                tol = mm_tol(a, b, dtype)
                err = held_twice(f"matmul_tiled {m}x{k}x{n} {dtype} B "
                                 f"{layout} ({route})", ops.matmul, (a, b),
                                 ref.matmul_ref(a, b), tol)
                worst = max(worst, err)
                nbytes, flops = mm_work(m, k, n, dtype)
                sets = [draw() for _ in range(max(1, min(
                    48, int(120e6 // nbytes) + 1)))]
                k_ms = time_ms(ops.matmul, sets)
                p_ms = time_ms(ref.matmul_ref, sets)
                l_ms = time_ms(torch.matmul, sets)
                b_ms, b_by = bound_of(nbytes, flops, dtype)
                rows.append(dict(shape=f"{m}x{k}x{n}", B=layout,
                                 dtype=str(dtype)[6:], route=route,
                                 kernel_ms=k_ms,
                                 plain_ms=p_ms, library_ms=l_ms,
                                 bound_ms=b_ms, bound_by=b_by,
                                 max_abs_err=err, tol=tol))
                print(f"[kernel] matmul_tiled M={m} K={k} N={n} B {layout} "
                      f"{str(dtype)[6:]:8s} route={route} err={err:.2e} "
                      f"(tol {tol:.2e}) "
                      f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                      f"library_ms={l_ms:.4f} bound_ms={b_ms:.5f} ({b_by})"
                      f" | {card}", flush=True)
                del sets
    pairs = []
    for name, (i, k, o) in SHAPES.items():
        for m in UNFUSED_M:
            for dtype in (torch.bfloat16, torch.float32):
                (x, r, l_), = inputs(m, i, k, o, dtype, gen)
                got = ops.lowrank_matmul_unfused(x, r, l_)
                torch.cuda.synchronize()
                chk = held_pair(f"lowrank_matmul_unfused {name} M={m} "
                                f"{dtype}", x, r, l_, got)
                err, tol = chk["max_abs_err"], chk["tol"]
                worst = max(worst, err, chk["h_err"])
                # the fused kernel keeps h in f32: its gap to the pair is
                # h's bf16 rounding, carried through L
                gap = (got.float() - ops.lowrank_matmul(x, r, l_).float()) \
                    .abs().max().item()
                nbytes, flops = unfused_work(m, i, k, o, dtype)
                sets = inputs(m, i, k, o, dtype, gen,
                              max(1, min(48, int(120e6 // nbytes) + 1)))
                k_ms = time_ms(ops.lowrank_matmul_unfused, sets)
                p_ms = time_ms(plain_unfused, sets)
                l_ms = time_ms(library_lowrank, sets)
                f_ms = time_ms(ops.lowrank_matmul, sets)
                kc_ms = call_ms(ops.lowrank_matmul_unfused, sets)
                fc_ms = call_ms(ops.lowrank_matmul, sets)
                b_ms, b_by = bound_of(nbytes, flops, dtype)
                fb_ms, fb_by = bound(m, i, k, o, dtype)
                pairs.append(dict(site=name, M=m, dtype=str(dtype)[6:],
                                  kernel_ms=k_ms, plain_ms=p_ms,
                                  library_ms=l_ms, bound_ms=b_ms,
                                  bound_by=b_by, fused_ms=f_ms,
                                  fused_bound_ms=fb_ms, fused_bound_by=fb_by,
                                  kernel_call_ms=kc_ms, fused_call_ms=fc_ms,
                                  fused_gap=gap, **chk))
                print(f"[kernel] unfused pair {name:11s} I={i} K={k} O={o} "
                      f"M={m:4d} {str(dtype)[6:]:8s} h err={chk['h_err']:.2e}"
                      f" (tol {chk['h_tol']:.2e}) y err={err:.2e} (tol "
                      f"{tol:.2e}) two_launch_ms={k_ms:.4f} fused_ms="
                      f"{f_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f}"
                      f" bound_ms={b_ms:.5f} ({b_by}) fused_bound_ms="
                      f"{fb_ms:.5f} eager_call two_launch={kc_ms:.4f} "
                      f"fused={fc_ms:.4f} |pair-fused|={gap:.2e} | {card}",
                      flush=True)
                del sets
    # headline: the Table 2 two-launch row, one layer's 7 sites at the
    # training batch (M = 4 x 512, bf16): 14 launches
    head = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "fused_ms": 0.0}
    nbytes = flops = 0
    for p in pairs:
        if p["M"] == 2048 and p["dtype"] == "bfloat16":
            c = SITE_COUNT[p["site"]]
            for key, src in (("ms", "kernel_ms"), ("plain_ms", "plain_ms"),
                             ("library_ms", "library_ms"),
                             ("fused_ms", "fused_ms")):
                head[key] += c * p[src]
            i, k, o = SHAPES[p["site"]]
            b, f = unfused_work(2048, i, k, o, torch.bfloat16)
            nbytes, flops = nbytes + c * b, flops + c * f
    head["bound_ms"], head["bound_by"] = bound_of(nbytes, flops,
                                                  torch.bfloat16)
    print(f"[kernel] matmul_tiled one layer's 7 two-launch pairs at M=2048, "
          f"bf16 (14 launches): kernel_ms={head['ms']:.4f} "
          f"plain_ms={head['plain_ms']:.4f} library_ms="
          f"{head['library_ms']:.4f} bound_ms={head['bound_ms']:.5f} "
          f"({head['bound_by']}); fused #1 at the same shapes "
          f"{head['fused_ms']:.4f} | {card}", flush=True)
    return dict(rows=rows, pairs=pairs, worst=worst, headline=head)


def site_residuals(card: str) -> dict:
    """At each distinct site shape of qwen2-0.5b at full width (bf16, batch
    4 x seq 512, the config's ASI ranks), one ``wasi_matmul``'s saved
    bytes equal the Tucker factors + h~'s (K, r_last) factor + L + R
    exactly, and x's storage is not among the saved tensors."""
    from repro_torch.api import bind
    from repro_torch.core.asi import asi_step
    from repro_torch.core.lowrank_linear import wasi_matmul
    from repro_torch.utils.memprof import (
        dense_residual_bytes,
        measured_residual_bytes,
    )

    cfg = configs.get("qwen2-0.5b")
    gen = torch.Generator().manual_seed(12)
    out = {}
    for name, (i, k, o) in SHAPES.items():
        act = (4, 512, i)
        x = torch.randn(*act, device="cuda").to(torch.bfloat16)
        l_ = (torch.randn(o, k, device="cuda") * k ** -0.5).bfloat16()
        r = (torch.randn(k, i, device="cuda") * i ** -0.5).bfloat16()
        st = bind.asi_state(gen, act, cfg.wasi, dtype=torch.bfloat16,
                            device="cuda")
        with torch.no_grad():
            xt, _ = asi_step(x, st)
        rep = measured_residual_bytes(
            lambda x_, lf, rr: wasi_matmul(x_, lf, rr, xt), x, l_, r)
        tucker = 2 * (xt.core.numel() + sum(u.numel() for u in xt.us
                                             if u is not None))
        sketch = 2 * k * xt.us[-1].shape[1]
        want = tucker + sketch + 2 * (l_.numel() + r.numel())
        if rep.total_bytes != want:
            raise AssertionError(f"wasi_matmul {name}: saved "
                                 f"{rep.total_bytes} B != {want} B")
        if x.untyped_storage().data_ptr() in rep.storages:
            raise AssertionError(f"wasi_matmul {name} saved x")
        dense = dense_residual_bytes(act, itemsize=2)
        ranks = tuple(None if u is None else u.shape[1] for u in xt.us)
        out[name] = dict(saved_bytes=rep.total_bytes, tucker_bytes=tucker,
                         sketch_bytes=sketch, dense_x_bytes=dense,
                         ranks=ranks, core=tuple(xt.core.shape))
        print(f"[table2] wasi_matmul {name:11s} act {act} ranks {ranks}: "
              f"saved {rep.total_bytes} B = Tucker {tucker} + h~ factor "
              f"{sketch} + L,R {2 * (l_.numel() + r.numel())}; x not saved "
              f"(dense x would be {dense} B) | {card}", flush=True)
    return out


def smoke_wasi_parity(card: str) -> dict:
    """qwen2 smoke under ``wasi``, SGD+momentum, card against CPU
    (``smoke_card_vs_cpu``): losses, final L/R and ASI factors compared,
    launch counts exact (Gram and CholeskyQR at each refresh, nothing
    else)."""
    out = smoke_card_vs_cpu("wasi", TrainConfig(
        optimizer="sgd", lr=0.3, momentum=0.9, steps=4, clip_norm=2.0))
    cuda, cpu = out["cuda"], out["cpu"]
    want = dict.fromkeys(cuda["launches"], 0)
    want.update(gram=2 * 7, choleskyqr=2 * 7,
                flash_attention=4 * out["n_layers"])
    if cuda["launches"] != want:
        raise AssertionError(f"smoke wasi launches {cuda['launches']} != "
                             f"{want}")

    def rel(a, b):
        return max(((x - y).abs().max() / y.abs().max()).item()
                   for x, y in zip(a, b))

    # f32 both sides, sums in other orders. Losses within 1e-5 relative;
    # L and R within 1e-4 of their scale; the ASI factors of the first
    # step (one subspace iteration from the same state on the same
    # activations) within 1e-4 of their scale. After 4 steps each
    # iteration has started from the last one's factors, and at smoke
    # ranks the gap between kept and dropped singular values is small, so
    # rounding alone turns the subspaces: card against CPU read 7.9e-4 of
    # the scale (SGD+momentum, two runs on an H100). Held to 2e-3, 2.5x
    # that reading.
    loss_err = max(abs(a / b - 1) for a, b in zip(cuda["losses"],
                                                  cpu["losses"]))
    par_err = rel([cuda["factors"][n] for n in cpu["factors"]],
                  list(cpu["factors"].values()))
    first_err = rel(cuda["first"], cpu["first"])
    st_err = rel(cuda["states"], cpu["states"])
    if not (loss_err <= 1e-5 and par_err <= 1e-4 and first_err <= 1e-4
            and st_err <= 2e-3):
        raise AssertionError(
            f"smoke wasi card vs CPU: loss rel err {loss_err:.3e} (tol "
            f"1e-5), L/R err {par_err:.3e} of scale (tol 1e-4), ASI factors "
            f"err after step 1 {first_err:.3e} (tol 1e-4), after step 4 "
            f"{st_err:.3e} of scale (tol 2e-3)")
    print(f"[table2-smoke] wasi, SGD+momentum: losses card {cuda['losses']} "
          f"cpu {cpu['losses']}: max rel err {loss_err:.3e} (tol 1e-5); "
          f"final L/R err {par_err:.3e} of scale (tol 1e-4); ASI factors "
          f"err {first_err:.3e} after step 1 (tol 1e-4), {st_err:.3e} after "
          f"step 4 (tol 2e-3); launches {cuda['launches']} | {card}",
          flush=True)
    return dict(losses_cuda=cuda["losses"], losses_cpu=cpu["losses"],
                loss_rel_err=loss_err, factor_err=par_err,
                state_err_step1=first_err, state_err=st_err,
                launches=cuda["launches"])


def table2_method(method: str, card: str) -> dict:
    """One method of the Table 2 comparison at full width: build through
    ``launch/train.py``, train through ``train_run``, the saved-for-backward
    bytes and peak under ``block`` and ``none`` (``remat_memory``) and the
    time of one ``lm_forward`` without states."""
    b, s, n_steps = 4, 512, 5
    tcfg = TrainConfig(optimizer="adamw", lr=3e-4, steps=n_steps,
                       checkpoint_every=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfg, plan, state, step, _ = launch_train.build(
        "qwen2-0.5b", smoke=False, batch=b, seq=s, wasi=method, tcfg=tcfg,
        device="cuda", refresh_every=4)
    build_s = time.perf_counter() - t0
    if cfg.wasi.method != method or (state.asi is None) == \
            cfg.wasi.compress_acts:
        raise AssertionError(f"{method}: built {cfg.wasi.method}, ASI "
                             f"states {state.asi is not None}")

    batch_fn = uniform_batches(cfg, b, s, 1000)
    state, res = train_run("table2", state, step, batch_fn, tcfg, cfg,
                           method, 0, n_steps, b * s)
    res.update(method=method, build_s=build_s)
    per_step = len(SITES) * cfg.n_layers
    batch = batch_fn(n_steps)
    res.update(remat_memory(state, batch, cfg,
                            with_remat(cfg, "none", b, s)))

    model = state.params
    with torch.no_grad():
        ops.reset_launches()
        logits, *_ = lm_forward(model, batch["tokens"], cfg)
        torch.cuda.synchronize()
        inf_counts = ops.launch_counts()
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{method}: non-finite inference logits")
        del logits
        want = dict.fromkeys(inf_counts, 0)
        want["flash_attention"] = cfg.n_layers
        if cfg.wasi.factored:
            want["lowrank_fwd"] = per_step
        if inf_counts != want:
            raise AssertionError(f"{method} inference launches {inf_counts}"
                                 f" != {want}")
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lm_forward(model, batch["tokens"], cfg)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    res["infer_ms_median"] = statistics.median(times[1:]) * 1e3
    res["infer_launches"] = inf_counts
    if method == "wasi":
        res["two_launch"] = two_launch_row(model, card)
    if method in ("wasi", "none"):
        state, prof = profile_train_step(state, step, batch_fn(n_steps + 1),
                                          card)
        res.update(prof)
    del state, step, model
    print(f"[table2] {method}: step_ms_median (steps 2-{n_steps})="
          f"{res['step_ms_median']:.3f} tok_s={res['tok_s']:.1f} "
          f"infer_ms_median={res['infer_ms_median']:.3f} dev_peak_mib="
          f"{res['dev_peak_mib']:.1f} saved bytes of one lm_loss: block "
          f"{res['residual_bytes_block']}, none {res['residual_bytes_none']};"
          f" peak MiB of one forward and backward: block "
          f"{res['grad_peak_mib_block']:.1f}, none "
          f"{res['grad_peak_mib_none']:.1f}; train launches "
          f"{res['launches']} inference launches {inf_counts} | {card}",
          flush=True)
    return res


def two_launch_row(model, card: str) -> dict:
    """The Table 2 serve row: each of layer 0's seven factored sites at the
    training batch's rows (M = 2048, bf16, the trained factors) through
    the fused kernel #1 and through the two-launch pair of kernel #9. The
    pair's launches are counted here: 2 per site, 14 in all."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    with torch.no_grad():
        layer = model.layer_views()[0][0][0]
        sites = {n: layer[n.split("/")[0]][n.split("/")[1]] for n in SITES}
        xs = {n: torch.randn(2048, SITES[n][0], device="cuda",
                             generator=gen).bfloat16() for n in SITES}
        ops.reset_launches()
        ys = {n: ops.lowrank_matmul_unfused(xs[n], p["R"], p["L"])
              for n, p in sites.items()}
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        want = dict.fromkeys(counts, 0)
        want["matmul_tiled"] = 2 * len(SITES)
        if counts != want:
            raise AssertionError(f"two-launch row launches {counts} != "
                                 f"{want}")
        rows = {}
        for n, p in sites.items():
            chk = held_pair(f"two-launch row {n}", xs[n], p["R"], p["L"],
                            ys[n])
            sets = [(xs[n], p["R"], p["L"])]
            rows[n] = dict(two_launch_call_ms=call_ms(
                ops.lowrank_matmul_unfused, sets), fused_call_ms=call_ms(
                ops.lowrank_matmul, sets), **chk)
    tot_u = sum(r["two_launch_call_ms"] for r in rows.values())
    tot_f = sum(r["fused_call_ms"] for r in rows.values())
    print(f"[table2] two-launch row, layer 0's 7 sites at M=2048 bf16: "
          f"launches {counts['matmul_tiled']} (2 a site); eager calls "
          f"two_launch {tot_u:.4f} ms, fused {tot_f:.4f} ms | {card}",
          flush=True)
    return dict(launches=counts["matmul_tiled"], sites=rows,
                two_launch_call_ms=tot_u, fused_call_ms=tot_f)


def phase_table2(card: str) -> dict:
    print("== phase 12: Table 2 at full width: qwen2-0.5b none/asi/wsi/"
          "wasi, bf16, batch 4 x seq 512, AdamW, refresh every 4, 5 steps",
          flush=True)
    out = {"sites": site_residuals(card)}
    for method in METHODS:
        out[method] = table2_method(method, card)
        gc.collect()
        torch.cuda.empty_cache()
    out["smoke"] = smoke_wasi_parity(card)
    cfg = configs.get("qwen2-0.5b")
    api.uninstall(cfg)
    api.install(api.resolve(cfg))
    print("[table2] method  step_ms  tok_s  infer_ms  dev_peak_mib  "
          "saved_MiB block / none  fwd+bwd_peak_MiB block / none "
          "(training runs remat block, the config's)")
    for m in METHODS:
        r = out[m]
        print(f"[table2] {m:5s} {r['step_ms_median']:8.3f} {r['tok_s']:8.1f}"
              f" {r['infer_ms_median']:8.3f} {r['dev_peak_mib']:9.1f} "
              f"{r['residual_bytes_block'] / 2 ** 20:10.2f} / "
              f"{r['residual_bytes_none'] / 2 ** 20:10.2f} "
              f"{r['grad_peak_mib_block']:10.1f} / "
              f"{r['grad_peak_mib_none']:10.1f} | {card}", flush=True)
    return out


# ---------------------------------------------------------------------------
# kernel #7 and the paper's ViT-B/16 fine-tuning (Fig. 5 / Tab. 1)
# ---------------------------------------------------------------------------

# (B, S, H, KVH, dh, causal, window): the reference's sweep
# (tests/test_kernels.py:146-168: ragged 100, GQA, windows 64/128, dh
# 16-128, causal and not), run in f32 and bf16
FLASH_SWEEP = ((2, 128, 4, 2, 32, True, 0), (1, 256, 4, 4, 64, True, 64),
               (2, 100, 2, 1, 16, False, 0), (1, 384, 2, 2, 128, True, 128),
               (1, 64, 8, 2, 96, True, 0))
# the main paths' shapes, each in its own dtype: ViT-B/16 training at
# batch 64 (phase 15), qwen2-0.5b training rows (phases 8, 12), one
# prefill bucket of phase 5 (2 prompts in the 256 bucket), zamba2-7b's
# shared attention at the 4 x 256 prefill bucket where #8 is timed (phase
# 18: 32 heads of dh 112)
FLASH_PATH = {"vit": (64, 197, 12, 12, 64, False, 0, torch.float32),
              "qwen2_train": (4, 512, 14, 2, 64, True, 0, torch.bfloat16),
              "qwen2_prefill": (2, 256, 14, 2, 64, True, 0, torch.bfloat16),
              "zamba2_prefill": (4, 256, 32, 32, 112, True, 0,
                                 torch.bfloat16)}
# the dense decoder configs' shapes (phases 19, 20), bf16, causal:
# tinyllama-1.1b's training rows and a prefill bucket (GQA 32/4, dh 64),
# stablelm-3b's (MHA, dh 80, padded to 128), granite-3-8b's (32/8, dh
# 128), internvl2-26b's (48/8, dh 128) prefill buckets, and gemma3-4b's
# 1,500-token prompt in its 1,536 bucket under the 1,024-key window (8/4,
# dh 256)
DENSE_FLASH = {
    "tinyllama_train": (4, 512, 32, 4, 64, True, 0, torch.bfloat16),
    "tinyllama_prefill": (2, 256, 32, 4, 64, True, 0, torch.bfloat16),
    "stablelm_prefill": (2, 256, 32, 32, 80, True, 0, torch.bfloat16),
    "granite_prefill": (2, 256, 32, 8, 128, True, 0, torch.bfloat16),
    "internvl2_prefill": (2, 256, 48, 8, 128, True, 0, torch.bfloat16),
    "gemma3_1536": (1, 1536, 8, 4, 256, True, 1024, torch.bfloat16)}
VIT_BATCH, VIT_PATCHES, VIT_PATCH_DIM, VIT_CLASSES = 64, 196, 768, 10
VIT_STEPS = 10
# Fig. 5's rows (scope "mlp", the paper's PAPER_WASI) and Tab. 1's
# (scope "all"): (row name, method, scope)
VIT_ROWS = (("none", "none", "mlp"), ("asi", "asi", "mlp"),
            ("wasi", "wasi", "mlp"), ("wasi_all", "wasi", "all"))


def visible_pairs(sq, sk, causal, window) -> int:
    """(query, key) pairs the mask lets through: the work this run's
    data needs."""
    qpos = np.arange(sq)[:, None]
    kpos = np.arange(sk)[None, :]
    ok = np.ones((sq, sk), bool)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    return int(ok.sum())


def flash_work(b, s, h, kvh, dh, causal, window, dtype):
    """(bytes, flops): q, k, v read once, o written once; 4 dh flops per
    visible (query, key) pair and head (q k^T and p v)."""
    item = itemsize(dtype)
    nbytes = (2 * b * s * h * dh + 2 * b * s * kvh * dh) * item
    return nbytes, 4 * b * h * visible_pairs(s, s, causal, window) * dh


def flash_route(dtype) -> str:
    """The kernel's route for a dtype: bf16 operands as they are, or f32
    operands as exact bf16 pieces (``flash_attention.PIECES``)."""
    return "bf16" if dtype == torch.bfloat16 else "f32_pieces"


def flash_bound(nbytes, flops, dtype):
    """The bound of a row: bytes at the HBM rate against the operations
    the kernel runs at their peak: bf16 flops on the tensor cores, or, for
    f32, the P (P + 1) / 2 products of pieces on the bf16 tensor cores
    (the f32 function's CUDA-core bound, ``bound_of(..., torch.float32)``,
    is printed beside it)."""
    if dtype == torch.float32:
        p = kflash.PIECES
        flops = flops * p * (p + 1) // 2
    return bound_of(nbytes, flops, torch.bfloat16)


def flash_tol(want, dtype) -> float:
    """f32: 2e-5 at unit-normal inputs (the online softmax's
    reassociation); bf16: 2 ulps of the output's scale (p is rounded to
    bf16 before p . v, as the TPU kernel does, and o is rounded on both
    sides)."""
    if dtype == torch.float32:
        return 2e-5
    scale = want.float().abs().max().item()
    return 2 * 2.0 ** (math.floor(math.log2(scale)) - 7)


def flash_inputs(b, s, h, kvh, dh, dtype, gen, n_sets=1):
    return [tuple(torch.randn(b, s, n, dh, device="cuda",
                              generator=gen).to(dtype)
                  for n in (h, kvh, kvh)) for _ in range(n_sets)]


def library_flash(causal, window, s):
    """The yardstick: one ``scaled_dot_product_attention`` call on the
    (B, H, S, dh) views, GQA by ``enable_gqa``, the window as a boolean
    mask. Timed here, used nowhere in the port."""
    import torch.nn.functional as F

    mask = None
    if window > 0:
        qpos = torch.arange(s, device="cuda")[:, None]
        kpos = torch.arange(s, device="cuda")[None, :]
        mask = kpos > qpos - window
        if causal:
            mask &= kpos <= qpos

    def fn(q, k, v):
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        o = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)
        return o.transpose(1, 2)
    return fn


def phase_flash_kernel(card: str) -> dict:
    print("== phase 13: flash_attention against its plain version",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(13)
    cases = [(f"sweep {c}", *c, dt) for c in FLASH_SWEEP
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(name, *c) for name, c in {**FLASH_PATH,
                                         **DENSE_FLASH}.items()]
    rows, worst = [], 0.0
    for name, b, s, h, kvh, dh, causal, window, dtype in cases:
        (q, k, v), = flash_inputs(b, s, h, kvh, dh, dtype, gen)
        nan_before(q.shape, dtype)
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        err = (got.float() - want.float()).abs().max().item()
        tol = flash_tol(want, dtype)
        if not err <= tol:
            raise AssertionError(f"flash_attention {name} {dtype}: max abs "
                                 f"err {err:.3e} > tol {tol:.3e}")
        worst = max(worst, err)
        del got, want
        nbytes, flops = flash_work(b, s, h, kvh, dh, causal, window, dtype)
        n_sets = max(1, min(24, int(120e6 // nbytes) + 1))
        sets = flash_inputs(b, s, h, kvh, dh, dtype, gen, n_sets)

        def kern(q_, k_, v_, causal=causal, window=window):
            return ops.flash_attention(q_, k_, v_, causal=causal,
                                       window=window)

        def plain(q_, k_, v_, causal=causal, window=window):
            return ref.flash_attention_ref(q_, k_, v_, causal=causal,
                                           window=window)

        k_ms, p_ms = time_ms(kern, sets), time_ms(plain, sets)
        l_ms = time_ms(library_flash(causal, window, s), sets)
        b_ms, b_by = flash_bound(nbytes, flops, dtype)
        plan = kflash.flash_plan(b, s, s, h, dh, dtype)
        route = flash_route(dtype)
        row = dict(case=name, B=b, S=s, H=h, KVH=kvh, dh=dh, causal=causal,
                   window=window, dtype=str(dtype)[6:], route=route,
                   plan=plan._asdict(), kernel_ms=k_ms, plain_ms=p_ms,
                   library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
                   max_abs_err=err, tol=tol)
        extra = ""
        if dtype == torch.float32:
            row["f32_cuda_core_bound_ms"] = bound_of(nbytes, flops,
                                                     dtype)[0]
            extra = (" f32_cuda_core_bound_ms="
                     f"{row['f32_cuda_core_bound_ms']:.5f}")
        rows.append(row)
        print(f"[kernel] flash_attention {name:14s} B={b} S={s} H={h}/{kvh} "
              f"dh={dh} causal={int(causal)} window={window} "
              f"{str(dtype)[6:]:8s} route={route} plan=(bq {plan.bq}, ks "
              f"{plan.ks}, stages {plan.stages}, bk {plan.bk}) err={err:.2e} (tol "
              f"{tol:.2e}) kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
              f"library_ms={l_ms:.4f} bound_ms={b_ms:.5f} ({b_by}){extra} | "
              f"{card}", flush=True)
        del sets
    # one backward through _FlashAttention (kernel forward, plain f32
    # recompute) against autograd of the plain version, ViT's heads at
    # batch 4: the same f32 math in another order, 1e-5 of the scale
    (q, k, v), = flash_inputs(4, 197, 12, 12, 64, torch.float32, gen)
    ts = [t.requires_grad_(True) for t in (q, k, v)]
    before = ops.launch_counts()["flash_attention"]
    out = ops.flash_attention(*ts, causal=False)
    dy = torch.randn(out.shape, device="cuda", generator=gen)
    got = torch.autograd.grad(out, ts, dy)
    if ops.launch_counts()["flash_attention"] != before + 1:
        raise AssertionError("the backward launched the forward kernel")
    want = torch.autograd.grad(ref.flash_attention_ref(*ts, causal=False),
                               ts, dy)
    bwd_err = max(((a - w).abs().max() / w.abs().max()).item()
                  for a, w in zip(got, want))
    if not bwd_err <= 1e-5:
        raise AssertionError(f"flash_attention backward: dq/dk/dv err "
                             f"{bwd_err:.3e} of scale > 1e-5")
    print(f"[kernel] flash_attention backward (ViT heads, B=4, f32): dq, "
          f"dk, dv against autograd of the plain version {bwd_err:.2e} of "
          f"scale (tol 1e-5); 1 forward launch, none in the backward | "
          f"{card}", flush=True)
    tiled = tiled_backward(gen, card)
    heads = {}
    for path in {**FLASH_PATH, **DENSE_FLASH}:
        r = next(r for r in rows if r["case"] == path)
        heads[path] = dict(ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                           library_ms=r["library_ms"],
                           bound_ms=r["bound_ms"], bound_by=r["bound_by"])
        print(f"[kernel] flash_attention headline {path}: kernel_ms="
              f"{r['kernel_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']:.4f} (kernel / library "
              f"{r['kernel_ms'] / r['library_ms']:.2f}x) bound_ms="
              f"{r['bound_ms']:.5f} ({r['bound_by']}) route={r['route']} | "
              f"{card}", flush=True)
    return dict(rows=rows, worst=worst, backward_rel_err=bwd_err,
                tiled_backward=tiled, sweep=flash_sweep(gen, card),
                path_headlines=heads, headline=heads["vit"])


# sweep-only shapes on the other side of flash_plan's thresholds (blocks
# counted in 64-row query tiles, f32 in 128-row ones): bf16, qwen2-0.5b
# prompts of 4,096 tokens (the tiled backward's forward below) and
# prefill buckets of 3, 4 and 5 x 256 (168, 224 and 280 blocks, between
# the paths' 112 and 448); f32, ViT-B/16 at batch 4, 8 and 16 (96, 192 and
# 384 blocks) and phase 14's vit-smoke attention (32 blocks)
FLASH_SWEEP_EXTRA = {
    "qwen2_4096": (1, 4096, 14, 2, 64, True, 0, torch.bfloat16),
    "qwen2_3x256": (3, 256, 14, 2, 64, True, 0, torch.bfloat16),
    "qwen2_4x256": (4, 256, 14, 2, 64, True, 0, torch.bfloat16),
    "qwen2_5x256": (5, 256, 14, 2, 64, True, 0, torch.bfloat16),
    "vit_b4": (4, 197, 12, 12, 64, False, 0, torch.float32),
    "vit_b8": (8, 197, 12, 12, 64, False, 0, torch.float32),
    "vit_b16": (16, 197, 12, 12, 64, False, 0, torch.float32),
    "vit_smoke": (8, 17, 4, 4, 16, False, 0, torch.float32)}


def nan_before(shape, dtype) -> None:
    """Leave NaN where the next tensor of ``shape`` is allocated: the
    allocator's free segments go back to the driver, and a NaN tensor of
    that size is made and freed, so the next allocation of the size takes
    its block. An output a kernel leaves unwritten then reads as NaN, not
    as the values an earlier call left there."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.full(shape, float("nan"), dtype=dtype, device="cuda")


def plan_error(shape, plan, gen) -> tuple[float, float]:
    """#7 under one plan on fresh inputs, its output's memory NaN first:
    (max abs error against the plain version, tolerance). New inputs and
    the NaN keep a plan that writes nothing from passing on an earlier
    call's output."""
    b, s, h, kvh, dh, causal, window, dtype = shape
    (q, k, v), = flash_inputs(b, s, h, kvh, dh, dtype, gen)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    nan_before(q.shape, dtype)
    got = kflash.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                      plan=plan)
    err = (got.float() - want.float()).abs().max().item()
    return err, flash_tol(want, dtype)


def flash_sweep(gen, card: str) -> list:
    """Every instantiated plan (``flash_attention.plans``: query tile 64,
    or 128 in f32; one or two key groups and ring depth 2 or 3 in bf16) at
    each path shape and ``FLASH_SWEEP_EXTRA``, each held to the plain
    version (``plan_error``) and timed (CUDA graphs): where
    ``flash_plan``'s thresholds come from."""
    out = []
    for path, shape in {**FLASH_PATH, **FLASH_SWEEP_EXTRA}.items():
        b, s, h, kvh, dh, causal, window, dtype = shape
        nbytes, _ = flash_work(b, s, h, kvh, dh, causal, window, dtype)
        sets = flash_inputs(b, s, h, kvh, dh, dtype, gen,
                            max(1, min(24, int(120e6 // nbytes) + 1)))
        chosen = kflash.flash_plan(b, s, s, h, dh, dtype)
        times = {}
        for plan in kflash.plans(dh, dtype):
            def kern(q_, k_, v_, plan=plan):
                return kflash.flash_attention_cuda(q_, k_, v_, causal=causal,
                                                   window=window, plan=plan)
            err, tol = plan_error(shape, plan, gen)
            if not err <= tol:
                raise AssertionError(f"flash_attention {path} {plan}: err "
                                     f"{err:.3e} > tol {tol:.3e}")
            times[(plan.bq, plan.ks, plan.stages)] = time_ms(kern, sets)
        best = min(times, key=times.get)
        pick = (chosen.bq, chosen.ks, chosen.stages)
        print(f"[sweep] flash_attention {path} ms by (bq, ks, stages): "
              + ", ".join(f"{p}={t:.4f}" for p, t in times.items())
              + f"; flash_plan {pick} {times[pick]:.4f}, fastest {best} | "
              f"{card}", flush=True)
        out.append(dict(path=path, chosen=list(pick), fastest=list(best),
                        ms={str(p): t for p, t in times.items()}))
        del sets
    return out


def tiled_backward(gen, card: str) -> dict:
    """The attention backward above ``ops.DENSE_BWD_MAX`` tokens, tiled by
    query blocks and KV chunks of 1024, at qwen2-0.5b's heads (14 query,
    2 KV, dh 64), bf16, causal: at 4,096 tokens dq, dk, dv against
    autograd of the plain version (both in f32, then rounded to bf16: 2
    bf16 ulps of each gradient's scale); at 32,768 tokens, batch 1, one
    forward and backward, its time and the allocator's peak (the dense
    backward would hold three f32 (1, 2, 7, S, S) tensors, 60 GB each)."""
    h, kvh, dh = 14, 2, 64
    (q, k, v), = flash_inputs(1, 4096, h, kvh, dh, torch.bfloat16, gen)
    ts = [t.requires_grad_(True) for t in (q, k, v)]
    out = ops.flash_attention(*ts, causal=True)
    dy = torch.randn(out.shape, device="cuda", generator=gen).bfloat16()
    got = torch.autograd.grad(out, ts, dy)
    want = torch.autograd.grad(ref.flash_attention_ref(*ts, causal=True),
                               ts, dy)
    errs, tols = [], []
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        err = (a.float() - w.float()).abs().max().item()
        tol = flash_tol(w, torch.bfloat16)
        tols.append(tol)
        if not err <= tol:
            raise AssertionError(f"tiled attention backward at 4096 tokens:"
                                 f" {name} err {err:.3e} > {tol:.3e}")
        errs.append(err)
    print(f"[kernel] attention backward, 4096 tokens (tiled 1024 x 1024), "
          f"qwen2 heads 14/2 dh 64 bf16 causal: dq, dk, dv against autograd "
          f"of the plain version, max abs err {max(errs):.3e} (tol 2 bf16 "
          f"ulps of each scale: {', '.join(f'{t:.3e}' for t in tols)}) | "
          f"{card}", flush=True)
    del q, k, v, ts, out, dy, got, want
    gc.collect()
    torch.cuda.empty_cache()
    s = 32768
    (q, k, v), = flash_inputs(1, s, h, kvh, dh, torch.bfloat16, gen)
    ts = [t.requires_grad_(True) for t in (q, k, v)]
    dy = torch.randn(1, s, h, dh, device="cuda", generator=gen).bfloat16()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = ops.flash_attention(*ts, causal=True)
    got = torch.autograd.grad(out, ts, dy)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if not all(torch.isfinite(g).all() for g in got):
        raise AssertionError("tiled attention backward at 32768 tokens: "
                             "non-finite gradients")
    dense_gb = h * s * s * 4 / 1e9      # one f32 (1, 2, 7, S, S) tensor
    print(f"[kernel] attention forward + backward, 32768 tokens, batch 1, "
          f"bf16 causal: {secs:.3f} s, allocator peak {peak / 2**20:.1f} MiB"
          f" ({(peak - base) / 2**20:.1f} MiB above the inputs and dy; the "
          f"dense backward's three f32 score tensors: {dense_gb:.1f} GB "
          f"each) | "
          f"{card}", flush=True)
    del q, k, v, ts, out, dy, got
    gc.collect()
    torch.cuda.empty_cache()
    return dict(err_4096=max(errs), seconds_32768=secs,
                peak_mib_32768=peak / 2**20,
                above_inputs_mib_32768=(peak - base) / 2**20,
                dense_scores_gb_32768=dense_gb)


def _vit_cfg(method: str, scope: str, smoke: bool = False):
    cfg = configs.get_smoke("vit-base") if smoke else configs.get("vit-base")
    return cfg.replace(wasi=dataclasses.replace(
        cfg.wasi, method=method, scope=scope, update_mode="project"))


def phase_vit_smoke(card: str) -> dict:
    """vit-smoke under project-mode ``wasi`` (SGD+momentum), 4 steps on
    the card and on the CPU (f32) from the same seeded params and ASI
    states and the CPU's WSI states (the truncated SVD's signs differ
    between LAPACK and cuSOLVER, so the card takes the CPU's factors)."""
    from repro_torch.core.wsi import WSIState
    from repro_torch.data.synthetic import SyntheticVision
    from repro_torch.models.lm import map_states
    from repro_torch.models.vit import init_vit, init_vit_states, vit_loss

    print("== phase 14: ViT smoke, project-mode wasi, card against CPU "
          "(f32)", flush=True)
    b, n_patch, p_dim, n_cls = 8, 16, 24, 4
    cfg = _vit_cfg("wasi", "all", smoke=True)
    api.uninstall(cfg)
    api.install(api.resolve(cfg, batch=b, seq=n_patch + 1))
    tcfg = TrainConfig(optimizer="sgd", lr=0.05, momentum=0.9, steps=4,
                       clip_norm=2.0, checkpoint_every=0)
    data = SyntheticVision(n_cls, n_patch, p_dim, b, seed=0, noise=0.5)
    batches = [data.batch(i) for i in range(4)]

    def leaves(tree):
        got = []
        map_states(lambda t: got.append(t.detach().cpu().clone()), tree)
        return got

    out, wsi0 = {}, None
    for dev in ("cpu", "cuda"):
        model = init_vit(cfg, n_cls, p_dim, n_patch, device=dev, seed=7)
        asi = init_vit_states(cfg, b, n_patch, device=dev, seed=7)
        state = make_train_state(model, cfg, tcfg, asi_states=asi,
                                 use_epsilon_ranks=True)
        if wsi0 is None:
            wsi0 = state.wsi
        state = state._replace(wsi={k: WSIState(v.L.to(dev), v.R.to(dev))
                                    for k, v in wsi0.items()})
        step = make_train_step(vit_loss, cfg, tcfg)
        ops.reset_launches()
        losses, first = [], None
        for bt in batches:
            state, m = step(state, {k: v.to(dev) for k, v in bt.items()})
            losses.append(float(m["loss"]))
            if first is None:
                first = leaves(state.asi)
        out[dev] = dict(losses=losses, launches=ops.launch_counts(),
                        first=first, states=leaves(state.asi),
                        params={n: p.detach().cpu() for n, p in
                                model.named_parameters()},
                        wsi=leaves(state.wsi))
    api.uninstall(cfg)
    cuda, cpu = out["cuda"], out["cpu"]
    want = dict.fromkeys(cuda["launches"], 0)
    want["flash_attention"] = 4 * cfg.n_layers
    if cuda["launches"] != want or any(cpu["launches"].values()):
        raise AssertionError(f"ViT smoke launches: card {cuda['launches']} "
                             f"(want {want}), CPU {cpu['launches']}")

    def rel(a, b_):
        return max(((x - y).abs().max() / y.abs().max()).item()
                   for x, y in zip(a, b_))

    # f32 both sides, sums in other orders. Losses within 1e-5 relative;
    # W within 1e-5 of each leaf's scale (SGD moves W by the same f32
    # gradient; PR 14's SGD bound); the WSI (L, R) after 4 steps within
    # 1e-4 of their scale, phase 12's limit on factors after 4 steps (one
    # subspace iteration a step, each against W that differs in its last
    # bits); the ASI factors within 1e-4 after step 1 and 2e-3 after
    # step 4, phase 12's limits (rounding turns the subspaces at smoke
    # ranks: card against CPU read 7.9e-4 under qwen2 wasi).
    loss_err = max(abs(a / b_ - 1) for a, b_ in zip(cuda["losses"],
                                                   cpu["losses"]))
    w_err = rel([cuda["params"][n] for n in cpu["params"]],
                list(cpu["params"].values()))
    wsi_err = rel(cuda["wsi"], cpu["wsi"])
    first_err = rel(cuda["first"], cpu["first"])
    st_err = rel(cuda["states"], cpu["states"])
    if not (loss_err <= 1e-5 and w_err <= 1e-5 and wsi_err <= 1e-4
            and first_err <= 1e-4 and st_err <= 2e-3):
        raise AssertionError(
            f"ViT smoke card vs CPU: loss rel err {loss_err:.3e} (tol "
            f"1e-5), W err {w_err:.3e} of scale (tol 1e-5), WSI (L, R) "
            f"{wsi_err:.3e} (tol 1e-4), ASI factors after step 1 "
            f"{first_err:.3e} (tol 1e-4), after step 4 {st_err:.3e} (tol "
            f"2e-3)")
    print(f"[vit-smoke] project wasi, SGD+momentum, 4 steps: losses card "
          f"{cuda['losses']} cpu {cpu['losses']}: max rel err "
          f"{loss_err:.3e} (tol 1e-5); W err {w_err:.3e} of scale (tol "
          f"1e-5); WSI (L, R) err {wsi_err:.3e} (tol 1e-4); ASI factors err "
          f"{first_err:.3e} after step 1 (tol 1e-4), {st_err:.3e} after "
          f"step 4 (tol 2e-3); launches {cuda['launches']} | {card}",
          flush=True)
    return dict(losses_cuda=cuda["losses"], losses_cpu=cpu["losses"],
                loss_rel_err=loss_err, w_err=w_err, wsi_err=wsi_err,
                state_err_step1=first_err, state_err=st_err,
                launches=cuda["launches"])


def vit_row(row: str, method: str, scope: str, batches: list,
            card: str) -> dict:
    """One row of Fig. 5 / Tab. 1 at full ViT-B/16 width: train
    ``VIT_STEPS`` steps through ``train_loop(memprof=True)``, exact launch
    counts (12 of #7 per forward, none in the backward), the saved bytes
    of one ``vit_loss``, one ``vit_forward`` without states, the busy
    share of one step, the ranks picked."""
    from repro_torch.core.project import project_forward_params
    from repro_torch.models.vit import (
        init_vit,
        init_vit_states,
        vit_forward,
        vit_loss,
    )
    from repro_torch.utils.memprof import measured_residual_bytes

    cfg = _vit_cfg(method, scope)
    api.uninstall(cfg)
    api.install(api.resolve(cfg, batch=VIT_BATCH, seq=VIT_PATCHES + 1))
    tcfg = TrainConfig(optimizer="sgd", lr=0.05, momentum=0.9,
                       steps=VIT_STEPS, checkpoint_every=0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = init_vit(cfg, VIT_CLASSES, VIT_PATCH_DIM, VIT_PATCHES,
                     device="cuda", seed=0)
    asi = init_vit_states(cfg, VIT_BATCH, VIT_PATCHES, device="cuda",
                          seed=0) if cfg.wasi.compress_acts else None
    state = make_train_state(model, cfg, tcfg, asi_states=asi,
                             use_epsilon_ranks=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ranks = {p: int(st.L.shape[-1]) for p, st in (state.wsi or {}).items()}
    step = make_train_step(vit_loss, cfg, tcfg)
    ops.reset_launches()
    state, hist = train_loop(state, step, lambda i: batches[i], tcfg,
                             log_every=1, memprof=True,
                             log_fn=lambda line: print(line, flush=True))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = dict.fromkeys(counts, 0)
    want["flash_attention"] = VIT_STEPS * cfg.n_layers
    if counts != want:
        raise AssertionError(f"ViT {row} training launches {counts} != "
                             f"{want}")
    losses = [h["loss"] for h in hist]
    if len(hist) != VIT_STEPS or not all(np.isfinite(x) for x in losses):
        raise AssertionError(f"ViT {row} losses {losses}")
    step_s = statistics.median(h["sec"] for h in hist[1:])
    res = dict(row=row, method=method, scope=scope, build_s=build_s,
               losses=losses, step_ms=[h["sec"] * 1e3 for h in hist],
               step_ms_median=step_s * 1e3, images_s=VIT_BATCH / step_s,
               dev_peak_mib=max(h["mem_dev_peak_mib"] for h in hist),
               train_launches=counts, ranks=ranks)

    batch = batches[0]
    fwd = state.params if state.wsi is None else project_forward_params(
        state.params, state.wsi)
    rep = measured_residual_bytes(
        lambda: vit_loss(fwd, batch, cfg, states=state.asi))
    res["residual_bytes"] = rep.total_bytes
    del rep, fwd
    torch.cuda.empty_cache()
    with torch.no_grad():
        ops.reset_launches()
        logits, _ = vit_forward(model, batch["patches"], cfg)
        torch.cuda.synchronize()
        inf_counts = ops.launch_counts()
        want = dict.fromkeys(inf_counts, 0)
        want["flash_attention"] = cfg.n_layers
        if inf_counts != want or not torch.isfinite(logits).all():
            raise AssertionError(f"ViT {row} inference launches "
                                 f"{inf_counts} != {want}, or non-finite "
                                 "logits")
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vit_forward(model, batch["patches"], cfg)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    res["infer_ms_median"] = statistics.median(times[1:]) * 1e3
    state, prof = profile_train_step(state, step, batches[1], card)
    res.update(prof)
    del state, step, model
    api.uninstall(cfg)
    shown = {p.split("/")[-2]: k for p, k in ranks.items()}
    print(f"[vit] {row}: step_ms_median (steps 2-{VIT_STEPS})="
          f"{res['step_ms_median']:.3f} images_s={res['images_s']:.1f} "
          f"infer_ms_median={res['infer_ms_median']:.3f} dev_peak_mib="
          f"{res['dev_peak_mib']:.1f} residual_bytes={res['residual_bytes']}"
          f" loss_step{VIT_STEPS}={losses[-1]:.4f} ranks (random init, eps "
          f"{cfg.wasi.epsilon}) {shown or '-'} train launches "
          f"{counts['flash_attention']} flash ({cfg.n_layers} a forward, 0 "
          f"in the backward) inference {inf_counts['flash_attention']} | "
          f"{card}", flush=True)
    return res


def phase_vit_fig5(card: str) -> dict:
    from repro_torch.data.synthetic import SyntheticVision

    print(f"== phase 15: Fig. 5 / Tab. 1 at full width: ViT-B/16 (12 "
          f"layers, d 768, f32, random init), batch {VIT_BATCH}, "
          f"{VIT_PATCHES} patches of {VIT_PATCH_DIM}, SGD+momentum, "
          f"{VIT_STEPS} steps per row", flush=True)
    data = SyntheticVision(VIT_CLASSES, VIT_PATCHES, VIT_PATCH_DIM,
                           VIT_BATCH, seed=0, noise=0.5)
    # set-up: every batch drawn and moved to the card before training
    batches = [{k: v.cuda() for k, v in data.batch(i).items()}
               for i in range(VIT_STEPS)]
    out = {}
    for row, method, scope in VIT_ROWS:
        out[row] = vit_row(row, method, scope, batches, card)
        gc.collect()
        torch.cuda.empty_cache()
    print("[vit] row       step_ms  images_s  infer_ms  dev_peak_mib  "
          "residual_MiB  busy  loss10")
    for row, _, _ in VIT_ROWS:
        r = out[row]
        print(f"[vit] {row:8s} {r['step_ms_median']:8.3f} "
              f"{r['images_s']:8.1f} {r['infer_ms_median']:8.3f} "
              f"{r['dev_peak_mib']:9.1f} "
              f"{r['residual_bytes'] / 2 ** 20:10.2f} "
              f"{r.get('train_busy_share') or 0:.3f} {r['losses'][-1]:.4f} | "
              f"{card}", flush=True)
    return out


# ---------------------------------------------------------------------------
# kernel #8 and zamba2-7b serving (Mamba-2 + shared attention)
# ---------------------------------------------------------------------------

# (Bz, S, H, dh, N, chunk): the reference's sweep
# (tests/test_kernels.py:186-188), ragged S (100 with chunk 32, one chunk
# of 37), then the path's shapes: zamba2-7b's prefill bucket (4 prompts of
# 256, one chunk), the 700-token prompt's bucket (768: 3 chunks) and one
# 4,096-token prompt (16 chunks: the carried state counts)
SSD_SWEEP = ((2, 32, 4, 8, 4, 8), (1, 64, 2, 16, 8, 16),
             (1, 128, 8, 32, 16, 32), (2, 100, 4, 16, 8, 32),
             (1, 37, 2, 8, 4, 37))
SSD_PATH = {"zamba2_prefill": (4, 256, 112, 64, 64, 256),
            "zamba2_768": (1, 768, 112, 64, 64, 256),
            "zamba2_4096": (1, 4096, 112, 64, 64, 256)}
# zamba2-7b's factored sites per layer: 3 in each Mamba-2 mixer, 7 in the
# shared attention + MLP block
ZAMBA_MIXER_SITES, ZAMBA_SHARED_SITES = 3, 7


def ssd_work(bz, s, h, dh, n, chunk, dtype=torch.float32):
    """(bytes, flops): u, dt, A, B, C read once (u, B and C in ``dtype``,
    dt and A in f32), y and the final state written once (f32). Per batch
    row and chunk of ql steps: C B^T once (shared by every head), 2 N
    flops per (query, key) pair on or below the diagonal; per head on
    top, 2 dh per such pair (G u) and 4 ql N dh (the carried state's term
    and the state update)."""
    item = itemsize(dtype)
    nbytes = (item * (bz * s * h * dh + 2 * bz * s * n)
              + 4 * (bz * s * h * dh + bz * s * h + h + bz * h * dh * n))
    flops = 0
    for c0 in range(0, s, chunk):
        ql = min(chunk, s - c0)
        pairs = ql * (ql + 1) // 2
        flops += 2 * pairs * n + h * (2 * pairs * dh + 4 * ql * n * dh)
    return nbytes, bz * flops


def ssd_tc_flops(bz, s, h, dh, n, chunk):
    """Flops of the tensor-core route's products (csrc/ssd_scan_tc.cu),
    counted as ``ssd_work`` counts pairs: C B^T once (bf16, one piece),
    and per head PIECES pieces of G (G u), of the weighted u (the state
    update) and, after the first chunk, of S_prev (the carried state's
    term)."""
    p = kssd.PIECES
    flops = 0
    for c0 in range(0, s, chunk):
        ql = min(chunk, s - c0)
        pairs = ql * (ql + 1) // 2
        carried = 2 * ql * n * dh if c0 > 0 else 0
        flops += 2 * pairs * n + h * p * (2 * pairs * dh + 2 * ql * n * dh
                                          + carried)
    return bz * flops


def ssd_tol(want) -> float:
    """1e-4 of the output's scale (at least 1e-4): f32 sums of up to Q + N
    terms and the prefix sum of dt A in other orders; the plain f32
    version sits within 8.1e-6 of the scale from a float64 evaluation at
    these shapes (tests/test_torch_cuda.py::ssd_tol)."""
    return 1e-4 * max(1.0, want.abs().max().item())


def ssd_inputs(bz, s, h, dh, n, gen, n_sets=1, dtype=torch.float32):
    """Sets of (u, dt, A, B, C) drawn in f32. bf16: u rounded, and B and
    C rounded into one (Bz, S, 2 N) tensor and split into row views, as
    the Mamba-2 mixer hands them to the scan."""
    sets = []
    for _ in range(n_sets):
        u = torch.randn(bz, s, h, dh, device="cuda", generator=gen)
        dt = torch.nn.functional.softplus(
            torch.randn(bz, s, h, device="cuda", generator=gen))
        a = -torch.exp(torch.randn(h, device="cuda", generator=gen))
        b = torch.randn(bz, s, n, device="cuda", generator=gen)
        c = torch.randn(bz, s, n, device="cuda", generator=gen)
        if dtype != torch.float32:
            u = u.to(dtype)
            b, c = torch.split(torch.cat([b, c], -1).to(dtype), n, dim=-1)
        sets.append((u, dt, a, b, c))
    return sets


def ssd_row(name, bz, s, h, dh, n, chunk, dtype, gen, card: str) -> dict:
    """One phase 16 row: the route ``ssd_route`` picks, y and the final
    state against the plain version (on the same values in f32), two
    calls bit-equal, kernel and plain times, and both bounds: the f32
    CUDA-core one (f32 bytes or f32 flops at 67 TFLOP/s) and the route's
    own (bf16: bytes with u, B and C in bf16, or the piece products at
    989 TFLOP/s; fma: the f32 one). The row's bound is the route's."""
    (args,) = ssd_inputs(bz, s, h, dh, n, gen, dtype=dtype)
    route = kssd.ssd_route(args[0], args[3], args[4])
    y, final = kssd.ssd_scan_cuda(*args, chunk)
    torch.cuda.synchronize()
    want_y, want_s = ref.ssd_scan_ref(*args, chunk)
    err_y = (y - want_y).abs().max().item()
    err_s = (final - want_s).abs().max().item()
    tol_y, tol_s = ssd_tol(want_y), ssd_tol(want_s)
    if not (err_y <= tol_y and err_s <= tol_s):
        raise AssertionError(f"ssd_scan {name} {dtype} ({route}): y err "
                             f"{err_y:.3e} (tol {tol_y:.3e}), state err "
                             f"{err_s:.3e} (tol {tol_s:.3e})")
    y2, final2 = kssd.ssd_scan_cuda(*args, chunk)
    if not (torch.equal(y, y2) and torch.equal(final, final2)):
        raise AssertionError(f"ssd_scan {name} {dtype}: two calls differ")
    del y, final, y2, final2, want_y, want_s, args
    nbytes, flops = ssd_work(bz, s, h, dh, n, chunk, dtype)
    n_sets = max(1, min(24, int(120e6 // nbytes) + 1))
    sets = ssd_inputs(bz, s, h, dh, n, gen, n_sets, dtype=dtype)

    def kern(*a, chunk=chunk):
        return kssd.ssd_scan_cuda(*a, chunk)

    def plain(*a, chunk=chunk):
        return ref.ssd_scan_ref(*a, chunk)

    k_ms, p_ms = time_ms(kern, sets), time_ms(plain, sets)
    del sets
    f32_ms, f32_by = bound_of(*ssd_work(bz, s, h, dh, n, chunk), torch.float32)
    if route == "tensor_core":
        tb = nbytes / HBM_BYTES_S * 1e3
        tf = ssd_tc_flops(bz, s, h, dh, n, chunk) / PEAK_FLOPS[
            torch.bfloat16] * 1e3
        b_ms, b_by = max(tb, tf), ("bytes" if tb >= tf else "operations")
    else:
        b_ms, b_by = f32_ms, f32_by
    dname = "bf16" if dtype == torch.bfloat16 else "f32"
    print(f"[kernel] ssd_scan {name:14s} {dname:4s} {route:11s} Bz={bz} "
          f"S={s} H={h} dh={dh} N={n} chunk={chunk} err y={err_y:.2e} (tol "
          f"{tol_y:.2e}) state={err_s:.2e} (tol {tol_s:.2e}) "
          f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms=none "
          f"bound_ms={b_ms:.5f} ({b_by}; f32 CUDA-core bound {f32_ms:.5f} "
          f"{f32_by}) | {card}", flush=True)
    return dict(case=name, dtype=dname, route=route, Bz=bz, S=s, H=h, dh=dh,
                N=n, chunk=chunk, kernel_ms=k_ms, plain_ms=p_ms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                f32_bound_ms=f32_ms, f32_bound_by=f32_by,
                max_abs_err_y=err_y, max_abs_err_state=err_s, tol_y=tol_y,
                tol_state=tol_s, gflop=flops / 1e9)


def phase_ssd_kernel(card: str) -> dict:
    print("== phase 16: ssd_scan (kernel #8) against its plain version",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(16)
    cases = [(f"sweep {c}", *c, torch.float32) for c in SSD_SWEEP]
    cases += [(name, *c, dt) for dt in (torch.float32, torch.bfloat16)
              for name, c in SSD_PATH.items()]
    rows = [ssd_row(*c, gen, card) for c in cases]
    gc.collect()
    torch.cuda.empty_cache()
    worst = max(max(r["max_abs_err_y"], r["max_abs_err_state"])
                for r in rows)
    head = next(r for r in rows
                if r["case"] == "zamba2_prefill" and r["dtype"] == "bf16")
    return dict(rows=rows, worst=worst,
                headline=dict(ms=head["kernel_ms"], plain_ms=head["plain_ms"],
                              library_ms=None, bound_ms=head["bound_ms"],
                              bound_by=head["bound_by"], route=head["route"]))


# zamba2-7b's factored site shapes (I, K, O): rank 896 (bcdt_proj 128),
# where #1's fused kernel (launch_config) would drop to 16-row tiles
ZAMBA_SHAPES = {"ssm/in_proj": (3584, 896, 14336),
                "ssm/bcdt_proj": (3584, 128, 240),
                "ssm/out_proj": (7168, 896, 3584),
                "attn/wq|wk|wv|wo": (3584, 896, 3584),
                "mlp/gate|up": (3584, 896, 14336),
                "mlp/down": (14336, 896, 3584)}


# sites of each shape in one mamba2_attn layer: the mixer's in_proj,
# bcdt_proj, out_proj; the shared block's wq, wk, wv, wo, gate, up, down
ZAMBA_LAYER_SITES = {"ssm/in_proj": 1, "ssm/bcdt_proj": 1,
                     "ssm/out_proj": 1, "attn/wq|wk|wv|wo": 4,
                     "mlp/gate|up": 2, "mlp/down": 1}


def zamba2_lowrank_rows(card: str) -> list:
    """Kernel #1 at zamba2-7b's site shapes, bf16, a decode step's rows
    (M = 4) and a prefill bucket's (M = 1024)."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    return [lowrank_row("[zamba2]", name, m, i, k, o, torch.bfloat16, gen,
                        card)
            for name, (i, k, o) in ZAMBA_SHAPES.items() for m in (4, 1024)]


def forward_counts(cfg) -> dict:
    """Kernel calls of one forward of ``cfg``, by its layers' kinds:
    ``sites``, the factored linears (#1 serving, #2 training, #6 int8);
    ``stateless``, those of them without an ASI state under ``wasi`` (the
    shared block's 7 in each ``mamba2_attn`` layer, Mamba-1's
    ``dt_proj``), which train through #2 and #3 there too; ``flash``, the
    attention layers (#7, full-sequence passes only); ``ssd``, the Mamba-2
    layers (#8, full-sequence passes only). ``stacks``: the factored
    (L, R) leaves of the tree, one CholeskyQR and one Gram each a
    refresh."""
    specs = [s.name for s in api.plan_of(cfg).specs]
    blk = sum(not n.startswith("ssm/") for n in specs)   # attention + MLP
    mixer = len(specs) - blk
    out = dict(sites=0, stateless=0, flash=0, ssd=0, stacks=0)
    for g in cfg.groups:
        for kind in g.pattern:
            attn = kind in ("dense", "local", "mamba2_attn")
            own = blk if kind in ("dense", "local") else mixer
            out["sites"] += g.repeat * (own + (blk if kind == "mamba2_attn"
                                               else 0))
            out["stateless"] += g.repeat * (blk if kind == "mamba2_attn" else
                                            1 if kind == "mamba1" else 0)
            out["flash"] += g.repeat * attn
            out["ssd"] += g.repeat * (kind in ("mamba2", "mamba2_attn"))
            out["stacks"] += own
    if any("mamba2_attn" in g.pattern for g in cfg.groups):
        out["stacks"] += blk                 # the shared block, one copy
    return out


def zamba2_per_forward(cfg) -> tuple[int, int, int]:
    """(#1 per forward or decode step, #8 and #7 per prefill call)."""
    c = forward_counts(cfg)
    return c["sites"], c["ssd"], c["flash"]


def phase_zamba2_smoke(card: str) -> dict:
    print("== phase 17: zamba2 smoke, card against CPU (f32)", flush=True)
    cfg = configs.get_smoke("zamba2-7b")
    api.install(api.resolve(cfg))
    per_fwd, per_ssd, per_flash = zamba2_per_forward(cfg)
    gpu = init_lm(cfg, device="cuda", seed=11)
    cpu = init_lm(cfg, device="cpu", seed=11)
    rng = np.random.default_rng(0)
    # 13 tokens: a chunk of 8 and a ragged one of 5; rows padded to it
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 13)))
    vl = torch.tensor([13, 4, 9])
    # f32 on both sides, sums in other orders (#1's split reduction, #8's
    # tiles and prefix sum, cuBLAS): a few ulps per op through 3 layers,
    # 1e-4 on logits of magnitude ~1, as phase 4
    tol = 1e-4
    worst = 0.0
    with torch.inference_mode():
        caches = {d: init_lm_cache(cfg, 3, 32, dtype=torch.float32, device=d)
                  for d in ("cuda", "cpu")}
        out = {}
        ops.reset_launches()
        for d, model in (("cuda", gpu), ("cpu", cpu)):
            lg, caches[d] = lm_prefill(model, toks.to(d), cfg,
                                       caches=caches[d],
                                       valid_len=vl.to(d), last_only=True)
            out[d] = lg[:, 0].cpu()
        want = {"lowrank_fwd": per_fwd, "ssd_scan": per_ssd,
                "flash_attention": per_flash}
        got = {k: ops.LAUNCHES[k] for k in want}
        if got != want:
            raise AssertionError(f"zamba2 smoke prefill launches {got} != "
                                 f"{want}")
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
        want["lowrank_fwd"] += 6 * per_fwd
        got = {k: ops.LAUNCHES[k] for k in want}
        if got != want:
            raise AssertionError(f"zamba2 smoke decode launches {got} != "
                                 f"{want} (none of #8, #7 per decode step)")
        state_err = max(
            (a.cpu() - b).abs().max().item() for a, b in zip(
                _tree_leaves(caches["cuda"]), _tree_leaves(caches["cpu"])))
    if not (worst <= tol and state_err <= tol):
        raise AssertionError(f"zamba2 smoke card vs CPU: logits differ by "
                             f"{worst:.3e}, caches by {state_err:.3e} > "
                             f"{tol:.1e}")
    print(f"[zamba2] smoke prefill (13 tokens, valid_len 13/4/9) + 6 teacher-"
          f"forced decode steps: max |card - cpu| logits = {worst:.3e}, "
          f"caches (SSD states, conv buffers, KV) = {state_err:.3e} (tol "
          f"{tol:.1e}); launches per prefill: {per_ssd} ssd_scan, "
          f"{per_flash} flash_attention, {per_fwd} lowrank_fwd; per decode "
          f"step {per_fwd} lowrank_fwd only | {card}")
    eng = ServeEngine(gpu, cfg, max_slots=2, max_cache=64,
                      buckets=(4, 8, 16), device="cuda")
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n)))
               for n in (3, 7, 5, 11, 20)]
    hs = [eng.submit(p, max_new=6) for p in prompts]
    eng.run()
    for p, h in zip(prompts, hs):
        want_t = generate(gpu, cfg, torch.tensor([p], device="cuda"),
                          max_cache=64, n_new=6)[0].tolist()
        if h.tokens != want_t:
            raise AssertionError(f"zamba2 card engine {h.tokens} != lockstep"
                                 f" generate {want_t}")
    print(f"[zamba2] smoke engine (2 slots, 5 prompts, buckets 4/8/16, a "
          f"20-token prompt padded to 32: 4 chunks) == lockstep generate on "
          f"the card | "
          f"{card}", flush=True)
    return dict(logit_err=worst, cache_err=state_err)


def cache_mib_by_kind(caches) -> dict:
    """Decode-cache MiB of the engine: KV, SSD states, conv buffers."""
    out = {"kv": 0, "ssm": 0, "conv": 0}
    for group in caches:
        for c in group:
            if "kv" in c:
                out["kv"] += sum(t.numel() * t.element_size() for t in c["kv"])
            if "ssm" in c:
                st = c["ssm"]
                out["ssm"] += st.ssm.numel() * st.ssm.element_size()
                out["conv"] += sum(t.numel() * t.element_size()
                                   for t in st.conv)
    return {k: v / 2**20 for k, v in out.items()}


def profile_prefill(eng, cfg, rng, card: str) -> dict:
    """Device busy share of one prefill tick: 4 prompts of 200 tokens (the
    256 bucket, one chunk through #8) admitted and prefilled by one engine
    tick under torch.profiler (max_new 1: no decode follows)."""
    for _ in range(4):
        eng.submit(list(map(int, rng.integers(0, cfg.vocab_size, 200))),
                   max_new=1)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    eng.run()
    events = device_events(prof)
    dev_us = sum(e.self_device_time_total for e in events)
    if dev_us <= 0:
        print(f"[profile] no device time in the prefill trace: busy share "
              f"not measured | {card}")
        return {"prefill_busy_share": None}
    print(f"[profile] 1 prefill tick (4 x 200 tokens, bucket 256): wall "
          f"{wall_us / 1e3:.3f} ms, device busy {dev_us / 1e3:.3f} ms, busy "
          f"share {dev_us / wall_us:.3f} | {card}")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        print(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms "
              f"{e.count:5d} calls  {e.key[:70]}")
    # kernel #8's launches: ssd_chunk, ssd_pass and ssd_out of the
    # tensor-core route, ssd_scan_f32 of the fma route
    ssd = [e for e in events if "ssd_" in e.key]
    ssd_ms = sum(e.self_device_time_total for e in ssd) / 1e3
    print(f"[profile]   #8 (ssd_scan) in the tick: {ssd_ms:.3f} ms of "
          f"{dev_us / 1e3:.3f} ms device time, "
          f"{sum(e.count for e in ssd)} launches | {card}")
    scan_ms = None
    if cfg.groups[0].pattern[0] == "mamba1":
        # the plain selective scan's ranges (``scan_ranges``): their spans
        # on the device, from each one's first kernel to its last
        rows = device_events(prof, ranges=True)
        scan_ms = sum(e.self_device_time_total for e in rows) / 1e3
        print(f"[profile]   plain selective scan in the tick: {scan_ms:.3f}"
              f" ms (the ranges' spans on the device) of {dev_us / 1e3:.3f} "
              f"ms device time, {sum(e.count for e in rows)} calls | {card}")
    return {"prefill_busy_share": dev_us / wall_us,
            "prefill_scan_device_ms": scan_ms,
            "prefill_tick_wall_ms": wall_us / 1e3,
            "prefill_tick_device_ms": dev_us / 1e3,
            "prefill_ssd_device_ms": ssd_ms,
            "prefill_top": [(e.key[:70], e.self_device_time_total / 1e3,
                             e.count) for e in top]}


def zamba2_reduced_logits(cfg, card: str) -> dict:
    """``logits_vs_cpu`` at full width and reduced depth: the first
    pattern once (5 mamba2 + 1 mamba2_attn)."""
    from repro_torch.config import LayerGroup

    red = cfg.replace(n_layers=len(cfg.groups[0].pattern), groups=(
        LayerGroup(pattern=cfg.groups[0].pattern, repeat=1),))
    api.install(api.resolve(red))
    gen = torch.Generator(device="cuda").manual_seed(18)
    model = init_lm(red, device="cuda", generator=gen)
    out = logits_vs_cpu("zamba2", red, model, card)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_zamba2_full(card: str) -> dict:
    print("== phase 18: zamba2-7b full width (81 Mamba-2 layers, shared "
          "attention after every 6th, d 3584, bf16), 9 requests, 4 slots",
          flush=True)
    cfg = configs.get("zamba2-7b")
    plan = api.install(api.resolve(cfg))
    per_fwd, per_ssd, per_flash = zamba2_per_forward(cfg)
    assert (per_fwd, per_ssd, per_flash) == (334, 81, 13)
    assert all(s.mode == "factored" for s in plan.specs)
    t0 = time.perf_counter()
    # weights drawn on the card from a seeded CUDA generator
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = init_lm(cfg, device="cuda", generator=gen)
    torch.cuda.synchronize()
    param_mib = sum(p.numel() * p.element_size()
                    for p in model.parameters()) / 2**20
    print(f"[zamba2] init {time.perf_counter() - t0:.1f}s, parameters "
          f"{param_mib:.1f} MiB", flush=True)
    eng = ServeEngine(model, plan=plan, max_slots=4, max_cache=1024,
                      device="cuda")
    rng = np.random.default_rng(1)
    eng.submit(list(map(int, rng.integers(0, cfg.vocab_size, 9))), max_new=4)
    eng.run()
    eng.reset_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # phase 5's 8 requests, and one 700-token prompt (bucket 768: three
    # chunks of 256 through #8)
    lengths = (5, 17, 33, 64, 9, 120, 48, 200, 700)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n)))
               for n in lengths]
    sampled = SamplingParams(temperature=0.8, top_k=50, seed=99)
    ops.reset_launches()
    hs = [eng.submit(p, max_new=16,
                     sampling=sampled if i in (2, 5) else None)
          for i, p in enumerate(prompts)]
    eng.run()
    torch.cuda.synchronize()
    launches = {k: ops.LAUNCHES[k] for k in ("lowrank_fwd", "ssd_scan",
                                             "flash_attention")}
    s = eng.summary()
    for h in hs:
        if not (h.finished and len(h.generated) == 16):
            raise AssertionError(f"request {h.rid} ended {h.status} with "
                                 f"{len(h.generated)} tokens")
        if not all(0 <= t < cfg.padded_vocab for t in h.generated):
            raise AssertionError(f"request {h.rid}: token out of range")
    lr = launches["lowrank_fwd"]
    if lr % per_fwd or lr < per_fwd * s["decode_steps"]:
        raise AssertionError(f"lowrank_fwd launches {lr} is not a multiple "
                             f"of {per_fwd} covering {s['decode_steps']} "
                             "decode steps")
    prefills = lr // per_fwd - s["decode_steps"]
    if launches["ssd_scan"] != per_ssd * prefills or \
            launches["flash_attention"] != per_flash * prefills:
        raise AssertionError(f"launches {launches}: want {per_ssd} ssd_scan"
                             f" and {per_flash} flash_attention x {prefills}"
                             f" prefill calls, none per decode step")
    print(f"[zamba2] launches {launches}: lowrank_fwd = {lr // per_fwd} "
          f"forwards x {per_fwd} ({s['decode_steps']} decode steps + "
          f"{prefills} prefill calls); ssd_scan = {prefills} x {per_ssd}, "
          f"flash_attention = {prefills} x {per_flash}; 0 of either per "
          f"decode step", flush=True)
    ttft = [h.ttft_s for h in hs]
    tpot = [h.tpot_s for h in hs]
    peak = torch.cuda.max_memory_allocated()
    cache = cache_mib_by_kind(eng.caches)
    res = dict(prefill_tok_s=s["prefill_tok_s"], decode_tok_s=s["decode_tok_s"],
               ttft_ms_median=statistics.median(ttft) * 1e3,
               ttft_ms_max=max(ttft) * 1e3, ttft_ms_700=ttft[-1] * 1e3,
               tpot_ms_median=statistics.median(tpot) * 1e3,
               weight_mib=s["weight_mib"], param_mib=param_mib,
               cache_mib=s["cache_bytes"] / 2**20, kv_mib=cache["kv"],
               ssm_mib=cache["ssm"], conv_mib=cache["conv"],
               max_memory_allocated_mib=peak / 2**20,
               decode_steps=s["decode_steps"], prefill_calls=prefills,
               launches=launches, prefill_tokens=s["prefill_tokens"],
               decode_tokens=s["decode_tokens"], wall_s=s["wall_s"])
    for key in ("prefill_tok_s", "decode_tok_s", "ttft_ms_median",
                "ttft_ms_max", "ttft_ms_700", "tpot_ms_median", "weight_mib",
                "param_mib", "cache_mib", "kv_mib", "ssm_mib", "conv_mib",
                "max_memory_allocated_mib"):
        print(f"[zamba2] {key}={res[key]:.3f} | {card}")
    print(f"[zamba2] greedy sample rid=0: {hs[0].generated}")
    res.update(profile_decode(eng, cfg, rng, card))
    res.update(profile_prefill(eng, cfg, rng, card))
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    res["cpu_logits"] = zamba2_reduced_logits(cfg, card)
    return res


# ---------------------------------------------------------------------------
# the dense decoder configs: tinyllama-1.1b (the paper's Fig. 7 model),
# stablelm-3b, granite-3-8b, internvl2-26b and gemma3-4b
# ---------------------------------------------------------------------------

def remat_runs(cfg) -> int:
    """How often a training step runs each forward kernel: twice under
    ``remat="block"`` (the forward, then the recompute the backward asks
    for), once under ``"none"``."""
    return 2 if cfg.remat == "block" else 1


def with_remat(cfg, remat: str, b: int, s: int):
    """``cfg`` under another ``remat`` setting, with its plan (which the
    setting does not change) installed for the run's activation shape."""
    c = cfg.replace(remat=remat)
    api.install(api.resolve(c, batch=b, seq=s))
    return c


def train_want(cfg, method: str, n_steps: int, refreshes: int) -> dict:
    """Exact launches of ``n_steps`` training steps (``forward_counts``):
    per step the attentions (#7) and Mamba-2 scans (#8) and, under
    factored ``wsi``, every factored linear's sketch forward (#2), each
    run ``remat_runs(cfg)`` times, and its backward (#3) once; under
    ``wasi`` only the linears without an ASI state take #2 and #3; one
    Gram (#5) and one CholeskyQR (#4) per factored stack a refresh;
    nothing else (#8's backward is plain). Project mode launches #7 alone:
    its linears and its WSI step are plain, as in the reference."""
    c = forward_counts(cfg)
    runs = remat_runs(cfg)
    want = dict.fromkeys(ops.launch_counts(), 0)
    want["flash_attention"] = n_steps * c["flash"] * runs
    want["ssd_scan"] = n_steps * c["ssd"] * runs
    if cfg.wasi.factored and method in ("wsi", "wasi"):
        sites = c["sites"] if method == "wsi" else c["stateless"]
        want["lowrank_fwd_sketch"] = n_steps * sites * runs
        want["lowrank_bwd"] = n_steps * sites
    if cfg.wasi.factored:
        want["gram"] = want["choleskyqr"] = refreshes * c["stacks"]
    return want


def want_text(cfg, method: str, n_steps: int, refreshes: int) -> str:
    """``train_want``'s formula, for the log."""
    runs, c = remat_runs(cfg), forward_counts(cfg)
    out = [f"flash_attention = {n_steps} steps x {c['flash']} attention "
           f"layers x {runs}"]
    if c["ssd"]:
        out.append(f"ssd_scan = {n_steps} x {c['ssd']} Mamba-2 layers x "
                   f"{runs}")
    if cfg.wasi.factored and method in ("wsi", "wasi"):
        sites = c["sites"] if method == "wsi" else c["stateless"]
        what = "sites" if method == "wsi" else "sites without an ASI state"
        out += [f"lowrank_fwd_sketch = {n_steps} x {sites} {what} x {runs}",
                f"lowrank_bwd = {n_steps} x {sites}"]
    if cfg.wasi.factored:
        out.append(f"gram = choleskyqr = {refreshes} refreshes x "
                   f"{c['stacks']} stacks")
    return "; ".join(out) + (f" (x {runs}: the forward and the recompute)"
                             if runs == 2 else "")


def refreshes_in(cfg, start: int, end: int) -> int:
    """WSI refreshes steps ``start`` .. ``end`` - 1 run."""
    every = cfg.wasi.refresh_every
    if not (cfg.wasi.factored and every > 0):
        return 0
    return sum((s + 1) % every == 0 for s in range(start, end))


def uniform_batches(cfg, b: int, s: int, seed: int):
    """Batch ``i``: seeded uniform tokens on the card, drawn from ``seed`` +
    i (``SyntheticLM``'s dense (vocab, vocab) bigram table would take 92
    GB of host memory at qwen2's vocab, 4 GB at tinyllama's)."""
    def batch_fn(i):
        g = torch.Generator(device="cuda").manual_seed(seed + i)
        t = torch.randint(0, cfg.vocab_size, (b, s + 1), device="cuda",
                          generator=g)
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}
    return batch_fn


def grad_peak(model, batch, cfg, states, fwd=None) -> float:
    """The allocator's peak MiB of one forward and backward
    (``value_and_grad``, on ``fwd`` where given: project mode's tree) under
    ``cfg``, from what is live before it."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = value_and_grad(lm_loss, model, batch, cfg, states, fwd)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    del out
    return peak


def remat_memory(state, batch, cfg, cfg_none) -> dict:
    """The config's ``remat="block"`` beside ``"none"`` (the paper's memory
    comparison) from one state and batch: the saved-for-backward bytes and
    arrays of one ``lm_loss`` (``utils.memprof``; in project mode on the
    tree with the factors injected, whose L and R count where the
    checkpoint keeps them) and the allocator's peak of one forward and
    backward (``grad_peak``)."""
    from repro_torch.utils.memprof import measured_residual_bytes

    fwd = (None if state.wsi is None
           else project_forward_params(state.params, state.wsi))
    out = {}
    for remat, c in (("block", cfg), ("none", cfg_none)):
        rep = measured_residual_bytes(
            lambda: lm_loss(state.params if fwd is None else fwd, batch, c,
                            states=state.asi))
        out[f"residual_bytes_{remat}"] = rep.total_bytes
        out[f"residual_arrays_{remat}"] = rep.n_arrays
        del rep
        torch.cuda.empty_cache()
        out[f"grad_peak_mib_{remat}"] = grad_peak(state.params, batch, c,
                                                  state.asi, fwd)
    torch.cuda.empty_cache()
    return out


def train_run(tag: str, state, step, batch_fn, tcfg, cfg, method: str,
              start: int, end: int, tokens: int):
    """Steps ``start`` .. ``end`` - 1 through ``train_loop(memprof=True)``
    under ``cfg``: exact launches (``train_want``, printed with its
    formula), finite losses, and the row: losses, step ms (the median
    leaves out the first step), tokens/s at ``tokens`` a step and the
    allocator's figures. Returns (state, row)."""
    ops.reset_launches()
    state, hist = train_loop(state, step, batch_fn, tcfg, log_every=1,
                             memprof=True, max_steps=end,
                             log_fn=lambda line: print(line, flush=True))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    refreshes = refreshes_in(cfg, start, end)
    want = train_want(cfg, method, end - start, refreshes)
    if counts != want:
        raise AssertionError(f"{tag} {method} remat={cfg.remat} launches "
                             f"{counts} != {want}")
    print(f"[{tag}] {method} remat={cfg.remat} launches = "
          f"{want_text(cfg, method, end - start, refreshes)}", flush=True)
    losses = [h["loss"] for h in hist]
    if len(hist) != end - start or not all(np.isfinite(x) for x in losses):
        raise AssertionError(f"{tag} {method} remat={cfg.remat} losses "
                             f"{losses}")
    step_s = statistics.median(h["sec"] for h in hist[1:])
    return state, dict(remat=cfg.remat, losses=losses,
                       step_ms=[h["sec"] * 1e3 for h in hist],
                       step_ms_median=step_s * 1e3, tok_s=tokens / step_s,
                       dev_peak_mib=max(h["mem_dev_peak_mib"] for h in hist),
                       live_mib=hist[-1]["mem_live_mib"],
                       live_peak_mib=hist[-1]["mem_live_peak_mib"],
                       launches=counts, refreshes=refreshes)


def remat_grads(state, cfg, cfg_none, method: str, batch, card: str,
                tag: str = "tinyllama") -> dict:
    """One step's loss, gradients and refreshed ASI states under ``block``
    and under ``none`` from the same state and batch, and their launches.
    Both run the same kernels on the same inputs (the recompute takes the
    forward's routes), so they should agree to the bit; held to one bf16
    ulp of each leaf's scale, with the largest difference printed."""
    out = {}
    for remat, c in (("block", cfg), ("none", cfg_none)):
        ops.reset_launches()
        loss, _, grads, ns = value_and_grad(lm_loss, state.params, batch, c,
                                            state.asi)
        torch.cuda.synchronize()
        out[remat] = (loss, grads, ns, ops.launch_counts())
    (lb, gb, sb, cb), (ln, gn, sn, cn) = out["block"], out["none"]
    for c, counts in ((cfg, cb), (cfg_none, cn)):
        want = train_want(c, method, 1, 0)
        if counts != want:
            raise AssertionError(f"{method} {c.remat} one step launches "
                                 f"{counts} != {want}")
    worst, bits = 0.0, bool(torch.equal(lb, ln))
    for k in gn:
        scale = gn[k].float().abs().max().item()
        diff = (gb[k].float() - gn[k].float()).abs().max().item()
        worst = max(worst, diff / max(scale, 1e-30))
        bits = bits and bool(torch.equal(gb[k], gn[k]))
    st_bits, st_worst = True, 0.0
    if sn is not None:
        from repro_torch.models.lm import map_states
        pairs = []
        map_states(lambda a, b_: pairs.append((a, b_)), sb, sn)
        for a, b_ in pairs:
            st_bits = st_bits and bool(torch.equal(a, b_))
            st_worst = max(st_worst, ((a.float() - b_.float()).abs().max()
                                      / b_.float().abs().max()).item())
    if not (worst <= 2.0 ** -8 and st_worst <= 2.0 ** -8):
        raise AssertionError(f"{method}: block and none gradients differ by "
                             f"{worst:.3e} of a leaf's scale, ASI states by "
                             f"{st_worst:.3e} (tol 2^-8)")
    print(f"[{tag}] {method}: one step from the same state, block "
          f"against none: loss {float(lb):.6f} / {float(ln):.6f}, "
          f"gradients {'bit-equal' if bits else 'NOT bit-equal'} (largest "
          f"difference {worst:.3e} of a leaf's scale, tol 2^-8), ASI states "
          f"{'bit-equal' if st_bits else 'NOT bit-equal'} ({st_worst:.3e});"
          f" launches block {dict((k, v) for k, v in cb.items() if v)} none "
          f"{dict((k, v) for k, v in cn.items() if v)} | {card}", flush=True)
    del out, gb, gn, sb, sn
    torch.cuda.empty_cache()
    return dict(grad_bit_equal=bits, grad_max_rel_diff=worst,
                states_bit_equal=st_bits, states_max_rel_diff=st_worst,
                loss_block=float(lb), loss_none=float(ln))


# phase 19: batch 4 x seq 512, SGD+momentum 0.9 at a constant rate of 0.05
# (the launcher's default rate; the reference's Fig. 7 protocol without its
# cosine decay, so both rows of a method train at one rate), refresh every
# 8: 8 steps under remat "block" (the config's), a profiled step, 4 steps
# under "none", a profiled step
TINY_B, TINY_S, TINY_LR = 4, 512, 0.05
TINY_BLOCK_STEPS, TINY_NONE_STEPS, TINY_REFRESH = 8, 4, 8
TINY_METHODS = ("wasi", "wsi", "none")


def tinyllama_method(method: str, card: str) -> dict:
    """One method of Fig. 7 at full width, under ``block`` and ``none``."""
    b, s = TINY_B, TINY_S
    n1 = TINY_BLOCK_STEPS
    n2 = n1 + 1 + TINY_NONE_STEPS
    tcfg = TrainConfig(optimizer="sgd", lr=TINY_LR, momentum=0.9,
                       schedule="constant", steps=n2 + 1, checkpoint_every=0)
    t0 = time.perf_counter()
    cfg, plan, state, step, _ = launch_train.build(
        "tinyllama-1.1b", smoke=False, batch=b, seq=s, wasi=method,
        tcfg=tcfg, device="cuda", refresh_every=TINY_REFRESH)
    build_s = time.perf_counter() - t0
    if cfg.remat != "block" or cfg.n_layers != 22 or \
            cfg.wasi.method != method:
        raise AssertionError(f"tinyllama-1.1b built {cfg.remat} "
                             f"{cfg.n_layers} {cfg.wasi.method}")
    cfg_none = with_remat(cfg, "none", b, s)
    batch_fn = uniform_batches(cfg, b, s, 1900)
    res = dict(method=method, build_s=build_s)
    res.update(remat_grads(state, cfg, cfg_none, method, batch_fn(100),
                           card))
    res.update(remat_memory(state, batch_fn(200), cfg, cfg_none))
    step_none = make_train_step(lm_loss, cfg_none, tcfg)
    for c, st_fn, start, end in ((cfg, step, 0, n1),
                                 (cfg_none, step_none, n1 + 1, n2)):
        state, row = train_run("tinyllama", state, st_fn, batch_fn, tcfg, c,
                               method, start, end, b * s)
        state, prof = profile_train_step(state, st_fn, batch_fn(300 + end),
                                         card)
        row.update(prof)
        print(f"[tinyllama] {method} remat={c.remat}: step_ms_median="
              f"{row['step_ms_median']:.3f} tok_s={row['tok_s']:.1f} "
              f"dev_peak_mib={row['dev_peak_mib']:.1f} busy_share="
              f"{row['train_busy_share']} losses "
              f"{[round(x, 4) for x in row['losses']]} | {card}", flush=True)
        res[c.remat] = row
        gc.collect()
        torch.cuda.empty_cache()
    res["params"] = sum(p.numel() for p in state.params.parameters())
    del state, step, step_none
    gc.collect()
    torch.cuda.empty_cache()
    return res


def fig7_ratios(cfg, b: int, s: int, card: str) -> list:
    """Fig. 7's analytic resource ratios of fine-tuning the last 1 and 2
    layers, computed from the full config as
    ``benchmarks/fig7_tinyllama.py`` computes them from the smoke config:
    weights of a layer's 7 linears dense against factored at the static
    rank (align 1), activations B x S x d dense against their Tucker form at
    mode fractions (1, 0.5, 0.5), 7 per layer."""
    from repro_torch.core.asi import tucker_storage
    from repro_torch.core.rank_policy import asi_mode_ranks, static_rank

    d, f = cfg.d_model, cfg.d_ff
    k = static_rank(d, f, cfg.wasi.rank_frac, align=1, min_rank=4)
    w_vanilla = 3 * d * f + 4 * d * d
    w_wasi = 3 * k * (d + f) + 4 * k * 2 * d
    a = (b, s, d)
    r = asi_mode_ranks(a, (1.0, 0.5, 0.5), skip_batch=True, align=1)
    a_vanilla = b * s * d * 7
    a_wasi = tucker_storage(a, r) * 7
    rows = []
    for n_ft in (1, 2):
        row = dict(layers=n_ft, rank=k, act_ranks=r,
                   w_elems_vanilla=n_ft * w_vanilla,
                   w_elems_wasi=n_ft * w_wasi,
                   w_mem_ratio=w_vanilla / w_wasi,
                   act_elems_vanilla=n_ft * a_vanilla,
                   act_elems_wasi=n_ft * a_wasi,
                   act_mem_ratio=a_vanilla / a_wasi)
        rows.append(row)
        print(f"[fig7] last {n_ft} layer(s) of tinyllama-1.1b (d {d}, d_ff "
              f"{f}, rank {k}, activations {a} at ranks {r}): weights "
              f"{row['w_elems_vanilla']:,} -> {row['w_elems_wasi']:,} "
              f"elements, w_mem_ratio={row['w_mem_ratio']:.2f}; "
              f"activations {row['act_elems_vanilla']:,} -> "
              f"{row['act_elems_wasi']:,}, act_mem_ratio="
              f"{row['act_mem_ratio']:.2f} (analytic)", flush=True)
    return rows


def phase_tinyllama(card: str) -> dict:
    print("== phase 19: tinyllama-1.1b full width and depth (22 layers, d "
          "2048, bf16): Fig. 7 training under wasi, wsi and none, each "
          "under remat block and none; serving", flush=True)
    out = {}
    for method in TINY_METHODS:
        out[method] = tinyllama_method(method, card)
    cfg = configs.get("tinyllama-1.1b")
    out["fig7"] = fig7_ratios(cfg, TINY_B, TINY_S, card)
    print("[tinyllama] method remat  step_ms  tok_s  dev_peak_mib  "
          "busy_share  saved_MiB  fwd+bwd_peak_MiB (the last two of one "
          "lm_loss from the method's first state)")
    for m in TINY_METHODS:
        for remat in ("block", "none"):
            r = out[m][remat]
            busy = r["train_busy_share"]
            print(f"[tinyllama] {m:5s} {remat:5s} {r['step_ms_median']:8.3f}"
                  f" {r['tok_s']:8.1f} {r['dev_peak_mib']:9.1f} "
                  f"{'n/a' if busy is None else f'{busy:.3f}'} "
                  f"{out[m][f'residual_bytes_{remat}'] / 2 ** 20:9.1f} "
                  f"{out[m][f'grad_peak_mib_{remat}']:9.1f} | {card}",
                  flush=True)
    plan = api.install(api.resolve(cfg))
    if [(s.name, s.rank) for s in plan.specs] != [
            ("attn/wq", 512), ("attn/wk", 128), ("attn/wv", 128),
            ("attn/wo", 512), ("mlp/gate", 512), ("mlp/up", 512),
            ("mlp/down", 512)]:
        raise AssertionError(f"tinyllama plan {plan.specs}")
    gen = torch.Generator(device="cuda").manual_seed(19)
    model = init_lm(cfg, device="cuda", generator=gen)
    out["serve"] = serve_dense("tinyllama", cfg, model, plan, card)
    if out["serve"]["launches_per_forward"] != 154:
        raise AssertionError("tinyllama: 154 launches of #1 per forward")
    out["serve"]["cpu_logits"] = logits_vs_cpu("tinyllama", cfg, model, card)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def reduced(cfg, groups) -> object:
    """``cfg`` cut to ``groups`` (full width)."""
    return cfg.replace(groups=groups, n_layers=sum(
        len(g.pattern) * g.repeat for g in groups))


def phase_dense_configs(card: str) -> dict:
    from repro_torch.config import LayerGroup

    print("== phase 20: gemma3-4b (34 layers), stablelm-3b, granite-3-8b "
          "and internvl2-26b (2 layers each) at full width, bf16, served",
          flush=True)
    out = {}
    for arch in ("gemma3-4b", "stablelm-3b", "granite-3-8b",
                 "internvl2-26b"):
        full = configs.get(arch)
        tag = arch.split("-")[0]
        if arch == "gemma3-4b":
            # full depth; a 1,500-token prompt (the 1,536 bucket) runs
            # #7 windowed and wraps the local layers' rolling caches
            cfg, extra, max_cache = full, (1500,), 2048
            # the logits check at one pattern (5 local + 1 dense) with a
            # 1,100-token prompt: the window masks, and decode reads
            # wrapped rolling caches
            small = reduced(full, (LayerGroup(pattern=full.groups[0].pattern,
                                              repeat=1),))
            prompt_len = 1100
        else:
            cfg = reduced(full, (LayerGroup(pattern=("dense",), repeat=2),))
            extra, max_cache, small, prompt_len = (), 512, None, 16
        plan = api.install(api.resolve(cfg))
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(20)
        model = init_lm(cfg, device="cuda", generator=gen)
        torch.cuda.synchronize()
        param_mib = sum(p.numel() * p.element_size()
                        for p in model.parameters()) / 2**20
        ranks = {s.name: s.rank for s in plan.specs}
        print(f"[{tag}] {cfg.n_layers} of {full.n_layers} layers, d "
              f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} of dh "
              f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}, ranks "
              f"{ranks}; init {time.perf_counter() - t0:.1f}s, parameters "
              f"{param_mib:.1f} MiB", flush=True)
        res = serve_dense(tag, cfg, model, plan, card, extra=extra,
                          max_cache=max_cache)
        res.update(layers=cfg.n_layers, full_layers=full.n_layers,
                   param_mib=param_mib)
        if arch == "internvl2-26b":
            # the ViT frontend is a stub: precomputed (B, S, d) embeddings
            emb = torch.randn(2, 64, cfg.d_model, device="cuda",
                              generator=gen).bfloat16()
            ops.reset_launches()
            with torch.inference_mode():
                lg, *_ = lm_forward(model, emb, cfg)
            torch.cuda.synchronize()
            if not torch.isfinite(lg).all() or ops.launch_counts()[
                    "flash_attention"] != cfg.n_layers:
                raise AssertionError("internvl2: embeddings forward")
            print(f"[{tag}] a forward of precomputed (2, 64, {cfg.d_model}) "
                  f"embeddings: logits {tuple(lg.shape)} finite, "
                  f"{cfg.n_layers} flash_attention launches", flush=True)
            del lg
        if small is not None:
            del model
            gc.collect()
            torch.cuda.empty_cache()
            api.install(api.resolve(small))
            model = init_lm(small, device="cuda", generator=gen)
            cfg = small
        res["cpu_logits"] = logits_vs_cpu(tag, cfg, model, card,
                                          prompt_len=prompt_len)
        out[arch] = res
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return out

# phase 21: tinyllama-1.1b in the paper's project mode. Dense weights drawn
# on the card stand in for a pretrained checkpoint; the plan is calibrated
# on them (epsilon 0.8, rank_align 128), the converted checkpoint's factors
# become warm WSI states, each method trains PROJ_STEPS steps under the
# config's remat "block" at phase 19's batch, optimizer and rate, then a
# profiled step and one profiled WSI step; the trained dense W is
# factorized under the calibrated plan in factored mode and served.
PROJ_METHODS = ("wasi", "wsi")
PROJ_STEPS = 6
PROJ_RANK_LAYERS = (0, 21)      # layers whose ranks are held to the CPU's
PROJ_RANK_SITE = "mlp/gate"
PROJ_CKPT = os.path.join(ROOT, "build", "chip_smoke_project_ckpt")
# the reduced-depth check: 2 layers at full width, batch 2 x 64; bf16 on
# the card against f32 on the CPU, limits per square root of the depth
# (logits_vs_cpu's rule): the loss's relative error, each trained leaf's
# gradient's RMS error over its RMS, the WSI states' L R likewise. On an
# H100 the check reads 3.9e-5, 0.0120 and 0.0017 per square root of the
# depth (the same weights and batch every run, so the readings repeat);
# the limits are 1.5x those.
PROJ_CHECK_B, PROJ_CHECK_S = 2, 64
PROJ_LOSS_TOL, PROJ_GRAD_TOL, PROJ_WSI_TOL = 6e-5, 0.018, 0.0025


def with_wasi(cfg, **kw):
    return cfg.replace(wasi=dataclasses.replace(cfg.wasi, **kw))


def project_ranks(dense, full, card) -> dict:
    """The calibrated plans (one per method, project mode, and the
    config's own factored mode for serving) from the dense weights on the
    card, each timed; ``PROJ_RANK_SITE``'s unaligned rank at
    ``PROJ_RANK_LAYERS`` on the card held to ``pick_rank`` on the CPU,
    with the margin by which the cumulative explained variance passes
    epsilon, and the card's f32 ``svdvals`` (cuSOLVER) beside the f64
    Gram that ``pick_rank`` takes on the card."""
    from repro_torch.core import svd as tsvd

    out, plans = {}, {}
    for name, cfg in [(m, with_wasi(full, method=m, update_mode="project"))
                      for m in PROJ_METHODS] + [("serve", full)]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plans[name] = api.resolve(cfg, batch=TINY_B, seq=TINY_S,
                                  calibration=dense)
        out[f"calibrate_s_{name}"] = time.perf_counter() - t0
    ranks = [(sp.name, sp.rank) for sp in plans["serve"].specs]
    if any([(sp.name, sp.rank) for sp in p.specs] != ranks
           for p in plans.values()) or not all(p.calibrated
                                               for p in plans.values()):
        raise AssertionError("project: the calibrated plans differ")
    print(f"[project] calibrated ranks (epsilon {full.wasi.epsilon}, "
          f"rank_align {full.wasi.rank_align}, the max over the "
          f"{full.n_layers}-layer stack): {dict(ranks)}; calibration "
          f"{out['calibrate_s_wasi']:.2f} s (wsi {out['calibrate_s_wsi']:.2f}"
          f" s, serving plan {out['calibrate_s_serve']:.2f} s) | {card}",
          flush=True)
    eps = full.wasi.epsilon
    w = dense.groups[0][0][PROJ_RANK_SITE.split("/")[0]][
        PROJ_RANK_SITE.split("/")[1]]["w"]
    checks = []
    for j in PROJ_RANK_LAYERS:
        t0 = time.perf_counter()
        k_card = tsvd.pick_rank(w[j], eps)
        card_s = time.perf_counter() - t0
        s_card = tsvd.singular_values(w[j])
        cpu = w[j].detach().float().cpu()
        t0 = time.perf_counter()
        k_cpu = tsvd.pick_rank(cpu, eps)
        cpu_s = time.perf_counter() - t0
        s_cpu = tsvd.singular_values(cpu)
        s32 = torch.linalg.svdvals(w[j].detach().float()).cpu()
        k32 = int(tsvd.rank_for_threshold(s32, eps))
        cum = torch.cumsum(tsvd.explained_variance(s_card.double()), 0)
        row = dict(layer=j, rank_card=k_card, rank_cpu=k_cpu,
                   rank_card_svdvals32=k32,
                   margin_above=float(cum[k_card - 1] - eps),
                   margin_below=float(eps - cum[k_card - 2]),
                   gram_err=float((s_card - s_cpu).abs().max() / s_cpu[0]),
                   svdvals32_err=float((s32 - s_cpu).abs().max()
                                       / s_cpu[0]),
                   card_s=card_s, cpu_s=cpu_s)
        checks.append(row)
        print(f"[project] {PROJ_RANK_SITE} layer {j}: unaligned epsilon rank"
              f" card {k_card} (f64 Gram, {card_s * 1e3:.1f} ms) cpu {k_cpu}"
              f" (f32 LAPACK, {cpu_s * 1e3:.0f} ms); cumulative explained "
              f"variance passes {eps} by {row['margin_above']:.2e} at the "
              f"rank, {row['margin_below']:.2e} short one below it; largest"
              f" singular-value difference from the CPU's, over the largest:"
              f" Gram {row['gram_err']:.2e}, the card's f32 svdvals "
              f"{row['svdvals32_err']:.2e} (its rank {k32}) | {card}",
              flush=True)
        if k_card != k_cpu:
            raise AssertionError(f"project: {PROJ_RANK_SITE} layer {j} "
                                 f"rank {k_card} on the card, {k_cpu} on "
                                 "the CPU")
    out.update(ranks=dict(ranks), rank_checks=checks)
    return out, plans


def project_rows(plan, card: str) -> tuple[list, dict]:
    """Kernel #1 at the calibrated plan's site shapes, bf16, a decode
    step's rows (M = 4) and a prefill bucket's (M = 1,024), held to the
    plain version; the decode layer's headline."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    rows, counts = [], {}
    for name, (i, k, o) in plan_shapes(plan).items():
        counts[name] = name.count("|") + 1
        for m in (4, 1024):
            rows.append(lowrank_row("[project]", name, m, i, k, o,
                                    torch.bfloat16, gen, card))
    head = layer_headline(
        "one calibrated tinyllama-1.1b layer's 7 sites at decode (M=4, "
        "bf16)", [r for r in rows if r["M"] == 4], counts, torch.bfloat16,
        card)
    return rows, head


def _cut(tree, n: int):
    """A converted LM tree cut to its first ``n`` layers (one group)."""
    def stack(node):
        if isinstance(node, dict):
            return {k: stack(v) for k, v in node.items()}
        return node[:n]
    out = {k: v for k, v in tree.items() if k != "groups"}
    out["groups"] = [[stack(tree["groups"][0][0])]]
    return out


def project_vs_cpu(tree, plan, card: str) -> dict:
    """One project step at reduced depth (2 layers, full width) from the
    converted tree's first layers: the loss and every trained leaf's
    gradient, bf16 on the card against the same values in f32 on the CPU
    (ASI states alike), then one ``update_project_states`` of the same W
    on each; limits per square root of the depth (``PROJ_*_TOL``)."""
    from repro_torch.config import LayerGroup
    from repro_torch.models.lm import init_lm_states, map_states

    small = reduced(plan.model, (LayerGroup(pattern=("dense",), repeat=2),))
    small32 = small.replace(dtype="float32")
    tcfg = TrainConfig(optimizer="sgd", lr=TINY_LR, momentum=0.9, steps=1)
    part = _cut(tree, 2)
    g = torch.Generator().manual_seed(2121)
    toks = torch.randint(0, small.vocab_size,
                         (PROJ_CHECK_B, PROJ_CHECK_S + 1), generator=g)
    asi = (init_lm_states(small, PROJ_CHECK_B, PROJ_CHECK_S,
                          dtype=torch.bfloat16, device="cpu", seed=2121)
           if small.wasi.compress_acts else None)
    out = {}
    for dev, c in (("cuda", small), ("cpu", small32)):
        api.install(dataclasses.replace(plan, model=c))
        model = from_reference(part, c, dev).to(_dtype(c.dtype))
        st = (None if asi is None else
              map_states(lambda t: t.to(dev, _dtype(c.dtype)), asi))
        state = make_train_state(model, c, tcfg, asi_states=st)
        batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
        fwd = project_forward_params(state.params, state.wsi)
        loss, _, grads, _ = value_and_grad(lm_loss, state.params, batch, c,
                                           state.asi, fwd)
        wsi = update_project_states(state.params, state.wsi)
        out[dev] = (float(loss), {k: v.float().cpu() for k, v in
                                  grads.items()},
                    {k: (v.L.float() @ v.R.float()).cpu()
                     for k, v in wsi.items()})
        del model, state, fwd, grads, wsi
    (l1, g1, w1), (l0, g0, w0) = out["cuda"], out["cpu"]
    root = math.sqrt(small.n_layers)

    def rms_rel(a, b):
        return float((a - b).square().mean().sqrt()
                     / b.square().mean().sqrt().clamp(min=1e-30))

    loss_rel = abs(l1 / l0 - 1)
    trained = [k for k in g0 if k.startswith("groups")]
    grad_rel = {k: rms_rel(g1[k], g0[k]) for k in trained}
    wsi_rel = {k: rms_rel(w1[k], w0[k]) for k in w0}
    worst_g = max(grad_rel, key=grad_rel.get)
    worst_w = max(wsi_rel, key=wsi_rel.get)
    print(f"[project] {small.wasi.method} one step at 2 layers, bf16 card vs"
          f" f32 CPU: loss {l1:.5f} / {l0:.5f} (relative error "
          f"{loss_rel:.2e}, limit {PROJ_LOSS_TOL * root:.4f}); W gradients' "
          f"RMS error over their RMS: largest {grad_rel[worst_g]:.3e} "
          f"({worst_g}, limit {PROJ_GRAD_TOL * root:.4f}); WSI states' L R "
          f"after one update_project_states: largest {wsi_rel[worst_w]:.3e}"
          f" ({worst_w}, limit {PROJ_WSI_TOL * root:.4f}) | {card}",
          flush=True)
    if not (loss_rel <= PROJ_LOSS_TOL * root
            and grad_rel[worst_g] <= PROJ_GRAD_TOL * root
            and wsi_rel[worst_w] <= PROJ_WSI_TOL * root):
        raise AssertionError(f"project {small.wasi.method}: card vs CPU at "
                             "reduced depth")
    api.install(plan)
    return dict(loss_rel=loss_rel, grad_rms_rel=grad_rel,
                wsi_rms_rel=wsi_rel, n_layers=small.n_layers)


def wsi_device_ms(state, card: str) -> dict:
    """One ``update_project_states`` (a WSI step of every site) under the
    profiler: its device time and wall time; the states are left as they
    were."""
    _, wall_us, _, events = profiled(
        lambda: update_project_states(state.params, state.wsi))
    wall = wall_us / 1e6
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:4]
    print(f"[project] one WSI step of every site: device {dev_ms:.3f} ms in "
          f"{wall * 1e3:.3f} ms wall; top: " + ", ".join(
              f"{e.key[:40]} {e.self_device_time_total / 1e3:.2f} ms x "
              f"{e.count}" for e in top) + f" | {card}", flush=True)
    return dict(wsi_device_ms=dev_ms, wsi_wall_ms=wall * 1e3,
                wsi_top=[(e.key[:70], e.self_device_time_total / 1e3,
                          e.count) for e in top])


def project_method(method: str, tree, plan, card: str):
    """One method in project mode at full width: the converted tree's
    factors as warm states, the saved bytes and peaks under ``block`` and
    ``none``, PROJ_STEPS steps under ``block`` through ``train_run`` (#7
    alone, 44 a step), a profiled step, a profiled WSI step, and the
    reduced-depth check. Returns (row, state)."""
    from repro_torch.models.lm import init_lm_states

    cfg = api.install(plan).model
    cfg_none = cfg.replace(remat="none")
    api.install(dataclasses.replace(plan, model=cfg_none))
    b, s = TINY_B, TINY_S
    tcfg = TrainConfig(optimizer="sgd", lr=TINY_LR, momentum=0.9,
                       schedule="constant", steps=PROJ_STEPS + 1,
                       checkpoint_every=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = from_reference(tree, cfg, "cuda")
    asi = (init_lm_states(cfg, b, s, dtype=_dtype(cfg.dtype), device="cuda",
                          seed=21) if cfg.wasi.compress_acts else None)
    state = make_train_state(model, cfg, tcfg, asi_states=asi)
    torch.cuda.synchronize()
    res = dict(method=method, build_s=time.perf_counter() - t0)
    gate = tree["groups"][0][0]["mlp"]["gate"]
    if cfg.remat != "block" or not torch.equal(
            state.wsi["groups/0/0/mlp/gate/w"].L, gate["L"]) or \
            {k: v.L.shape[-1] for k, v in state.wsi.items()} != {
                k: plan.spec(f"{k.split('/')[-3]}/{k.split('/')[-2]}").rank
                for k in state.wsi}:
        raise AssertionError(f"project {method}: the warm states are not "
                             "the converted checkpoint's")
    step = make_train_step(lm_loss, cfg, tcfg)
    batch_fn = uniform_batches(cfg, b, s, 2100)
    res.update(remat_memory(state, batch_fn(200), cfg, cfg_none))
    state, row = train_run("project", state, step, batch_fn, tcfg, cfg,
                           method, 0, PROJ_STEPS, b * s)
    state, prof = profile_train_step(state, step, batch_fn(300), card)
    row.update(prof)
    row.update(wsi_device_ms(state, card))
    busy = row["train_busy_share"]
    print(f"[project] {method} project block: step_ms_median="
          f"{row['step_ms_median']:.3f} tok_s={row['tok_s']:.1f} "
          f"dev_peak_mib={row['dev_peak_mib']:.1f} saved_MiB="
          f"{res['residual_bytes_block'] / 2 ** 20:.1f} (none "
          f"{res['residual_bytes_none'] / 2 ** 20:.1f}) fwd+bwd_peak_MiB="
          f"{res['grad_peak_mib_block']:.1f} (none "
          f"{res['grad_peak_mib_none']:.1f}) busy_share="
          f"{'n/a' if busy is None else f'{busy:.3f}'}; device ms of the "
          f"profiled step {row.get('train_step_device_ms', float('nan')):.3f}"
          f", of it the WSI steps' {row['wsi_device_ms']:.3f} (measured "
          f"alone), the rest "
          f"{row.get('train_step_device_ms', float('nan')) - row['wsi_device_ms']:.3f}"
          f"; losses {[round(x, 4) for x in row['losses']]} | {card}",
          flush=True)
    res["block"] = row
    res["cpu_check"] = project_vs_cpu(tree, plan, card)
    api.install(plan)
    gc.collect()
    torch.cuda.empty_cache()
    return res, state


def phase_project(card: str) -> dict:
    print("== phase 21: tinyllama-1.1b, the paper's project mode, full width"
          " and depth (22 layers, d 2048, bf16): epsilon-calibrated ranks, "
          "a converted checkpoint, wasi and wsi training, the calibrated "
          "factored checkpoint served", flush=True)
    full = configs.get("tinyllama-1.1b")
    dense_cfg = with_wasi(full, method="none")
    api.install(api.resolve(dense_cfg))
    gen = torch.Generator(device="cuda").manual_seed(21)
    dense = init_lm(dense_cfg, device="cuda", generator=gen)
    out, plans = project_ranks(dense, full, card)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree = convert.factorize(dense, plans["wasi"])
    torch.cuda.synchronize()
    out["convert_project_s"] = time.perf_counter() - t0
    del dense
    print(f"[project] convert.factorize to the project layout {{w, L, R}}: "
          f"{out['convert_project_s']:.2f} s | {card}", flush=True)
    out["rows"], out["decode_headline"] = project_rows(plans["serve"], card)
    state = None
    for method in PROJ_METHODS:
        del state
        gc.collect()
        torch.cuda.empty_cache()
        out[method], state = project_method(method, tree, plans[method], card)
    del tree
    gc.collect()
    # the trained dense W (the last method's) -> the calibrated plan in the
    # config's factored mode -> a plan-bearing checkpoint -> served
    fplan = api.install(plans["serve"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ftree = convert.factorize(state.params, fplan)
    torch.cuda.synchronize()
    out["convert_factored_s"] = time.perf_counter() - t0
    del state
    shutil.rmtree(PROJ_CKPT, ignore_errors=True)
    t0 = time.perf_counter()
    save_checkpoint(PROJ_CKPT, PROJ_STEPS, ftree, plan=fplan, label="params")
    out["save_s"] = time.perf_counter() - t0
    del ftree
    gc.collect()
    torch.cuda.empty_cache()
    if not load_manifest(PROJ_CKPT, PROJ_STEPS)["plan"]["calibrated"]:
        raise AssertionError("project: the manifest's plan is not "
                             "calibrated")
    t0 = time.perf_counter()
    api.uninstall(full)
    eng = ServeEngine.from_checkpoint(PROJ_CKPT, max_slots=4, max_cache=512,
                                      device="cuda")
    out["load_s"] = time.perf_counter() - t0
    if not eng.plan.calibrated or eng.plan.specs != fplan.specs:
        raise AssertionError("project: the served plan is not the "
                             "calibrated one")
    print(f"[project] factorize the trained W to the factored layout "
          f"{out['convert_factored_s']:.2f} s, save "
          f"{out['save_s']:.2f} s, ServeEngine.from_checkpoint "
          f"{out['load_s']:.2f} s (manifest: calibrated) | {card}",
          flush=True)
    routes = {}
    layer = eng.params.layer_views()[0][0][0]
    for sp in fplan.specs:
        p = layer[sp.name.split("/")[0]][sp.name.split("/")[1]]
        x = torch.empty(1024, sp.in_dim, dtype=torch.bfloat16, device="cuda")
        routes[sp.name] = {m: klowrank.forward_route(
            m, sp.in_dim, sp.rank, sp.out_dim, torch.bfloat16,
            (x[:m], p["R"], p["L"])) for m in (4, 1024)}
    print(f"[project] #1's routes at K = "
          f"{sorted({sp.rank for sp in fplan.specs})} (decode M=4 / prefill"
          f" M=1024): " + ", ".join(f"{k} {v[4]}/{v[1024]}"
                                    for k, v in routes.items())
          + f"; the decode route's dynamic shared memory at K=1152 "
          f"{klowrank.decode_smem_bytes(1, 1152)} B of "
          f"{klowrank.SMEM_LIMIT} | {card}", flush=True)
    if any(v[4] != "decode" or v[1024] != "tensor_core"
           for v in routes.values()):
        raise AssertionError(f"project: #1's routes {routes}")
    out["routes"] = routes
    out["serve"] = serve_dense("project", fplan.model, eng.params, fplan,
                               card, engine=eng)
    if out["serve"]["launches_per_forward"] != 154:
        raise AssertionError("project: 154 launches of #1 per forward")
    out["serve"]["cpu_logits"] = logits_vs_cpu("project", fplan.model,
                                               eng.params, card)
    del eng
    shutil.rmtree(PROJ_CKPT, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the Mamba family: #8's gradient, zamba2-7b trained, falcon-mamba-7b served
# ---------------------------------------------------------------------------

# phase 22: #8's gradient at zamba2-7b's scan heads (H 112, dh 64, N 64,
# chunk 256), two rows of a batch, over one, two and a ragged three chunks;
# and the forward and backward device time at the training shape (a layer
# of phase 23's batch 4 x 512)
SSD_GRAD_BZ, SSD_GRAD_S = 2, (256, 512, 700)
SSD_GRAD_HEADS = (112, 64, 64, 256)          # H, dh, N, chunk
SSD_TRAIN_SHAPE = (4, 512)


def ssd_grad_tol(name: str, g: torch.Tensor, bz: int, s: int) -> float:
    """The card's gradient (the plain chunked backward, f32, TF32 off)
    against the CPU's plain autograd on the same values differ only by
    the order of f32 sums: each entry of a gradient sums on average r =
    Bz S min(Q, S) H dh N / numel(g) products (the chunk's (Q, Q, H)
    decay block against dh, each entry of C B^T a sum over N: u's entries
    sum Q N); dt and A enter through the chunk's cumulative sum of dt A,
    whose gradient is a reverse cumulative sum over the chunk, so theirs
    sum min(Q, S) times more. A sum of r
    rounded terms of both signs strays about eps sqrt(r) of its scale:
    held to 8 eps sqrt(r) of the gradient's largest entry. A gradient
    that comes back in bf16 (u's, B's and C's in a bf16 model, summed in
    f32 and rounded once) adds one rounding, at most half an ulp, 2^-8 of
    the value and so of the scale."""
    h, dh, n, chunk = SSD_GRAD_HEADS
    q = min(chunk, s)
    r = bz * s * q * h * dh * n / g.numel()
    if name in ("dt", "A"):
        r *= q
    return 8 * EPS32 * math.sqrt(r) + (2.0 ** -8 if g.dtype ==
                                       torch.bfloat16 else 0.0)


def ssd_grad_row(s: int, dtype, gen, card: str) -> dict:
    """One phase 22 row: ``ops.ssd_scan`` with grad on the card (the
    kernel's forward, ``_SSDScan``'s plain backward) against autograd of
    the plain version on the CPU in f32 on the same values; two runs
    bit-equal; exactly one #8 launch a forward and none in the backward."""
    bz = SSD_GRAD_BZ
    h, dh, n, chunk = SSD_GRAD_HEADS
    (args,) = ssd_inputs(bz, s, h, dh, n, gen, dtype=dtype)
    d = torch.randn(h, device="cuda", generator=gen)
    w = torch.randn(bz, s, h, dh, device="cuda", generator=gen)
    leaves = [t.detach().requires_grad_() for t in (*args, d)]
    ops.reset_launches()
    runs = []
    for _ in range(2):
        y = ops.ssd_scan(*leaves, chunk)
        runs.append(torch.autograd.grad((y * w).sum(), leaves))
    torch.cuda.synchronize()
    launches = ops.launch_counts()["ssd_scan"]
    if launches != 2:
        raise AssertionError(f"ssd_scan grad S={s}: {launches} launches, "
                             "want 2 (one a forward, none a backward)")
    bits = all(torch.equal(a, b) for a, b in zip(*runs))
    if not bits:
        raise AssertionError(f"ssd_scan grad S={s}: two runs differ")
    cpu = [t.detach().float().cpu().requires_grad_() for t in leaves]
    y_c = ref.ssd_scan_ref(*cpu[:5], chunk)[0] \
        + cpu[5][None, None, :, None] * cpu[0]
    want = torch.autograd.grad((y_c * w.cpu()).sum(), cpu)
    errs = {}
    for name, g, wg, t in zip(("u", "dt", "A", "B", "C", "D"), runs[0],
                              want, leaves):
        if g.dtype != t.dtype:
            raise AssertionError(f"d{name} is {g.dtype}, not {t.dtype}")
        scale = wg.abs().max().item()
        err = (g.float().cpu() - wg).abs().max().item()
        tol = ssd_grad_tol(name, g, bz, s)
        errs[name] = dict(err=err / scale, tol=tol)
        if not err <= tol * scale:
            raise AssertionError(f"ssd_scan grad S={s} {dtype}: d{name} err "
                                 f"{err:.3e} of scale {scale:.3e} (tol "
                                 f"{tol:.2e} of it)")
    dname = "bf16" if dtype == torch.bfloat16 else "f32"
    route = kssd.ssd_route(args[0], args[3], args[4])
    print(f"[ssd_grad] S={s} {dname} ({route}) Bz={bz} H={h} dh={dh} N={n} "
          f"chunk={chunk}: gradients card vs CPU, error / tolerance (of "
          f"each one's scale) " + ", ".join(
              f"d{k} {v['err']:.2e}/{v['tol']:.2e}" for k, v in errs.items())
          + f"; two runs bit-equal; ssd_scan launches 2 (2 forwards, 0 in "
          f"the backwards) | {card}", flush=True)
    return dict(S=s, dtype=dname, route=route, errors=errs, bit_equal=bits,
                launches=launches)


def ssd_train_times(card: str) -> dict:
    """At one zamba2-7b layer of phase 23's batch, bf16 u, B and C: #8's
    forward (``time_ms``, as phase 16 times it) and ``_SSDScan``'s plain
    backward (one call alone under the profiler, its kernels' device time
    summed), and the backward's peak memory above its inputs."""
    bz, s = SSD_TRAIN_SHAPE
    h, dh, n, chunk = SSD_GRAD_HEADS
    gen = torch.Generator(device="cuda").manual_seed(2222)
    (args,) = ssd_inputs(bz, s, h, dh, n, gen, dtype=torch.bfloat16)
    fwd_ms = time_ms(lambda *a: kssd.ssd_scan_cuda(*a, chunk), [args])
    d = torch.randn(h, device="cuda", generator=gen)
    leaves = [t.detach().requires_grad_() for t in (*args, d)]
    w = torch.randn(bz, s, h, dh, device="cuda", generator=gen)
    for _ in range(2):                            # the second is timed
        loss = (ops.ssd_scan(*leaves, chunk) * w).sum()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        (_, _, _, bwd) = profiled(lambda: torch.autograd.grad(loss, leaves))
        peak = torch.cuda.max_memory_allocated() - base
    out = dict(fwd_device_ms=fwd_ms,
               bwd_device_ms=sum(e.self_device_time_total for e in bwd)
               / 1e3, bwd_peak_mib=peak / 2 ** 20, Bz=bz, S=s)
    print(f"[ssd_grad] one zamba2-7b layer's scan at Bz={bz} S={s} (bf16): "
          f"#8 forward {out['fwd_device_ms']:.3f} ms, plain backward "
          f"{out['bwd_device_ms']:.3f} ms device time, backward peak "
          f"{out['bwd_peak_mib']:.1f} MiB above its inputs | {card}",
          flush=True)
    return out


def phase_ssd_grad(card: str) -> dict:
    print("== phase 22: #8's gradient (kernel forward, plain chunked "
          "backward) at zamba2-7b's heads against the CPU", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(22)
    rows = [ssd_grad_row(s, dt, gen, card)
            for dt in (torch.bfloat16, torch.float32) for s in SSD_GRAD_S]
    out = dict(rows=rows, train_shape=ssd_train_times(card))
    gc.collect()
    torch.cuda.empty_cache()
    return out


# phase 23: zamba2-7b trained at full width and depth, phase 19's optimizer
# (SGD+momentum 0.9 at a constant 0.05), refresh every 8: 8 steps (the
# refresh at the 8th) and a profiled step per method, batch 4 x 512
Z_TRAIN_B, Z_TRAIN_S, Z_TRAIN_STEPS, Z_REFRESH = 4, 512, 8, 8
Z_METHODS = ("wasi", "wsi")
# the reduced-depth check: one repeat of the pattern and the tail (9
# layers) at full width, batch 1 x 320 (two chunks of #8, the second
# ragged), limits per square root of the depth as ``logits_vs_cpu``'s.
# f32 on the card (#8's fma route, the f32 routes of #2, #3, #7) against
# f32 on the CPU: the loss's relative error and each gradient's RMS error
# over its RMS (``MAMBA_F32_*``; on an H100 8.8e-8 and 9.9e-5 at 9
# layers, limits set before the reading). bf16 on the card against f32 on
# the CPU: the loss (``Z_LOSS_TOL``) and each gradient's cosine with the
# CPU's (at least ``MAMBA_BF16_COS``). An RMS limit cannot hold bf16
# there: the scan's gradient in dt cancels (card and CPU in f32 already
# differ by 1.2e-4 of its scale at one layer, phase 22), so bf16's
# rounding of every activation moves the gradients by 15-16% of their RMS
# (median) at 9 layers on an H100, cosines 0.968-0.975; a wrong gradient
# reads a cosine near 0. The bf16 loss reads 9.5e-5 (``wasi``) and
# 2.15e-4 (``wsi``: #2's pieced sketch rounds otherwise than ``wasi``'s
# plain products) per square root of the depth; the limit is 1.5x the
# larger, as phase 21's are 1.5x its readings.
Z_CHECK_B, Z_CHECK_S = 1, 320
Z_LOSS_TOL = 3.3e-4
MAMBA_F32_LOSS_TOL, MAMBA_F32_GRAD_TOL, MAMBA_BF16_COS = 1e-5, 0.01, 0.9
Z_INT8_DIR = os.path.join(ROOT, "build", "chip_smoke_zamba2_int8")


def zamba2_reduced(cfg):
    """zamba2 at full width, its pattern once and the tail (9 layers)."""
    from repro_torch.config import LayerGroup

    return reduced(cfg, (LayerGroup(pattern=cfg.groups[0].pattern,
                                    repeat=1),) + cfg.groups[1:])


def with_method(cfg, method: str, refresh: int):
    return cfg.replace(wasi=dataclasses.replace(
        cfg.wasi, method=method, refresh_every=refresh))


def mamba_vs_cpu(tag: str, cfg, method: str, card: str, b: int, s: int,
                 loss_tol: float) -> dict:
    """One step's loss and gradients at reduced depth (``cfg``), weights
    drawn on the card in bf16: under ``block`` and ``none`` on the card in
    bf16 (exact launches; the same bits expected, held to 2^-8 as phase
    19's), under ``none`` on the card in f32 and on the CPU in f32, from
    the same values (ASI states alike). f32 card against f32 CPU:
    ``MAMBA_F32_LOSS_TOL`` and ``MAMBA_F32_GRAD_TOL`` per square root of
    the depth; bf16 card against f32 CPU: ``loss_tol`` per square root of
    the depth and every gradient's cosine with the CPU's at least
    ``MAMBA_BF16_COS``."""
    from repro_torch.models.lm import init_lm_states, map_states

    plan = api.install(api.resolve(cfg, batch=b, seq=s))
    gen = torch.Generator(device="cuda").manual_seed(2323)
    model = init_lm(cfg, device="cuda", generator=gen)
    model.requires_grad_(True)
    tree = to_reference(model)
    g = torch.Generator().manual_seed(2324)
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=g)
    asi = (map_states(lambda t: t.to(torch.bfloat16).float(), init_lm_states(
        cfg, b, s, dtype=torch.float32, device="cpu", seed=2325))
        if cfg.wasi.compress_acts else None)
    cfg32 = cfg.replace(dtype="float32", remat="none")
    out = {}
    for key, dev, c in (("bf16_block", "cuda", cfg),
                        ("bf16_none", "cuda", cfg.replace(remat="none")),
                        ("f32_card", "cuda", cfg32),
                        ("f32_cpu", "cpu", cfg32)):
        api.install(dataclasses.replace(plan, model=c))
        m = model if c.dtype == "bfloat16" else from_reference(
            tree, c, dev, trainable=True)
        st = None if asi is None else map_states(
            lambda t: t.to(dev, _dtype(c.dtype)), asi)
        batch = {"tokens": toks[:, :-1].to(dev),
                 "labels": toks[:, 1:].to(dev)}
        ops.reset_launches()
        loss, _, grads, _ = value_and_grad(lm_loss, m, batch, c, st)
        if dev == "cuda":
            torch.cuda.synchronize()
            want = train_want(c, method, 1, 0)
            if ops.launch_counts() != want:
                raise AssertionError(f"{tag} {method} {key} one step "
                                     f"launches {ops.launch_counts()} != "
                                     f"{want}")
        out[key] = (float(loss), {k: v.float().cpu()
                                  for k, v in grads.items()})
        del grads, m
    api.install(plan)
    (lb, gb), (ln, gn) = out["bf16_block"], out["bf16_none"]
    (l1, g1), (l0, g0) = out["f32_card"], out["f32_cpu"]
    bits = lb == ln and all(torch.equal(gb[k], gn[k]) for k in gn)
    remat_worst = max((gb[k] - gn[k]).abs().max().item()
                      / max(gn[k].abs().max().item(), 1e-30) for k in gn)
    if remat_worst > 2.0 ** -8:
        raise AssertionError(f"{tag} {method}: block and none gradients "
                             f"differ by {remat_worst:.3e} of a leaf's scale")

    def rms_rel(a, b_):
        return float((a - b_).square().mean().sqrt()
                     / b_.square().mean().sqrt().clamp(min=1e-30))

    def cos(a, b_):
        return float(torch.nn.functional.cosine_similarity(
            a.flatten().double(), b_.flatten().double(), dim=0))

    root = math.sqrt(cfg.n_layers)
    f32_loss = abs(l1 / l0 - 1)
    f32_rel = {k: rms_rel(g1[k], g0[k]) for k in g0}
    bf16_loss = abs(lb / l0 - 1)
    bf16_rel = {k: rms_rel(gb[k], g0[k]) for k in g0}
    bf16_cos = {k: cos(gb[k], g0[k]) for k in g0}
    w32 = max(f32_rel, key=f32_rel.get)
    wbf = min(bf16_cos, key=bf16_cos.get)
    print(f"[{tag}] {method} one step at {cfg.n_layers} layers, batch {b} x "
          f"{s}: bf16 block against none on the card: gradients "
          f"{'bit-equal' if bits else 'NOT bit-equal'} (largest difference "
          f"{remat_worst:.3e} of a leaf's scale, tol 2^-8); f32 card vs f32 "
          f"CPU: loss {l1:.6f} / {l0:.6f} (relative error {f32_loss:.2e}, "
          f"limit {MAMBA_F32_LOSS_TOL * root:.2e}), gradients' RMS error "
          f"over their RMS largest {f32_rel[w32]:.3e} ({w32}, limit "
          f"{MAMBA_F32_GRAD_TOL * root:.4f}), median "
          f"{statistics.median(f32_rel.values()):.3e}; bf16 card vs f32 CPU:"
          f" loss {lb:.5f} (relative error {bf16_loss:.2e}, limit "
          f"{loss_tol * root:.4f}), gradients' cosine smallest "
          f"{bf16_cos[wbf]:.4f} ({wbf}, limit {MAMBA_BF16_COS}), RMS error "
          f"median {statistics.median(bf16_rel.values()):.3e}, largest "
          f"{max(bf16_rel.values()):.3e} | {card}", flush=True)
    if not (f32_loss <= MAMBA_F32_LOSS_TOL * root
            and f32_rel[w32] <= MAMBA_F32_GRAD_TOL * root
            and bf16_loss <= loss_tol * root
            and bf16_cos[wbf] >= MAMBA_BF16_COS):
        raise AssertionError(f"{tag} {method}: card vs CPU at reduced depth")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(f32_loss_rel=f32_loss, f32_grad_rms_rel=f32_rel,
                bf16_loss_rel=bf16_loss, bf16_grad_rms_rel=bf16_rel,
                bf16_grad_cos=bf16_cos, grad_bit_equal_block_none=bits,
                grad_max_rel_diff_block_none=remat_worst,
                n_layers=cfg.n_layers)


def zamba2_train_method(method: str, card: str) -> dict:
    """One method at full width and depth under the config's ``block``:
    the saved-for-backward bytes and the allocator's peak of one loss,
    ``Z_TRAIN_STEPS`` steps through ``train_loop`` with exact launches, a
    profiled step."""
    from repro_torch.models.lm import init_lm_states
    from repro_torch.utils.memprof import measured_residual_bytes

    b, s = Z_TRAIN_B, Z_TRAIN_S
    cfg = with_method(configs.get("zamba2-7b"), method, Z_REFRESH)
    tcfg = TrainConfig(optimizer="sgd", lr=TINY_LR, momentum=0.9,
                       schedule="constant", steps=Z_TRAIN_STEPS + 1,
                       checkpoint_every=0)
    t0 = time.perf_counter()
    api.install(api.resolve(cfg, batch=b, seq=s))
    # weights and ASI states drawn on the card from a seeded generator
    gen = torch.Generator(device="cuda").manual_seed(2300)
    model = init_lm(cfg, device="cuda", generator=gen)
    asi = (init_lm_states(cfg, b, s, dtype=torch.bfloat16, device="cuda",
                          generator=gen) if cfg.wasi.compress_acts else None)
    state = make_train_state(model, cfg, tcfg, asi_states=asi)
    step = make_train_step(lm_loss, cfg, tcfg)
    torch.cuda.synchronize()
    res = dict(method=method, build_s=time.perf_counter() - t0,
               params=sum(p.numel() for p in model.parameters()))
    batch_fn = uniform_batches(cfg, b, s, 2300)
    rep = measured_residual_bytes(
        lambda: lm_loss(state.params, batch_fn(200), cfg, states=state.asi))
    res.update(residual_bytes_block=rep.total_bytes,
               residual_arrays_block=rep.n_arrays)
    del rep
    torch.cuda.empty_cache()
    res["grad_peak_mib_block"] = grad_peak(state.params, batch_fn(200), cfg,
                                           state.asi)
    state, row = train_run("zamba2", state, step, batch_fn, tcfg, cfg,
                           method, 0, Z_TRAIN_STEPS, b * s)
    state, prof = profile_train_step(state, step, batch_fn(300), card)
    row.update(prof)
    res.update(row)
    print(f"[zamba2] {method} remat=block at {cfg.n_layers} layers, batch "
          f"{b} x {s}: "
          f"step_ms_median={row['step_ms_median']:.3f} tok_s="
          f"{row['tok_s']:.1f} dev_peak_mib={row['dev_peak_mib']:.1f} "
          f"saved_for_backward_mib={res['residual_bytes_block'] / 2**20:.1f}"
          f" fwd+bwd_peak_mib={res['grad_peak_mib_block']:.1f} busy_share="
          f"{row['train_busy_share']} losses "
          f"{[round(x, 4) for x in row['losses']]} | {card}", flush=True)
    del state, step, model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def zamba2_int8(card: str) -> dict:
    """zamba2 at full width and reduced depth (``zamba2_reduced``): the
    bf16 weights through ``plan.quantized("int8")`` -> ``convert.quantize``
    -> a plan-bearing checkpoint -> ``ServeEngine.from_checkpoint``, which
    serves phase 5's requests through #6 (exact launches)."""
    cfg = zamba2_reduced(configs.get("zamba2-7b"))
    plan = api.install(api.resolve(cfg))
    gen = torch.Generator(device="cuda").manual_seed(2400)
    model = init_lm(cfg, device="cuda", generator=gen)
    qplan = plan.quantized("int8")
    shutil.rmtree(Z_INT8_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    save_checkpoint(Z_INT8_DIR, 0, convert.quantize(model, qplan),
                    plan=qplan, label="params")
    del model
    api.uninstall(cfg)
    eng = ServeEngine.from_checkpoint(Z_INT8_DIR, device="cuda", max_slots=4,
                                      max_cache=512)
    load_s = time.perf_counter() - t0
    if eng.plan.to_json() != qplan.to_json() or \
            not eng.summary()["quantized"]:
        raise AssertionError("zamba2 int8: the checkpoint's plan")
    print(f"[zamba2_int8] {cfg.n_layers} layers: quantize, save and "
          f"from_checkpoint {load_s:.1f}s", flush=True)
    res = serve_dense("zamba2_int8", cfg, None, qplan, card, engine=eng,
                      kernel="lowrank_q8")
    del eng
    shutil.rmtree(Z_INT8_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_zamba2_train(card: str) -> dict:
    print("== phase 23: zamba2-7b trained at full width and depth (81 "
          "layers, d 3584, bf16, remat block) under wasi and wsi; card vs "
          "CPU at 9 layers; int8 from a plan-bearing checkpoint", flush=True)
    out = {}
    for method in Z_METHODS:
        out[method] = zamba2_train_method(method, card)
        out[method]["cpu_check"] = mamba_vs_cpu(
            "zamba2", with_method(zamba2_reduced(configs.get("zamba2-7b")),
                                  method, Z_REFRESH),
            method, card, Z_CHECK_B, Z_CHECK_S, Z_LOSS_TOL)
    out["int8"] = zamba2_int8(card)
    return out


# phase 24: falcon-mamba-7b (64 Mamba-1 layers, d 4096)
F_SITES = {"ssm/in_proj": (4096, 16384, 1024), "ssm/x_proj": (8192, 288, 128),
           "ssm/dt_proj": (256, 8192, 128), "ssm/out_proj": (8192, 4096, 1024)}
F_LOGIT_LAYERS, F_TRAIN_LAYERS = 4, 4
# ``logits_vs_cpu``'s limits for falcon-mamba, per sqrt(L): 2x the
# attention models'. Mamba-1 takes dt, rounded to bf16, into exp(dt A)
# with |A| up to 16 and sums the state over the whole prompt, so its bf16
# logits stray further: the prefill read 0.0171 and 0.073 sqrt(L) of the
# RMS logit at 4 layers on an H100. In f32 on the card the same check
# holds 1e-4 and 5e-4 sqrt(L): a wrong kernel or layout reads near 1.
F_LOGIT_TOLS = (2 * LOGIT_RMS_TOL, 2 * LOGIT_MAX_TOL)
F32_LOGIT_TOLS = (1e-4, 5e-4)
F_TRAIN_B, F_TRAIN_S, F_TRAIN_STEPS = 4, 512, 2


class scan_ranges:
    """Within it, every Mamba-1 selective scan runs inside a profiler
    range named ``SCAN_RANGE`` (``profile_prefill`` reads its device
    time); the module's function is restored on exit."""

    def __enter__(self):
        import repro_torch.nn.mamba as mamba

        self.mod, self.fn = mamba, mamba._selective_scan

        def traced(*a, _fn=self.fn, **kw):
            with torch.profiler.record_function(SCAN_RANGE):
                return _fn(*a, **kw)

        mamba._selective_scan = traced
        return self

    def __exit__(self, *exc):
        self.mod._selective_scan = self.fn


def scan_device_ms(bz: int, s: int, card: str) -> dict:
    """Device time of one plain selective scan at falcon-mamba-7b's widths
    (d_inner 8192, N 16, f32 as the mixer hands it over), the call alone
    under the profiler, and its peak memory above its inputs."""
    from repro_torch.nn.mamba import _selective_scan

    di, n = 8192, 16
    g = torch.Generator(device="cuda").manual_seed(2424)
    u = torch.randn(bz, s, di, device="cuda", generator=g)
    dt = torch.nn.functional.softplus(
        torch.randn(bz, s, di, device="cuda", generator=g) - 4)
    a = -torch.arange(1, n + 1, device="cuda", dtype=torch.float32).expand(
        di, n).contiguous()
    b = torch.randn(bz, s, n, device="cuda", generator=g)
    c = torch.randn(bz, s, n, device="cuda", generator=g)
    d = torch.ones(di, device="cuda")
    with torch.inference_mode():
        _selective_scan(u, dt, a, b, c, d)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _, wall_us, _, ev = profiled(
            lambda: _selective_scan(u, dt, a, b, c, d, return_final=True))
        peak = torch.cuda.max_memory_allocated() - base
    ms = sum(e.self_device_time_total for e in ev) / 1e3
    q = 128 if s % 128 == 0 else s
    print(f"[falcon] plain selective scan Bz={bz} S={s} d_inner={di} N={n} "
          f"(chunks of {q}): {ms:.3f} ms device time, wall {wall_us / 1e3:.3f}"
          f" ms, peak {peak / 2**20:.1f} MiB above its inputs | {card}",
          flush=True)
    return dict(Bz=bz, S=s, chunk=q, device_ms=ms, wall_ms=wall_us / 1e3,
                peak_mib=peak / 2 ** 20)


def falcon_train(method: str, card: str) -> dict:
    """``F_TRAIN_STEPS`` steps at full width and ``F_TRAIN_LAYERS`` layers
    under ``block``, batch 4 x 512 (four chunks of the scan): exact
    launches (#2 and #3: every site under ``wsi``, ``dt_proj`` alone under
    ``wasi``), step time of the second step, peak memory."""
    from repro_torch.config import LayerGroup
    from repro_torch.models.lm import init_lm_states

    b, s = F_TRAIN_B, F_TRAIN_S
    cfg = with_method(reduced(configs.get("falcon-mamba-7b"), (LayerGroup(
        pattern=("mamba1",), repeat=F_TRAIN_LAYERS),)), method, 8)
    tcfg = TrainConfig(optimizer="sgd", lr=TINY_LR, momentum=0.9,
                       schedule="constant", steps=F_TRAIN_STEPS,
                       checkpoint_every=0)
    api.install(api.resolve(cfg, batch=b, seq=s))
    gen = torch.Generator(device="cuda").manual_seed(2424)
    model = init_lm(cfg, device="cuda", generator=gen)
    asi = (init_lm_states(cfg, b, s, dtype=torch.bfloat16, device="cuda",
                          generator=gen) if cfg.wasi.compress_acts else None)
    state = make_train_state(model, cfg, tcfg, asi_states=asi)
    step = make_train_step(lm_loss, cfg, tcfg)
    state, row = train_run("falcon", state, step,
                           uniform_batches(cfg, b, s, 2400), tcfg, cfg,
                           method, 0, F_TRAIN_STEPS, b * s)
    print(f"[falcon] {method} remat=block at {cfg.n_layers} layers, batch "
          f"{b} x {s}: step_ms (2nd) {row['step_ms_median']:.3f} tok_s="
          f"{row['tok_s']:.1f} dev_peak_mib={row['dev_peak_mib']:.1f} losses"
          f" {[round(x, 4) for x in row['losses']]} | {card}", flush=True)
    del state, step, model
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_falcon_mamba(card: str) -> dict:
    from repro_torch.config import LayerGroup

    print("== phase 24: falcon-mamba-7b full width and depth (64 Mamba-1 "
          "layers, d 4096, bf16): served bf16 and int8, logits vs CPU at 4 "
          "layers, a wasi and a wsi step at 4 layers", flush=True)
    cfg = configs.get("falcon-mamba-7b")
    plan = api.install(api.resolve(cfg))
    fc = forward_counts(cfg)
    if (fc["sites"], fc["flash"], fc["ssd"]) != (4 * cfg.n_layers, 0, 0) or {
            sp.name: (sp.in_dim, sp.out_dim, sp.rank) for sp in plan.specs
            if sp.mode == "factored"} != F_SITES:
        raise AssertionError(f"falcon-mamba plan {plan.specs}")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(24)
    model = init_lm(cfg, device="cuda", generator=gen)
    torch.cuda.synchronize()
    param_mib = sum(p.numel() * p.element_size()
                    for p in model.parameters()) / 2**20
    print(f"[falcon] init {time.perf_counter() - t0:.1f}s, parameters "
          f"{param_mib:.1f} MiB", flush=True)
    gen_r = torch.Generator(device="cuda").manual_seed(1)
    for name, (i, o, k) in F_SITES.items():
        for m in (4, 1024):
            # kernel #1's route and error at the narrow sites' shapes
            lowrank_row("[falcon]", name, m, i, k, o, torch.bfloat16, gen_r,
                        card)
    with scan_ranges():
        out = {"serve": serve_dense("falcon", cfg, model, plan, card,
                                    extra=(700,), max_cache=1024,
                                    prefill_profile=True)}
    out["serve"]["param_mib"] = param_mib
    out["scan"] = [scan_device_ms(4, 256, card), scan_device_ms(1, 768, card),
                   scan_device_ms(1, 700, card)]
    qplan = api.install(plan.quantized("int8"))
    qmodel = from_reference(convert.quantize(model, qplan), cfg, "cuda")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    out["int8"] = serve_dense("falcon_int8", cfg, qmodel, qplan, card,
                              extra=(700,), max_cache=1024,
                              kernel="lowrank_q8")
    del qmodel
    gc.collect()
    torch.cuda.empty_cache()
    red = reduced(cfg, (LayerGroup(pattern=("mamba1",),
                                   repeat=F_LOGIT_LAYERS),))
    api.install(api.resolve(red))
    model = init_lm(red, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(25))
    out["cpu_logits"] = logits_vs_cpu("falcon", red, model, card,
                                      limits=F_LOGIT_TOLS)
    red32 = red.replace(dtype="float32")
    api.install(dataclasses.replace(api.plan_of(red), model=red32))
    model = from_reference(to_reference(model), red32, "cuda")
    out["cpu_logits_f32"] = logits_vs_cpu("falcon_f32", red32, model, card,
                                          limits=F32_LOGIT_TOLS)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    for method in ("wasi", "wsi"):
        out[f"train_{method}"] = falcon_train(method, card)
    return out


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

    seconds = {}

    def run(n: int, fn, *a):
        """Phase ``n`` with its wall seconds printed and kept."""
        t = time.perf_counter()
        out = fn(*a)
        seconds[n] = time.perf_counter() - t
        print(f"[time] phase {n}: {seconds[n]:.1f}s", flush=True)
        return out

    k = run(3, phase_kernels, card)
    run(4, phase_smoke_parity, card)
    full = run(5, phase_full_width, card)
    tk = run(6, phase_train_kernels, card)
    smoke_train = run(7, phase_smoke_training, card)
    train = run(8, phase_full_training, card)
    q8 = run(9, phase_q8_kernels, card)
    deploy = run(10, phase_int8_deploy, card, full)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    mm = run(11, phase_matmul_kernels, card)
    table2 = run(12, phase_table2, card)
    fk = run(13, phase_flash_kernel, card)
    vit_smoke = run(14, phase_vit_smoke, card)
    vit = run(15, phase_vit_fig5, card)
    ssd = run(16, phase_ssd_kernel, card)
    z_smoke = run(17, phase_zamba2_smoke, card)
    zamba = run(18, phase_zamba2_full, card)
    tiny = run(19, phase_tinyllama, card)
    dense = run(20, phase_dense_configs, card)
    project = run(21, phase_project, card)
    ssd_grad = run(22, phase_ssd_grad, card)
    z_train = run(23, phase_zamba2_train, card)
    falcon = run(24, phase_falcon_mamba, card)

    head = k["headline"]
    kernels = [{
        "name": "lowrank_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lowrank_decode.cu",
        "replaces": "src/repro/kernels/lowrank.py:58",
        "launches": full["launches"]["lowrank_fwd"],
        "max_abs_err": k["worst"],
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"]}]
    sources = {"lowrank_fwd_sketch": ("lowrank_sketch.cu", "lowrank.py:70"),
               "lowrank_bwd": ("lowrank_bwd.cu", "lowrank.py:144"),
               "gram": ("gram.cu", "gram.py:18"),
               "choleskyqr": ("choleskyqr_blocked.cu", "qr.py:87")}
    for name, (src, tpu) in sources.items():
        h = tk["headline"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{tpu}",
            "launches": train["launches"][name],
            "max_abs_err": tk["worst"][name], "ms": h["ms"],
            "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
            "bound_by": h["bound_by"], "library_ms": h["library_ms"]})
    h = q8["headline"]
    kernels.append({
        "name": "lowrank_q8", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lowrank_q8_routes.cu",
        "replaces": "src/repro/kernels/quant.py:38",
        "launches": deploy["launches"], "max_abs_err": q8["worst"],
        "ms": h["ms"], "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
        "bound_by": h["bound_by"], "library_ms": h["library_ms"]})
    h = mm["headline"]
    kernels.append({
        "name": "matmul_tiled", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/matmul_tiled.cu",
        "replaces": "src/repro/kernels/matmul_tiled.py:24",
        "launches": table2["wasi"]["two_launch"]["launches"],
        "max_abs_err": mm["worst"], "ms": h["ms"], "plain_ms": h["plain_ms"],
        "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
        "library_ms": h["library_ms"]})
    h = fk["headline"]
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attn.cu",
        "replaces": "src/repro/kernels/flash_attention.py:26",
        "launches": vit["wasi"]["train_launches"]["flash_attention"],
        "max_abs_err": fk["worst"], "ms": h["ms"], "plain_ms": h["plain_ms"],
        "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
        "library_ms": h["library_ms"]})
    h = ssd["headline"]
    kernels.append({
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan_tc.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:27",
        "launches": zamba["launches"]["ssd_scan"],
        "max_abs_err": ssd["worst"], "ms": h["ms"], "plain_ms": h["plain_ms"],
        "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
        "library_ms": None})
    line = {"kernels": kernels}
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": card, "kernel_rows": k["rows"],
                       "zamba2_kernel_rows": k["zamba2_rows"],
                       "zamba2_headline": k["zamba2_headline"],
                       "dense_kernel_rows": k["dense_rows"],
                       "tinyllama_decode_headline":
                           k["tinyllama_decode_headline"],
                       "kernel_headline": k["headline"],
                       "route_sweep": k["sweep"], "full": full,
                       "train_kernel_rows": tk["rows"],
                       "train_kernel_headline": tk["headline"],
                       "tinyllama_refresh": tk["tinyllama_refresh"],
                       "smoke_training": smoke_train, "full_training": train,
                       "q8_kernel_rows": q8["rows"],
                       "q8_headline": q8["headline"],
                       "q8_prefill_headline": q8["prefill_headline"],
                       "q8_route_sweep": q8["sweep"], "int8_deploy": deploy,
                       "matmul_rows": mm["rows"], "unfused_rows": mm["pairs"],
                       "matmul_headline": mm["headline"], "table2": table2,
                       "flash_rows": fk["rows"],
                       "flash_headline": fk["headline"],
                       "flash_path_headlines": fk["path_headlines"],
                       "flash_sweep": fk["sweep"],
                       "flash_backward_rel_err": fk["backward_rel_err"],
                       "flash_tiled_backward": fk["tiled_backward"],
                       "vit_smoke": vit_smoke, "vit_fig5": vit,
                       "ssd_rows": ssd["rows"],
                       "ssd_headline": ssd["headline"],
                       "zamba2_smoke": z_smoke, "zamba2_full": zamba,
                       "tinyllama": tiny, "dense_configs": dense,
                       "project": project, "ssd_grad": ssd_grad,
                       "zamba2_train": z_train, "falcon_mamba": falcon,
                       "kernels": line["kernels"],
                       "phase_seconds": seconds,
                       "seconds": time.perf_counter() - t_start}, f,
                      indent=1)
    print(f"[done] {time.perf_counter() - t_start:.1f}s | {card}")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
