"""Training loop over a ``batch_fn(step) -> batch`` (the reference's first
data contract, ``repro.train.loop``): step timing, logging, the metrics
history and checkpoints. The batch must already be on the model's device.

With ``ckpt`` (a ``checkpoint.CheckpointManager``) the loop restores the
latest published state on start, saves asynchronously every
``tcfg.checkpoint_every`` steps and synchronously at the end, as the
reference's loop does; a ``batch_fn`` carries no reader state.

``memprof`` adds the reference's measured memory columns to every logged
step (``utils.memprof``): ``mem_live_mib`` and ``mem_live_peak_mib``, the
live tensor bytes at the step boundary and their watermark, and on the
card ``mem_dev_peak_mib``, the allocator's peak since the loop started
(the CPU has no such counter, so the column is absent there).

Not ported yet, and refused with ``NotImplementedError``: the streaming
``DataIterator`` contract (and with it the reader-state extra) and DP
batch placement (``batch_sharding``); see ROADMAP.md queue 1.
"""
from __future__ import annotations

import time

import torch

from repro_torch.config import TrainConfig
from repro_torch.train.step import TrainState
from repro_torch.utils.memprof import LiveWatermark


def _is_iterator(data) -> bool:
    return hasattr(data, "next_batch") and hasattr(data, "state")


def train_loop(state: TrainState, step_fn, data, tcfg: TrainConfig, *,
               log_every: int = 10, ckpt=None, max_steps: int | None = None,
               memprof: bool = False, batch_sharding=None,
               log_fn=print) -> tuple[TrainState, list[dict]]:
    """Runs from ``state.step`` (or the latest checkpoint of ``ckpt``) up
    to ``max_steps or tcfg.steps``. Returns (final_state,
    metrics_history); a logged step's ``sec`` is its wall time up to its
    metrics on the host (reading them waits for the device)."""
    for what, given in (("DP batch placement", batch_sharding is not None),
                        ("the DataIterator contract", _is_iterator(data))):
        if given:
            raise NotImplementedError(f"train_loop: {what} is not ported "
                                      "yet (ROADMAP.md queue 1)")
    if ckpt is not None:
        restored_step, restored = ckpt.restore_latest(state)
        if restored is not None:
            state = restored
            log_fn(f"[train] resumed from checkpoint step {restored_step}")
    total = max_steps or tcfg.steps
    watermark = None
    if memprof:
        device = next(state.params.parameters()).device
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        watermark = LiveWatermark(device)
    history = []
    for step in range(state.step, total):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, data(step))
        if watermark is not None:
            watermark.sample()
        if step % log_every == 0 or step == total - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["sec"] = time.perf_counter() - t0
            if watermark is not None:
                m.update(watermark.metrics())
            history.append(m)
            log_fn(f"[train] step {step}: " +
                   " ".join(f"{k}={v:.4g}" for k, v in m.items()
                            if k != "step"))
        if ckpt is not None and tcfg.checkpoint_every > 0 and \
                (step + 1) % tcfg.checkpoint_every == 0:
            ckpt.save_async(step + 1, state)
    if ckpt is not None:
        ckpt.save(total, state)
    return state, history
