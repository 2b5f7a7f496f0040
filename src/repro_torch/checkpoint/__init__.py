"""Checkpoints in the reference's on-disk layout (port of
``repro.checkpoint``)."""
from repro_torch.checkpoint.ckpt import (
    CheckpointManager,
    latest_step,
    load_manifest,
    restore_checkpoint,
    restore_extra,
    restore_untyped,
    save_checkpoint,
    sweep_stale_tmp,
)

__all__ = [
    "CheckpointManager",
    "latest_step",
    "load_manifest",
    "restore_checkpoint",
    "restore_extra",
    "restore_untyped",
    "save_checkpoint",
    "sweep_stale_tmp",
]
