"""Optimizers, LR schedules and gradient clipping, written out on tensors
as the reference writes them (``repro.optim``); ``torch.optim`` is not
used, since its AdamW differs from the reference's."""
from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.optimizers import (
    OptState,
    init_optimizer,
    optimizer_update,
)
from repro_torch.optim.schedule import cosine_schedule, make_schedule

__all__ = ["OptState", "clip_by_global_norm", "cosine_schedule",
           "global_norm", "init_optimizer", "make_schedule",
           "optimizer_update"]
